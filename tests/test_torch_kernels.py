"""The port's tiering kernels against the JAX package's Pallas kernels.

On the CPU each CUDA wrapper runs its plain version, so these tests hold
those versions (and the dispatchers) to the Pallas kernels run in
interpret mode, as ``tests/test_kernels.py`` runs them: ``cache_lookup``
and ``block_gather`` exactly, ``paged_attention`` within 2e-5 in float32
and 3e-2 in bfloat16 (the reference's own tolerances: the kernel takes the
softmax online, the plain version in one pass). They also hold the
wrappers' input checks, the tier access's launch plan (shared memory
layout, fill-copy path) and the shared nvcc build helper. The kernels
themselves are held to the same plain versions on the card by
``chip_smoke.py``.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.block_gather.kernel import block_gather as j_block_gather
from repro.kernels.cache_lookup.kernel import cache_lookup as j_cache_lookup
from repro.kernels.cache_lookup.ref import set_index_ref as j_set_index_ref
from repro.kernels.paged_attention.kernel import paged_attention as j_paged_attention
from repro_torch.kernels import nvcc
from repro_torch.kernels.block_gather import (block_gather, block_gather_ref,
                                              gather_blocks)
from repro_torch.configs.base import FamConfig, fam_replace
from repro_torch.core.tiering import TieredBlockPool
from repro_torch.kernels.cache_lookup import (cache_lookup, cache_lookup_ref, lookup,
                                              set_index_ref)
from repro_torch.kernels.cache_lookup import kernel as ck
from repro_torch.kernels.paged_attention import (decode_attention,
                                                 paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.paged_attention.kernel import (MAX_SHARED_BYTES, cluster_plan,
                                                        cluster_size, copy_path, layout,
                                                        shared_bytes)

I32_MAX = np.iinfo(np.int32).max


def _bits(x):
    """Array bits for an exact comparison (bfloat16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


# ---------------------------------------------------------------------------
# cache_lookup
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(sets=st.sampled_from([8, 32, 64]), ways=st.sampled_from([4, 8, 16, 40]),
       k=st.integers(1, 64), seed=st.integers(0, 2 ** 16))
def test_cache_lookup_matches_pallas(sets, ways, k, seed):
    """hit, way and slot equal the Pallas kernel's, through the wrapper and
    both dispatcher backends; queries include negative ids and INT32_MAX
    (the +1 tag wraps in int32 on both sides)."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 200, (sets, ways)).astype(np.int32)
    qs = rng.integers(-5, 250, k).astype(np.int32)
    qs[0] = I32_MAX
    si = ((I32_MAX * 0x9E3779B1) % 2 ** 32 >> 7) % sets
    tags[si, -1] = np.iinfo(np.int32).min       # I32_MAX's tag, wrapped
    want = j_cache_lookup(jnp.asarray(tags), jnp.asarray(qs), interpret=True)
    t_tags, t_qs = torch.from_numpy(tags), torch.from_numpy(qs)
    for got in (cache_lookup(t_tags, t_qs), lookup(t_tags, t_qs, "cuda"),
                lookup(t_tags, t_qs, "torch")):
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(j_set_index_ref(jnp.asarray(qs), sets)),
                                  set_index_ref(t_qs, sets).numpy())


def test_cache_lookup_ties_return_first_way():
    tags = torch.tensor([[0, 8, 8, 8]], dtype=torch.int32)   # block 7 in 3 ways
    hit, way, slot = cache_lookup_ref(tags, torch.tensor([7, 3], dtype=torch.int32))
    assert hit.tolist() == [True, False]
    assert way.tolist() == [1, 0] and slot.tolist() == [1, -1]


# ---------------------------------------------------------------------------
# block_gather
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(nb=st.integers(2, 40), e=st.sampled_from([8, 64, 130]),
       k=st.integers(1, 32), bf16=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_block_gather_matches_pallas(nb, e, k, bf16, seed):
    """Gathered rows equal the Pallas kernel's bit for bit, in float32 and
    bfloat16, through the wrapper and both dispatcher backends."""
    rng = np.random.default_rng(seed)
    pool = jnp.asarray(rng.normal(size=(nb, e)), jnp.bfloat16 if bf16 else jnp.float32)
    idx = rng.integers(0, nb, k).astype(np.int32)
    want = _bits(j_block_gather(pool, jnp.asarray(idx), interpret=True))
    host = np.array(pool)
    t_pool = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16) \
        if bf16 else torch.from_numpy(host)
    t_idx = torch.from_numpy(idx)
    for got in (block_gather(t_pool, t_idx), gather_blocks(t_pool, t_idx, "cuda"),
                gather_blocks(t_pool, t_idx, "torch"), block_gather_ref(t_pool, t_idx)):
        np.testing.assert_array_equal(want, _bits(got))


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------

def _attention_inputs(rng, B, Hq, Hkv, D, T, P, NB):
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(P, T, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, T, Hkv, D)).astype(np.float32)
    bt = rng.integers(0, P, (B, NB)).astype(np.int32)
    lengths = rng.integers(1, NB * T + 1, B).astype(np.int32)
    return q, kp, vp, bt, lengths


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(dtype) if x.dtype == np.float32 else torch.from_numpy(x)


@pytest.mark.parametrize("B,Hq,Hkv,D,T,P,NB", [
    (3, 8, 2, 32, 16, 20, 4),
    (1, 4, 1, 64, 8, 8, 8),
    (2, 2, 2, 16, 32, 6, 2),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_pallas(B, Hq, Hkv, D, T, P, NB, dtype):
    """The plain version (through the wrapper and both backends) against the
    Pallas kernel in interpret mode, on the same inputs in the same type."""
    args = _attention_inputs(np.random.default_rng(B * 100 + D), B, Hq, Hkv, D, T, P, NB)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    j_args = [jnp.asarray(a, jdt) if a.dtype == np.float32 else jnp.asarray(a) for a in args]
    want = np.asarray(j_paged_attention(*j_args, interpret=True), np.float32)
    t_args = [_to_torch(a, tdt) for a in args]
    tol = 2e-5 if dtype == "float32" else 3e-2
    for got in (paged_attention(*t_args), decode_attention(*t_args),
                decode_attention(*t_args, backend="torch")):
        assert got.dtype == tdt and got.shape == (B, Hq, D)
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                                   rtol=tol, atol=tol)


def test_paged_attention_strided_views_and_mid_block_lengths():
    """K and V as the interleaved halves of one pool (the tiered-KV fast
    tier's layout), taken as strided views, give what the Pallas kernel
    gives on contiguous copies; lengths end mid-block and at one token."""
    rng = np.random.default_rng(7)
    P, T, Hkv, D, Hq, B, NB = 16, 8, 2, 16, 4, 3, 5
    fast = rng.normal(size=(P, 2, T, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    bt = rng.permutation(P)[:B * NB].reshape(B, NB).astype(np.int32)
    lengths = np.array([13, 1, 40], np.int32)
    want = j_paged_attention(jnp.asarray(q), jnp.asarray(fast[:, 0]),
                             jnp.asarray(fast[:, 1]), jnp.asarray(bt),
                             jnp.asarray(lengths), interpret=True)
    t_fast = torch.from_numpy(fast)
    k_view, v_view = t_fast[:, 0], t_fast[:, 1]
    assert not k_view.is_contiguous() and k_view.stride(0) == 2 * T * Hkv * D
    got = paged_attention(torch.from_numpy(q), k_view, v_view,
                          torch.from_numpy(bt), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# clusters of each size an H100 80GB HBM3 held at once at the tiered decode's
# shape (cudaOccupancyMaxActiveClusters, one CTA an SM), as chip_smoke.py
# prints them
H100_HELD = {8: 15, 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}


def test_paged_attention_shared_memory_and_split_plan():
    """The source's plan, through its Python mirrors: at the tiered-KV decode
    widths (G 4, D 64, T 16) a CTA is 8 consumer warps and a producer warp
    over a ring of 16 one-block stages (128 KB in f32), padded to 116 KB in
    bf16 so that no two CTAs share an SM; every width of the dense configs
    and of the CPU tests fits the 227 KB a block may use. On the H100's
    cluster counts the decode's 8 pairs take clusters of 9 (one wave), one
    pair 16 and 1,024 pairs the portable 8; every plan covers the table in
    at most `cluster` contiguous chunks."""
    f32 = layout(4, 64, 16, 4)
    assert (f32["stages"], f32["walkers"], f32["warps"], f32["threads"]) == (16, 8, 8, 288)
    assert f32["ring"] == 16 * 2 * 16 * 256 and f32["total"] == 138480
    assert shared_bytes(4, 64, 16, 2) == 116 * 1024
    assert layout(8, 128, 16, 4)["stages"] == 8 and layout(8, 128, 16, 4)["walkers"] == 4
    assert layout(8, 256, 16, 4)["stages"] == 4
    widths = [(4, 64, 16), (6, 128, 16), (8, 128, 16), (8, 256, 16)]
    widths += [(G, D, T) for G in (1, 2, 3, 4) for D in (8, 16, 32, 64) for T in (8, 16, 32)]
    for G, D, T in widths:
        for isz in (2, 4):
            assert shared_bytes(G, D, T, isz) <= MAX_SHARED_BYTES, (G, D, T, isz)
    assert cluster_size(8, H100_HELD) == 9
    assert cluster_size(1, H100_HELD) == 16 and cluster_size(1024, H100_HELD) == 8
    assert cluster_plan(251, 9) == [(28 * r, 28) for r in range(8)] + [(224, 27)]
    assert cluster_plan(0, 16) == [(0, 0)] * 16
    for pairs in (1, 2, 7, 8, 9, 15, 16, 64, 1024):
        C = cluster_size(pairs, H100_HELD)
        for nb in (0, 1, 7, 251, 256, 5000):
            plan = cluster_plan(nb, C)
            assert len(plan) == C
            covered = [j for start, n in plan for j in range(start, start + n)]
            assert covered == list(range(nb)), (pairs, nb)


def _strided_views(dtype, D=64, offset=0, P=6, T=16, Hkv=8):
    """K and V as the interleaved halves of one (P, 2, T, Hkv, D) pool,
    ``offset`` elements past the start of its storage."""
    flat = torch.zeros(offset + P * 2 * T * Hkv * D, dtype=dtype)
    fast = flat[offset:].view(P, 2, T, Hkv, D)
    return fast[:, 0], fast[:, 1]


@pytest.mark.parametrize("dtype,D,offset,want", [
    (torch.float32, 64, 0, ("tma", 16)),      # the tiered fast tier's views
    (torch.bfloat16, 64, 0, ("tma", 16)),
    (torch.float32, 256, 0, ("tma", 16)),
    (torch.float32, 64, 1, ("cp_async", 4)),  # one element past 16 bytes
    (torch.bfloat16, 64, 1, ("element", 0)),  # two bytes past 16
    (torch.bfloat16, 60, 0, ("cp_async", 8)),  # 120-byte rows
    (torch.float32, 512, 0, ("cp_async", 16)),  # rows past a TMA box
])
def test_paged_attention_copy_path(dtype, D, offset, want):
    """The copy path the wrapper hands the kernel, from the views' layout."""
    k, v = _strided_views(dtype, D, offset)
    assert not k.is_contiguous() and copy_path(k, v) == want


def test_paged_attention_zero_length_matches_pallas():
    """A sequence of length 0 gives zeros in the plain version, as in the
    Pallas kernel (and the CUDA kernel); the other sequences are as before."""
    args = _attention_inputs(np.random.default_rng(5), 3, 8, 2, 32, 16, 20, 4)
    args[4][:] = [0, 50, 0]
    want = np.asarray(j_paged_attention(*[jnp.asarray(a) for a in args], interpret=True))
    got = paged_attention(*[torch.from_numpy(a) for a in args]).numpy()
    assert not got[0].any() and not got[2].any() and not want[0].any()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# wrapper input checks
# ---------------------------------------------------------------------------

def _lookup_args():
    return dict(tags=torch.zeros((8, 4), dtype=torch.int32),
                queries=torch.arange(5, dtype=torch.int32))


def _gather_args():
    return dict(pool=torch.zeros((6, 10), dtype=torch.bfloat16),
                idx=torch.tensor([1, 5, 0], dtype=torch.int32))


def _attention_args():
    return dict(q=torch.zeros((2, 4, 8)), k_pool=torch.zeros((5, 4, 2, 8)),
                v_pool=torch.zeros((5, 4, 2, 8)),
                block_table=torch.zeros((2, 3), dtype=torch.int32),
                lengths=torch.ones(2, dtype=torch.int32))


@pytest.mark.parametrize("fn,make,field,bad,err", [
    (cache_lookup, _lookup_args, "tags", lambda t: t.to(torch.int64), TypeError),
    (cache_lookup, _lookup_args, "queries", lambda t: t.to(torch.float32), TypeError),
    (cache_lookup, _lookup_args, "queries", lambda t: t.reshape(5, 1), ValueError),
    (cache_lookup, _lookup_args, "tags", lambda t: t.t(), ValueError),
    (block_gather, _gather_args, "idx", lambda t: t.to(torch.int64), TypeError),
    (block_gather, _gather_args, "pool", lambda t: t[:, ::2], ValueError),
    (block_gather, _gather_args, "pool", lambda t: t.reshape(60), ValueError),
    (paged_attention, _attention_args, "q", lambda t: t.to(torch.float64), TypeError),
    (paged_attention, _attention_args, "k_pool", lambda t: t.to(torch.bfloat16), TypeError),
    (paged_attention, _attention_args, "v_pool", lambda t: t[:4], ValueError),
    (paged_attention, _attention_args, "k_pool", lambda t: t.transpose(2, 3).contiguous()
     .transpose(2, 3), ValueError),
    (paged_attention, _attention_args, "block_table", lambda t: t[:1], ValueError),
    (paged_attention, _attention_args, "lengths", lambda t: t.to(torch.int64), TypeError),
])
def test_wrappers_reject_bad_inputs(fn, make, field, bad, err):
    args = make()
    args[field] = bad(args[field])
    with pytest.raises(err, match=field):
        fn(**args)


@pytest.mark.parametrize("fn,make,field", [
    (cache_lookup, _lookup_args, "queries"),
    (block_gather, _gather_args, "idx"),
    (paged_attention, _attention_args, "lengths"),
])
def test_wrappers_reject_other_devices(fn, make, field):
    """An argument on another device than the first is refused, and so is a
    first argument that is on neither the CPU nor a CUDA device."""
    args = make()
    args[field] = args[field].to("meta")
    with pytest.raises(ValueError, match=field):
        fn(**args)
    args = {k: v.to("meta") for k, v in make().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(**args)


def test_wrappers_reject_bad_geometry_and_backends():
    with pytest.raises(ValueError, match="kv heads"):
        paged_attention(**dict(_attention_args(), q=torch.zeros((2, 3, 8))))
    with pytest.raises(ValueError, match="at least one"):
        block_gather(torch.zeros((0, 4)), torch.zeros(1, dtype=torch.int32))
    for call in (lambda: lookup(**_lookup_args(), backend="pallas"),
                 lambda: gather_blocks(**_gather_args(), backend="xla"),
                 lambda: decode_attention(**_attention_args(), backend="triton")):
        with pytest.raises(ValueError, match="kernel backend"):
            call()


def test_cpu_wrappers_count_no_launch():
    before = (cache_lookup.launches, block_gather.launches, paged_attention.launches)
    cache_lookup(**_lookup_args())
    block_gather(**_gather_args())
    paged_attention(**_attention_args())
    assert (cache_lookup.launches, block_gather.launches,
            paged_attention.launches) == before


# ---------------------------------------------------------------------------
# tier_access: shared memory layout and the fill copy
# ---------------------------------------------------------------------------

def test_tier_access_layout_at_the_paths_shapes():
    """The tiered decode (32 x 16, K 256) and the expert tier (12 x 16,
    K 8) hold their tag and lru rows and ids in shared memory, under the
    48 KB a launch gets without opting in; the SPP tables stay in device
    memory at any prefetch setting."""
    kv = 4 * (2 * 512 + 7 * 256) + 512
    assert ck.access_layout(32, 16, 256, 4) == kv < 48 * 1024
    moe = 4 * (2 * 192 + 7 * 8) + 192
    assert ck.access_layout(12, 16, 8, 4) == moe
    # ragged sizes round each region up to 16 bytes
    assert ck.access_shared_bytes(3, 3, 1) == 4 * 28 + 16
    # the wrapper's limit is the source's, under 48 KB (no opt-in)
    assert (f"kMaxSharedBytes = {ck.MAX_SHARED_BYTES // 1024} * 1024;"
            in ck.ACCESS_SOURCE.read_text())
    assert ck.MAX_SHARED_BYTES < 48 * 1024


@pytest.mark.parametrize("args,kw,match", [
    ((4, 40, 8, 4), {}, "at most 32 ways"),
    ((4, 16, 8, 40), {}, "prefetch degree"),
    ((4096, 16, 256, 4), {}, "tag and lru rows"),
    ((32, 16, 9000, 4), {}, "9000 ids"),
    ((32, 16, 256, 4), {"degree": 33}, "at most 32, got 33"),
])
def test_tier_access_refuses_what_it_cannot_hold(args, kw, match):
    with pytest.raises(ValueError, match=match):
        ck.access_layout(*args[:3], **{"degree": args[3], **kw})


def test_tier_access_keeps_large_spp_tables_in_device_memory():
    """The SPP tables never enter shared memory: the chain reads and
    writes them through their device pointers, and the layout counts only
    the tag and lru rows, the ids and the fill flags, so no SPP size
    limits a pool."""
    assert "const Spp& tab = a.spp;" in ck.ACCESS_SOURCE.read_text()
    assert ck.access_layout(32, 16, 256, 4) == ck.access_shared_bytes(32, 16, 256)


@pytest.mark.parametrize("slow_dtype,fast_dtype,E,offset,want", [
    (torch.float32, torch.float32, 16384, 0, ("vector", 4096)),
    (torch.bfloat16, torch.bfloat16, 24, 0, ("vector", 3)),
    (torch.bfloat16, torch.bfloat16, 12, 0, ("bytes", 24)),
    (torch.float32, torch.float32, 8, 1, ("bytes", 32)),
    (torch.float32, torch.bfloat16, 8, 0, ("bf16x4", 2)),
    (torch.float32, torch.bfloat16, 6, 0, ("bf16", 6)),
    (torch.float32, torch.bfloat16, 8, 1, ("bf16", 8)),
])
def test_tier_access_copy_path(slow_dtype, fast_dtype, E, offset, want):
    flat = torch.zeros(4 * E + offset, dtype=slow_dtype)
    slow = flat[offset:].view(4, E)
    assert ck.copy_path(slow, torch.zeros((2, E), dtype=fast_dtype)) == want


def test_tier_access_refuses_other_type_pairs():
    with pytest.raises(TypeError, match="float32 -> bfloat16"):
        ck.copy_path(torch.zeros((2, 8), dtype=torch.bfloat16), torch.zeros((2, 8)))


def test_access_dispatch_refuses_unknown_backends():
    """The pool routes the access itself and refuses a backend it does not
    know before touching any tensor."""
    pool = TieredBlockPool(fam_replace(FamConfig(), kernel_backend="triton"), 64, 16, 8,
                           dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="kernel backend"):
        pool.access(None, None, torch.tensor([1], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the shared nvcc build helper
# ---------------------------------------------------------------------------

def test_library_named_by_source_hash(tmp_path):
    src = tmp_path / "pkg" / "csrc" / "k.cu"
    src.parent.mkdir(parents=True)
    src.write_text("// one\n")
    digest = hashlib.sha256(b"// one\n").hexdigest()[:16]
    assert nvcc.library_path(src) == tmp_path / "pkg" / "build" / f"libk_{digest}.so"
    first = nvcc.library_path(src)
    src.write_text("// two\n")
    assert nvcc.library_path(src) != first


def test_build_reuses_a_built_library_without_nvcc(tmp_path, monkeypatch):
    """A library already built for this source is returned as is (empty
    log) and nvcc is never looked for; a source not built yet needs nvcc,
    and its absence raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    srcs = []
    for name in ("a", "b"):
        src = tmp_path / name / "csrc" / f"{name}.cu"
        src.parent.mkdir(parents=True)
        src.write_text(f"// {name}\n")
        srcs.append(src)
    lib = nvcc.library_path(srcs[0])
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    assert nvcc.build(srcs[0]) == (lib, "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc.build_all(srcs)
