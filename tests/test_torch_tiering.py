"""The port's tiering runtime against the JAX package, on the same numpy
inputs from a seed: the DWRR schedule, ``TieredBlockPool.access`` (slots,
every ``TierState`` field and the counters bit for bit, for both kernel
backends), ``TieredKV.decode_step`` (within 2e-5 of JAX's, whose Pallas
paged attention runs in interpret mode), ``ExpertTier.gather_experts``
(exact in float32 and bfloat16), and a mid-run handover of a JAX state
through ``from_numpy``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FamConfig as JFamConfig, fam_replace
from repro.core import spp as jspp
from repro.core import wfq as jwfq
from repro.core.tiering import TieredBlockPool as JPool
from repro.serve.expert_tiering import ExpertTier as JExpertTier
from repro.serve.tiered_kv import TieredKV as JTieredKV
from repro.serve.tiered_kv import TieredKVConfig as JKVConfig
from repro_torch.configs.base import FamConfig
from repro_torch.core import spp as tspp
from repro_torch.core import wfq as twfq
from repro_torch.core.fam_params import from_numpy
from repro_torch.core.tiering import TieredBlockPool, TierState
from repro_torch.kernels.cache_lookup import cache_lookup
from repro_torch.serve.expert_tiering import ExpertTier
from repro_torch.serve.tiered_kv import TieredKV, TieredKVConfig

J_CFG = fam_replace(JFamConfig(), cache_ways=4, prefetch_degree=4)


def _cfg(backend="cuda", **kw):
    return FamConfig(cache_ways=4, prefetch_degree=4, kernel_backend=backend, **kw)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for node in tree for leaf in _leaves(node)]
    return [tree]


def assert_state_equal(jst, tst):
    """Every TierState field, nested states included, bit for bit."""
    assert isinstance(tst, TierState)
    jl, tl = jax.tree.leaves(jst), _leaves(tst)
    assert len(jl) == len(tl) == 19
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# DWRR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight,quantum,max_deficit,r,max_issues", [
    (2, 1, 8, 1, 260), (4, 1, 8, 4, 64), (1, 2, 3, 2, 40), (7, 1, 8, 1, 24)])
def test_schedule_batch_matches_jax(weight, quantum, max_deficit, r, max_issues):
    """The tensor schedule over 32 random states and backlogs equals the
    JAX reference exactly (state and issue order), and the host-int
    schedule equals it lane by lane."""
    rng = np.random.default_rng(weight * 10 + r)
    L = 32
    state = (rng.integers(0, weight + 1, L), rng.integers(-6, max_deficit + 1, L),
             rng.integers(-6, max_deficit * r + 1, L))
    state = tuple(a.astype(np.int32) for a in state)
    nd = rng.integers(0, 40, L).astype(np.int32)
    npf = rng.integers(0, 12, L).astype(np.int32)
    kw = dict(weight=weight, quantum=quantum, max_deficit=max_deficit, r=r,
              max_issues=max_issues)
    j_fn = jax.jit(jax.vmap(functools.partial(jwfq.schedule_batch, **kw)))
    j_state, j_order = j_fn(jwfq.WfqState(*state), nd, npf)
    t_state, t_order = twfq.schedule_batch(
        twfq.WfqState(*(torch.from_numpy(a) for a in state)),
        torch.from_numpy(nd), torch.from_numpy(npf), **kw)
    assert t_order.dtype == torch.int32 and t_order.shape == (L, max_issues)
    np.testing.assert_array_equal(np.asarray(j_order), t_order.numpy())
    for a, b in zip(j_state, t_state):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for lane in range(L):
        h_state, h_order = twfq.schedule_batch_host(
            tuple(int(a[lane]) for a in state), int(nd[lane]), int(npf[lane]), **kw)
        assert h_order == t_order[lane].tolist()
        assert h_state == tuple(int(b[lane]) for b in t_state)


def test_predict_defaults_to_the_config_threshold():
    """``spp.predict`` without a threshold uses the config's, as in JAX."""
    cfg = _cfg()
    rng = np.random.default_rng(3)
    s = tspp.init_spp(cfg)
    for blk in rng.integers(0, 16, 60):
        tspp.update(cfg, s, torch.tensor(2, dtype=torch.int32),
                    torch.tensor(int(blk), dtype=torch.int32))
    args = (cfg, s, torch.tensor(2, dtype=torch.int32), torch.tensor(5, dtype=torch.int32),
            torch.tensor(9, dtype=torch.int32), 4)
    for a, b in zip(tspp.predict(*args, bpp=16),
                    tspp.predict(*args, bpp=16, threshold=cfg.spp_confidence_threshold)):
        assert torch.equal(a, b)
    assert tspp.predict.__defaults__ == jspp.predict.__defaults__ == (64, None)


# ---------------------------------------------------------------------------
# TieredBlockPool.access
# ---------------------------------------------------------------------------

def _streams(kind, rng):
    if kind == "random":
        return [rng.integers(0, 64, 4).astype(np.int32) for _ in range(20)]
    seq = np.arange(48, dtype=np.int32)          # a stream SPP learns
    return [seq[i:i + 2] for i in range(0, 40, 2)]


@functools.lru_cache(maxsize=None)
def _j_access(fast_blocks, prefetch):
    pool = JPool(J_CFG, num_blocks=64, fast_blocks=fast_blocks, block_elems=8,
                 dtype=jnp.float32)
    return pool, jax.jit(functools.partial(pool.access, prefetch=prefetch))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("kind,fast_blocks", [("random", 16), ("stream", 32)])
def test_access_matches_jax(kind, fast_blocks, prefetch, backend):
    """After each of 20 accesses the slots, reads and the whole TierState
    (fast tier, side tables, cache, SPP, WFQ, counters) equal JAX's."""
    jpool, j_access = _j_access(fast_blocks, prefetch)
    slow_np = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    j_slow = jnp.asarray(slow_np)
    jst = jpool.init(j_slow)
    pool = TieredBlockPool(_cfg(backend), 64, fast_blocks, 8, dtype=torch.float32,
                           device="cpu")
    slow = torch.from_numpy(slow_np)
    tst = pool.init(slow)
    for ids in _streams(kind, np.random.default_rng(0)):
        jst, j_slots = j_access(jst, j_slow, jnp.asarray(ids))
        tst, t_slots = pool.access(tst, slow, torch.from_numpy(ids), prefetch=prefetch)
        np.testing.assert_array_equal(np.asarray(j_slots), t_slots.numpy())
        np.testing.assert_array_equal(pool.read(tst, t_slots).numpy(), slow_np[ids])
        assert_state_equal(jst, tst)
    if prefetch and kind == "stream":
        assert float(tst.prefetches) > 0
    assert float(pool.hit_rate(tst)) == float(jpool.hit_rate(jst))


def test_access_probes_through_the_lookup_wrapper(monkeypatch):
    """Under kernel_backend="cuda" the final probe goes through the
    cache_lookup wrapper once per access; under "torch" never."""
    calls = []
    import repro_torch.kernels.cache_lookup.ops as ops
    monkeypatch.setattr(ops, "cache_lookup",
                        lambda *a: calls.append(1) or cache_lookup(*a))
    slow = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    for backend, want in (("cuda", 3), ("torch", 0)):
        calls.clear()
        pool = TieredBlockPool(_cfg(backend), 64, 16, 8, dtype=torch.float32, device="cpu")
        st = pool.init(slow)
        for i in range(3):
            st, _ = pool.access(st, slow, torch.tensor([i, i + 1], dtype=torch.int32))
        assert len(calls) == want


# ---------------------------------------------------------------------------
# TieredKV.decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("window,Hq,Hkv,D,lengths", [
    (0, 4, 2, 16, (8, 24, 64, 63)),
    (2, 2, 1, 8, (40, 41, 17)),
])
def test_decode_step_matches_jax(window, Hq, Hkv, D, lengths, backend):
    """Outputs within 2e-5 of JAX's decode_step (Pallas paged attention in
    interpret mode) and the same TierState after every step, at the shapes
    of tests/test_tiering.py, full and windowed."""
    S, T = 64, 8
    rng = np.random.default_rng(window + D)
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    jtk = JTieredKV(fam_replace(JFamConfig(), cache_ways=4),
                    JKVConfig(block_tokens=T, fast_blocks=16, window_blocks=window),
                    max_blocks=S // T, kv_heads=Hkv, head_dim=D)
    ttk = TieredKV(FamConfig(cache_ways=4, kernel_backend=backend),
                   TieredKVConfig(block_tokens=T, fast_blocks=16, window_blocks=window),
                   max_blocks=S // T, kv_heads=Hkv, head_dim=D, device="cpu")
    j_slow = jtk.pack(jnp.asarray(k), jnp.asarray(v))
    t_slow = ttk.pack(torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(np.asarray(j_slow), t_slow.numpy())
    jst, tst = jtk.init(j_slow), ttk.init(t_slow)
    for length in lengths:
        q = rng.normal(size=(Hq, D)).astype(np.float32)
        jst, j_out = jtk.decode_step(jst, j_slow, jnp.asarray(q),
                                     jnp.asarray(length, jnp.int32))
        tst, t_out = ttk.decode_step(tst, t_slow, torch.from_numpy(q), length)
        assert t_out.shape == (Hq, D)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=2e-5, atol=2e-5)
        assert_state_equal(jst, tst)


# ---------------------------------------------------------------------------
# ExpertTier.gather_experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_experts_matches_jax(dtype):
    """Gathered slabs and the state equal JAX's bit for bit. The slow tier
    is float32, so in bfloat16 every fill rounds float32 -> bfloat16 as
    XLA does (to nearest, ties to even)."""
    L, E, elems, fast = 4, 8, 32, 16
    rng = np.random.default_rng(1)
    slow_np = rng.normal(size=(L * E, elems)).astype(np.float32)
    # values on bfloat16 rounding ties and near them
    slow_np[0, :4] = np.array([0x3F808000, 0x3F818000, 0x3F808001, 0xBF817FFF],
                              np.uint32).view(np.float32)
    jtier = JExpertTier(J_CFG, L, E, elems, fast, dtype=getattr(jnp, dtype))
    ttier = ExpertTier(_cfg(), L, E, elems, fast, dtype=getattr(torch, dtype),
                       device="cpu")
    j_slow, t_slow = jnp.asarray(slow_np), torch.from_numpy(slow_np)
    j_gather = jax.jit(jtier.gather_experts)
    jst, tst = jtier.init(j_slow), ttier.init(t_slow)
    for step in range(12):
        experts = rng.choice(E, size=2, replace=False).astype(np.int32)
        if step % 3 == 0:
            experts[0] = 0            # slab 0 of layer 0 carries the ties
        layer = step % L
        jst, j_slabs = j_gather(jst, j_slow, jnp.int32(layer), jnp.asarray(experts))
        tst, t_slabs = ttier.gather_experts(tst, t_slow, layer, torch.from_numpy(experts))
        assert t_slabs.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_bits(j_slabs), _bits(t_slabs))
        ids = ttier.slab_ids(layer, torch.from_numpy(experts)).numpy()
        np.testing.assert_array_equal(
            _bits(t_slabs), _bits(torch.from_numpy(slow_np[ids]).to(getattr(torch, dtype))))
        assert_state_equal(jst, tst)


def test_bf16_cast_rounds_like_xla():
    """float32 -> bfloat16 in torch equals XLA's bit for bit on random
    values and on rounding ties, denormals and infinities; NaN stays NaN
    (the two pick different NaN payloads)."""
    rng = np.random.default_rng(5)
    special = np.array([0x3F808000, 0x3F818000, 0x00008000, 0x00018000, 0x7F7FFFFF,
                        0x7F800000, 0xFF800000], np.uint32).view(np.float32)
    x = np.concatenate([rng.normal(size=4096).astype(np.float32) * 1e3, special])
    want = _bits(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(want, _bits(torch.from_numpy(x).to(torch.bfloat16)))
    assert torch.tensor([np.nan]).to(torch.bfloat16).isnan().all()


# ---------------------------------------------------------------------------
# handover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_handover_from_jax_mid_run(dtype):
    """A JAX TierState after 10 accesses, carried across by from_numpy
    (bfloat16 through a uint16 view), continues in the port to the same
    state and slots as JAX over 10 more."""
    jpool = JPool(J_CFG, num_blocks=64, fast_blocks=32, block_elems=8,
                  dtype=getattr(jnp, dtype))
    slow_np = np.random.default_rng(2).normal(size=(64, 8)).astype(np.float32)
    j_slow = jnp.asarray(slow_np)
    j_access = jax.jit(jpool.access)
    jst = jpool.init(j_slow)
    seq = np.concatenate([np.arange(40), np.random.default_rng(4).integers(0, 64, 40)])
    steps = [seq[i:i + 4].astype(np.int32) for i in range(0, 80, 4)]
    for ids in steps[:10]:
        jst, _ = j_access(jst, j_slow, jnp.asarray(ids))
    tst = from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    assert_state_equal(jst, tst)
    assert tst.fast.dtype == getattr(torch, dtype)
    pool = TieredBlockPool(_cfg(), 64, 32, 8, dtype=getattr(torch, dtype), device="cpu")
    slow = torch.from_numpy(slow_np)
    for ids in steps[10:]:
        jst, j_slots = j_access(jst, j_slow, jnp.asarray(ids))
        tst, t_slots = pool.access(tst, slow, torch.from_numpy(ids))
        np.testing.assert_array_equal(np.asarray(j_slots), t_slots.numpy())
        assert_state_equal(jst, tst)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: TieredBlockPool(_cfg(), 64, 16, 8),
                 lambda: TieredKV(_cfg(), TieredKVConfig(), 8, 2, 16),
                 lambda: ExpertTier(_cfg(), 2, 8, 32, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_pool_refuses_a_slow_tier_elsewhere():
    """init refuses a slow tier on another device or of another shape, and
    the pool a fast tier that is not whole sets."""
    with pytest.raises(ValueError, match="multiple of cache_ways"):
        TieredBlockPool(_cfg(), 64, 18, 8, device="cpu")
    pool = TieredBlockPool(_cfg(), 64, 16, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="slow is on meta"):
        pool.init(torch.zeros((64, 8), device="meta"))
    with pytest.raises(ValueError, match="slow must be"):
        pool.init(torch.zeros((64, 9)))
