"""The port's dense model stack and serving engine against the JAX package.

The JAX params (``transformer.init_lm``) are carried across as numpy arrays
with ``params_from_numpy``, and both packages run on the same tokens, on
the CPU. Tolerances:

* float32 (``dtype="float32"``): atol 1e-5 x max|reference|, rtol 1e-5;
  the two differ only in the order of float32 sums;
* bfloat16 (the configs' compute type): the teacher-forcing tolerance of
  ``tests/test_models.py:89-101``, atol 0.05 x max|reference|, rtol 0.05;
  the two round to bfloat16 at different places inside fused ops.

With ``kernel_backend="cuda"`` the prefill's causal attention goes through
the flash-attention wrapper (its plain version on these CPU tensors); with
``"torch"`` through the reference's chunked path. Both are held here.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import attention as JA
from repro.models import build_model as j_build_model
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model_zoo import pad_cache as j_pad_cache
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as serve_launch
from repro_torch.models import attention as A
from repro_torch.models import build_model, pad_cache, params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, ServeConfig

F32 = dict(scale=1e-5, rtol=1e-5)
BF16 = dict(scale=0.05, rtol=0.05)
ARCHS = ("granite-3-2b-smoke", "gemma-2b-smoke", "yi-9b-smoke")


def _close(got, want, scale, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, atol=scale * (np.abs(want).max() + 1e-3),
                               rtol=rtol)


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32", seed=1):
    jc = dataclasses.replace(j_get_config(arch), dtype=dtype)
    tc = dataclasses.replace(get_config(arch), dtype=dtype)
    params = JT.init_lm(jax.random.PRNGKey(seed), jc)
    lm = params_from_numpy(tc, jax.tree.map(np.asarray, params), "cpu")
    return jc, tc, params, lm


def _tokens(cfg, B, S, seed=0):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jnp.asarray(tok), torch.from_numpy(tok)


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS + tuple(a + "-smoke" for a in ARCH_IDS))
def test_model_config_equals_reference(arch):
    tc, jc = get_config(arch), j_get_config(arch)
    assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.q_dim, tc.kv_dim, tc.param_count()) == (jc.q_dim, jc.kv_dim, jc.param_count())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fast_variant_equals_reference(arch):
    """``-fast`` resolves as the reference's: the chunked-parallel mLSTM for
    xLSTM, every other architecture unchanged (its -smoke too)."""
    tc, jc = get_config(arch + "-fast"), j_get_config(arch + "-fast")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc == get_config(arch)) == (tc.xlstm is None)
    if tc.xlstm is not None:
        assert tc.xlstm.parallel_mlstm and not get_config(arch).xlstm.parallel_mlstm
    assert dataclasses.asdict(get_config(arch + "-fast-smoke")) == \
        dataclasses.asdict(j_get_config(arch + "-fast-smoke"))


def test_build_model_refuses_what_it_does_not_run():
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(get_config("granite-3-2b-smoke"), family="diffusion"),
                    device="cpu")
    with pytest.raises(ValueError, match="kernel backend"):
        build_model(get_config("granite-3-2b-smoke"), device="cpu", kernel_backend="pallas")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("granite-3-2b-smoke"))


@pytest.mark.parametrize("arch", ARCHS)
def test_module_params_are_the_reference_keys_and_count(arch):
    _, tc, params, lm = _setup(arch)
    n = sum(p.numel() for p in lm.parameters())
    assert n == tc.param_count() == sum(x.size for x in jax.tree.leaves(params))
    names = {n for n, _ in lm.named_parameters()}
    assert {"embed.embedding", "layers.1.attn.wq", "layers.0.mlp.gate",
            "layers.0.norm1.scale", "final_norm.scale"} <= names
    # trainable parameters; serving takes no gradient through its no_grad
    # entry points
    assert all(p.requires_grad for p in lm.parameters())
    model = build_model(tc, device="cpu")
    _, tok = _tokens(tc, 2, 5)
    logits, cache = model.prefill(lm, {"tokens": tok})
    step, cache = model.decode(lm, pad_cache(cache, 6), {"tokens": tok[:, :1], "index": 5})
    assert not any(t.requires_grad for t in (logits, step, cache["k"], cache["v"]))


def test_params_from_numpy_checks_keys_and_shapes():
    jc, tc, params, _ = _setup("granite-3-2b-smoke")
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, final_norm={})
    with pytest.raises(KeyError, match="final_norm.scale"):
        params_from_numpy(tc, bad, "cpu")
    bad = dict(tree, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        params_from_numpy(tc, bad, "cpu")


def test_init_is_seeded_and_truncated():
    model = build_model(get_config("granite-3-2b-smoke"), device="cpu")
    a, b, c = model.init(0), model.init(0), model.init(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        if "norm" not in name:
            assert not torch.equal(pa, pc), name
    wq = a.layers[0].attn.wq
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(wq.shape[0]) + 1e-7
    emb = a.embed.embedding
    assert float(emb.abs().max()) <= 0.04 + 1e-7 and emb.dtype == torch.float32


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_matches(norm, dtype):
    jc = dataclasses.replace(j_get_config("granite-3-2b-smoke"), norm=norm, dtype=dtype)
    tc = dataclasses.replace(get_config("granite-3-2b-smoke"), norm=norm, dtype=dtype)
    rng = np.random.default_rng(5)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = L.init_norm(tc)
    with torch.no_grad():
        tp.scale.copy_(torch.from_numpy(scale))
        if norm == "layernorm":
            tp.bias.copy_(torch.from_numpy(bias))
    jx, tx = _x((2, 5, 64), dtype)
    got = L.apply_norm(tc, tp, tx)
    assert got.dtype == tx.dtype
    _close(got, JL.apply_norm(jc, jp, jx), **_tol(dtype))


@pytest.mark.parametrize("arch", ["granite-3-2b-smoke", "internlm2-20b-smoke", "gemma-2b-smoke"])
def test_apply_rope_matches(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    jx, tx = _x((2, 9, 3, tc.head_dim), "float32", seed=6)
    pos = np.random.default_rng(6).integers(0, 4096, (2, 9)).astype(np.int32)
    _close(L.apply_rope(tc, tx, torch.from_numpy(pos)),
           JL.apply_rope(jc, jx, jnp.asarray(pos)), scale=1e-5, rtol=1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp_matches(activation, dtype):
    """geglu and gelu: jax.nn.gelu is the tanh approximation, which the
    float32 tolerance tells from the exact erf form."""
    jc = dataclasses.replace(j_get_config("gemma-2b-smoke"), activation=activation, dtype=dtype)
    tc = dataclasses.replace(get_config("gemma-2b-smoke"), activation=activation, dtype=dtype)
    jp = JL.init_mlp(jax.random.PRNGKey(2), jc)
    tp = L.init_mlp(None, tc)
    with torch.no_grad():
        for k, v in jp.items():
            getattr(tp, k).copy_(torch.tensor(np.asarray(v)))
    jx, tx = _x((2, 7, 64), dtype, seed=7)
    got = L.apply_mlp(tc, tp, tx).detach()
    _close(got, JL.apply_mlp(jc, jp, jx), **_tol(dtype))
    if activation != "swiglu" and dtype == "float32":
        h = torch.nn.functional.gelu(tx @ (tp.gate if activation == "geglu" else tp.up))
        erf = ((h * (tx @ tp.up) if activation == "geglu" else h) @ tp.down).detach()
        assert not np.allclose(erf.numpy(), got.numpy(), atol=1e-5)


def test_embedding_scale_is_rounded_to_bfloat16_first():
    """Gemma scales embeddings by sqrt(d_model) rounded to the compute type
    (sqrt(2048) = 45.2548... -> 45.25 in bfloat16): bit for bit."""
    jc = dataclasses.replace(j_get_config("gemma-2b-smoke"), d_model=2048)
    tc = dataclasses.replace(get_config("gemma-2b-smoke"), d_model=2048)
    jp = JL.init_embedding(jax.random.PRNGKey(3), jc)
    tp = L.init_embedding(None, tc)
    with torch.no_grad():
        tp.embedding.copy_(torch.tensor(np.asarray(jp["embedding"])))
    jt, tt = _tokens(tc, 2, 6)
    got = L.embed_tokens(tc, tp, tt).detach()
    want = np.asarray(JL.embed_tokens(jc, jp, jt).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    unrounded = (tp.embedding[tt] * float(np.sqrt(2048))).to(torch.bfloat16).detach()
    assert not torch.equal(unrounded, got)


@pytest.mark.parametrize("arch,softcap", [("granite-3-2b-smoke", 0.0),
                                          ("yi-9b-smoke", 0.0), ("yi-9b-smoke", 3.0)])
def test_unembed_matches(arch, softcap):
    """Tied (granite) and untied (yi) heads, with and without a soft cap."""
    jc = dataclasses.replace(j_get_config(arch), dtype="float32", logit_softcap=softcap)
    tc = dataclasses.replace(get_config(arch), dtype="float32", logit_softcap=softcap)
    _, _, params, lm = _setup(arch)
    jx, tx = _x((2, 3, 64), "float32", seed=8)
    _close(L.unembed(tc, lm.embed, tx), JL.unembed(jc, params["embed"], jx), **F32)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(cfg, B, Sq, Sk, dtype, seed=9):
    jq, tq = _x((B, Sq, cfg.num_heads, cfg.head_dim), dtype, seed)
    jk, tk = _x((B, Sk, cfg.num_kv_heads, cfg.head_dim), dtype, seed + 1)
    jv, tv = _x((B, Sk, cfg.num_kv_heads, cfg.head_dim), dtype, seed + 2)
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("schedule", ["rect", "grouped"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("window", [0, 5])
def test_attend_matches(schedule, backend, window):
    """Long queries (S 32 over chunks of 8, 2 groups) in float32."""
    jc, tc = j_get_config("granite-3-2b-smoke"), get_config("granite-3-2b-smoke")
    (jq, jk, jv), (q, k, v) = _qkv(tc, 2, 32, 32, "float32")
    want = JA.attend(jc, jq, jk, jv, causal=True, window=window, chunk=8,
                     schedule=schedule, groups=2)
    got = A.attend(tc, q, k, v, causal=True, window=window, chunk=8,
                   schedule=schedule, groups=2, backend=backend)
    _close(got, want, **F32)


@pytest.mark.parametrize("S", [6, 21])
def test_attend_bfloat16_casts_probabilities_like_the_reference(S):
    """The jnp path casts the softmax to q's type before p.v: the port's
    torch path keeps that rounding and agrees with the reference to a
    bfloat16 ulp or two, closer than without the cast."""
    jc = dataclasses.replace(j_get_config("granite-3-2b-smoke"), dtype="bfloat16")
    tc = dataclasses.replace(get_config("granite-3-2b-smoke"), dtype="bfloat16")
    (jq, jk, jv), (q, k, v) = _qkv(tc, 2, S, S, "bfloat16", seed=11)
    want = np.asarray(JA.attend(jc, jq, jk, jv, causal=True, chunk=8), np.float32)
    got = A.attend(tc, q, k, v, causal=True, chunk=8, backend="torch").to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
    f32 = A.attend(tc, q.float(), k.float(), v.float(), causal=True, chunk=8,
                   backend="torch").to(torch.bfloat16).to(torch.float32).numpy()
    assert np.abs(got - want).sum() < np.abs(f32 - want).sum()


def test_decode_attend_and_cache_update_match():
    jc, tc = j_get_config("granite-3-2b-smoke"), get_config("granite-3-2b-smoke")
    (jq, jk, jv), (q, k, v) = _qkv(tc, 2, 1, 12, "float32", seed=12)
    kc, vc = torch.zeros_like(k), torch.zeros_like(v)
    jkc, jvc = jnp.zeros_like(jk), jnp.zeros_like(jv)
    got_kc, got_vc = A.cache_update(kc, vc, k[:, :7], v[:, :7], 2)
    assert got_kc is kc and got_vc is vc            # written in place
    jkc, jvc = JA.cache_update(jkc, jvc, jk[:, :7], jv[:, :7], jnp.asarray(2, jnp.int32))
    np.testing.assert_array_equal(kc.numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(jvc))
    for window in (0, 4):
        _close(A.decode_attend(tc, q, kc, vc, 9, window=window),
               JA.decode_attend(jc, jq, jkc, jvc, jnp.asarray(9, jnp.int32), window=window),
               **F32)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = 0
        real = flash_ops.attention

        def spy(*args, **kw):
            self.calls += 1
            return real(*args, **kw)
        monkeypatch.setattr(flash_ops, "attention", spy)


@pytest.mark.parametrize("kw,routed", [
    (dict(), True),
    (dict(backend="torch"), False),
    (dict(window=4), False),
    (dict(schedule="grouped"), False),
    (dict(causal=False), True),
    (dict(causal=False, Sk=24), True),
    (dict(causal=False, window=4), False),
    (dict(causal=False, backend="torch"), False),
    (dict(Sk=24), False),
])
def test_attend_routes_the_prefill_case_to_the_kernel(monkeypatch, kw, routed):
    """Under backend "cuda" with no window, causal self-attention with
    Sq == Sk under the rect schedule and unmasked attention at any Sq, Sk
    go to the kernel; the rest by rule to the jnp path."""
    spy = _Spy(monkeypatch)
    tc = get_config("granite-3-2b-smoke")
    kw = dict(kw)
    _, (q, k, v) = _qkv(tc, 1, 16, kw.pop("Sk", 16), "float32")
    A.attend(tc, q, k, v, chunk=8, groups=2, **kw)
    assert spy.calls == int(routed)


def test_prefill_launches_the_kernel_once_per_layer_and_decode_never(monkeypatch):
    _, tc, _, lm = _setup("granite-3-2b-smoke")
    model = build_model(tc, device="cpu")
    _, tok = _tokens(tc, 2, 10)
    spy = _Spy(monkeypatch)
    _, cache = model.prefill(lm, {"tokens": tok})
    assert spy.calls == tc.num_layers
    cache = pad_cache(cache, 12)
    assert cache["k"].shape == model.init_cache(2, 12)["k"].shape == (2, 2, 12, 2, 16)
    model.decode(lm, cache, {"tokens": tok[:, :1], "index": 10})
    assert spy.calls == tc.num_layers


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches(arch, dtype):
    jc, tc, params, lm = _setup(arch, dtype)
    jt, tt = _tokens(tc, 2, 12)
    want, _ = JT.forward(jc, None, params, jt)
    for backend in ("cuda", "torch"):
        with torch.no_grad():
            logits, aux = T.forward(tc, lm, tt, backend=backend)
        assert float(aux) == 0.0
        _close(logits, want, **_tol(dtype))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match(arch, dtype):
    """prefill's last logits and K/V cache, then 3 decode steps' logits and
    caches, against the reference on the same tokens."""
    jc, tc, params, lm = _setup(arch, dtype)
    jt, tt = _tokens(tc, 2, 9, seed=1)
    PRE = 6
    jl, jcache = JT.prefill(jc, None, params, jt[:, :PRE])
    tl, tcache = T.prefill(tc, lm, tt[:, :PRE])
    tol = _tol(dtype)
    _close(tl, jl, **tol)
    for key in ("k", "v"):
        assert tcache[key].shape == jcache[key].shape
        _close(tcache[key], jcache[key], **tol)
    jcache, tcache = j_pad_cache(jcache, 9), pad_cache(tcache, 9)
    for t in range(PRE, 9):
        jl, jcache = JT.decode_step(jc, None, params, jcache, jt[:, t:t + 1],
                                    jnp.asarray(t, jnp.int32))
        tl, tcache = T.decode_step(tc, lm, tcache, tt[:, t:t + 1], t)
        _close(tl, jl, **tol)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], **tol)


BUFFERED = ("qwen2-vl-72b-smoke", "granite-3-2b-smoke")


def _buffered_setup(arch, B=2, PRE=8, W=4):
    """The reference's and the port's caches after a PRE-token prefill,
    padded to PRE + W rows, and empty W-slot buffers."""
    jc, tc, params, lm = _setup(arch)
    jt, tt = _tokens(tc, B, PRE + W, seed=3)
    _, jcache = JT.prefill(jc, None, params, jt[:, :PRE])
    _, tcache = T.prefill(tc, lm, tt[:, :PRE])
    jcache, tcache = j_pad_cache(jcache, PRE + W), pad_cache(tcache, PRE + W)
    return (jc, tc, params, lm, jt, tt, jcache, tcache, JT.init_kv_buffer(jc, B, W),
            T.init_kv_buffer(tc, B, W, device="cpu"))


@pytest.mark.parametrize("arch", BUFFERED)
def test_buffered_decode_matches_reference(arch):
    """decode_step_buffered from base_len 8 with a 4-slot buffer: logits
    and buffers at each step against the reference's, the cache never
    written; flush_buffer's cache at base_len 8 and at a start past
    S - W (clamped, as dynamic_update_slice clamps it), f32 tight."""
    PRE, W = 8, 4
    jc, tc, params, lm, jt, tt, jcache, tcache, jbuf, tbuf = _buffered_setup(arch, PRE=PRE,
                                                                           W=W)
    before = {k: v.clone() for k, v in tcache.items()}
    for i in range(W):
        jl, jbuf = JT.decode_step_buffered(jc, None, params, jcache, jbuf,
                                           jt[:, PRE + i:PRE + i + 1],
                                           jnp.asarray(PRE, jnp.int32), jnp.asarray(i, jnp.int32))
        tl, got = T.decode_step_buffered(tc, lm, tcache, tbuf, tt[:, PRE + i:PRE + i + 1], PRE, i)
        assert got is tbuf                              # written in place
        _close(tl, jl, **F32)
        for key in ("k", "v"):
            _close(tbuf[key], jbuf[key], **F32)
            assert torch.equal(tcache[key], before[key])    # the cache is read only
    for start in (PRE, PRE + W - 1):                    # the second start is clamped
        jm = JT.flush_buffer(jc, jcache, jbuf, jnp.asarray(start, jnp.int32))
        tm = T.flush_buffer(tc, {k: v.clone() for k, v in tcache.items()}, tbuf, start)
        for key in ("k", "v"):
            _close(tm[key], jm[key], **F32)
            np.testing.assert_array_equal(tm[key][:, :, -W:].numpy(), tbuf[key].numpy())


@pytest.mark.parametrize("arch", BUFFERED)
def test_buffered_decode_matches_plain_decode(arch):
    """As ``tests/test_models.py`` holds the reference: the buffered steps'
    logits equal the in-place decode's on the same tokens and positions,
    and after the flush the cache's new rows equal the in-place decode's
    (layer 0 bit for bit: its K/V come from the token alone; the later
    layers' inputs went through the two-source softmax, within F32)."""
    PRE, W = 8, 4
    _, tc, _, lm, _, tt, _, tcache, _, tbuf = _buffered_setup(arch, PRE=PRE, W=W)
    plain = {k: v.clone() for k, v in tcache.items()}
    for i in range(W):
        t = PRE + i
        want, plain = T.decode_step(tc, lm, plain, tt[:, t:t + 1], t)
        got, tbuf = T.decode_step_buffered(tc, lm, tcache, tbuf, tt[:, t:t + 1], PRE, i)
        _close(got, want.numpy(), **F32)
    merged = T.flush_buffer(tc, tcache, tbuf, PRE)
    for key in ("k", "v"):
        np.testing.assert_array_equal(merged[key][0].numpy(), plain[key][0].numpy())
        _close(merged[key], plain[key].numpy(), **F32)


def test_partial_softmax_of_an_empty_source_weighs_nothing():
    """base_len 0: the cache source has no valid row, its partial sits at
    the finite NEG_INF and the merge gives the buffer's attention alone,
    finite, equal to the reference's."""
    jc, tc = j_get_config("granite-3-2b-smoke"), get_config("granite-3-2b-smoke")
    (jq, jk, jv), (q, k, v) = _qkv(tc, 2, 1, 12, "float32", seed=21)
    kb, vb = k[:, :4], v[:, :4]
    got = A.decode_attend_buffered(tc, q, k, v, kb, vb, 0, 3)
    want = JA.decode_attend_buffered(jc, jq, jk, jv, jk[:, :4], jv[:, :4],
                                     jnp.asarray(0, jnp.int32), jnp.asarray(3, jnp.int32))
    assert torch.isfinite(got).all()
    _close(got, want, **F32)
    alone = A.decode_attend(tc, q, kb, vb, 3)
    _close(got, alone.numpy(), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """prefill + step-by-step decode logits == full forward logits (the
    property of tests/test_models.py:62, on the port, in bfloat16)."""
    _, tc, _, lm = _setup(arch, "bfloat16")
    model = build_model(tc, device="cpu")
    _, tokens = _tokens(tc, 2, 12, seed=2)
    with torch.no_grad():
        full = T.forward(tc, lm, tokens)[0].to(torch.float32)
    PRE, S = 6, 12
    logits, cache = model.prefill(lm, {"tokens": tokens[:, :PRE]})
    cache = pad_cache(cache, S)
    scale = float(full.abs().max()) + 1e-3
    np.testing.assert_allclose(logits.float().numpy(), full[:, PRE - 1].numpy(),
                               atol=0.05 * scale, rtol=0.05)
    for t in range(PRE, S):
        logits, cache = model.decode(lm, cache, {"tokens": tokens[:, t:t + 1], "index": t})
        np.testing.assert_allclose(logits.float().numpy(), full[:, t].numpy(),
                                   atol=0.05 * scale, rtol=0.05)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-2b-smoke", "gemma-2b-smoke"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_engine_greedy_tokens_equal_reference(arch, backend):
    jc, tc, params, lm = _setup(arch, "float32")
    jt, tt = _tokens(tc, 3, 10, seed=3)
    want, jstats = JEngine(j_build_model(jc, None), params,
                           JServeConfig(max_new_tokens=8)).generate({"tokens": jt})
    got, stats = Engine(build_model(tc, device="cpu", kernel_backend=backend), lm,
                        ServeConfig(max_new_tokens=8)).generate({"tokens": tt})
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == jstats


def test_engine_temperature_sampling_is_seeded():
    _, tc, _, lm = _setup("granite-3-2b-smoke", "float32")
    model = build_model(tc, device="cpu")
    _, tt = _tokens(tc, 2, 5)
    runs = [Engine(model, lm, ServeConfig(max_new_tokens=6, temperature=0.8, seed=s))
            .generate({"tokens": tt})[0] for s in (4, 4, 5)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert runs[0].min() >= 0 and runs[0].max() < tc.vocab_size


def test_greedy_sampling_breaks_bfloat16_ties_to_the_first_index():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0],
                           [1.0, 1.0001, 0.0, 1.0]], dtype=torch.bfloat16)
    engine = Engine(None, None, ServeConfig())
    got = engine._sample(logits, torch.Generator())
    want = jnp.argmax(jnp.asarray(logits.float().numpy(), jnp.bfloat16), axis=-1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [1, 0, 0]


def test_serve_launcher_runs_on_cpu(capsys):
    serve_launch.main(["--arch", "granite-3-2b-smoke", "--batch", "2", "--prompt-len", "7",
                       "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=granite-3-2b-smoke generated 2x3 tokens in ")
    assert out[0].endswith("tok/s on this backend)")
    rows = [eval(line) for line in out[1:]]
    assert len(rows) == 2 and all(len(r) == 3 for r in rows)
