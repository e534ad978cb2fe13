"""The port's hybrid (zamba2: Mamba2 + a shared attention block) and ssm
(xLSTM) families against the JAX package, on the CPU.

Same inputs from numpy seeds through ``repro.models.mamba2`` / ``zamba``
/ ``xlstm`` and their ports; the JAX params (``Model.init``) are carried
across with ``params_from_numpy``. Tolerances:

* float32 compute: atol 1e-5 x max|reference|, rtol 1e-5, as the dense
  family is held (``tests/test_torch_models.py``); the SSD's cumulative
  sums and the chunked mLSTM's differ from JAX's in the order of their
  float32 sums (``torch.cumsum`` accumulates in double on the CPU), so
  the SSD and the chunked mLSTM against their sequential forms are held
  at the reference's own bounds (``tests/test_mamba_xlstm.py``: 2e-4 and
  1e-4);
* bfloat16 compute (the configs' type): the teacher-forcing tolerance,
  atol 0.05 x max|reference|, rtol 0.05;
* integer outputs (greedy tokens) exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import mamba2 as JM2
from repro.models import xlstm as JX
from repro.models import zamba as JZ
from repro.models.model_zoo import pad_cache as j_pad_cache
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model, pad_cache, params_from_numpy
from repro_torch.models import mamba2 as M2
from repro_torch.models import xlstm as X
from repro_torch.models import zamba as Z
from repro_torch.serve.engine import Engine, ServeConfig

F32 = dict(scale=1e-5, rtol=1e-5)
BF16 = dict(scale=0.05, rtol=0.05)
HYBRID, SSM = "zamba2-2.7b-smoke", "xlstm-350m-smoke"
ARCHS = (HYBRID, SSM)


def _close(got, want, scale, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, atol=scale * (np.abs(want).max() + 1e-3),
                               rtol=rtol)


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


def _cfgs(arch, dtype="float32", **xlstm):
    jc = dataclasses.replace(j_get_config(arch), dtype=dtype)
    tc = dataclasses.replace(get_config(arch), dtype=dtype)
    if xlstm:
        jc = dataclasses.replace(jc, xlstm=dataclasses.replace(jc.xlstm, **xlstm))
        tc = dataclasses.replace(tc, xlstm=dataclasses.replace(tc.xlstm, **xlstm))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jfns(jc):
    """The reference's entry points for ``jc``, jitted once a config."""
    m = j_build_model(jc, None)
    fwd = JZ.zamba_forward if jc.ssm is not None else JX.xlstm_forward
    return dict(init=jax.jit(m.init), prefill=jax.jit(m.prefill), decode=jax.jit(m.decode),
                forward=jax.jit(lambda p, t: fwd(jc, None, p, t)[0]),
                loss=jax.jit(jax.value_and_grad(m.loss, has_aux=True)))


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32", seed=1, fast=False):
    jc, tc = _cfgs(arch, dtype, **({"parallel_mlstm": True} if fast else {}))
    params = _jfns(jc)["init"](jax.random.PRNGKey(seed))
    module = params_from_numpy(tc, jax.tree.map(np.asarray, params), "cpu")
    return jc, tc, params, module


def _tokens(cfg, B, S, seed=0):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jnp.asarray(tok), torch.from_numpy(tok)


def _x(shape, dtype="float32", seed=0, scale=1.0):
    a = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _jtree(tree):
    """A port state / cache (nested dicts of tensors) as JAX arrays."""
    return {k: _jtree(v) if isinstance(v, dict) else
            jnp.asarray(v.detach().float().numpy()).astype(
                jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
            for k, v in tree.items()}


def _tree_close(got, want, tol, path=""):
    assert got.keys() == want.keys(), (path, got.keys(), want.keys())
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], tol, f"{path}{k}.")
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), f"{path}{k}"
            _close(got[k], want[k], **tol)


def _block(jinit, tinit, jc, tc, seed=0):
    """A block's params from JAX's ``jinit`` and the port's module
    (``tinit(cfg)``) holding a copy of them."""
    jp = jinit(jax.random.PRNGKey(seed), jc)
    tp = tinit(tc)
    with torch.no_grad():
        for k, v in jp.items():
            getattr(tp, k).copy_(torch.tensor(np.asarray(v)))
    return jp, tp


# ---------------------------------------------------------------------------
# Mamba2: the SSD core and the mixer
# ---------------------------------------------------------------------------

def _naive_ssd(x, dt, A, B_, C_, h=None):
    """The SSM recurrence token by token (numpy, float32): the oracle of
    ``tests/test_mamba_xlstm.py``, from an optional initial state."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    h = np.zeros((Bb, H, P, N), np.float32) if h is None else h.copy()
    ys = np.zeros((Bb, S, H, P), np.float32)
    for t in range(S):
        Bh = np.repeat(B_[:, t], rep, axis=1)
        Ch = np.repeat(C_[:, t], rep, axis=1)
        dec = np.exp(dt[:, t] * A)
        xin = x[:, t] * dt[:, t][..., None]
        h = dec[..., None, None] * h + np.einsum("bhp,bhn->bhpn", xin, Bh)
        ys[:, t] = np.einsum("bhpn,bhn->bhp", h, Ch)
    return ys, h


def _ssd_inputs(cfg, S, seed=0, G=None):
    s = cfg.ssm
    H, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    G = G or s.n_groups
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((2, S, H)))) * 0.5).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    B_ = (rng.standard_normal((2, S, G, N)) * 0.5).astype(np.float32)
    C_ = (rng.standard_normal((2, S, G, N)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((2, H, P, N)) * 0.1).astype(np.float32)
    return x, dt, A, B_, C_, h0


def test_softplus_and_segsum_match_jax():
    """dt's softplus is jax.nn.softplus (logaddexp(x, 0)) on both sides of
    F.softplus's threshold of 20; _segsum keeps -inf above the diagonal."""
    x = np.array([-40.0, -5.0, -0.5, 0.0, 0.7, 19.5, 20.0, 20.5, 35.0], np.float32)
    np.testing.assert_allclose(M2._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6)
    a = -np.abs(np.random.default_rng(1).standard_normal((2, 3, 16))).astype(np.float32)
    got, want = M2._segsum(torch.from_numpy(a)).numpy(), np.asarray(JM2._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[..., 0, 1]).all() and (got[..., 1, 0] <= 0).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,G,init", [(32, 1, False), (32, 1, True), (8, 1, False),
                                      (48, 2, True)])
def test_ssd_matches_naive_recurrence_and_reference(S, G, init):
    """The chunked SSD (chunk 16; S 8 is one short chunk; two groups) against
    the token-by-token recurrence and JAX's ssd, from zeros or a state."""
    cfg = get_config(HYBRID)
    jc = j_get_config(HYBRID)
    x, dt, A, B_, C_, h0 = _ssd_inputs(cfg, S, seed=S + G, G=G)
    h0 = h0 if init else None
    y, h = M2.ssd(cfg, *map(torch.from_numpy, (x, dt, A, B_, C_)),
                  None if h0 is None else torch.from_numpy(h0))
    y_ref, h_ref = _naive_ssd(x, dt, A, B_, C_, h0)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=2e-4, atol=2e-4)
    jy, jh = JM2.ssd(jc, *map(jnp.asarray, (x, dt, A, B_, C_)),
                     None if h0 is None else jnp.asarray(h0))
    _close(y, jy, **F32)
    _close(h, jh, **F32)


def test_ssd_split_state_equals_full():
    cfg = get_config(HYBRID)
    x, dt, A, B_, C_, _ = map(torch.from_numpy, _ssd_inputs(cfg, 64, seed=3))
    y, h = M2.ssd(cfg, x, dt, A, B_, C_)
    y1, h1 = M2.ssd(cfg, x[:, :32], dt[:, :32], A, B_[:, :32], C_[:, :32])
    y2, h2 = M2.ssd(cfg, x[:, 32:], dt[:, 32:], A, B_[:, 32:], C_[:, 32:], h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba2_matches(dtype):
    """The mixer from zeros (S 32), continued from that state (S 16) and one
    single step: outputs and both states (ssm float32, conv in the compute
    type) against JAX's."""
    jc, tc = _cfgs(HYBRID, dtype)
    jp, tp = _block(JM2.init_mamba2, M2.Mamba2, jc, tc, seed=2)
    jx, tx = _x((2, 49, tc.d_model), dtype, seed=4)
    tol = _tol(dtype)
    with torch.no_grad():
        japply = jax.jit(JM2.apply_mamba2, static_argnums=0, static_argnames="single_step")
        y, st = M2.apply_mamba2(tc, tp, tx[:, :32])
        jy, jst = japply(jc, jp, jx[:, :32])
        _close(y, jy, **tol)
        _tree_close(st, jst, tol)
        assert st["ssm"].dtype == torch.float32 and st["conv"].dtype == tx.dtype
        y, st = M2.apply_mamba2(tc, tp, tx[:, 32:48], st)
        jy, jst = japply(jc, jp, jx[:, 32:48], jst)
        _close(y, jy, **tol)
        _tree_close(st, jst, tol)
        y, st = M2.apply_mamba2(tc, tp, tx[:, 48:], st, single_step=True)
        jy, jst = japply(jc, jp, jx[:, 48:], jst, single_step=True)
        _close(y, jy, **tol)
        _tree_close(st, jst, tol)


def test_mamba2_state_passing_and_single_steps_equal_full():
    """Port only, float32: two halves with the state carried, and the second
    half token by token through ``single_step``, equal one full pass."""
    jc, tc = _cfgs(HYBRID)
    _, tp = _block(JM2.init_mamba2, M2.Mamba2, jc, tc, seed=0)
    _, tx = _x((2, 32, tc.d_model), seed=1)
    with torch.no_grad():
        y, st = M2.apply_mamba2(tc, tp, tx)
        y1, st1 = M2.apply_mamba2(tc, tp, tx[:, :16], M2.init_mamba_state(tc, 2))
        y2, st2 = M2.apply_mamba2(tc, tp, tx[:, 16:], st1)
        steps, s = [], st1
        for t in range(16, 32):
            o, s = M2.apply_mamba2(tc, tp, tx[:, t:t + 1], s, single_step=True)
            steps.append(o)
    for got in (torch.cat([y1, y2], 1), torch.cat([y1] + steps, 1)):
        np.testing.assert_allclose(got.numpy(), y.numpy(), rtol=5e-4, atol=5e-4)
    for got in (st2, s):
        np.testing.assert_allclose(got["ssm"].numpy(), st["ssm"].numpy(), rtol=5e-4, atol=5e-4)
        np.testing.assert_array_equal(got["conv"].numpy(), st["conv"].numpy())


# ---------------------------------------------------------------------------
# xLSTM cells and blocks
# ---------------------------------------------------------------------------

def test_cells_match():
    """One mLSTM and one sLSTM step from a carried state (and mLSTM's first
    step from m = -1e9, where m_new is log_i) against JAX's."""
    rng = np.random.default_rng(5)
    B, H, D = 2, 3, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, li, lf = f(B, H, D), f(B, H, D), f(B, H, D), f(B, H), -np.abs(f(B, H))
    for C, n, m in ((f(B, H, D, D), f(B, H, D), f(B, H)),
                    (np.zeros((B, H, D, D), np.float32), np.zeros((B, H, D), np.float32),
                     np.full((B, H), -1e9, np.float32))):
        h, st = X.mlstm_cell(*map(torch.from_numpy, (q, k, v, li, lf)),
                             tuple(map(torch.from_numpy, (C, n, m))))
        jh, jst = JX.mlstm_cell(*map(jnp.asarray, (q, k, v, li, lf)),
                                tuple(map(jnp.asarray, (C, n, m))))
        for got, want in zip((h,) + st, (jh,) + jst):
            _close(got, want, **F32)
    gx, r = f(B, 4, H, D), (f(4, H, D, D) / np.sqrt(D)).astype(np.float32)
    state = (f(B, H, D), np.abs(f(B, H, D)), f(B, H, D), f(B, H, D))
    h, st = X.slstm_cell(torch.from_numpy(gx), torch.from_numpy(r),
                         tuple(map(torch.from_numpy, state)))
    jh, jst = JX.slstm_cell(jnp.asarray(gx), jnp.asarray(r), tuple(map(jnp.asarray, state)))
    for got, want in zip((h,) + st, (jh,) + jst):
        _close(got, want, **F32)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_match_with_state_passing(block, dtype):
    """apply_mlstm / apply_slstm from the initial state (S 12), then
    continued from it (S 12): outputs and states against JAX's."""
    jc, tc = _cfgs(SSM, dtype)
    jinit, tinit = ((JX.init_mlstm, X.MLSTM) if block == "mlstm" else
                    (JX.init_slstm, X.SLSTM))
    jp, tp = _block(jinit, tinit, jc, tc, seed=3)
    japply, tapply = ((JX.apply_mlstm, X.apply_mlstm) if block == "mlstm" else
                      (JX.apply_slstm, X.apply_slstm))
    jx, tx = _x((2, 24, tc.d_model), dtype, seed=6)
    tol = _tol(dtype)
    with torch.no_grad():
        y1, st = tapply(tc, tp, tx[:, :12])
        jy1, jst = japply(jc, jp, jx[:, :12])
        _close(y1, jy1, **tol)
        _tree_close(st, jst, F32)
        y2, st = tapply(tc, tp, tx[:, 12:], st)
        jy2, jst = japply(jc, jp, jx[:, 12:], jst)
        _close(y2, jy2, **tol)
        _tree_close(st, jst, F32 if dtype == "float32" else BF16)
        assert all(t.dtype == torch.float32 for t in st.values())


@pytest.mark.parametrize("chunk", [8, 16])
def test_mlstm_chunked_equals_sequential(chunk):
    """The chunked-parallel mLSTM equals the sequential cell (outputs, C, n
    and m; with a carried state too) within the reference's 1e-4, and JAX's
    chunked form within float32."""
    jc, tc = _cfgs(SSM, chunk=chunk, parallel_mlstm=True)
    jp, tp = _block(JX.init_mlstm, X.MLSTM, jc, tc, seed=0)
    jx, tx = _x((2, 32, tc.d_model), seed=1)
    with torch.no_grad():
        seq_cfg = dataclasses.replace(tc, xlstm=dataclasses.replace(tc.xlstm,
                                                                    parallel_mlstm=False))
        y_seq, st_seq = X.apply_mlstm(seq_cfg, tp, tx)
        y_chk, st_chk = X.apply_mlstm(tc, tp, tx)
        y1, st1 = X.apply_mlstm(tc, tp, tx[:, :16])
        y2, st2 = X.apply_mlstm(tc, tp, tx[:, 16:], st1)
    for got in (y_chk, torch.cat([y1, y2], 1)):
        np.testing.assert_allclose(got.numpy(), y_seq.numpy(), rtol=1e-4, atol=1e-4)
    for st in (st_chk, st2):
        for key in ("C", "n", "m"):
            np.testing.assert_allclose(st[key].numpy(), st_seq[key].numpy(), rtol=1e-4,
                                       atol=1e-4)
    jy, jst = JX.apply_mlstm_chunked(jc, jp, jx)
    _close(y_chk, jy, **F32)
    _tree_close(st_chk, jst, F32)


def test_mlstm_long_sequence_stable():
    """Exponential gating does not overflow over 512 tokens of large
    inputs (tests/test_mamba_xlstm.py's case)."""
    jc, tc = _cfgs(SSM)
    _, tp = _block(JX.init_mlstm, X.MLSTM, jc, tc, seed=0)
    _, tx = _x((1, 512, tc.d_model), seed=1, scale=5.0)
    with torch.no_grad():
        y, st = X.apply_mlstm(tc, tp, tx)
    assert torch.isfinite(y).all() and torch.isfinite(st["C"]).all()


# ---------------------------------------------------------------------------
# the assemblies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_keys_and_shapes(arch):
    """Every key of the reference's tree, stacks split per layer (zamba's
    ``mamba_layers``, xLSTM's ``pairs``), with its shape and values; a
    missing key, a wrong shape and a wrong stack count raise."""
    jc, tc, params, module = _setup(arch)
    names = dict(module.named_parameters())
    tree = jax.tree.map(np.asarray, params)
    stack, n = ("mamba_layers", tc.num_layers) if arch == HYBRID else ("pairs", tc.num_layers // 2)
    assert sum(p.numel() for p in module.parameters()) == \
        sum(x.size for x in jax.tree.leaves(params))
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] == stack:
            for i in range(n):
                got = names[".".join([stack, str(i)] + keys[1:])]
                np.testing.assert_array_equal(got.detach().numpy(), leaf[i])
        else:
            np.testing.assert_array_equal(names[".".join(keys)].detach().numpy(), leaf)
    if arch == HYBRID:
        assert "shared_attn.attn.wq" in names and "mamba_layers.3.mixer.dt_bias" in names
    else:
        assert names["pairs.0.slstm.r"].shape == (4, tc.num_heads, tc.d_model // tc.num_heads,
                                                  tc.d_model // tc.num_heads)
    bad = dict(tree, final_norm={})
    with pytest.raises(KeyError, match="final_norm"):
        params_from_numpy(tc, bad, "cpu")
    bad = dict(tree, embed=dict(tree["embed"], embedding=np.ones((3, 3), np.float32)))
    with pytest.raises(ValueError, match="embed.embedding"):
        params_from_numpy(tc, bad, "cpu")
    bad = dict(tree, **{stack: jax.tree.map(lambda a: np.concatenate([a, a]), tree[stack])})
    with pytest.raises(ValueError, match=f"{2 * n} stacked, config has {n}"):
        params_from_numpy(tc, bad, "cpu")


@pytest.mark.parametrize("arch,fast", [(HYBRID, False), (SSM, False), (SSM, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches(arch, fast, dtype):
    """Full-sequence logits (S 32: two SSD / mLSTM chunks) against JAX's, both
    attention backends; xLSTM also with the chunked mLSTM (``-fast``)."""
    jc, tc, params, module = _setup(arch, dtype, fast=fast)
    jt, tt = _tokens(tc, 2, 32)
    want = _jfns(jc)["forward"](params, jt)
    with torch.no_grad():
        runs = ([Z.zamba_forward(tc, module, tt, backend=b) for b in ("cuda", "torch")]
                if arch == HYBRID else [X.xlstm_forward(tc, module, tt)])
    for logits, aux, _ in runs:
        assert float(aux) == 0.0
        _close(logits, want, **_tol(dtype))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match(arch, dtype):
    """Model.prefill's last logits and cache (zamba: the Mamba2 states and
    the groups' K/V; xLSTM: every pair's states), then 3 decode steps'
    logits and caches, against JAX's Model on the same tokens."""
    jc, tc, params, module = _setup(arch, dtype)
    jm, tm = _jfns(jc), build_model(tc, device="cpu")
    jt, tt = _tokens(tc, 2, 19, seed=1)
    PRE = 16
    jl, jcache = jm["prefill"](params, {"tokens": jt[:, :PRE]})
    tl, tcache = tm.prefill(module, {"tokens": tt[:, :PRE]})
    tol = _tol(dtype)
    _close(tl, jl, **tol)
    _tree_close(tcache, jcache, tol)
    jcache, tcache = j_pad_cache(jcache, 19), pad_cache(tcache, 19)
    for t in range(PRE, 19):
        jl, jcache = jm["decode"](params, jcache, {"tokens": jt[:, t:t + 1],
                                                   "index": jnp.asarray(t, jnp.int32)})
        tl, tcache = tm.decode(module, tcache, {"tokens": tt[:, t:t + 1], "index": t})
        assert not tl.requires_grad
        _close(tl, jl, **tol)
        _tree_close(tcache, jcache, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Port only, bfloat16: prefill + step-by-step decode logits == the
    full forward's (the property of tests/test_models.py:62)."""
    _, tc, _, module = _setup(arch, "bfloat16")
    model = build_model(tc, device="cpu")
    _, tokens = _tokens(tc, 2, 16, seed=2)
    with torch.no_grad():
        full = (Z.zamba_forward(tc, module, tokens)[0] if arch == HYBRID else
                X.xlstm_forward(tc, module, tokens)[0]).float()
    PRE, S = 12, 16
    logits, cache = model.prefill(module, {"tokens": tokens[:, :PRE]})
    cache = pad_cache(cache, S)
    scale = float(full.abs().max()) + 1e-3
    np.testing.assert_allclose(logits.float().numpy(), full[:, PRE - 1].numpy(),
                               atol=0.05 * scale, rtol=0.05)
    for t in range(PRE, S):
        logits, cache = model.decode(module, cache, {"tokens": tokens[:, t:t + 1], "index": t})
        np.testing.assert_allclose(logits.float().numpy(), full[:, t].numpy(),
                                   atol=0.05 * scale, rtol=0.05)


def test_caches_and_pad_cache_match_reference_shapes():
    """Model.init_cache's trees equal the reference's in keys, shapes and
    types; pad_cache grows zamba's attn_k / attn_v only, passing the Mamba2
    states and xLSTM's state through."""
    for arch in ARCHS:
        jc, tc, _, _ = _setup(arch)
        want = j_build_model(jc, None).init_cache(2, 12)
        got = build_model(tc, device="cpu").init_cache(2, 12)
        flat = lambda t: {"/".join(p.key for p in path): (tuple(x.shape), str(x.dtype))
                          for path, x in jax.tree_util.tree_flatten_with_path(t)[0]}
        assert flat(_jtree(got)) == flat(want)
        if arch == SSM:
            assert float(got["mlstm"]["m"].max()) == float(got["slstm"]["m"].max()) == -1e9
    _, tc, _, module = _setup(HYBRID)
    _, tt = _tokens(tc, 2, 16)
    _, cache = build_model(tc, device="cpu").prefill(module, {"tokens": tt})
    grown = pad_cache(cache, 20)
    assert grown["attn_k"].shape == (2, 2, 20, tc.num_kv_heads, tc.head_dim)
    assert torch.equal(grown["attn_v"][:, :, :16], cache["attn_v"])
    assert not grown["attn_v"][:, :, 16:].any()
    assert all(grown["mamba"][k] is cache["mamba"][k] for k in ("ssm", "conv"))


def test_routing_hybrid_prefill_launches_a_kernel_per_group(monkeypatch):
    """zamba's prefill sends each group's shared attention (causal, Sq ==
    Sk) to the flash-attention wrapper; decode, the loss and xLSTM never
    reach it."""
    calls = []
    real = flash_ops.attention
    monkeypatch.setattr(flash_ops, "attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    for arch in ARCHS:
        _, tc, _, module = _setup(arch)
        model = build_model(tc, device="cpu")
        _, tt = _tokens(tc, 2, 16)
        calls.clear()
        _, cache = model.prefill(module, {"tokens": tt})
        assert len(calls) == (Z.n_groups(tc) if arch == HYBRID else 0)
        model.decode(module, pad_cache(cache, 17), {"tokens": tt[:, :1], "index": 16})
        model.loss(module, {"tokens": tt, "labels": tt})
        assert len(calls) == (Z.n_groups(tc) if arch == HYBRID else 0)


@pytest.mark.parametrize("arch,fast", [(HYBRID, False), (SSM, False), (SSM, True)])
def test_loss_and_gradients_match(arch, fast):
    """Model.loss (forward, float32 log-softmax, mean xent) and the gradient
    of every parameter against jax.value_and_grad of the reference's."""
    jc, tc, params, module = _setup(arch, fast=fast)
    jt, tt = _tokens(tc, 2, 32, seed=3)
    jl, tl = _tokens(tc, 2, 32, seed=4)
    (jloss, jm), jgrads = _jfns(jc)["loss"](params, {"tokens": jt, "labels": jl})
    loss, m = build_model(tc, device="cpu").loss(module, {"tokens": tt, "labels": tl})
    names, leaves = zip(*module.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    for got, want in ((loss, jloss), (m["xent"], jm["xent"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(m["aux"]) == 0.0
    from repro_torch.models.model_zoo import per_layer_arrays
    want = per_layer_arrays(tc, jax.tree.map(np.asarray, jgrads))
    assert want.keys() == grads.keys()
    for name, g in grads.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * (np.abs(w).max() + 1e-6),
                                   rtol=1e-3, err_msg=name)
    assert all(float(g.abs().max()) > 0 for n, g in grads.items()), "a parameter got no gradient"


@functools.lru_cache(maxsize=None)
def _jax_generated(arch):
    jc, tc, params, _ = _setup(arch)
    jt, _ = _tokens(tc, 3, 16, seed=5)
    return JEngine(j_build_model(jc, None), params,
                   JServeConfig(max_new_tokens=6)).generate({"tokens": jt})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_engine_greedy_tokens_equal_reference(arch, backend):
    _, tc, _, module = _setup(arch)
    _, tt = _tokens(tc, 3, 16, seed=5)
    want, jstats = _jax_generated(arch)
    got, stats = Engine(build_model(tc, device="cpu", kernel_backend=backend), module,
                        ServeConfig(max_new_tokens=6)).generate({"tokens": tt})
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == jstats
