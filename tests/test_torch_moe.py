"""The port's MoE family against the JAX package, on the CPU.

Same inputs from numpy seeds through ``repro.models.moe`` /
``repro.models.transformer`` and their ports; the JAX params are carried
across with ``params_from_numpy``. Tolerances, as in
``tests/test_torch_models.py``:

* float32 compute: atol 1e-5 x max|reference|, rtol 1e-5 (routing picks
  the same experts on both sides);
* bfloat16 compute (the configs' type): the teacher-forcing tolerance,
  atol 0.05 x max|reference|, rtol 0.05.

Top-k ties go to the lower expert index in both packages.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.registry import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.model_zoo import pad_cache as j_pad_cache
from repro.parallel import single_device_context
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model, pad_cache, params_from_numpy
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.parallel import single_device_context as t_single_device_context
from repro_torch.serve.engine import Engine, ServeConfig

F32 = dict(scale=1e-5, rtol=1e-5)
BF16 = dict(scale=0.05, rtol=0.05)
MOE_ARCH = "granite-moe-1b-a400m-smoke"


def _close(got, want, scale, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, atol=scale * (np.abs(want).max() + 1e-3),
                               rtol=rtol)


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


def _cfgs(E=8, k=2, d=32, f=16, dtype="float32"):
    kw = dict(name="t", family="moe", num_layers=2, d_model=d, num_heads=4,
              num_kv_heads=2, d_ff=f, vocab_size=64, dtype=dtype)
    return (JModelConfig(moe=JMoEConfig(num_experts=E, top_k=k, d_ff=f), **kw),
            ModelConfig(moe=MoEConfig(num_experts=E, top_k=k, d_ff=f), **kw))


def _moe_params(jc, tc, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jc)
    tp = M.init_moe(None, tc)
    with torch.no_grad():
        for k, v in jp.items():
            getattr(tp, k).copy_(torch.tensor(np.asarray(v)))
    return jp, tp


def _x(shape, dtype, seed=1):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


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


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "arctic-480b"])
def test_moe_configs_resolve_and_build(arch):
    tc, jc = get_config(arch), j_get_config(arch)
    assert tc.family == "moe" and dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    assert build_model(get_config(arch + "-smoke"), device="cpu").cfg.moe is not None


@pytest.mark.parametrize("arch,extra", [(MOE_ARCH, set()),
                                        ("arctic-480b-smoke", {"gate", "up", "down"})])
def test_moe_params_from_numpy_keys(arch, extra):
    """The MoE keys (``layers.N.moe.*``, arctic's ``layers.N.dense_mlp.*``)
    load from the reference's stacked tree with their shapes and values."""
    _, tc, params, lm = _setup(arch)
    names = dict(lm.named_parameters())
    m = tc.moe
    for i in range(tc.num_layers):
        assert names[f"layers.{i}.moe.router"].shape == (tc.d_model, m.num_experts)
        for k, shape in (("w_gate", (m.num_experts, tc.d_model, m.d_ff)),
                         ("w_up", (m.num_experts, tc.d_model, m.d_ff)),
                         ("w_down", (m.num_experts, m.d_ff, tc.d_model))):
            assert names[f"layers.{i}.moe.{k}"].shape == shape
            np.testing.assert_array_equal(names[f"layers.{i}.moe.{k}"].detach().numpy(),
                                          np.asarray(params["layers"]["moe"][k][i]))
        assert {k.split(".")[-1] for k in names
                if k.startswith(f"layers.{i}.dense_mlp.")} == extra
        assert not any(k.startswith(f"layers.{i}.mlp.") for k in names)
    assert sum(p.numel() for p in lm.parameters()) == tc.param_count() == \
        sum(x.size for x in jax.tree.leaves(params))
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "moe"})
    with pytest.raises(KeyError, match="layers.0.moe.router"):
        params_from_numpy(tc, bad, "cpu")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k", [(8, 2), (4, 1), (8, 8), (32, 8)])
def test_route_matches(E, k):
    jc, tc = _cfgs(E=E, k=k)
    jp, tp = _moe_params(jc, tc)
    jx, tx = _x((2, 16, tc.d_model), "float32")
    jw, ji, jaux = JM.route(jc, jp, jx)
    tw, ti, taux = M.route(tc, tp, tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, **F32)
    np.testing.assert_allclose(tw.detach().sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    assert tw.dtype == torch.float32 and float(taux.detach()) >= 0.0


def test_route_exact_ties_go_to_the_lower_expert():
    """Zero inputs give equal logits for all experts, and a router with
    duplicated columns gives exact ties between its experts: both packages
    pick the lower index first, with equal renormalised weights."""
    jc, tc = _cfgs(E=8, k=3)
    jp, tp = _moe_params(jc, tc)
    jz, tz = _x((1, 2, tc.d_model), "float32")
    jw, ji, _ = JM.route(jc, jp, jz * 0)
    tw, ti, _ = M.route(tc, tp, tz * 0)
    assert ti.tolist() == np.asarray(ji).tolist() == [[[0, 1, 2], [0, 1, 2]]]
    np.testing.assert_array_equal(tw.detach().numpy(), np.asarray(jw))
    np.testing.assert_allclose(tw.detach().numpy(), 1 / 3, rtol=1e-6)
    router = np.random.default_rng(3).standard_normal((tc.d_model, 8)).astype(np.float32)
    router[:, [2, 5, 6]] = router[:, [1, 1, 1]] * 4.0     # 1 < 2 = 5 = 6 in size
    jp = dict(jp, router=jnp.asarray(router))
    with torch.no_grad():
        tp.router.copy_(torch.from_numpy(router))
    jx, tx = _x((2, 5, tc.d_model), "float32", seed=4)
    jw, ji, _ = JM.route(jc, jp, jx)
    tw, ti, _ = M.route(tc, tp, tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ties = np.asarray(jw)[..., 1:] == np.asarray(jw)[..., :-1]
    assert ties.any()
    _close(tw, jw, **F32)


def test_route_gradients_match():
    """density (from the one-hot of the chosen experts) carries no gradient,
    mean_prob does: the router's and the input's gradients of aux plus a
    weighted sum of the routing weights equal jax.grad's."""
    jc, tc = _cfgs(E=8, k=2)
    jp, tp = _moe_params(jc, tc)
    jx, tx = _x((2, 6, tc.d_model), "float32")
    c = np.random.default_rng(5).standard_normal((2, 6, 2)).astype(np.float32)

    def jf(router, x):
        w, _, aux = JM.route(jc, dict(jp, router=router), x)
        return aux + jnp.sum(w * c)

    jg_r, jg_x = jax.grad(jf, argnums=(0, 1))(jp["router"], jx)
    tx.requires_grad_(True)
    w, _, aux = M.route(tc, tp, tx)
    g_r, g_x = torch.autograd.grad(aux + (w * torch.from_numpy(c)).sum(), (tp.router, tx))
    _close(g_r, jg_r, **F32)
    _close(g_x, jg_x, **F32)
    ga = torch.autograd.grad(M.route(tc, tp, tx)[2], tp.router)[0]
    jga = jax.grad(lambda r: JM.route(jc, dict(jp, router=r), jx)[2])(jp["router"])
    assert float(ga.abs().max()) > 0
    _close(ga, jga, **F32)


# ---------------------------------------------------------------------------
# the dense combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k,activation", [(8, 2, "swiglu"), (4, 4, "swiglu"),
                                            (8, 2, "gelu")])
def test_moe_dense_matches(dtype, E, k, activation):
    jc, tc = _cfgs(E=E, k=k, dtype=dtype)
    jc, tc = (dataclasses.replace(c, activation=activation) for c in (jc, tc))
    jp, tp = _moe_params(jc, tc)
    jx, tx = _x((2, 16, tc.d_model), dtype)
    jy, jaux = JM.moe_dense(jc, jp, jx)
    ty, taux = M.moe_dense(tc, tp, tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    _close(ty, jy, **_tol(dtype))
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-5 if dtype == "float32" else 0.05)


def test_moe_apply_raises_for_expert_parallel_context():
    """A context with ``use_ep`` takes moe_sharded (no longer refused: 4
    tokens fill no expert's capacity of 8, so it equals the dense path
    within F32); none, or ``use_ep`` off, takes moe_dense exactly."""
    jc, tc = _cfgs()
    _, tp = _moe_params(jc, tc)
    _, tx = _x((1, 4, tc.d_model), "float32")
    with M.dispatch_record() as rec:
        y, aux = M.moe_apply(tc, tp, tx, parallel=t_single_device_context("cpu"))
    assert len(rec) == 1 and int(rec[0]["dropped"]) == 0
    want, want_aux = M.moe_dense(tc, tp, tx)
    _close(y, want.detach(), **F32)
    _close(aux, want_aux.detach(), **F32)
    for parallel in (None, SimpleNamespace(use_ep=False)):
        y, aux = M.moe_apply(tc, tp, tx, parallel=parallel)
        want, want_aux = M.moe_dense(tc, tp, tx)
        assert torch.equal(y, want) and torch.equal(aux, want_aux)
    # the reference takes its sharded path for such a context
    assert single_device_context().use_ep


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [MOE_ARCH, "arctic-480b-smoke"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_matches(arch, dtype):
    """Logits and the aux loss summed over layers, both attention backends;
    arctic runs its dense residual beside the experts."""
    jc, tc, params, lm = _setup(arch, dtype)
    jt, tt = _tokens(tc, 2, 12)
    want, jaux = JT.forward(jc, None, params, jt)
    assert float(jaux) > 0
    with torch.no_grad():
        for backend in ("cuda", "torch"):
            logits, aux = T.forward(tc, lm, tt, backend=backend)
            _close(logits, want, **_tol(dtype))
            np.testing.assert_allclose(float(aux), float(jaux),
                                       rtol=1e-5 if dtype == "float32" else 0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_and_decode_match(dtype):
    jc, tc, params, lm = _setup(MOE_ARCH, dtype)
    jt, tt = _tokens(tc, 2, 9, seed=1)
    PRE = 6
    jl, jcache = JT.prefill(jc, None, params, jt[:, :PRE])
    tl, tcache = T.prefill(tc, lm, tt[:, :PRE])
    tol = _tol(dtype)
    _close(tl, jl, **tol)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], **tol)
    jcache, tcache = j_pad_cache(jcache, 9), pad_cache(tcache, 9)
    for t in range(PRE, 9):
        jl, jcache = JT.decode_step(jc, None, params, jcache, jt[:, t:t + 1],
                                    jnp.asarray(t, jnp.int32))
        tl, tcache = T.decode_step(tc, lm, tcache, tt[:, t:t + 1], t)
        assert not tl.requires_grad
        _close(tl, jl, **tol)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_moe_engine_greedy_tokens_equal_reference(backend):
    jc, tc, params, lm = _setup(MOE_ARCH, "float32")
    jt, tt = _tokens(tc, 3, 10, seed=3)
    want, jstats = JEngine(j_build_model(jc, None), params,
                           JServeConfig(max_new_tokens=8)).generate({"tokens": jt})
    got, stats = Engine(build_model(tc, device="cpu", kernel_backend=backend), lm,
                        ServeConfig(max_new_tokens=8)).generate({"tokens": tt})
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == jstats
