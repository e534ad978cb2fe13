"""The port's training path against the JAX package, on the CPU.

``repro_torch.optim.adamw``, ``data.pipeline``, ``train.steps``,
``train.trainer``, ``checkpoint.checkpointer`` and ``launch.train`` against
their JAX originals on the same state, carried across with
``train_state_from_numpy``. Compute is float32 (the configs' bfloat16
compute is held by ``tests/test_torch_moe.py`` at the teacher-forcing
tolerance). Tolerances:

* the loss, its parts and one optimizer step: rtol 1e-5 (float32 sums in
  another order; ``global_norm`` sums per-layer leaves in parameter
  order, the reference its stacked leaves in sorted-key order);
* gradients: atol 1e-5 x max|reference| of the leaf, rtol 1e-4 (a
  backward sums in yet more orders);
* parameters after train steps: AdamW's first steps move an element by
  about lr x sign(g); where |g| is at rounding level the sign can differ,
  so atol is 2 x lr a step (rtol 1e-4), and at most 1 % of the elements
  may use more than 1e-6 of it;
* int8 moment codes: equal, except where JAX's scaled value lies within
  one float32 ulp of a half (the two round it on either side), and there
  by one code; such elements are counted and bounded.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.registry import get_config as j_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import build_model as j_build_model
from repro.models import transformer as JT
from repro.optim import adamw as JO
from repro.train import steps as JS
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model, pad_cache
from repro_torch.models.model_zoo import per_layer_arrays
from repro_torch.optim import adamw as O
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.train.steps import (abstract_train_state, build_decode_step,
                                     build_prefill_step, build_train_step, init_train_state,
                                     train_state_from_numpy)
from repro_torch.train.trainer import Trainer, TrainerConfig

MOE_ARCH = "granite-moe-1b-a400m-smoke"
DENSE_ARCH = "granite-3-2b-smoke"
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
B, S = 4, 16


def _cfgs(arch):
    return (dataclasses.replace(j_get_config(arch), dtype="float32"),
            dataclasses.replace(get_config(arch), dtype="float32"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stacked(cfg, named):
    """The port's ``{name: tensor}`` (per layer) as the reference's flat
    ``{dotted key: array}`` with the layer axis stacked."""
    out, layers = {}, {}
    for name, t in named.items():
        a = t.detach().numpy() if isinstance(t, torch.Tensor) else t
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            layers.setdefault(rest, {})[int(i)] = a
        else:
            out[name] = a
    for rest, per in layers.items():
        out[f"layers.{rest}"] = np.stack([per[i] for i in range(cfg.num_layers)])
    return out


def _jflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_jflat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _leaves_close(got, want, scale=1e-5, rtol=1e-5):
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(got[k], np.float32), w,
                                   atol=scale * (np.abs(w).max() + 1e-30), rtol=rtol,
                                   err_msg=k)


def _params_close(got, want, atol, rtol=1e-4, share=0.01):
    """Every element within atol + rtol |want|, and at most ``share`` of a
    leaf's elements more than 1e-6 x atol off."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = np.asarray(got[k], np.float32)
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=k)
        off = np.abs(g - w) > 1e-6 * atol + rtol * np.abs(w)
        assert off.mean() <= share, (k, off.mean())


def _batch(cfg, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        b["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@functools.lru_cache(maxsize=None)
def _jax_state(arch, optimizer="adamw", seed=0):
    jc, _ = _cfgs(arch)
    return _np(JS.init_train_state(j_build_model(jc, None), jax.random.PRNGKey(seed),
                                   optimizer=optimizer))


@functools.lru_cache(maxsize=None)
def _jax_step(arch, microbatches=1, optimizer="adamw"):
    jc, _ = _cfgs(arch)
    return jax.jit(JS.build_train_step(j_build_model(jc, None), JO.AdamWConfig(**OPT),
                                       microbatches=microbatches, optimizer=optimizer))


def _random_tree(tree, seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    draw = (lambda a: rng.random(a.shape)) if positive else \
        (lambda a: rng.standard_normal(a.shape))
    return jax.tree.map(lambda a: (draw(a) * scale).astype(np.float32), tree)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 10])
def test_schedule_matches(warmup):
    jcfg = JO.AdamWConfig(warmup_steps=warmup, total_steps=100)
    tcfg = O.AdamWConfig(warmup_steps=warmup, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = float(O.schedule(tcfg, torch.tensor(step, dtype=torch.int32)))
        want = float(JO.schedule(jcfg, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))
        assert O.schedule(tcfg, step).dtype == torch.float32


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clipping_match(max_norm):
    """The norm of a model-shaped tree (stacked in JAX, per layer in the
    port) and the clipped gradients, scaled or left alone."""
    jc, tc = _cfgs(MOE_ARCH)
    grads = _random_tree(_jax_state(MOE_ARCH)["params"], seed=1, scale=0.01)
    tgrads = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in per_layer_arrays(tc, grads).items()}
    want = float(JO.global_norm(grads))
    np.testing.assert_allclose(float(O.global_norm(tgrads)), want, rtol=1e-5)
    jclipped, jnorm = JO.clip_by_global_norm(grads, max_norm)
    clipped, norm = O.clip_by_global_norm(tgrads, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-5)
    _leaves_close(_stacked(tc, clipped), _jflat(jclipped))
    if max_norm > want:
        for k, v in _stacked(tc, clipped).items():
            np.testing.assert_array_equal(v, _jflat(grads)[k])


def _carried_state(arch, optimizer, seed=2, step=7):
    """A JAX train state with random moments at ``step`` (q8: encoded)."""
    st = _jax_state(arch)
    mu = _random_tree(st["params"], seed, scale=1e-3)
    nu = _random_tree(st["params"], seed + 1, scale=1e-5, positive=True)
    if optimizer == "adamw_q8":
        enc = lambda t: jax.tree.map(lambda a: dict(zip("qs", _np(JO._q8_encode(jnp.asarray(a))))), t)
        mu, nu = enc(mu), enc(nu)
    return {"params": st["params"], "opt": {"mu": mu, "nu": nu,
                                            "step": np.asarray(step, np.int32)}}


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_q8"])
@pytest.mark.parametrize("clip", [0.5, 1e3])
def test_adamw_update_matches(optimizer, clip):
    """One update from a carried state (random moments at step 7): params,
    moments, lr and grad_norm against JAX's."""
    jc, tc = _cfgs(MOE_ARCH)
    tree = _carried_state(MOE_ARCH, optimizer)
    grads = _random_tree(tree["params"], seed=9, scale=0.01)
    cfg = dict(lr=1e-3, warmup_steps=3, total_steps=20, clip_norm=clip)
    j_update = JO.adamw_update_q8 if optimizer == "adamw_q8" else JO.adamw_update
    t_update = O.adamw_update_q8 if optimizer == "adamw_q8" else O.adamw_update
    jp, jopt, jm = j_update(JO.AdamWConfig(**cfg), grads, tree["params"], tree["opt"])
    state = train_state_from_numpy(tc, tree, optimizer, "cpu")
    tgrads = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in per_layer_arrays(tc, grads).items()}
    tp, topt, tm = t_update(O.AdamWConfig(**cfg), tgrads, state["params"], state["opt"])
    assert tp is state["params"] and int(topt["step"]) == int(jopt["step"]) == 8
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    _params_close(_stacked(tc, dict(tp.named_parameters())), _jflat(_np(jp)),
                  atol=1e-6, rtol=1e-5, share=0.0)
    for moment in ("mu", "nu"):
        if optimizer == "adamw":
            _leaves_close(_stacked(tc, topt[moment]), _jflat(_np(jopt[moment])))
            continue
        got = _stacked(tc, {f"{n}.{k}": v for n, qs in topt[moment].items()
                            for k, v in qs.items()})
        want = _jflat(_np(jopt[moment]))
        for key in [k for k in want if k.endswith(".q")]:
            _codes_match(got[key], want[key], want[key[:-1] + "s"],
                         _jflat(_np(jopt[moment]))[key[:-1] + "s"], None)
            np.testing.assert_allclose(got[key[:-1] + "s"], want[key[:-1] + "s"], rtol=1e-5)


# ---------------------------------------------------------------------------
# int8 moments
# ---------------------------------------------------------------------------

def _near_half(x, scale):
    """Where x / scale (per block) lies within one float32 ulp of a half."""
    pad = (-x.shape[-1]) % O.Q_BLOCK
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    v = (xp.reshape(xp.shape[:-1] + (-1, O.Q_BLOCK)) / scale[..., None]).astype(np.float32)
    v = np.abs(v.reshape(xp.shape)[..., : x.shape[-1]])
    return np.abs(v - np.floor(v) - 0.5) <= np.spacing(v)


def _codes_match(got, want, scale_got, scale_want, x):
    """Codes equal but where the reference's value sits within an ulp of a
    half (when ``x`` is known), and there by one code; at most 0.1 % of
    the codes differ."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = got != want
    assert np.abs(got - want).max(initial=0) <= 1
    if x is not None:
        near = _near_half(x, np.asarray(scale_want))
        assert not (diff & ~near).any(), np.argwhere(diff & ~near)[:5]
    assert diff.mean() <= 1e-3, diff.mean()
    return int(diff.sum())


@pytest.mark.parametrize("shape", [(3, 300), (2, 4, 256), (1000,), (5, 128)])
def test_q8_encode_decode_match(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = (rng.standard_normal(shape) * np.exp(rng.uniform(-8, 2, shape))).astype(np.float32)
    x[..., :3] = 0.0
    jq, js = _np(JO._q8_encode(jnp.asarray(x)))
    tq, ts = O._q8_encode(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == shape and tq.is_contiguous()
    assert tuple(ts.shape) == js.shape and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6)
    _codes_match(tq.numpy(), jq, ts.numpy(), js, x)
    # decoding the reference's codes gives its values bit for bit
    want = np.asarray(JO._q8_decode(jnp.asarray(jq), jnp.asarray(js), shape))
    got = O._q8_decode(torch.tensor(jq), torch.tensor(js), shape)
    np.testing.assert_array_equal(got.numpy(), want)


def test_q8_rounds_half_to_even():
    """Values exactly at a half of the block scale: both round to even."""
    x = np.zeros(128, np.float32)
    x[0] = 127.0                                   # scale = 1 + 1e-12 -> 1.0
    x[1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    jq, _ = _np(JO._q8_encode(jnp.asarray(x)))
    tq, _ = O._q8_encode(torch.from_numpy(x))
    assert tq[:6].tolist() == jq[:6].tolist() == [127, 0, 2, 2, 0, -2]


def test_init_opt_states_are_zero_and_keyed_by_parameter():
    model = build_model(get_config(MOE_ARCH), device="cpu")
    params = model.init(0)
    names = [n for n, _ in params.named_parameters()]
    st, q8 = O.init_opt_state(params), O.init_opt_state_q8(params)
    for state in (st, q8):
        assert list(state["mu"]) == list(state["nu"]) == names
        assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
        assert state["mu"][names[0]] is not state["nu"][names[0]]
    assert all(float(t.abs().max()) == 0 for t in st["mu"].values())
    q = q8["mu"]["layers.0.moe.w_gate"]
    assert q["q"].dtype == torch.int8 and q["q"].shape == params.layers[0].moe.w_gate.shape
    assert q["s"].shape == (4, 64, 1)
    assert O.state_bytes(q8) < O.state_bytes(st) / 3


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [DENSE_ARCH, MOE_ARCH])
@pytest.mark.parametrize("mask", [False, True])
def test_lm_loss_and_gradients_match(arch, mask):
    """xent, aux and the loss, and the gradient of every parameter, against
    jax.value_and_grad of the reference's lm_loss."""
    jc, tc = _cfgs(arch)
    params = _jax_state(arch)["params"]
    jb, tb = _batch(tc, seed=3, mask=mask)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JT.lm_loss(jc, None, p, jb), has_aux=True)(params)
    model = build_model(tc, device="cpu")
    lm = train_state_from_numpy(tc, _carried_state(arch, "adamw"), "adamw", "cpu")["params"]
    loss, m = model.loss(lm, tb)
    names, leaves = zip(*lm.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    for got, want in ((loss, jloss), (m["xent"], jm["xent"]), (m["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    assert (float(m["aux"].detach()) > 0) == (arch == MOE_ARCH)
    _leaves_close(_stacked(tc, dict(zip(names, grads))), _jflat(_np(jgrads)),
                  scale=1e-5, rtol=1e-4)


def test_train_step_launches_no_hand_written_kernel(monkeypatch):
    """The train step takes the torch attention even through a model built
    with the "cuda" kernel backend; prefill still takes the kernel."""
    calls = []
    real = flash_ops.attention
    monkeypatch.setattr(flash_ops, "attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    jc, tc = _cfgs(MOE_ARCH)
    model = build_model(tc, device="cpu")
    assert model.kernel_backend == "cuda"
    state = init_train_state(model, 0)
    step = build_train_step(model, O.AdamWConfig(**OPT))
    _, tb = _batch(tc)
    state, metrics = step(state, tb)
    assert not calls and np.isfinite(float(metrics["loss"]))
    nxt, logits, cache = build_prefill_step(model)(state["params"], {"tokens": tb["tokens"]})
    assert len(calls) == tc.num_layers and nxt.dtype == torch.int32
    nxt2, _ = build_decode_step(model)(state["params"], pad_cache(cache, S + 1),
                                       {"tokens": nxt[:, None], "index": S})
    assert nxt2.shape == (B,) and len(calls) == tc.num_layers


@pytest.mark.parametrize("kernel", ["flash", "paged"])
def test_attention_kernels_refuse_inputs_that_require_grad(kernel):
    """The wrappers have no backward: under grad mode an input that
    requires grad raises before any dispatch (here on CPU tensors);
    under no_grad, or without grad, they run."""
    rng = np.random.default_rng(0)
    if kernel == "flash":
        args = [torch.from_numpy(rng.standard_normal((1, 8, 4, 16)).astype(np.float32))
                for _ in range(3)]
        fn = lambda *a: flash_attention(*a, causal=True)
    else:
        args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((2, 4, 16), (3, 4, 2, 16), (3, 4, 2, 16))]
        table = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32)
        lengths = torch.tensor([6, 3], dtype=torch.int32)
        fn = lambda *a: paged_attention(*a, table, lengths)
    want = fn(*args)
    for i in range(3):
        grad_args = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*grad_args)
        with torch.no_grad():
            torch.testing.assert_close(fn(*grad_args), want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _data(cfg):
    return (JSyntheticLM(JDataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)),
            SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)))


@pytest.mark.parametrize("arch,microbatches,optimizer", [
    (MOE_ARCH, 1, "adamw"), (MOE_ARCH, 2, "adamw"), (DENSE_ARCH, 2, "adamw"),
    (MOE_ARCH, 1, "adamw_q8")])
def test_train_step_matches(arch, microbatches, optimizer):
    """One and three steps from JAX's initial state on SyntheticLM batches:
    losses, xent, aux, grad norms and lr each step, then the params and
    moments after the first step and after the third.

    int8 moments are held for one step: after it, a code that rounds to
    the other side of a half can leave an nu of code 0 under an mu that is
    not, and the reference's update then moves that element by mu / eps,
    so the two runs part."""
    jc, tc = _cfgs(arch)
    j_step = _jax_step(arch, microbatches, optimizer)
    jstate = _jax_state(arch, optimizer)
    state = train_state_from_numpy(tc, jstate, optimizer, "cpu")
    step = build_train_step(build_model(tc, device="cpu"), O.AdamWConfig(**OPT),
                            microbatches=microbatches, optimizer=optimizer)
    jdata, data = _data(tc)
    steps = 1 if optimizer == "adamw_q8" else 3
    for i in range(steps):
        jstate, jm = j_step(jstate, jdata.batch(i))
        state, m = step(state, data.batch(i, "cpu"))
        for k in ("loss", "xent", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        if i in (0, 2):
            atol = 2 * OPT["lr"] * (i + 1)
            _params_close(_stacked(tc, dict(state["params"].named_parameters())),
                          _jflat(_np(jstate["params"])), atol=atol)
            if optimizer == "adamw":
                _leaves_close(_stacked(tc, state["opt"]["mu"]),
                              _jflat(_np(jstate["opt"]["mu"])), scale=1e-4, rtol=1e-3)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == steps


def test_accept_drops_the_update():
    jc, tc = _cfgs(MOE_ARCH)
    model = build_model(tc, device="cpu")
    state = init_train_state(model, 0)
    before = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    step = build_train_step(model, O.AdamWConfig(**OPT))
    seen = []
    _, tb = _batch(tc)
    new, m = step(state, tb, accept=lambda g: seen.append(float(g)) or False)
    assert new is state and m["skipped"] and seen == [float(m["grad_norm"])]
    assert int(state["opt"]["step"]) == 0
    for n, p in state["params"].named_parameters():
        assert torch.equal(p, before[n]), n
    new, m = step(state, tb, accept=lambda g: True)
    assert int(new["opt"]["step"]) == 1 and "skipped" not in m


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_lm_equals_reference():
    cfg = dict(vocab_size=300, seq_len=24, global_batch=3, seed=7)
    jd, td = JSyntheticLM(JDataConfig(**cfg)), SyntheticLM(DataConfig(**cfg))
    for step in (0, 1, 12):
        want, got = jd.batch(step), td.batch(step, "cpu")
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    it = td.iterator(start_step=5, device="cpu")
    for step in (5, 6, 7):
        got = next(it)
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(jd.batch(step)["tokens"]))
    it.close()
    with pytest.raises(RuntimeError, match="no CUDA device") if not torch.cuda.is_available() \
            else pytest.raises(AssertionError):
        td.batch(0)
        raise AssertionError("a CUDA device is present")


# ---------------------------------------------------------------------------
# the trainer (the reference's tests/test_train_integration.py on the port)
# ---------------------------------------------------------------------------

CFG = ModelConfig(name="itest", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)


def _setup(tmp_path, steps, ckpt_every=5, async_checkpoint=False):
    model = build_model(CFG, device="cpu")
    state = init_train_state(model, 0)
    step_fn = build_train_step(model, O.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                    total_steps=steps))
    data = SyntheticLM(DataConfig(vocab_size=CFG.vocab_size, seq_len=32, global_batch=4))
    tr = Trainer(TrainerConfig(total_steps=steps, checkpoint_every=ckpt_every,
                               checkpoint_dir=str(tmp_path),
                               async_checkpoint=async_checkpoint),
                 step_fn, state, None)
    return tr, data


def test_loss_decreases(tmp_path):
    tr, data = _setup(tmp_path, steps=30)
    tr.data_iter = (data.batch(i, "cpu") for i in range(1000))
    report = tr.run()
    assert np.mean(report.losses[-5:]) < np.mean(report.losses[:5])
    assert report.steps == 30 and len(report.step_times) == 30


@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_restart_exactness(tmp_path, async_checkpoint):
    """Crash after step 10, restore, continue: losses equal the
    uninterrupted run (deterministic data pipeline + checkpointed state)."""
    tr, data = _setup(tmp_path / "a", steps=20, ckpt_every=10,
                      async_checkpoint=async_checkpoint)
    tr.data_iter = (data.batch(i, "cpu") for i in range(1000))
    full = tr.run().losses

    tr1, _ = _setup(tmp_path / "b", steps=20, ckpt_every=10,
                    async_checkpoint=async_checkpoint)
    tr1.cfg.total_steps = 10
    tr1.data_iter = (data.batch(i, "cpu") for i in range(1000))
    tr1.run()

    tr2, _ = _setup(tmp_path / "b", steps=20, ckpt_every=10,
                    async_checkpoint=async_checkpoint)
    start = tr2.maybe_restore()
    assert start == 10 and tr2.report.restarts == 1
    tr2.data_iter = (data.batch(i, "cpu") for i in range(start, 1000))
    resumed = tr2.run().losses
    np.testing.assert_allclose(resumed, full[10:], rtol=1e-4, atol=1e-5)


def test_trainer_grad_spike_guard_and_straggler(tmp_path):
    tr, data = _setup(tmp_path, steps=6, ckpt_every=100)
    tr.cfg.grad_spike_factor = 1e-6       # every step after the first spikes
    stragglers = []
    tr.on_straggler = lambda s, f: stragglers.append(s)
    tr.cfg.straggler_factor = 0.0         # every step after the first straggles
    tr.data_iter = (data.batch(i, "cpu") for i in range(1000))
    report = tr.run()
    assert int(tr.state["opt"]["step"]) == 1 and report.steps == 6
    assert report.straggler_steps == 5 and stragglers == [1, 2, 3, 4, 5]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpointer_layout_gc_and_async(tmp_path):
    tc = get_config(MOE_ARCH)
    model = build_model(tc, device="cpu")
    state = init_train_state(model, 0, optimizer="adamw_q8")
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, state, blocking=True, metadata={"step": s})
    ck.save(4, state, blocking=False, metadata={"step": 4})
    saved = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    with torch.no_grad():                 # the next step writes in place
        for p in state["params"].parameters():
            p.add_(1.0)
    ck.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000004"]
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert manifest["step"] == 4 and manifest["metadata"] == {"step": 4}
    leaves = manifest["leaves"]
    assert leaves["params/layers.0.moe.w_gate"] == {"shape": [4, 64, 64], "dtype": "float32"}
    assert leaves["opt/mu/layers.0.moe.w_gate/q"]["dtype"] == "int8"
    assert leaves["opt/step"] == {"shape": [], "dtype": "int32"}
    assert len(leaves) == 1 + 5 * len(saved)
    fresh = init_train_state(model, 1, optimizer="adamw_q8")
    step, restored = Checkpointer(str(tmp_path)).restore_latest(fresh, "cpu")
    assert step == 4 and restored["params"] is fresh["params"]
    for n, p in restored["params"].named_parameters():
        assert torch.equal(p, saved[n]), n
    for n, qs in restored["opt"]["mu"].items():
        assert torch.equal(qs["q"], state["opt"]["mu"][n]["q"])


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_q8"])
def test_reference_checkpoint_restores(tmp_path, optimizer):
    """A train state after one JAX step, written by the reference's
    Checkpointer, read back through train_state_from_numpy: every leaf
    equal, and the port's next step equals JAX's."""
    jc, tc = _cfgs(MOE_ARCH)
    j_step = _jax_step(MOE_ARCH, 1, optimizer)
    jdata, data = _data(tc)
    jstate, _ = j_step(_jax_state(MOE_ARCH, optimizer), jdata.batch(0))
    JCheckpointer(str(tmp_path)).save(1, jstate, blocking=True)
    arrays = Checkpointer(str(tmp_path)).load_arrays(1)
    assert "params/layers/moe/w_gate" in arrays and "opt/step" in arrays
    state = train_state_from_numpy(tc, arrays, optimizer, "cpu")
    assert int(state["opt"]["step"]) == 1
    want = _jflat(_np(jstate["params"]))
    got = _stacked(tc, dict(state["params"].named_parameters()))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jmu = _jflat(_np(jstate["opt"]["mu"]))
    if optimizer == "adamw":
        gmu = _stacked(tc, state["opt"]["mu"])
    else:
        gmu = _stacked(tc, {f"{n}.{k}": v for n, qs in state["opt"]["mu"].items()
                            for k, v in qs.items()})
    for k in jmu:
        np.testing.assert_array_equal(gmu[k], jmu[k], err_msg=k)
    step = build_train_step(build_model(tc, device="cpu"), O.AdamWConfig(**OPT),
                            optimizer=optimizer)
    jstate, jm = j_step(jstate, jdata.batch(1))
    state, m = step(state, data.batch(1, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    with pytest.raises(KeyError, match="opt/mu"):
        train_state_from_numpy(tc, {k: v for k, v in arrays.items()
                                    if "mu/layers/moe/router" not in k}, optimizer, "cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adamw_q8"])
def test_train_launcher_runs_on_cpu(tmp_path, capsys, optimizer):
    argv = ["--arch", MOE_ARCH, "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "16", "--optimizer", optimizer, "--ckpt-dir", str(tmp_path),
            "--checkpoint-every", "2"]
    report = train_launch.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={MOE_ARCH} params=0.1M mesh={{'data': 1, 'model': 1}} "
                             "device=cpu steps=4")
    assert out[-1].startswith("done: loss ") and np.isfinite(report.losses).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000004"]
    resumed = train_launch.main(argv + ["--resume", "--steps", "6"])
    assert resumed.restarts == 1 and resumed.steps == 2
    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 devices, found 1"):
        train_launch.main(argv + ["--production"])


# ---------------------------------------------------------------------------
# the abstract train state
# ---------------------------------------------------------------------------

def _shape_leaves(tree, prefix=""):
    """{dotted name: (shape, dtype)} of a nested mapping of tensors, every
    one on ``meta``."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_shape_leaves(val, name + "."))
        else:
            assert val.is_meta, name
            out[name] = (tuple(val.shape), val.dtype)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_matches_eval_shape(arch):
    """At the published widths, with adamw and adamw_q8: every leaf of the
    port's state is on ``meta`` (nothing allocated) and its shape and
    dtype are those of ``jax.eval_shape`` of the reference's, leaf for leaf
    by dotted name (a per-layer leaf against its stacked leaf without the
    layer axis)."""
    jm = j_build_model(j_get_config(arch), None)
    model = build_model(get_config(arch), device="cpu")
    stacks = {"layers", "mamba_layers", "pairs", "encoder", "decoder"}
    for optimizer in ("adamw", "adamw_q8"):
        want = JS.abstract_train_state(jm, optimizer=optimizer)
        state = abstract_train_state(model, optimizer=optimizer)
        params = dict(state["params"].named_parameters())
        moments = {"mu": state["opt"]["mu"], "nu": state["opt"]["nu"]}
        got = _shape_leaves({"params": params, "opt": moments})
        step = state["opt"]["step"]
        assert all(p.device.type == "meta" for p in params.values()) and step.is_meta
        assert step.dtype == torch.int32 and want["opt"]["step"].shape == ()
        covered = set()
        for name, (shape, dtype) in got.items():
            parts = name.split(".")
            stacked = ".".join(p for p in parts if not p.isdigit())
            leaf = functools.reduce(lambda t, k: t[k], stacked.split("."), want)
            wshape = tuple(leaf.shape)
            if any(p.isdigit() for p in parts):
                assert parts[parts.index(next(p for p in parts if p.isdigit())) - 1] in stacks
                wshape = wshape[1:]
            assert shape == wshape, (name, shape, wshape)
            assert dtype == torch.from_numpy(np.zeros((), leaf.dtype)).dtype, name
            covered.add(stacked)
        ref = {".".join(str(getattr(k, "key", k)) for k in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(
                   {"params": want["params"], "opt": {"mu": want["opt"]["mu"],
                                                      "nu": want["opt"]["nu"]}})[0]}
        assert covered == ref, sorted(covered ^ ref)
