"""The port's expert-parallel MoE (``moe_sharded``, ``_rank_within_expert``)
and the train launcher's parallel context against the JAX reference.

* ``_rank_within_expert`` bit for bit;
* ``moe_sharded`` on granite-moe-1b-a400m-smoke's widths with 8 experts
  top-2 in float32, at capacity factors where no slot and where slots drop
  (the drop counts > 0 and equal to the reference's, counted from its own
  route and rank functions), over one and several token chunks:
  - at (1, 1) in this process: the port on ``single_device_context``'s
    one-rank gloo group, the reference on its one-device mesh; and the
    gradients of the output and the aux loss against ``jax.grad``;
  - at (2, 1), (1, 2), (2, 2) and (1, 4), and with a batch of 1 that
    (2, 2) cannot split: the port's ranks as ``gloo`` processes (one spawn
    per world size for the module, a ``FileStore`` under ``tmp_path``),
    the reference in one JAX subprocess with 4 host devices
    (``--xla_force_host_platform_device_count=4``), its results in an npz;
    every rank returns the whole output; and every rank's gradients of
    ``sum(y * r) + aux`` by the parameters and the input equal to
    ``jax.grad`` of the reference's and to each other's (the (1, 2) cases
    have a data axis of size 1);
  - at (1, 3) both fall back to the dense path (8 experts do not split
    over 3);
  outputs and aux within MOE_TOL (float32 GEMMs in either library's
  order), gradients within GRAD_TOL;
* the train launcher: ``repro_torch.launch.train`` and
  ``repro.launch.train`` from the same initial state on a config whose
  reference drops slots at step 0 (granite-moe-1b-a400m-smoke with 32
  experts top-8, float32, 2 x 16 tokens; asserted): losses within
  LOSS_RTOL, while the dense path's step-0 loss is not; ``--production``
  raises the reference's ``RuntimeError``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as j_registry
import repro.train.trainer as j_trainer
from repro.launch import train as j_train_launch
from repro.models import attention as JA
from repro.models import build_model as j_build_model
from repro.models import layers as JL
from repro.models import moe as JM
from repro.parallel import single_device_context as j_single_device_context
from repro.train import steps as JS
import repro_torch.configs.registry as t_registry
import repro_torch.train.steps as t_steps
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as t_train_launch
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.parallel import single_device_context
from repro_torch.parallel.compat import Mesh

REPO = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-1b-a400m-smoke"
E, K = 8, 2
B, S = 4, 16
MOE_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
# name -> (mesh (data, model), capacity factor, token chunk, input)
CASES = {
    "11": ((1, 1), 1.25, 8192, "x"), "11d": ((1, 1), 0.5, 32, "x"),
    "12": ((1, 2), 1.25, 8192, "x"), "12d": ((1, 2), 0.5, 32, "x"),
    "21": ((2, 1), 1.25, 8192, "x"), "21d": ((2, 1), 0.5, 32, "x"),
    "22": ((2, 2), 1.25, 8192, "x"), "22d": ((2, 2), 0.5, 32, "x"),
    "22r": ((2, 2), 0.5, 8192, "x1"),
    "14": ((1, 4), 1.25, 8192, "x"), "14d": ((1, 4), 0.5, 32, "x"),
    "13": ((1, 3), 0.5, 8192, "x"),
}
DROPPING = ("11d", "12d", "21d", "22d", "22r", "14d")
SEVERAL = ["12", "12d", "21", "21d", "22", "22d", "22r", "14", "14d"]
PARAMS = ("router", "w_gate", "w_up", "w_down")


def _cfg(registry, **moe):
    base = registry.get_config(ARCH)
    return dataclasses.replace(base, dtype="float32",
                               moe=dataclasses.replace(base.moe, **moe))


def _inputs():
    cfg = _cfg(t_registry, num_experts=E, top_k=K)
    d, f = cfg.d_model, cfg.moe.d_ff
    rng = np.random.default_rng(0)
    n = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    return {"router": n(d, E, s=d ** -0.5), "w_gate": n(E, d, f, s=d ** -0.5),
            "w_up": n(E, d, f, s=d ** -0.5), "w_down": n(E, f, d, s=f ** -0.5),
            "x": n(B, S, d), "x1": n(1, 2 * S, d),
            # cotangent weights of the gradient checks' loss sum(y * r) + aux
            "r_x": n(B, S, d), "r_x1": n(1, 2 * S, d)}


def _port_moe(arrays):
    cfg = _cfg(t_registry, num_experts=E, top_k=K)
    p = M.init_moe(None, cfg, "cpu")
    with torch.no_grad():
        for k in ("router", "w_gate", "w_up", "w_down"):
            getattr(p, k).copy_(torch.from_numpy(arrays[k]))
    return cfg, p


def _ref_drops(cfg, p, x, shape, cf, token_chunk):
    """Slots past capacity in the reference's dispatch, from its own route
    and rank functions over each data shard's chunks."""
    _, top_i, _ = JM.route(cfg, p, x)
    Bx, Sx = x.shape[:2]
    dp = shape[0] if Bx % shape[0] == 0 else 1
    T_loc = -(-Bx // dp) * Sx
    n_chunks = max(T_loc // min(token_chunk, T_loc), 1)
    chunk = T_loc // n_chunks
    C = int(max(8, np.ceil(chunk * cfg.moe.top_k * cf / cfg.moe.num_experts)))
    drops = 0
    for b in range(dp):
        ids = np.asarray(top_i[b * (Bx // dp):(b + 1) * (Bx // dp)]).reshape(T_loc, -1)
        for c in range(n_chunks):
            rank = JM._rank_within_expert(jnp.asarray(ids[c * chunk:(c + 1) * chunk].reshape(-1),
                                                      jnp.int32), cfg.moe.num_experts)
            drops += int((np.asarray(rank) >= C).sum())
    return drops


# ---------------------------------------------------------------------------
# rank within expert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,experts", [(1, 4), (64, 4), (257, 32), (4096, 32)])
def test_rank_within_expert_bit_for_bit(T, experts):
    ids = np.random.default_rng(T).integers(0, experts, T).astype(np.int32)
    want = np.asarray(JM._rank_within_expert(jnp.asarray(ids), experts))
    got = M._rank_within_expert(torch.from_numpy(ids), experts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (1, 1) in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["11", "11d"])
def test_moe_sharded_one_rank(case):
    """The one-rank group: moe_apply under single_device_context takes
    moe_sharded, equal to the reference's; drops counted alike; without
    drops both equal the dense path."""
    (_, cf, chunk, xname) = CASES[case]
    arrays = _inputs()
    cfg, p = _port_moe(arrays)
    jcfg = _cfg(j_registry, num_experts=E, top_k=K)
    jp = {k: jnp.asarray(arrays[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = arrays[xname]
    jctx = j_single_device_context(capacity_factor=cf, moe_token_chunk=chunk)
    want, jaux = JM.moe_apply(jcfg, jp, jnp.asarray(x), parallel=jctx)
    ctx = single_device_context("cpu", capacity_factor=cf, moe_token_chunk=chunk)
    with M.dispatch_record() as rec:
        got, aux = M.moe_apply(cfg, p, torch.from_numpy(x), parallel=ctx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=MOE_TOL["rtol"])
    drops = sum(int(r["dropped"]) for r in rec)
    assert drops == _ref_drops(jcfg, jp, jnp.asarray(x), (1, 1), cf, chunk)
    assert len(rec) == max(B * S // min(chunk, B * S), 1)
    if case in DROPPING:
        assert drops > 0
    else:
        assert drops == 0
        dense, _ = M.moe_dense(cfg, p, torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), dense.detach().numpy(), **MOE_TOL)


def test_moe_sharded_gradients_match_jax():
    """d(sum(y * r) + aux) by every parameter and the input, at (1, 1)
    with slots dropped over two chunks, against jax.grad."""
    _, cf, chunk, _ = CASES["11d"]
    arrays = _inputs()
    cfg, p = _port_moe(arrays)
    jcfg = _cfg(j_registry, num_experts=E, top_k=K)
    r = np.random.default_rng(1).standard_normal(arrays["x"].shape).astype(np.float32)
    jctx = j_single_device_context(capacity_factor=cf, moe_token_chunk=chunk)

    def jloss(jp, x):
        y, aux = JM.moe_apply(jcfg, jp, x, parallel=jctx)
        return jnp.sum(y * r) + aux
    jp = {k: jnp.asarray(arrays[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(arrays["x"]))

    ctx = single_device_context("cpu", capacity_factor=cf, moe_token_chunk=chunk)
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    y, aux = M.moe_apply(cfg, p, x, parallel=ctx)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    for k in jp:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(getattr(p, k).grad.numpy(), want, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * np.abs(want).max(), err_msg=k)
    want = np.asarray(jgx)
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=GRAD_TOL["rtol"],
                               atol=GRAD_TOL["atol"] * np.abs(want).max())


# ---------------------------------------------------------------------------
# several ranks: gloo processes against the reference on 4 host devices
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import get_config
    from repro.launch.mesh import make_host_mesh
    from repro.models import moe as JM
    inp = np.load(sys.argv[1])
    cases = json.loads(sys.argv[3])
    base = get_config(sys.argv[4])
    cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
        base.moe, num_experts=int(sys.argv[5]), top_k=int(sys.argv[6])))
    p = {k: jnp.asarray(inp[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    out = {}
    for name, (shape, cf, chunk, xname) in cases.items():
        mesh = make_host_mesh(*shape)
        fn = lambda p, x: JM.moe_sharded(
            cfg, p, x, mesh=mesh, dp_axes=("data",), ep_axis="model",
            capacity_factor=cf, token_chunk=chunk)
        y, aux = jax.jit(fn)(p, jnp.asarray(inp[xname]))
        out[name], out[name + "_aux"] = np.asarray(y), np.asarray(aux)
        if shape != (1, 3):
            r = jnp.asarray(inp["r_" + xname])
            loss = lambda p, x: (lambda y, aux: jnp.sum(y * r) + aux)(*fn(p, x))
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(inp[xname]))
            for k in p:
                out[name + "_g_" + k] = np.asarray(gp[k])
            out[name + "_g_x"] = np.asarray(gx)
    np.savez(sys.argv[2], **out)
""")

PORT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                            rank=rank, world_size=world)
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as M
    from repro_torch.parallel.compat import make_mesh
    inp = np.load(sys.argv[4])
    cases = json.loads(sys.argv[6])
    base = get_config(sys.argv[7])
    cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
        base.moe, num_experts=int(sys.argv[8]), top_k=int(sys.argv[9])))
    p = M.init_moe(None, cfg, "cpu")
    with torch.no_grad():
        for k in ("router", "w_gate", "w_up", "w_down"):
            getattr(p, k).copy_(torch.from_numpy(inp[k]))
    out = {}
    for name, (shape, cf, chunk, xname) in cases.items():
        mesh = make_mesh(shape, ("data", "model"))
        x = torch.from_numpy(inp[xname]).requires_grad_(True)
        for k in ("router", "w_gate", "w_up", "w_down"):
            getattr(p, k).grad = None
        with M.dispatch_record() as rec:
            y, aux = M.moe_sharded(cfg, p, x, mesh=mesh,
                                   dp_axes=("data",), ep_axis="model",
                                   capacity_factor=cf, token_chunk=chunk)
        (torch.sum(y * torch.from_numpy(inp["r_" + xname])) + aux).backward()
        for k in ("router", "w_gate", "w_up", "w_down"):
            out[name + "_g_" + k] = getattr(p, k).grad.numpy().copy()
        out[name + "_g_x"] = x.grad.numpy()
        out[name], out[name + "_aux"] = y.detach().numpy(), aux.detach().numpy()
        out[name + "_drops"] = np.int64(sum(int(r["dropped"]) for r in rec))
        out[name + "_at"] = np.array([mesh.coords["data"], mesh.coords["model"]])
    np.savez(sys.argv[5], **out)
    dist.destroy_process_group()
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _spawn(world, cases, tmp: Path, inputs: Path):
    """``world`` gloo ranks running PORT over ``cases``; each rank's outputs."""
    store = tmp / f"store{world}"
    outs = [tmp / f"w{world}_rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", PORT, str(r), str(world), str(store),
                               str(inputs), str(outs[r]), json.dumps(cases), ARCH,
                               str(E), str(K)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    arrays = _inputs()
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **arrays)
    ref_out = tmp / "reference.npz"
    subprocess.run([sys.executable, "-c", REFERENCE, str(inputs), str(ref_out),
                    json.dumps({k: v for k, v in CASES.items() if k != "11"}), ARCH,
                    str(E), str(K)], check=True, timeout=300,
                   env=_env(JAX_PLATFORMS="cpu",
                            XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    ranks = {}
    for world in (2, 4):
        cases = {k: v for k, v in CASES.items() if np.prod(v[0]) == world}
        for r, out in enumerate(_spawn(world, cases, tmp, inputs)):
            for name in cases:
                ranks.setdefault(name, []).append(
                    {s: out[name + s] for s in ("", "_aux", "_drops", "_at", "_g_x")
                     + tuple("_g_" + k for k in PARAMS)})
    return arrays, dict(np.load(ref_out)), ranks


@pytest.mark.parametrize("case", SEVERAL)
def test_moe_sharded_matches_reference_across_ranks(sharded, case):
    """Every rank's output and aux equal to the reference's shard_map run;
    the slots dropped over the data shards (each counted on its model-index
    0 rank; a batch the data axis cannot split is one shard) equal the
    reference's."""
    arrays, ref, ranks = sharded
    shape, cf, chunk, xname = CASES[case]
    assert len(ranks[case]) == np.prod(shape)
    for out in ranks[case]:
        np.testing.assert_allclose(out[""], ref[case], **MOE_TOL)
        np.testing.assert_allclose(out["_aux"], ref[case + "_aux"], rtol=MOE_TOL["rtol"])
    jcfg = _cfg(j_registry, num_experts=E, top_k=K)
    jp = {k: jnp.asarray(arrays[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    split = arrays[xname].shape[0] % shape[0] == 0
    drops = sum(int(out["_drops"]) for out in ranks[case]
                if out["_at"][1] == 0 and (split or out["_at"][0] == 0))
    assert drops == _ref_drops(jcfg, jp, jnp.asarray(arrays[xname]), shape, cf, chunk)
    if case in DROPPING:
        assert drops > 0


@pytest.mark.parametrize("case", SEVERAL)
def test_moe_sharded_gradients_across_ranks(sharded, case):
    """Every rank's gradients by the router, the experts and the input are
    the global loss's: equal on every rank, and to jax.grad through the
    reference's shard_map within GRAD_TOL (slots drop in the ``d`` and
    ``r`` cases; the (1, 2) cases have a data axis of size 1)."""
    _, ref, ranks = sharded
    outs = ranks[case]
    for part in ("_g_x",) + tuple("_g_" + k for k in PARAMS):
        for out in outs[1:]:
            np.testing.assert_array_equal(out[part], outs[0][part], err_msg=part)
        want = ref[case + part]
        np.testing.assert_allclose(outs[0][part], want, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * np.abs(want).max(), err_msg=part)


def test_moe_sharded_dense_fallback(sharded):
    """8 experts over a model axis of 3: both packages take the dense path
    (the port's mesh needs no ranks for it)."""
    arrays, ref, _ = sharded
    shape, cf, chunk, xname = CASES["13"]
    cfg, p = _port_moe(arrays)
    with M.dispatch_record() as rec:
        y, _ = M.moe_sharded(cfg, p, torch.from_numpy(arrays[xname]),
                             mesh=Mesh(shape, ("data", "model")), dp_axes=("data",),
                             ep_axis="model", capacity_factor=cf, token_chunk=chunk)
    assert rec == []
    np.testing.assert_allclose(y.detach().numpy(), ref["13"], **MOE_TOL)


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------

LAUNCH_ARGS = ["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "16",
               "--checkpoint-every", "100"]


def test_train_launcher_trains_the_references_moe(tmp_path, monkeypatch, capsys):
    """Both launchers from the reference's initial state on a config whose
    reference dispatch drops slots at step 0: the port's losses equal the
    reference's within LOSS_RTOL, the dense path's step-0 loss does not
    (the fault before the port's launcher took the context)."""
    E32 = dict(num_experts=32, top_k=8)
    jcfg, tcfg = _cfg(j_registry, **E32), _cfg(t_registry, **E32)
    for reg, cfg in ((j_registry, jcfg), (t_registry, tcfg)):
        get = reg.get_config
        monkeypatch.setattr(reg, "get_config",
                            lambda a, get=get, cfg=cfg: cfg if a == ARCH else get(a))
    jstate = jax.tree.map(np.asarray, JS.init_train_state(
        j_build_model(jcfg, None), jax.random.PRNGKey(0)))
    monkeypatch.setattr(t_steps, "init_train_state", lambda model, seed, optimizer="adamw":
                        t_steps.train_state_from_numpy(tcfg, jstate, optimizer, "cpu"))

    # the reference drops slots in layer 0 at step 0
    p = jax.tree.map(jnp.asarray, jstate["params"])
    lp = jax.tree.map(lambda t: t[0], p["layers"])
    data = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=2))
    batch0 = data.batch(0, "cpu")
    tokens = jnp.asarray(batch0["tokens"].numpy())
    x = JL.embed_tokens(jcfg, p["embed"], tokens)
    pos = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32), (2, 16))
    x = x + JA.self_attention(jcfg, lp["attn"], JL.apply_norm(jcfg, lp["norm1"], x), pos,
                              window=jcfg.sliding_window, chunk=512, schedule="rect")
    h = JL.apply_norm(jcfg, lp["norm2"], x)
    assert _ref_drops(jcfg, lp["moe"], h, (1, 1), 1.25, 8192) > 0

    reports = []
    run = j_trainer.Trainer.run
    monkeypatch.setattr(j_trainer.Trainer, "run",
                        lambda self: reports.append(run(self)) or reports[-1])
    monkeypatch.setattr(sys, "argv", ["train"] + LAUNCH_ARGS +
                        ["--ckpt-dir", str(tmp_path / "ref")])
    j_train_launch.main()
    want = np.asarray(reports[0].losses)
    got = t_train_launch.main(LAUNCH_ARGS + ["--device", "cpu", "--ckpt-dir",
                                             str(tmp_path / "port")])
    first = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("arch=")]
    head = f"arch={ARCH} params={tcfg.param_count() / 1e6:.1f}M mesh={{'data': 1, 'model': 1}}"
    assert first == [head + " steps=3", head + " device=cpu steps=3"]
    np.testing.assert_allclose(np.asarray(got.losses), want, rtol=LOSS_RTOL)
    # the dense path from the same state misses the reference's step-0 loss
    model = build_model(tcfg, None, device="cpu")
    state = t_steps.train_state_from_numpy(tcfg, jstate, "adamw", "cpu")
    with torch.no_grad():
        dense0 = float(model.loss(state["params"], batch0)[0])
    assert abs(dense0 - want[0]) > 100 * LOSS_RTOL * abs(want[0]), (dense0, want[0])

    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 devices, found 1"):
        t_train_launch.main(LAUNCH_ARGS + ["--device", "cpu", "--production"])
    monkeypatch.setattr(sys, "argv", ["train"] + LAUNCH_ARGS + ["--production"])
    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 devices, found 1"):
        j_train_launch.main()
