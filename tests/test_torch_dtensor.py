"""The model's sharded run as DTensors against the reference jitted with
``param_shardings`` over 4 host devices.

* ``shard_params`` at a (2, 2) ``("data", "model")`` mesh: every rank's
  local slice of every parameter of the dense and the MoE smoke configs is
  the slice that JAX's ``NamedSharding`` gives that device
  (``devices_indices_map``), bit for bit;
* the forward logits of all ten smoke configs (float32), parameters from
  ``Model.shard``, the batch distributed by ``batch_placements``, the
  prefill attention through the kernel route (its plain version on CPU
  tensors, each rank's heads), against the reference's forward under its
  context jitted with the parameters placed by ``param_shardings``:
  within FWD_TOL on every rank;
* for the dense (granite-3-2b) and MoE (granite-moe-1b-a400m) smoke
  configs at (2, 2) and (1, 4): the gradients of ``Model.loss``
  (``full_tensor()``, the ``Partial`` sums reduced) within GRAD_TOL, and
  one step of ``build_train_step`` with ``adamw`` and ``adamw_q8``: the
  loss, the gradient norm and the parameters' update within STEP_TOL, and
  for ``adamw_q8`` the moments' block scales within STEP_TOL and their
  decoded values within one code. The projections' last dims are sharded
  into 32- and 16-wide slices, so no rank's slice is a whole int8 block:
  the blocks are JAX's global ones only if each row is quantized whole;
  and the dense config's adamw step at (2, 2) in 2 microbatches, each
  rank splitting its own rows;
* the xLSTM smoke config (2 heads) at (1, 4), a model axis that does not
  divide its heads, its token loop and its chunked form (two chunks): the
  mLSTM's h before the head merge and the returned C state sharded along
  Dv on every rank (the recurrence split, ``xlstm._split_scan``), and the
  sharded logits and every gradient against the port's replicated run and
  the reference's jitted forward and jax.grad at (1, 4); one decode step
  from the split state (as returned, whole as a placed cache, plain)
  against the replicated model's;
* on ``single_device_context``'s one-rank mesh, in this process, the
  sharded MoE forward equals the plain model's bit for bit and one
  ``adamw_q8`` step moves the parameters as on the plain model.

The port's 4 ranks run as ``gloo`` processes in one spawn for the module
(their ``DeviceMesh`` built over the mesh's own groups,
``compat.device_mesh``), the reference in one JAX subprocess with
``--xla_force_host_platform_device_count=4``; the reference writes the
initial parameters and batches first and the ranks start from them while
it computes.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import repro_torch.configs.registry as t_registry
from repro_torch.models.model_zoo import per_layer_arrays
from repro_torch.train.steps import _nest
from test_torch_moe_ep import _env

ARCHS = [a + "-smoke" for a in t_registry.ARCH_IDS]
TRAIN = {"dense": "granite-3-2b-smoke", "moe": "granite-moe-1b-a400m-smoke"}
TRAIN_MESHES = {"22": (2, 2), "14": (1, 4)}
#: the xLSTM case: 2 heads on a model axis of 4; the chunked form
#: (``xlstm-350m-smoke-fast``) at a chunk of XLSTM_CHUNK, two chunks of S
XLSTM, XLSTM_MESH, XLSTM_CHUNK = "xlstm-350m-smoke", (1, 4), 8
OPTIMIZERS = ("adamw", "adamw_q8")
B, S = 4, 16
# AdamW with a visible first step: no warmup, an eps above the gradients'
# float32 noise
OPT = dict(lr=1e-2, warmup_steps=0, eps=1e-4)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)        # float32, either library's order
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)       # atol times max |reference|
# an update lr * g / (|g| + eps) moves by lr / eps times a gradient's error
# where |g| << eps: GRAD_TOL's atol times lr / eps, against the largest
# update (about lr)
STEP_TOL = dict(rtol=1e-3, atol=1e-3)       # atol times max |reference|

REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    from pathlib import Path
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs.registry import get_config
    from repro.launch.mesh import make_host_mesh
    from repro.models import build_model, encdec, transformer, xlstm, zamba
    from repro.models.model_zoo import batch_specs
    from repro.optim.adamw import AdamWConfig, init_opt_state, init_opt_state_q8
    from repro.parallel.sharding import ParallelContext, param_shardings
    from repro.train import steps as JS
    out_dir = Path(sys.argv[1])
    archs, train, meshes, opt_kw = (json.loads(a) for a in sys.argv[2:6])
    B, S = int(sys.argv[6]), int(sys.argv[7])
    xl_arch, xl_mesh, xl_chunk = sys.argv[8], json.loads(sys.argv[9]), int(sys.argv[10])
    MICROBATCHES = 2

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                for path, v in leaves}

    def cfg_of(arch):
        return dataclasses.replace(get_config(arch), dtype="float32")

    def batch_of(i, cfg):
        rng = np.random.default_rng(100 + i)
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        b = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
        if cfg.is_encoder_decoder:
            b["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32)
        return b

    # the initial states first: the port's ranks start from them
    params, batches = {}, {}
    for i, arch in enumerate(archs):
        cfg = cfg_of(arch)
        params[arch] = build_model(cfg, None).init(jax.random.PRNGKey(i))
        batches[arch] = batch_of(i, cfg)
        np.savez(out_dir / f"init_{arch}.npz", **flat(params[arch]),
                 **{"batch/" + k: v for k, v in batches[arch].items()})
    (out_dir / "ready").write_text("1")

    def put(ctx, tree, batch):
        p = jax.device_put(tree, param_shardings(ctx, tree))
        sh = jax.tree.map(lambda s: NamedSharding(ctx.mesh, s), batch_specs(ctx, batch))
        return p, jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, sh)

    def fwd(c, ctx, p, b):
        if c.xlstm is not None:
            return xlstm.xlstm_forward(c, ctx, p, b["tokens"])[0]
        if c.ssm is not None:
            return zamba.zamba_forward(c, ctx, p, b["tokens"])[0]
        if c.is_encoder_decoder:
            return encdec.forward(c, ctx, p, b["tokens"], b["frames"])[0]
        return transformer.forward(c, ctx, p, b["tokens"])[0]

    out = {}
    ctx = ParallelContext(mesh=make_host_mesh(2, 2))
    for arch in archs:
        cfg = cfg_of(arch)
        p, b = put(ctx, params[arch], batches[arch])
        out["fwd/" + arch] = np.asarray(jax.jit(
            lambda p, b, cfg=cfg: fwd(cfg, ctx, p, b))(p, b))
        if arch in train.values():
            leaves, _ = jax.tree_util.tree_flatten_with_path(p)
            devs = list(ctx.mesh.devices.flat)
            for path, leaf in leaves:
                name = "/".join(str(getattr(k, "key", k)) for k in path)
                imap = leaf.sharding.devices_indices_map(leaf.shape)
                out[f"index/{arch}/{name}"] = np.array(
                    [[sl.indices(n)[:2] for sl, n in zip(imap[d], leaf.shape)]
                     for d in devs], dtype=np.int64)
    for kind, arch in train.items():
        cfg = cfg_of(arch)
        for mname, shape in meshes.items():
            ctx = ParallelContext(mesh=make_host_mesh(*shape))
            model = build_model(cfg, ctx)
            p, b = put(ctx, params[arch], batches[arch])
            grads = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(p, b)
            for k, v in flat(grads).items():
                out[f"grad/{kind}{mname}/{k}"] = v
            for opt in ("adamw", "adamw_q8"):
                init = init_opt_state_q8 if opt == "adamw_q8" else init_opt_state
                state = {"params": p, "opt": init(params[arch])}
                state["opt"] = jax.device_put(state["opt"], param_shardings(ctx, state["opt"]))
                step = jax.jit(JS.build_train_step(model, AdamWConfig(**opt_kw), optimizer=opt))
                new, metrics = step(state, b)
                tag = f"{kind}{mname}/{opt}"
                for k, v in flat(new["params"]).items():
                    out[f"step/{tag}/{k}"] = v
                if opt == "adamw_q8":
                    for k, v in flat(new["opt"]["mu"]).items():
                        out[f"mu/{tag}/{k}"] = v
                out[f"loss/{tag}"] = np.asarray(metrics["loss"])
                out[f"gnorm/{tag}"] = np.asarray(metrics["grad_norm"])
            if kind == "dense" and mname == "22":
                state = {"params": p, "opt": jax.device_put(
                    init_opt_state(params[arch]), param_shardings(ctx, init_opt_state(params[arch])))}
                step = jax.jit(JS.build_train_step(model, AdamWConfig(**opt_kw),
                                                   microbatches=MICROBATCHES))
                new, metrics = step(state, b)
                tag = f"{kind}{mname}/adamw_mb"
                for k, v in flat(new["params"]).items():
                    out[f"step/{tag}/{k}"] = v
                out[f"loss/{tag}"] = np.asarray(metrics["loss"])
                out[f"gnorm/{tag}"] = np.asarray(metrics["grad_norm"])
    cfg = cfg_of(xl_arch)
    ctx = ParallelContext(mesh=make_host_mesh(*xl_mesh))
    p, b = put(ctx, params[xl_arch], batches[xl_arch])
    # the token loop ("x") and the chunked form ("xf", two chunks)
    fast = dataclasses.replace(cfg, xlstm=dataclasses.replace(
        cfg.xlstm, parallel_mlstm=True, chunk=xl_chunk))
    for tag, c in (("x", cfg), ("xf", fast)):
        model = build_model(c, ctx)
        out[f"{tag}fwd"] = np.asarray(jax.jit(lambda p, b, c=c: fwd(c, ctx, p, b))(p, b))
        for k, v in flat(jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(p, b)).items():
            out[f"{tag}grad/{k}"] = v
    np.savez(out_dir / "reference.npz", **out)
""")

PORT = textwrap.dedent("""
    import dataclasses, json, sys
    from pathlib import Path
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                            rank=rank, world_size=world)
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model, encdec, transformer, xlstm, zamba
    from repro_torch.models.model_zoo import batch_placements, cache_placements, \
        params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.compat import make_mesh
    from repro_torch.parallel.sharding import ParallelContext, distribute, spmd
    from repro_torch.train.steps import _nest, build_train_step, init_opt_state, \\
        init_opt_state_q8
    in_dir, out_path = Path(sys.argv[4]), sys.argv[5]
    archs, train, meshes, opt_kw = (json.loads(a) for a in sys.argv[6:10])
    xl_arch, xl_mesh, xl_chunk = sys.argv[10], json.loads(sys.argv[11]), int(sys.argv[12])
    MICROBATCHES = 2

    def cfg_of(arch):
        return dataclasses.replace(get_config(arch), dtype="float32")

    def load(arch):
        arrays = dict(np.load(in_dir / f"init_{arch}.npz"))
        batch = {k[len("batch/"):]: torch.from_numpy(v).long()
                 if v.dtype.kind == "i" else torch.from_numpy(v)
                 for k, v in arrays.items() if k.startswith("batch/")}
        tree = _nest({k: v for k, v in arrays.items() if not k.startswith("batch/")})
        return tree, batch

    def fwd(c, ctx, p, b):
        if c.xlstm is not None:
            return xlstm.xlstm_forward(c, p, b["tokens"], ctx=ctx)[0]
        if c.ssm is not None:
            return zamba.zamba_forward(c, p, b["tokens"], ctx=ctx)[0]
        if c.is_encoder_decoder:
            return encdec.forward(c, p, b["tokens"], b["frames"], ctx=ctx)[0]
        return transformer.forward(c, p, b["tokens"], ctx=ctx)[0]

    def sharded(arch, ctx, cfg=None):
        cfg = cfg or cfg_of(arch)
        tree, batch = load(arch)
        model = build_model(cfg, ctx, device="cpu")
        params = model.shard(params_from_numpy(cfg, tree, "cpu"))
        return cfg, model, params, distribute(batch, batch_placements(ctx, batch), ctx, "cpu")

    out = {}
    ctx = ParallelContext(mesh=make_mesh((2, 2), ("data", "model")))
    for arch in archs:
        cfg, model, params, batch = sharded(arch, ctx)
        with torch.no_grad():
            out["fwd/" + arch] = fwd(cfg, ctx, params, batch).full_tensor().numpy()
        if arch in train.values():
            for name, p in params.named_parameters():
                out[f"local/{arch}/{name}"] = p.detach().to_local().numpy()
    for kind, arch in train.items():
        for mname, shape in meshes.items():
            ctx = ParallelContext(mesh=make_mesh(shape, ("data", "model")))
            cfg, model, params, batch = sharded(arch, ctx)
            names, leaves = zip(*params.named_parameters())
            grads = spmd(lambda: torch.autograd.grad(model.loss(params, batch)[0], leaves))()
            for n, g in zip(names, grads):
                out[f"grad/{kind}{mname}/{n}"] = g.full_tensor().numpy()
            for opt in ("adamw", "adamw_q8"):
                cfg, model, params, batch = sharded(arch, ctx)
                init = init_opt_state_q8 if opt == "adamw_q8" else init_opt_state
                state = {"params": params, "opt": init(params)}
                step = build_train_step(model, AdamWConfig(**opt_kw), optimizer=opt)
                state, metrics = step(state, batch)
                tag = f"{kind}{mname}/{opt}"
                for n, p in state["params"].named_parameters():
                    out[f"step/{tag}/{n}"] = p.detach().full_tensor().numpy()
                if opt == "adamw_q8":
                    for n, m in state["opt"]["mu"].items():
                        for part in ("q", "s"):
                            out[f"mu/{tag}/{n}.{part}"] = m[part].full_tensor().numpy()
                out[f"loss/{tag}"] = metrics["loss"].numpy()
                out[f"gnorm/{tag}"] = metrics["grad_norm"].numpy()
            if kind == "dense" and mname == "22":
                cfg, model, params, batch = sharded(arch, ctx)
                state = {"params": params, "opt": init_opt_state(params)}
                step = build_train_step(model, AdamWConfig(**opt_kw),
                                        microbatches=MICROBATCHES)
                state, metrics = step(state, batch)
                tag = f"{kind}{mname}/adamw_mb"
                for n, p in state["params"].named_parameters():
                    out[f"step/{tag}/{n}"] = p.detach().full_tensor().numpy()
                out[f"loss/{tag}"] = metrics["loss"].numpy()
                out[f"gnorm/{tag}"] = metrics["grad_norm"].numpy()
    ctx = ParallelContext(mesh=make_mesh(xl_mesh, ("data", "model")))
    seen, merge = [], xlstm._merge_heads

    def spy(h, heads, flat=None):       # h before the head merge
        seen.append(h)
        return merge(h, heads, flat)

    def layout(t):                      # a DTensor's mesh, placements and shapes
        return np.array(json.dumps({
            "mesh": list(t.device_mesh.mesh_dim_names), "local": list(t.to_local().shape),
            "shard": [p.dim if p.is_shard() else -1 for p in t.placements],
            "global": list(t.shape)}))
    xlstm._merge_heads = spy
    cfg = cfg_of(xl_arch)
    fast = dataclasses.replace(cfg, xlstm=dataclasses.replace(
        cfg.xlstm, parallel_mlstm=True, chunk=xl_chunk))
    for tag, c in (("x", cfg), ("xf", fast)):
        _, model, params, batch = sharded(xl_arch, ctx, c)
        seen.clear()
        with torch.no_grad():
            logits, _, state = xlstm.xlstm_forward(c, params, batch["tokens"], ctx=ctx)
        out[f"{tag}fwd/sharded"] = logits.full_tensor().numpy()
        out[f"{tag}layout/h"], out[f"{tag}layout/C"] = layout(seen[0]), layout(state["mlstm"]["C"])
        if tag == "x":
            # one decode step from the split state, from that state whole and
            # placed as a cache, and from it as plain tensors
            whole = {b: {k: t.full_tensor() for k, t in d.items()} for b, d in state.items()}
            step = batch["tokens"][:, :1]
            with torch.no_grad():
                for how, st in (("split", state),
                                ("cache", distribute(whole, cache_placements(ctx, whole), ctx,
                                                     "cpu")),
                                ("plain", whole)):
                    out[f"xdecode/{how}"] = xlstm.xlstm_decode_step(
                        c, params, st, step, 0, ctx=ctx)[0].full_tensor().numpy()
        names, leaves = zip(*params.named_parameters())
        grads = spmd(lambda: torch.autograd.grad(model.loss(params, batch)[0], leaves))()
        for n, g in zip(names, grads):
            out[f"{tag}grad/sharded/{n}"] = g.full_tensor().numpy()
        tree, batch = load(xl_arch)
        model = build_model(c, None, device="cpu")
        params = params_from_numpy(c, tree, "cpu")
        with torch.no_grad():
            out[f"{tag}fwd/replicated"] = fwd(c, None, params, batch).numpy()
            if tag == "x":
                _, _, state = xlstm.xlstm_forward(c, params, batch["tokens"])
                out["xdecode/replicated"] = xlstm.xlstm_decode_step(
                    c, params, state, batch["tokens"][:, :1], 0)[0].numpy()
        names, leaves = zip(*params.named_parameters())
        for n, g in zip(names, torch.autograd.grad(model.loss(params, batch)[0], leaves)):
            out[f"{tag}grad/replicated/{n}"] = g.numpy()
    xlstm._merge_heads = merge
    np.savez(out_path, **out)
    dist.destroy_process_group()
""")


def _cfg(arch):
    return dataclasses.replace(t_registry.get_config(arch), dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's npz, each rank's npz, the trained configs' initial
    states), from one JAX subprocess and one spawn of 4 gloo ranks that
    starts once the reference has written the initial states."""
    tmp = tmp_path_factory.mktemp("dtensor")
    args = [json.dumps(ARCHS), json.dumps(TRAIN), json.dumps(TRAIN_MESHES), json.dumps(OPT)]
    xl = [XLSTM, json.dumps(XLSTM_MESH), str(XLSTM_CHUNK)]
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp), *args, str(B), str(S), *xl],
                           env=_env(JAX_PLATFORMS="cpu",
                                    XLA_FLAGS="--xla_force_host_platform_device_count=4"),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    deadline = time.time() + 300
    while not (tmp / "ready").exists():
        assert ref.poll() is None, ref.communicate()[0].decode()
        assert time.time() < deadline, "the reference wrote no initial state"
        time.sleep(0.2)
    world = 4
    outs = [tmp / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", PORT, str(r), str(world),
                               str(tmp / "store"), str(tmp), str(outs[r]), *args, *xl],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    ref_log = ref.communicate(timeout=600)[0].decode()
    assert ref.returncode == 0, ref_log
    assert all(p.returncode == 0 for p in procs), logs
    inits = {a: dict(np.load(tmp / f"init_{a}.npz")) for a in TRAIN.values()}
    return dict(np.load(tmp / "reference.npz")), [dict(np.load(o)) for o in outs], inits


def _port_names(cfg, ref, prefix):
    """The reference's ``prefix/<stacked key>`` arrays as ``{port name:
    array}``."""
    tree = _nest({k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)})
    return per_layer_arrays(cfg, tree)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("kind", list(TRAIN))
def test_shard_params_holds_named_sharding_slices(runs, kind):
    """Each rank's local slice of each parameter at (2, 2) is, bit for bit,
    the slice JAX's NamedSharding puts on that device (the layer axis of
    the reference's stacked leaves unsharded); some are split."""
    ref, ranks, inits = runs
    arch = TRAIN[kind]
    cfg = _cfg(arch)
    full = per_layer_arrays(cfg, _nest({k: v for k, v in inits[arch].items()
                                        if not k.startswith("batch/")}))
    split = 0
    for name, value in full.items():
        parts = name.split(".")
        stacked = "/".join(p for p in parts if not p.isdigit())
        idx = ref[f"index/{arch}/{stacked}"]                # (ranks, dims, 2)
        if len(parts) > len(stacked.split("/")):
            assert (idx[:, 0, 0] == 0).all() and (idx[:, 0, 1] == idx[0, 0, 1]).all()
            idx = idx[:, 1:]
        for r, out in enumerate(ranks):
            want = value[tuple(slice(a, b) for a, b in idx[r])]
            np.testing.assert_array_equal(out[f"local/{arch}/{name}"], want,
                                          err_msg=f"{name} rank {r}")
        split += ranks[0][f"local/{arch}/{name}"].size < value.size
    assert split > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_reference(runs, arch):
    """All ten smoke configs: the logits of the sharded run on every rank
    equal the reference's jitted sharded forward within FWD_TOL."""
    ref, ranks, _ = runs
    want = ref["fwd/" + arch]
    for r, out in enumerate(ranks):
        got = out["fwd/" + arch]
        assert got.shape == want.shape and np.isfinite(got).all()
        _close(got, want, FWD_TOL, f"{arch} rank {r}")


TRAIN_CASES = [k + m for k in TRAIN for m in TRAIN_MESHES]


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_sharded_gradients_match_reference(runs, case):
    """Every parameter's gradient of the loss (``full_tensor()``, the
    data axis's partial sums reduced) on every rank, against jax.grad of
    the reference's loss under its context, within GRAD_TOL."""
    ref, ranks, _ = runs
    cfg = _cfg(TRAIN[case[:-2]])
    want = _port_names(cfg, ref, f"grad/{case}/")
    for r, out in enumerate(ranks):
        got = {k[len(f"grad/{case}/"):]: v for k, v in out.items()
               if k.startswith(f"grad/{case}/")}
        assert got.keys() == want.keys()
        for name, w in want.items():
            _close(got[name], w, GRAD_TOL, f"{case} {name} rank {r}")


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_sharded_train_step_matches_reference(runs, case, opt):
    """One step of build_train_step on the sharded model: loss and
    gradient norm, every parameter's update, and for adamw_q8 the first
    moment's block scales (within STEP_TOL) and decoded values (within one
    code), against the reference's jitted step on its sharded state."""
    ref, ranks, inits = runs
    arch = TRAIN[case[:-2]]
    cfg = _cfg(arch)
    tag = f"{case}/{opt}"
    init = per_layer_arrays(cfg, _nest({k: v for k, v in inits[arch].items()
                                        if not k.startswith("batch/")}))
    want = _port_names(cfg, ref, f"step/{tag}/")
    mu = _port_names(cfg, ref, f"mu/{tag}/") if opt == "adamw_q8" else {}
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"loss/{tag}"], ref[f"loss/{tag}"], rtol=1e-5)
        np.testing.assert_allclose(out[f"gnorm/{tag}"], ref[f"gnorm/{tag}"], rtol=1e-4)
        for name, w in want.items():
            _close(out[f"step/{tag}/{name}"] - init[name], w - init[name], STEP_TOL,
                   f"{tag} {name} rank {r}")
        for key, w in mu.items():
            if key.endswith(".s"):
                _close(out[f"mu/{tag}/{key}"], w, STEP_TOL, f"{tag} {key} rank {r}")
                continue
            scale = mu[key[:-2] + ".s"]
            blocks = lambda c: np.pad(c.astype(np.float32), [(0, 0)] * (c.ndim - 1) + [
                (0, -c.shape[-1] % 128)]).reshape(c.shape[:-1] + (-1, 128))
            step = (np.abs(blocks(out[f"mu/{tag}/{key}"]) - blocks(w)) * scale[..., None])
            assert (step <= scale[..., None] * 1.0001).all(), (tag, key, r)


def test_microbatched_sharded_step_matches_reference(runs):
    """The dense config's adamw step at (2, 2) in 2 microbatches: the
    port's microbatch i takes the i-th slice of every data rank's rows
    (``steps._split_sharded``), the reference's a block of global rows;
    with every token in the mean and equal microbatches the loss, the
    gradient norm and every update are the same sums, within STEP_TOL."""
    ref, ranks, inits = runs
    arch = TRAIN["dense"]
    cfg = _cfg(arch)
    tag = "dense22/adamw_mb"
    init = per_layer_arrays(cfg, _nest({k: v for k, v in inits[arch].items()
                                        if not k.startswith("batch/")}))
    want = _port_names(cfg, ref, f"step/{tag}/")
    assert want.keys() == init.keys()
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"loss/{tag}"], ref[f"loss/{tag}"], rtol=1e-5)
        np.testing.assert_allclose(out[f"gnorm/{tag}"], ref[f"gnorm/{tag}"], rtol=1e-4)
        for name, w in want.items():
            _close(out[f"step/{tag}/{name}"] - init[name], w - init[name], STEP_TOL,
                   f"{tag} {name} rank {r}")


def _xlstm_held(runs, tag):
    """The xLSTM run ``tag`` ("x" the token loop, "xf" the chunked form):
    on every rank the sharded logits and every parameter's gradient equal
    the port's replicated run's and the reference's."""
    ref, ranks, _ = runs
    cfg = _cfg(XLSTM)
    assert cfg.num_heads % XLSTM_MESH[1]          # the axis does not divide the heads
    want = _port_names(cfg, ref, f"{tag}grad/")
    for r, out in enumerate(ranks):
        got, plain = out[f"{tag}fwd/sharded"], out[f"{tag}fwd/replicated"]
        assert got.shape == ref[f"{tag}fwd"].shape and np.isfinite(got).all()
        _close(got, plain, FWD_TOL, f"{tag} logits vs replicated, rank {r}")
        _close(got, ref[f"{tag}fwd"], FWD_TOL, f"{tag} logits vs reference, rank {r}")
        prefix = f"{tag}grad/sharded/"
        assert {k[len(prefix):] for k in out if k.startswith(prefix)} == want.keys()
        for name, w in want.items():
            g = out[prefix + name]
            _close(g, out[f"{tag}grad/replicated/{name}"], GRAD_TOL,
                   f"{tag} {name} vs replicated, rank {r}")
            _close(g, w, GRAD_TOL, f"{tag} {name} vs jax.grad, rank {r}")


def test_xlstm_on_a_model_axis_that_does_not_divide_its_heads(runs):
    """The xLSTM smoke config's 2 heads on a model axis of 4: on every
    rank the sharded logits and every parameter's gradient equal the
    port's replicated run's (FWD_TOL / GRAD_TOL: DTensor sums the
    contractions in its own order) and the reference's jitted forward and
    jax.grad at the same mesh."""
    _xlstm_held(runs, "x")


def test_chunked_xlstm_on_a_model_axis_that_does_not_divide_its_heads(runs):
    """The chunked-parallel mLSTM (``xlstm-350m-smoke-fast``, two chunks
    of XLSTM_CHUNK) on the same mesh, held as the token loop is."""
    _xlstm_held(runs, "xf")


@pytest.mark.parametrize("tag", ["x", "xf"])
def test_xlstm_recurrence_is_split_along_dv(runs, tag):
    """On every rank, in both forms (the token loop "x", the chunked form
    "xf"), the mLSTM's h before the head merge (B, S, H, Dv) and the
    returned C state (pairs, B, H, Dk, Dv) are sharded along Dv over the
    model axis unflattened into (heads, Dv blocks), and not replicated:
    each rank holds one head's share of the Dv columns, all ranks of the
    model axis together every column once."""
    _, ranks, _ = runs
    cfg = _cfg(XLSTM)
    per = XLSTM_MESH[1] // cfg.num_heads          # ranks a head
    for r, out in enumerate(ranks):
        for what in ("h", "C"):
            lay = json.loads(str(out[f"{tag}layout/{what}"]))
            dv, heads = len(lay["global"]) - 1, len(lay["global"]) - 2 - (what == "C")
            assert lay["mesh"] == ["data", "model_heads", "model_dv"], (what, r, lay)
            assert lay["shard"][1:] == [heads, dv], (what, r, lay)
            assert lay["local"][dv] * per == lay["global"][dv] and lay["local"][heads] == 1, \
                (what, r, lay)


def test_xlstm_decodes_from_a_split_state(runs):
    """One decode step of the sharded token-loop model after its prefill,
    from the split state it returned, from that state whole placed by
    ``cache_placements`` and from it as plain tensors: each step's logits,
    on every rank, equal the replicated model's step from its own state
    within FWD_TOL."""
    _, ranks, _ = runs
    for r, out in enumerate(ranks):
        want = out["xdecode/replicated"]
        for how in ("split", "cache", "plain"):
            got = out[f"xdecode/{how}"]
            assert got.shape == want.shape and np.isfinite(got).all()
            _close(got, want, FWD_TOL, f"decode from the {how} state, rank {r}")


def test_one_rank_sharded_run_is_the_plain_model():
    """On ``single_device_context``'s one-rank DeviceMesh (in this
    process): the MoE smoke config's sharded forward equals the plain
    model's bit for bit, and one adamw_q8 step of ``build_train_step``
    moves every parameter as on the plain model (within GRAD_TOL: the
    backward through DTensor sums in its own order)."""
    import torch

    from repro_torch.models import build_model, transformer
    from repro_torch.models.model_zoo import batch_placements
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state_q8
    from repro_torch.parallel import single_device_context
    from repro_torch.parallel.sharding import distribute, is_dtensor
    from repro_torch.train.steps import build_train_step
    cfg = _cfg(TRAIN["moe"])
    ctx = single_device_context("cpu")
    model = build_model(cfg, ctx, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    sbatch = distribute(batch, batch_placements(ctx, batch), ctx, "cpu")
    plain, sharded = model.init(0), model.shard(model.init(0))
    assert all(is_dtensor(p) for p in sharded.parameters())
    with torch.no_grad():
        want = transformer.forward(cfg, plain, tokens, ctx=ctx)[0]
        got = transformer.forward(cfg, sharded, sbatch["tokens"], ctx=ctx)[0]
    assert is_dtensor(got)
    np.testing.assert_array_equal(got.full_tensor().numpy(), want.numpy())
    step = build_train_step(model, AdamWConfig(**OPT), optimizer="adamw_q8")
    before = {n: p.detach().clone() for n, p in plain.named_parameters()}
    plain_state, _ = step({"params": plain, "opt": init_opt_state_q8(plain)}, batch)
    sharded_state, _ = step({"params": sharded, "opt": init_opt_state_q8(sharded)}, sbatch)
    moved = dict(sharded_state["params"].named_parameters())
    for name, p in plain_state["params"].named_parameters():
        upd = (p - before[name]).detach().numpy()
        _close((moved[name].detach().full_tensor() - before[name]).numpy(), upd, STEP_TOL, name)
