"""The port's ``parallel/`` (meshes, sharding rules, int8 error-feedback
compression, the GPipe loop) and ``launch/mesh.py`` against the JAX
reference.

* ``spec_for`` / ``param_specs`` for all ten configs, their parameters
  and their int8 AdamW moments, on abstract 16 x 16, 2 x 16 x 16 and
  (2, 4) meshes: entry for entry equal to the reference's (a per-layer
  spec of the port is the reference's stacked spec without its leading
  ``"layers"`` entry); nothing is allocated (``meta`` tensors, JAX's
  ``eval_shape``);
* ``batch_specs`` / ``cache_specs`` of every config's cells on the same
  shapes as the reference's;
* ``_quantize`` codes and scales bit for bit;
* ``pipeline_forward`` at 2 and 4 stages and ``ef_compress_allreduce`` at
  4 ranks: the port's ranks run as ``gloo`` processes, one spawn per world
  size for the module, over a ``FileStore`` under ``tmp_path``; the
  reference runs once in a JAX subprocess with 4 host devices
  (``--xla_force_host_platform_device_count=4``), its results in an npz.
  Pipelines within PIPE_TOL (float32 matmuls in either library's order),
  the reduced gradient within REDUCE_TOL (the sum's order over ranks),
  the error residuals within one float32 ulp of ``g + err`` (XLA contracts
  ``x - q * s`` into a fused multiply-add; the codes are bit for bit);
* the one-rank process group of ``single_device_context`` (``out + err ==
  g``, as ``tests/test_parallel.py`` holds it; one stage == ``layer_fn``);
* the executor's sharded mode on D virtual CPU devices: rows at D 1, 2
  and 4 bit for bit equal to the reference's batched (``"vmap"``) run,
  the sharded run's ``shard_check``; ``_pad_systems`` and
  ``group_cache_keys``' lanes and mode equal to the reference's for D in
  {1, 2, 3, 4, 6, 9}.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import experiments as jx
from repro.configs.base import FamConfig as JFamConfig
from repro.configs.registry import get_config as j_get_config
from repro.core.famsim import SimFlags as JSimFlags
from repro.experiments import executor as jex
from repro.models.model_zoo import batch_specs as j_batch_specs
from repro.models.model_zoo import build_model as j_build_model
from repro.models.model_zoo import cache_specs as j_cache_specs
from repro.optim.adamw import init_opt_state_q8 as j_init_opt_state_q8
from repro.parallel import compression as JC
from repro.parallel.sharding import ParallelContext as JParallelContext
from repro.parallel.sharding import param_specs as j_param_specs
from repro_torch import experiments as tx
from repro_torch.configs.base import FamConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.experiments import executor as tex
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model_zoo import (batch_placements, batch_specs, cache_placements,
                                          cache_specs, init_params)
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import compression as TC
from repro_torch.parallel.compat import Mesh
from repro_torch.parallel.pipeline import pipeline_forward
from repro_torch.parallel.sharding import (P, ParallelContext, param_specs,
                                           single_device_context)
from repro_torch.policies import SimFlags

REPO = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
PIPE_TOL = dict(rtol=1e-5, atol=1e-6)
REDUCE_TOL = dict(rtol=1e-6, atol=1e-7)   # four float32 addends near 1: an ulp
PIPE_D, PIPE_M, PIPE_MB = 8, 5, 2
EF_N = 300                       # not a multiple of Q_BLOCK: padded blocks


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _contexts(name):
    shape, names = MESHES[name]
    jmesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    dp = ("pod", "data")
    return JParallelContext(mesh=jmesh, dp_axes=dp), ParallelContext(mesh=Mesh(shape, names),
                                                                      dp_axes=dp)


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "key", k)) for k in path)


def _ref_specs(jctx, tree):
    specs = j_param_specs(jctx, tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {_dotted(path): tuple(spec) for path, spec in flat}


def _held(port, ref):
    """Every port spec equal to the reference's: a name with a layer index
    against the stacked name's spec without its leading entry."""
    assert all(isinstance(s, P) for s in port.values())
    covered = set()
    for name, spec in port.items():
        parts = name.split(".")
        if any(p.isdigit() for p in parts):
            stacked = ".".join(p for p in parts if not p.isdigit())
            assert ref[stacked][0] is None, (stacked, ref[stacked])
            want = ref[stacked][1:]
            covered.add(stacked)
        else:
            want = ref[name]
            covered.add(name)
        assert tuple(spec) == want, (name, tuple(spec), want)
    assert covered == set(ref), sorted(set(ref) ^ covered)


@pytest.fixture(scope="module")
def abstract_params():
    """{arch: (the reference's abstract params and q8 moments, the port's
    meta module and q8 moments)}; q8 codes on ``meta`` encoded once per
    shape by the port's own encoder."""
    out, q8 = {}, {}

    def enc(p):
        key = tuple(p.shape)
        if key not in q8:
            c, s = tadamw._q8_encode(torch.zeros(key, device="meta"))
            q8[key] = {"q": c, "s": s}
        return q8[key]

    for arch in ARCH_IDS:
        jm = j_build_model(j_get_config(arch), None)
        jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        jmu = jax.eval_shape(j_init_opt_state_q8, jp)["mu"]
        module = init_params(None, get_config(arch), torch.device("meta"))
        mu = {n: enc(p) for n, p in module.named_parameters()}
        out[arch] = (jp, jmu, module, mu)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_match_reference(abstract_params, mesh):
    """All ten configs' parameters and int8 moments, entry for entry."""
    jctx, ctx = _contexts(mesh)
    assert ctx.rules == jctx.rules and ctx.dp_axes == jctx.dp_axes
    for arch, (jp, jmu, module, mu) in abstract_params.items():
        _held(param_specs(ctx, module), _ref_specs(jctx, jp))
        _held(param_specs(ctx, mu), _ref_specs(jctx, jmu))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_fallbacks_match_reference(mesh):
    """spec_for on shapes that divide, shrink a tuple rule to its prefix,
    or fall back to replication, as the reference's; placements follow the
    spec."""
    jctx, ctx = _contexts(mesh)
    cases = [((256, 64), ("batch", None)), ((2, 64), ("batch", None)),
             ((6, 8), ("batch", "kv_heads")), ((32, 8, 16), ("experts", "q_heads", "mlp")),
             ((49155, 1024), ("vocab", "param_embed")), ((7, 13), ("batch", "mlp")),
             ((3,), ("q_heads",)), ((5, 9, 11), ("layers", "batch", "kv_heads")),
             ((64, 64), ("mlp", "vocab"))]
    for shape, logical in cases:
        assert tuple(ctx.spec_for(shape, logical)) == tuple(jctx.spec_for(shape, logical))
        spec = ctx.spec_for(shape, logical)
        placements = ctx.placements_for(shape, logical)
        assert len(placements) == len(ctx.mesh.axis_names)
        for ax, pl in zip(ctx.mesh.axis_names, placements):
            on = [d for d, e in enumerate(spec)
                  if e == ax or (isinstance(e, tuple) and ax in e)]
            assert pl.is_shard(on[0]) if on else pl.is_replicate(), (shape, ax, pl)


def _meta_tree(tree):
    """A JAX ShapeDtypeStruct tree as nested dicts of meta tensors."""
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    return torch.empty(tree.shape, device="meta")


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_batch_and_cache_placements_follow_the_specs(mesh):
    """batch_placements / cache_placements of every config's cells: per
    key, one placement a mesh axis, ``Shard(d)`` exactly where the
    reference's spec puts that axis on dim d."""
    jctx, ctx = _contexts(mesh)
    for arch in ARCH_IDS:
        jm = j_build_model(j_get_config(arch), jctx)
        for shape in jm.cfg.shapes():
            for struct, jfn, fn in ((jm.batch_struct(shape), j_batch_specs, batch_placements),
                                    (jm.cache_struct(shape), j_cache_specs, cache_placements)):
                specs, _ = jax.tree_util.tree_flatten_with_path(
                    jfn(jctx, struct), is_leaf=lambda x: isinstance(x, PartitionSpec))
                got = fn(ctx, _meta_tree(struct))
                assert got.keys() == {_dotted(path) for path, _ in specs}
                for path, spec in specs:
                    for ax, pl in zip(ctx.mesh.axis_names, got[_dotted(path)]):
                        on = [d for d, e in enumerate(spec)
                              if e == ax or (isinstance(e, tuple) and ax in e)]
                        assert (pl.is_shard(on[0]) if on else pl.is_replicate()), \
                            (arch, _dotted(path), ax, pl, spec)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_batch_and_cache_specs_match_reference(mesh):
    """batch_specs / cache_specs of every config's cells (train, prefill,
    decode) on the same shapes, key for key, as the reference's."""
    jctx, ctx = _contexts(mesh)
    for arch in ARCH_IDS:
        jm = j_build_model(j_get_config(arch), jctx)
        for shape in jm.cfg.shapes():
            for struct, jfn, fn in ((jm.batch_struct(shape), j_batch_specs, batch_specs),
                                    (jm.cache_struct(shape), j_cache_specs, cache_specs)):
                want = jax.tree.map(tuple, jfn(jctx, struct),
                                    is_leaf=lambda x: isinstance(x, PartitionSpec))
                got = jax.tree.map(tuple, fn(ctx, _meta_tree(struct)),
                                   is_leaf=lambda x: isinstance(x, P))
                assert got == want, (arch, shape.name)


def test_production_mesh_refuses_without_ranks():
    for multi, msg in ((False, r"mesh \(16, 16\) needs 256 devices, found 1"),
                       (True, r"mesh \(2, 16, 16\) needs 512 devices, found 1")):
        with pytest.raises(RuntimeError, match=msg):
            tmesh.make_production_mesh(multi_pod=multi)
    host = tmesh.make_host_mesh(2, 4)
    assert host.shape == {"data": 2, "model": 4} and host.groups is None


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _quantize_inputs():
    rng = np.random.default_rng(0)
    halves = np.concatenate([[127.0], np.arange(-20.5, 20.5, 1.0),
                             np.zeros(256 - 42)]).astype(np.float32)
    return [rng.standard_normal(1000).astype(np.float32) * 3,
            rng.standard_normal((7, 300)).astype(np.float32),
            halves,                     # scale 1: codes at exact halves
            np.zeros(256, np.float32)]


def test_quantize_bit_for_bit():
    for x in _quantize_inputs():
        jq, js = JC._quantize(jnp.asarray(x))
        tq, ts = TC._quantize(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(TC.compress_decompress(torch.from_numpy(x)).numpy(),
                                      np.asarray(JC.compress_decompress(jnp.asarray(x))))


def test_one_rank_group():
    """single_device_context's one-rank gloo group: ef_compress_allreduce's
    out + err == g, a one-stage pipeline == layer_fn per microbatch."""
    ctx = single_device_context("cpu")
    assert ctx.mesh.shape == {"data": 1, "model": 1} and ctx.mesh.groups is not None
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(64).astype(np.float32))
    out, err = TC.ef_compress_allreduce(g, torch.zeros(64), ctx.mesh, "data")
    np.testing.assert_allclose((out + err).numpy(), g.numpy(), atol=1e-6)
    w, b, x = _pipe_inputs(1)
    fn = pipeline_forward(_layer, ctx.mesh, "model", 1, PIPE_M)
    p = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    got = fn(p, torch.from_numpy(x))
    want = torch.stack([_layer(p, xm) for xm in torch.from_numpy(x)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert TC.init_error({"a": g})["a"].dtype == torch.float32


# ---------------------------------------------------------------------------
# multi-rank: gloo ranks against the reference on 4 host devices
# ---------------------------------------------------------------------------

def _layer(p, h):
    return torch.tanh(h @ p["w"][0] + p["b"][0])


def _pipe_inputs(stages):
    rng = np.random.default_rng(stages)
    w = (rng.standard_normal((stages, PIPE_D, PIPE_D)) / np.sqrt(PIPE_D)).astype(np.float32)
    b = rng.standard_normal((stages, PIPE_D)).astype(np.float32) * 0.1
    x = rng.standard_normal((PIPE_M, PIPE_MB, PIPE_D)).astype(np.float32)
    return w, b, x


def _ef_inputs():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((4, EF_N)).astype(np.float32),
            rng.standard_normal((4, EF_N)).astype(np.float32) * 0.01)


REFERENCE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.parallel.compat import make_mesh, shard_map
    from repro.parallel.compression import ef_compress_allreduce
    from repro.parallel.pipeline import pipeline_forward
    inp = np.load(sys.argv[1])
    out = {}
    for S in (2, 4):
        mesh = make_mesh((S,), ("stage",), devices=jax.devices()[:S])
        fn = pipeline_forward(lambda p, h: jnp.tanh(h @ p["w"][0] + p["b"][0]),
                              mesh, "stage", S, int(inp[f"x{S}"].shape[0]))
        out[f"pipe{S}"] = np.asarray(jax.jit(fn)(
            {"w": inp[f"w{S}"], "b": inp[f"b{S}"]}, inp[f"x{S}"]))
    mesh = make_mesh((4,), ("pod",), devices=jax.devices()[:4])
    f = shard_map(lambda g, e: ef_compress_allreduce(g, e, "pod"), mesh=mesh,
                  in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")))
    red, err = jax.jit(f)(inp["g"], inp["err"])
    out["reduced"], out["new_err"] = np.asarray(red), np.asarray(err)
    np.savez(sys.argv[2], **out)
""")

PORT = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                            rank=rank, world_size=world)
    from repro_torch.parallel.compat import make_mesh
    from repro_torch.parallel.compression import ef_compress_allreduce
    from repro_torch.parallel.pipeline import pipeline_forward
    inp = np.load(sys.argv[4])
    S = world
    mesh = make_mesh((S,), ("stage",))
    fn = pipeline_forward(lambda p, h: torch.tanh(h @ p["w"][0] + p["b"][0]),
                          mesh, "stage", S, int(inp[f"x{S}"].shape[0]))
    p = {k: torch.from_numpy(inp[f"{k}{S}"][rank:rank + 1]) for k in ("w", "b")}
    out = {"pipe": fn(p, torch.from_numpy(inp[f"x{S}"])).numpy()}
    if world == 4:
        mesh = make_mesh((4,), ("pod",))
        red, err = ef_compress_allreduce(torch.from_numpy(inp["g"][rank:rank + 1]),
                                         torch.from_numpy(inp["err"][rank:rank + 1]),
                                         mesh, "pod")
        out["reduced"], out["new_err"] = red.numpy(), err.numpy()
    np.savez(sys.argv[5], **out)
    dist.destroy_process_group()
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _spawn(world, tmp: Path, inputs: Path, tag: str):
    """``world`` gloo ranks running PORT; returns each rank's outputs."""
    store = tmp / f"store_{tag}"
    outs = [tmp / f"{tag}_rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", PORT, str(r), str(world), str(store),
                               str(inputs), str(outs[r])], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = tmp / "inputs.npz"
    arrays = {}
    for S in (2, 4):
        arrays[f"w{S}"], arrays[f"b{S}"], arrays[f"x{S}"] = _pipe_inputs(S)
    arrays["g"], arrays["err"] = _ef_inputs()
    np.savez(inputs, **arrays)
    ref_out = tmp / "reference.npz"
    subprocess.run([sys.executable, "-c", REFERENCE, str(inputs), str(ref_out)], check=True,
                   timeout=300, env=_env(JAX_PLATFORMS="cpu",
                                         XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    port = {w: _spawn(w, tmp, inputs, f"w{w}") for w in (2, 4)}
    return arrays, dict(np.load(ref_out)), port


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_forward_matches_reference(multi_rank, stages):
    """Every rank returns the last stage's outputs, equal to the
    reference's shard_map pipeline and to the stages applied in turn."""
    arrays, ref, port = multi_rank
    w, b, x = (torch.from_numpy(arrays[f"{k}{stages}"]) for k in ("w", "b", "x"))
    seq = x
    for s in range(stages):
        seq = _layer({"w": w[s:s + 1], "b": b[s:s + 1]}, seq)
    for out in port[stages]:
        np.testing.assert_allclose(out["pipe"], ref[f"pipe{stages}"], **PIPE_TOL)
        np.testing.assert_allclose(out["pipe"], seq.numpy(), **PIPE_TOL)


def test_ef_compress_allreduce_four_ranks(multi_rank):
    """At 4 ranks: each rank's residual within one ulp of its g + err, the
    reduced gradient (the same on every rank) within REDUCE_TOL of the
    reference's."""
    arrays, ref, port = multi_rank
    reduced = [out["reduced"] for out in port[4]]
    for r, out in enumerate(port[4]):
        ulp = np.spacing(np.abs(arrays["g"][r] + arrays["err"][r]).max())
        np.testing.assert_allclose(out["new_err"], ref["new_err"][r:r + 1], rtol=0, atol=ulp)
        np.testing.assert_allclose(out["reduced"], ref["reduced"][r:r + 1], **REDUCE_TOL)
        np.testing.assert_array_equal(out["reduced"], reduced[0])
    want = sum(TC.compress_decompress(torch.from_numpy(arrays["g"][r] + arrays["err"][r]))
               for r in range(4)) / 4
    np.testing.assert_allclose(reduced[0][0], want.numpy(), **REDUCE_TOL)



# ---------------------------------------------------------------------------
# the executor's sharded mode ("shard", D) on D virtual CPU devices
# ---------------------------------------------------------------------------

SHARD_T = 300


def _small_experiment(mod, flags_cls, cfg_cls, kernel_backend, T=SHARD_T):
    """The reference's small experiment (tests/test_experiments.py:27-37)."""
    return mod.Experiment(
        name="small", T=T,
        base=dataclasses.replace(cfg_cls(), kernel_backend=kernel_backend),
        axes=(mod.workload_axis(["LU", "bfs"]),
              mod.flag_axis("variant", {"base": flags_cls(core_prefetch=False,
                                                          dram_prefetch=False),
                                        "dram": flags_cls()})))


@pytest.fixture(scope="module")
def sharded_runs():
    """The reference's vmap run and the port's at D 1, 2 and 4 (numpy
    traces); D 2 with the shard cross-check."""
    jres = _small_experiment(jx, JSimFlags, JFamConfig, "xla").run(trace_backend="numpy")
    texp = _small_experiment(tx, SimFlags, FamConfig, "cuda")
    return jres, {D: texp.run(trace_backend="numpy", device="cpu", devices=D,
                              cross_check_shard=D == 2, assert_compiles=True)
                  for D in (1, 2, 4)}


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_executor_rows_bit_exact(sharded_runs, D):
    """Every metric of every point bit for bit equal to the reference's
    vmap run; the mode and lanes the reference would use at D."""
    jres, runs = sharded_runs
    tres = runs[D]
    assert [p.coords for p in jres.points] == [p.coords for p in tres.points]
    for jp, tp in zip(jres.points, tres.points):
        jm, tm = jres.metrics_for(jp), tres.metrics_for(tp)
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_array_equal(np.asarray(jm[k]), tm[k], err_msg=f"{jp.coords} {k}")
    info = tres.info
    assert info.devices == D and info.compiles == 0
    assert info.groups[0]["S_exec"] % D == 0
    if D == 2:
        assert info.shard_check == {"group": 0, "primary": "('shard', 2)", "alt": "vmap",
                                    "systems": info.groups[0]["S_exec"], "bit_exact": True}


@pytest.mark.parametrize("D", [1, 2, 3, 4, 6, 9])
def test_pad_systems_and_keys_match_reference(D):
    """_pad_systems' lane counts and group_cache_keys' lanes and mode equal
    the reference's at D devices, with no device touched."""
    for n, s_pad in ((1, 4), (3, 4), (5, 5), (7, 8), (13, 14), (72, 80), (228, 240)):
        idxs = list(range(n))
        assert tex._pad_systems(idxs, s_pad, D) == jex._pad_systems(idxs, s_pad, D)
    jplan = _small_experiment(jx, JSimFlags, JFamConfig, "xla").plan()
    tplan = _small_experiment(tx, SimFlags, FamConfig, "cuda").plan()
    jkeys = jx.group_cache_keys(jplan, devices=D)
    tkeys = tx.group_cache_keys(tplan, devices=D)
    assert [(k[3], k[6]) for k in tkeys] == [(k[3], k[6]) for k in jkeys]
