"""The port's whole simulator path against the JAX reference.

Same numpy traces, same configuration: the port's ``build_sim`` / ``sweep``
on the CPU against ``repro.core.famsim``. Counters (hit fractions,
prefetches issued, cache occupancy) must be equal; float metrics (ipc,
fam_latency, issue_rate) are held at RTOL = 1e-5, since a last-bit float
difference could flip an integer decision downstream. (They match bit for
bit today: the port mirrors XLA's sequential cumsum order.)

Also: a padded sweep over three block sizes, a mid-run hand-over (a JAX
state taken after k events is carried across with ``from_numpy`` and
both sides continue), and the golden values ``chip_smoke.py`` holds the
card's run against. Regenerate them with ``python tests/test_torch_famsim.py``.
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FamConfig as JFamConfig
from repro.configs.base import fam_replace as j_fam_replace
from repro.core import famsim as jfam
from repro.core.fam_params import FamParams as JFamParams
from repro.core.fam_params import stack_params as j_stack_params
from repro.policies import PolicySet as JPolicySet
from repro.traces import system_traces
from repro_torch.configs.base import FamConfig, fam_replace
from repro_torch.core import famsim as tfam
from repro_torch.core.fam_params import FamParams, from_numpy, stack_params
from repro_torch.policies import PolicySet

N, T = 2, 400
WL = ["LU", "bfs"]
RTOL = 1e-5
COUNTERS = ("demand_hit_fraction", "corepf_hit_fraction", "prefetches_issued",
            "cache_occupancy")
FLOATS = ("ipc", "fam_latency", "issue_rate")
FLAG_SETS = {"default": {}, "bw_adapt": {"bw_adapt": True}, "wfq": {"wfq": True}}
GOLDEN = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "testdata" / "famsim_golden.json"


def _assert_metrics(jout, tout, err=""):
    assert sorted(jout) == sorted(tout) == sorted(COUNTERS + FLOATS)
    for k in COUNTERS:
        np.testing.assert_array_equal(np.asarray(jout[k]), np.asarray(tout[k]),
                                      err_msg=f"{err} {k}")
    for k in FLOATS:
        np.testing.assert_allclose(np.asarray(jout[k]), np.asarray(tout[k]),
                                   rtol=RTOL, err_msg=f"{err} {k}")


def _policies(ps_cls, replacement, flags):
    """The set ``from_flags`` would pick, with the replacement policy swapped."""
    ps = ps_cls(replacement=replacement, scheduler="wfq" if flags.wfq else "fifo")
    return ps.override("scheduler", weight=float(flags.wfq_weight))


@pytest.mark.parametrize("replacement", ["lru", "srrip"])
def test_build_sim_matches_reference(replacement):
    """build_sim under SimFlags(), bw_adapt=True and wfq=True. The JAX side
    runs the three as one batched sweep (bit-identical to its build_sim)."""
    addrs, gaps = system_traces(WL, T, 0)
    cfg = JFamConfig()
    jflags = [jfam.SimFlags(**f) for f in FLAG_SETS.values()]
    jp = j_stack_params([JFamParams.of(cfg, f, _policies(JPolicySet, replacement, f))
                         for f in jflags])
    jout = jfam.sweep(cfg, jp, None, np.stack([addrs] * 3), np.stack([gaps] * 3),
                      policies=JPolicySet(replacement=replacement))
    for i, f in enumerate(FLAG_SETS.values()):
        flags = tfam.SimFlags(**f)
        run = tfam.build_sim(FamConfig(), flags, N,
                             policies=_policies(PolicySet, replacement, flags),
                             device="cpu")
        tout = run(addrs, gaps)
        _assert_metrics({k: np.asarray(v)[i] for k, v in jout.items()},
                        {k: v.numpy() for k, v in tout.items()},
                        err=f"{replacement} {f}")


def test_padded_sweep_over_block_sizes():
    """Three block sizes (1024, 256 and 64 sets) share one padded
    allocation, each masked to its own geometry."""
    blocks = (64, 256, 1024)
    addrs, gaps = system_traces(WL, 300, 1)
    A, G = np.stack([addrs] * 3), np.stack([gaps] * 3)
    jcfg = JFamConfig(dram_cache_bytes=1 << 20, block_bytes=64)
    jp = j_stack_params([JFamParams.of(j_fam_replace(jcfg, block_bytes=b))
                         for b in blocks])
    jout = jfam.sweep(jcfg, jp, jfam.SimFlags(), A, G)
    tcfg = FamConfig(dram_cache_bytes=1 << 20, block_bytes=64)
    tp = stack_params([FamParams.of(fam_replace(tcfg, block_bytes=b), device="cpu")
                       for b in blocks])
    tout = tfam.sweep(tcfg, tp, tfam.SimFlags(), A, G, device="cpu")
    _assert_metrics(jout, {k: v.numpy() for k, v in tout.items()})
    # a donor smaller than a member's geometry is refused
    with pytest.raises(ValueError, match="num_sets"):
        tfam.sweep(fam_replace(tcfg, block_bytes=1024), tp, None, A, G,
                   device="cpu")


def test_masked_runner_equals_unpadded_runs():
    """Padded tail events are exact no-ops: a system simulated for t_true
    of T_pad events equals an unpadded run of t_true events."""
    T_pad, t_true = 120, (80, 120)
    addrs, gaps = system_traces(["bfs"], T_pad, 3)
    cfg = FamConfig(sample_interval=32)
    p = stack_params([FamParams.of(cfg, tfam.SimFlags(bw_adapt=True), device="cpu")] * 2)
    A, G = torch.from_numpy(np.stack([addrs] * 2)), torch.from_numpy(np.stack([gaps] * 2))
    masked = tfam._make_run_masked(cfg, 1)(
        p, A, G, torch.tensor(t_true), torch.tensor([int(t * 0.2) for t in t_true]))
    for s, t in enumerate(t_true):
        plain = tfam._make_run(cfg, 1)(p, A[:, :, :t], G[:, :, :t])
        for k in plain:
            assert torch.equal(masked[k][s], plain[k][s]), (t, k)


def test_mid_run_handover():
    """A JAX NodeState after k events, carried across with from_numpy
    (params too), continues on the port exactly as it does on JAX."""
    k = T // 2
    cfg = JFamConfig(sample_interval=64)        # adaptation fires mid-run
    flags = jfam.SimFlags(bw_adapt=True)
    jp = JFamParams.of(cfg, flags)
    addrs, gaps = system_traces(WL, T, 2)
    warm = np.arange(T) >= int(T * 0.2)
    xs = (addrs.T.astype(np.int32), np.asarray(jnp.asarray(gaps.T) / jp.cores_per_node),
          warm, np.ones(T, bool))
    step = jfam._make_step(cfg, N)
    run = jax.jit(lambda p, c, x: jax.lax.scan(lambda cc, i: step(p, cc, i), c, x)[0])
    mid = run(jp, jfam._init_carry(cfg, jp, N), jax.tree.map(lambda a: a[:k], xs))
    end = run(jp, mid, jax.tree.map(lambda a: a[k:], xs))
    jout = jfam._metrics(end[0], jp)

    with_s = lambda tree: jax.tree.map(lambda a: np.asarray(a)[None], tree)
    nodes = from_numpy(with_s(mid[0]), device="cpu")
    assert isinstance(nodes, tfam.NodeState)
    p = tfam._per_node(from_numpy(with_s(jp), device="cpu"))
    tstep = tfam._make_step(FamConfig(sample_interval=64), N)
    gaps_t = torch.from_numpy(gaps[None, :, k:]).float() / p.cores_per_node[..., None]
    tail = tfam.run_steps(tstep, p, (nodes, torch.from_numpy(np.array(mid[1])[None])),
                          torch.from_numpy(addrs[None, :, k:].astype(np.int32)),
                          gaps_t, torch.from_numpy(warm[k:, None]),
                          torch.ones((T - k, 1), dtype=torch.bool))
    tout = tfam._metrics(tail[0], p)
    _assert_metrics(jout, {kk: v[0].numpy() for kk, v in tout.items()})


def golden_from_jax():
    """JAX ``simulate`` metrics for the golden configuration: FamConfig()
    defaults (16 MB, 16 ways, 256 B blocks), SimFlags(), LU + bfs, T = 400,
    numpy traces from seed 0. The traces are stored beside the metrics, so
    a run elsewhere (another numpy) replays the same inputs."""
    addrs, gaps = system_traces(WL, T, 0)
    out = jfam.simulate(JFamConfig(), jfam.SimFlags(), WL, T, seed=0)
    return {"config": "FamConfig()", "flags": "SimFlags()", "workloads": WL,
            "T": T, "seed": 0, "rtol": RTOL, "counters": list(COUNTERS),
            "addrs": addrs.tolist(), "gaps": [[float(x) for x in row] for row in gaps],
            "metrics": {k: [float(x) for x in np.asarray(v)]
                        for k, v in sorted(out.items())}}


def test_golden_file_is_current():
    assert json.loads(GOLDEN.read_text()) == golden_from_jax()


def test_simulate_matches_golden():
    golden = json.loads(GOLDEN.read_text())
    want = {k: np.float32(v) for k, v in golden["metrics"].items()}
    out = tfam.simulate(FamConfig(), tfam.SimFlags(), golden["workloads"],
                        golden["T"], seed=golden["seed"], device="cpu")
    _assert_metrics(want, out)
    # the stored traces replay to the same metrics (what chip_smoke.py runs)
    run = tfam.build_sim(FamConfig(), tfam.SimFlags(), N, device="cpu")
    out = run(np.asarray(golden["addrs"], np.int64),
              np.asarray(golden["gaps"], np.float32))
    _assert_metrics(want, {k: v.numpy() for k, v in out.items()})


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(golden_from_jax(), indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
