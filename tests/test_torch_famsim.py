"""The port's whole simulator path against the JAX reference.

Same numpy traces, same configuration: the port's ``build_sim`` / ``sweep``
on the CPU against ``repro.core.famsim``. Counters (hit fractions,
prefetches issued, cache occupancy) must be equal; float metrics (ipc,
fam_latency, issue_rate) are held at RTOL = 1e-5, since a last-bit float
difference could flip an integer decision downstream. (They match bit for
bit today: the port mirrors XLA's sequential cumsum order.)

Also: a padded sweep over three block sizes, a mid-run hand-over (a JAX
state taken after k events is carried across with ``from_numpy`` and
both sides continue), the strict scheduler and the static adaptation
policy over the whole simulator, the event-loop runner (``GroupRunner.drive``:
windows of in-place steps, a padded last window) against JAX and against
a plain functional loop, and the golden values ``chip_smoke.py`` holds the
card's run against. Regenerate them with ``python tests/test_torch_famsim.py``.
On the CPU the runner steps through its windows; on the card it
replays them from a CUDA graph (``chip_smoke.py`` holds the two, and the
``torch`` backend, bit for bit).
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


# policy combinations beyond lru/srrip x fifo/wfq/token_bucket: (PolicySet
# fields, SimFlags fields, T, numeric overrides {kind: {param: value}});
# sample_interval 64 lets adaptation fire
POLICY_CASES = {
    "strict": (dict(scheduler="strict"), {}, 300, {}),
    "static": (dict(adaptation="static"), {}, 300, {}),
    "srrip_strict_bw_adapt_wfq": (dict(replacement="srrip", scheduler="strict"),
                                  dict(bw_adapt=True, wfq=True), 300, {}),
    "strict_t400": (dict(scheduler="strict"), {}, 400, {}),
    "static_t400": (dict(adaptation="static"), {}, 400, {}),
    "srrip_strict_bw_adapt_wfq_t400": (dict(replacement="srrip", scheduler="strict"),
                                       dict(bw_adapt=True, wfq=True), 400, {}),
    "strict_static_rate_quarter": (dict(scheduler="strict", adaptation="static"),
                                   dict(bw_adapt=True), 400,
                                   {"adaptation": {"rate": 0.25}}),
    "srrip_static_wfq_backlog_cap": (dict(replacement="srrip", adaptation="static",
                                          scheduler="wfq"), {}, 400,
                                     {"scheduler": {"backlog_cap": 400.0}}),
}


def _with_overrides(ps, overrides):
    for kind, values in overrides.items():
        ps = ps.override(kind, **values)
    return ps


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_sets_match_reference(case):
    """build_sim against the JAX sweep for the strict scheduler, the static
    adaptation policy (at its default rate and at a quarter), srrip + strict
    under bw_adapt and wfq, and srrip + static under a tight WFQ backlog
    cap."""
    fields, flag_fields, T_case, overrides = POLICY_CASES[case]
    addrs, gaps = system_traces(WL, T_case, 4)
    jcfg = JFamConfig(sample_interval=64)
    jps = _with_overrides(JPolicySet(**fields), overrides)
    jflags = jfam.SimFlags(**flag_fields)
    jp = j_stack_params([JFamParams.of(jcfg, jflags, jps)])
    jout = jfam.sweep(jcfg, jp, None, addrs[None], gaps[None], policies=jps)
    run = tfam.build_sim(FamConfig(sample_interval=64), tfam.SimFlags(**flag_fields),
                         N, policies=_with_overrides(PolicySet(**fields), overrides),
                         device="cpu")
    tout = run(addrs, gaps)
    _assert_metrics({k: np.asarray(v)[0] for k, v in jout.items()},
                    {k: v.numpy() for k, v in tout.items()}, err=case)


def _runner_inputs(cfg, flags, T, seed):
    """(runner, params, per-node params, initial carry, events) of
    build_sim's program for one system, for driving ``GroupRunner.drive``
    directly."""
    addrs, gaps = system_traces(WL, T, seed)
    p = stack_params([FamParams.of(cfg, flags, device="cpu")])
    pn = tfam._per_node(p)
    events = (torch.from_numpy(addrs[None].astype(np.int32)),
              torch.from_numpy(gaps[None]).float() / pn.cores_per_node[..., None],
              (torch.arange(T) >= int(T * 0.2))[:, None],
              torch.ones((T, 1), dtype=torch.bool))
    return tfam.GroupRunner(cfg, N), p, pn, tfam._init_carry(cfg, pn, N), events


def _event(events, i):
    addrs, gaps, warm, live = events
    return addrs[..., i], gaps[..., i], warm[i, :, None], live[i, :, None]


def test_window_runner_matches_reference(monkeypatch):
    """The runner over T = 400 in windows of 64 (the last padded with 48
    dead events) matches the JAX reference."""
    monkeypatch.setattr(tfam, "GRAPH_EVENTS", 64)
    jout = jfam.simulate(JFamConfig(), jfam.SimFlags(), WL, T, seed=0)
    runner, p, pn, carry, events = _runner_inputs(FamConfig(), tfam.SimFlags(), T, 0)
    nodes, _ = runner.drive(p, carry, *events)
    _assert_metrics(jout, {k: v[0].numpy() for k, v in tfam._metrics(nodes, pn).items()})


@pytest.mark.parametrize("window", [7, 150, 200])
def test_window_runner_equals_functional_loop(window, monkeypatch):
    """Windows of in-place steps, the last padded with dead events when
    ``window`` does not divide T, leave every carry tensor bit-identical to
    the functional loop ``carry = step(p, carry, event)``."""
    monkeypatch.setattr(tfam, "GRAPH_EVENTS", window)
    T_short = 150
    cfg = FamConfig(sample_interval=32)
    runner, p, pn, carry, events = _runner_inputs(
        cfg, tfam.SimFlags(bw_adapt=True, wfq=True), T_short, 5)
    got = runner.drive(p, carry, *events)
    for i in range(T_short):
        carry = runner.step(pn, carry, _event(events, i))
    for a, b in zip(tfam._leaves(got), tfam._leaves(carry)):
        assert torch.equal(a, b)


def test_in_place_step_keeps_storage_and_dead_events_are_no_ops():
    """The in-place step keeps every carry buffer's storage from event to
    event (what a captured graph relies on), and an event that is neither
    live nor warm (the padding) changes no carry tensor."""
    runner, _, pn, carry, events = _runner_inputs(FamConfig(), tfam.SimFlags(), 40, 6)
    buf = tfam._clone(carry)
    ptrs = [t.data_ptr() for t in tfam._leaves(buf)]
    step_ = tfam._in_place(runner.step)
    for i in range(40):
        step_(pn, buf, _event(events, i))
        assert [t.data_ptr() for t in tfam._leaves(buf)] == ptrs
    before = tfam._clone(buf)
    dead = tuple(torch.zeros_like(x) for x in _event(events, 0))
    step_(pn, buf, dead)
    for a, b in zip(tfam._leaves(buf), tfam._leaves(before)):
        assert torch.equal(a, b)


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


def test_build_sweep_matches_reference():
    """``build_sweep`` against the reference's jitted batched runner, over
    three block sizes in one padded allocation: metrics as ``sweep``'s; one
    entry a static shape, one runner a trace shape, reused by a second
    call (bit for bit the first's)."""
    blocks = (64, 256, 1024)
    addrs, gaps = system_traces(WL, 300, 2)
    A, G = np.stack([addrs] * 3), np.stack([gaps] * 3)
    jcfg = JFamConfig(dram_cache_bytes=1 << 20, block_bytes=64)
    jp = j_stack_params([JFamParams.of(j_fam_replace(jcfg, block_bytes=b))
                         for b in blocks])
    jout = jfam.build_sweep(jcfg, N)(jp, A, G)
    tcfg = FamConfig(dram_cache_bytes=1 << 20, block_bytes=64)
    tp = stack_params([FamParams.of(fam_replace(tcfg, block_bytes=b), device="cpu")
                       for b in blocks])
    run = tfam.build_sweep(tcfg, N)
    assert tfam.build_sweep(FamConfig(dram_cache_bytes=1 << 20, block_bytes=64), N) is run
    tout = run(tp, torch.from_numpy(A), torch.from_numpy(G))
    _assert_metrics(jout, {k: v.numpy() for k, v in tout.items()})
    again = run(tp, torch.from_numpy(A), torch.from_numpy(G))
    for k in tout:
        assert torch.equal(tout[k], again[k]), k


def test_masked_runner_equals_unpadded_runs():
    """Padded tail events are exact no-ops: a system simulated for t_true
    of T_pad events equals an unpadded run of t_true events."""
    T_pad, t_true = 120, (80, 120)
    addrs, gaps = system_traces(["bfs"], T_pad, 3)
    cfg = FamConfig(sample_interval=32)
    p = stack_params([FamParams.of(cfg, tfam.SimFlags(bw_adapt=True), device="cpu")] * 2)
    A, G = torch.from_numpy(np.stack([addrs] * 2)), torch.from_numpy(np.stack([gaps] * 2))
    masked = tfam.GroupRunner(cfg, 1)(
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
    p = from_numpy(with_s(jp), device="cpu")
    pn = tfam._per_node(p)
    runner = tfam.GroupRunner(FamConfig(sample_interval=64), N)
    gaps_t = torch.from_numpy(gaps[None, :, k:]).float() / pn.cores_per_node[..., None]
    tail = runner.drive(p, (nodes, torch.from_numpy(np.array(mid[1])[None])),
                        torch.from_numpy(addrs[None, :, k:].astype(np.int32)),
                        gaps_t, torch.from_numpy(warm[k:, None]),
                        torch.ones((T - k, 1), dtype=torch.bool))
    tout = tfam._metrics(tail[0], pn)
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
