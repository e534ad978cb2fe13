"""The port's experiment API (``repro_torch.experiments``) against
``repro.experiments`` on the CPU.

* Plans: the port's ``plan()`` of fig08, fig14 and fig16 (quick and full)
  equals the reference's — groups, indices, padded geometry, ``t_pad``,
  ``s_pad`` and ``describe()`` — modulo the kernel-backend entry of the
  compile key (``"cuda"`` in the port where the reference says ``"xla"``).
  ``t_bucket`` / ``s_bucket`` equal the reference's and never truncate.
* Execution: ``execute`` with numpy traces equals the reference's
  ``execute`` bit for bit, on the reference's small experiment (LU/bfs x
  base/dram, T 900, ``tests/test_experiments.py``), on a mixed-T group and
  on a group whose system axis is padded; the seed threads through to the
  traces; with device traces the metrics stay within DEVICE_RTOL of the
  reference's and no trace is generated on the host.
* The runner cache: the same plan twice hits the cache for every group
  with bit-equal rows; a plan of the same runner keys with other traced
  params (WFQ weight, backlog cap, ``bw_adapt``, the token bucket's rates),
  with telemetry off and on, replays the cached runner with rows bit-equal
  to a run after the cache is emptied; another S or ``t_pad`` is a miss.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from repro import experiments as jx  # noqa: E402
from repro.configs.base import FamConfig as JFamConfig  # noqa: E402
from repro.core.famsim import SimFlags as JSimFlags  # noqa: E402
from repro_torch import experiments as tx  # noqa: E402
from repro_torch.configs.base import FamConfig  # noqa: E402
from repro_torch.core import famsim as tfam  # noqa: E402
from repro_torch.policies import PolicySet, SimFlags  # noqa: E402
from repro_torch.traces import node_seed, system_traces  # noqa: E402

T = 900
#: device-backend metrics vs the reference's: the port's zipf-tail ranks
#: and gaps follow torch's float32 log/exp/erfinv, not XLA's (see
#: tests/test_torch_trace_device.py); measured here at most 1.9e-2
#: (prefetches_issued), 1.6e-2 (cache_occupancy), 2.2e-3 (ipc)
DEVICE_RTOL = 5e-2
KERNEL_TAG = 9      # index of kernel_backend in geometry_free_shape()


def _flags(mod_flags):
    return {"base": mod_flags(core_prefetch=False, dram_prefetch=False),
            "dram": mod_flags()}


def _small(mod, flags_cls, cfg_cls, kernel_backend, **kw):
    """The reference's small experiment (tests/test_experiments.py:27-37),
    its axes or others given by ``kw``."""
    axes = kw.pop("axes", None) or (
        mod.workload_axis(["LU", "bfs"]),
        mod.flag_axis("variant", _flags(flags_cls)))
    return mod.Experiment(name="small", T=kw.pop("T", T),
                          base=dataclasses.replace(cfg_cls(), kernel_backend=kernel_backend),
                          axes=axes, **kw)


def _pair(**kw):
    """(reference experiment, port experiment) from one axis recipe."""
    recipe = kw.pop("recipe", None)
    j_kw, t_kw = dict(kw), dict(kw)
    if recipe is not None:
        j_kw["axes"], t_kw["axes"] = recipe(jx, JSimFlags), recipe(tx, SimFlags)
    return (_small(jx, JSimFlags, JFamConfig, "xla", **j_kw),
            _small(tx, SimFlags, FamConfig, "cuda", **t_kw))


def _strip(shape):
    return shape[:2 + KERNEL_TAG] + shape[3 + KERNEL_TAG:]


def _assert_plans_equal(jplan, tplan):
    assert tplan.num_groups == jplan.num_groups
    for jg, tg in zip(jplan.groups, tplan.groups):
        assert (tg.indices, tg.t_pad, tg.s_pad, tg.pad_sets, tg.pad_ways) == \
            (jg.indices, jg.t_pad, jg.s_pad, jg.pad_sets, jg.pad_ways)
        assert tg.key.static_shape[2 + KERNEL_TAG] == "cuda"
        assert jg.key.static_shape[2 + KERNEL_TAG] == "xla"
        assert _strip(tg.key.static_shape) == _strip(jg.key.static_shape)
        assert (tg.key.num_nodes, tg.key.t_bucket) == (jg.key.num_nodes, jg.key.t_bucket)
    jd, td = jplan.describe(), tplan.describe()
    for a, b in zip(jd, td):
        a, b = dict(a), dict(b)
        assert a.pop("static_shape").replace("'xla'", "'cuda'") == b.pop("static_shape")
        assert a == b
    assert (tplan.events(), tplan.padded_events(), tplan.padded_systems()) == \
        (jplan.events(), jplan.padded_events(), jplan.padded_systems())


#: compile groups of each figure's grid: one, or one per node count
FIGURE_GROUPS = {"fig08_blocksize": 1, "fig14_mixes": 1, "fig16_cachesize": 1,
                 "fig10_bw_adaptation": 3, "fig12_wfq": 2, "fig15_allocation": 1}


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("fig", list(FIGURE_GROUPS))
def test_figure_plans_equal_reference(fig, quick):
    import importlib
    ref = importlib.import_module(f"benchmarks.{fig}")
    port = importlib.import_module(f"repro_torch.benchmarks.{fig}")
    for backend in ("device", "numpy"):
        jplan = ref.experiment(quick=quick, trace_backend=backend).plan()
        tplan = port.experiment(quick=quick, trace_backend=backend).plan()
        assert tplan.num_groups == FIGURE_GROUPS[fig] and tplan.trace_backend == backend
        assert [p.coords for p in tplan.points] == [p.coords for p in jplan.points]
        _assert_plans_equal(jplan, tplan)


def _matrix_pair(specs):
    """(reference, port) fig12 policy experiments over the combos ``specs``
    name, through each side's ``policy_combos``."""
    from benchmarks import fig12_wfq as ref12
    from benchmarks.run import policy_combos as jcombos
    from repro_torch.benchmarks import fig12_wfq as port12
    from repro_torch.benchmarks.run import policy_combos as tcombos

    def error(msg):
        raise ValueError(msg)
    return (ref12.policy_experiment(jcombos(specs, error), quick=True),
            port12.policy_experiment(tcombos(specs, error), quick=True))


@pytest.mark.parametrize("specs,groups", [
    (["scheduler=fifo,wfq,strict", "prefetch=spp,nextline,bestoffset"], 12),
    (["replacement=lru,random,srrip", "adaptation=token_bucket,static"], 12),
    (["scheduler=fifo,wfq"], 2),
])
def test_policy_matrix_plans_equal_reference(specs, groups):
    """fig12's policy matrix plans into the reference's compile groups: one
    per node count and set of compile tags (fifo and wfq share one)."""
    jexp, texp = _matrix_pair(specs)
    jplan, tplan = jexp.plan(), texp.plan()
    assert [p.coords for p in tplan.points] == [p.coords for p in jplan.points]
    assert [p.policy_set().describe() for p in tplan.points] == \
        [p.policy_set().describe() for p in jplan.points]
    _assert_plans_equal(jplan, tplan)
    assert tplan.num_groups == groups


def test_bench_quick_grid_digests_and_rows(tmp_path, capsys):
    """``bench --quick`` on the CPU: the quick grid (2 block sizes x 2
    workloads x {base, dram} at T 400, one group), both backends' digests
    equal (both run the plain cache step on CPU tensors), best-of run_s
    over the repeats; rows and the trajectory only under ``--out``, the
    trajectory appended on a second call."""
    from repro_torch.benchmarks import bench_famsim as bench
    from repro_torch.benchmarks import run as run_cli
    plan = bench._experiment("cuda", quick=True).plan()
    assert plan.num_groups == 1 and plan.num_points == 8
    assert {p.T for p in plan.points} == {bench.QUICK_T}
    assert [p.coords for p in plan.points][:2] == [
        (("block", "256"), ("workload", "603.bwaves_s"), ("variant", "base")),
        (("block", "256"), ("workload", "603.bwaves_s"), ("variant", "dram"))]
    before = set(REPO.iterdir())
    rows = bench.main(["--quick", "--repeats", "2", "--device", "cpu"])
    assert set(REPO.iterdir()) == before and not list(tmp_path.iterdir())
    assert [r["name"] for r in rows] == ["bench_famsim_cuda", "bench_famsim_torch"]
    assert rows[0]["digest"] == rows[1]["digest"]
    assert rows[0]["derived"] == rows[1]["derived"] == \
        f"digest={rows[0]['digest']};events={8 * bench.QUICK_T}"
    for r in rows:
        assert len(r["run_s_all"]) == 2 and r["run_s_best"] == min(r["run_s_all"])
        assert r["planned_groups"] == 1 and r["compile_s"] == 0.0   # no capture on the CPU
    run_cli.main(["bench", "--quick", "--repeats", "1", "--device", "cpu",
                  "--kernel-backend", "torch", "--out", str(tmp_path)])
    run_cli.main(["bench", "--quick", "--repeats", "1", "--device", "cpu",
                  "--kernel-backend", "torch", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"\"digest={rows[0]['digest']};events=3200\"" in out
    saved = json.loads((tmp_path / "bench_famsim.json").read_text())
    assert [r["name"] for r in saved] == ["bench_famsim_torch"]
    traj = json.loads((tmp_path / bench.TRAJECTORY).read_text())
    assert traj["schema"] == bench.SCHEMA and len(traj["runs"]) == 2
    assert all(r["quick"] and r["digest"] == rows[0]["digest"] for r in traj["runs"])


def test_buckets_equal_reference():
    for n in list(range(1, 300)) + [1023, 1024, 1025, 12_000, 16_000, 100_001]:
        assert tx.t_bucket(n) == jx.t_bucket(n) >= n
        assert tx.t_bucket(n) <= max(1024, 1.5 * n)
        assert tx.s_bucket(n) == jx.s_bucket(n) >= n
        assert tx.s_bucket(n) <= max(4, 1.25 * n)
    for bad in (0, -3):
        with pytest.raises(ValueError):
            tx.t_bucket(bad)
        with pytest.raises(ValueError):
            tx.s_bucket(bad)


def test_mixed_policies_split_groups_as_reference():
    """Policy choice splits a group where its compile tag differs (strict,
    srrip, static), and fifo/wfq share one, as in the reference."""
    def recipe(mod, flags_cls):
        pset = mod.PolicySet
        return (mod.workload_axis(["LU"]),
                mod.policy_axis({"fifo": pset(), "wfq": pset(scheduler="wfq"),
                                 "strict": pset(scheduler="strict"),
                                 "srrip": pset(replacement="srrip"),
                                 "static": pset(adaptation="static")}))
    jexp, texp = _pair(recipe=recipe)
    _assert_plans_equal(jexp.plan(), texp.plan())
    assert texp.plan().num_groups == 4
    assert PolicySet(scheduler="wfq").compile_tags() == \
        ("prefetch:spp", "scheduler:chain", "replacement:lru", "adaptation:throttle")


def _assert_results_equal(jres, tres):
    assert [p.coords for p in jres.points] == [p.coords for p in tres.points]
    for jp, tp in zip(jres.points, tres.points):
        jm, tm = jres.metrics_for(jp), tres.metrics_for(tp)
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_array_equal(np.asarray(jm[k]), tm[k],
                                          err_msg=f"{jp.coords} {k}")


@pytest.fixture(scope="module")
def small_results():
    jexp, texp = _pair()
    from repro_torch.experiments import executor
    executor._TRACE_CACHE.clear()
    return (jexp.run(trace_backend="numpy", cross_check_shard=True),
            texp.run(trace_backend="numpy", device="cpu", cross_check_shard=True,
                     cross_check_eager=True, assert_compiles=True))


def test_execute_numpy_bit_exact(small_results):
    jres, tres = small_results
    _assert_results_equal(jres, tres)
    info = tres.info
    assert (info.planned_groups, info.compiles, info.xla_compiles) == (1, 0, -1)
    assert info.systems == 4 and info.events == 4 * T
    # two traces generated (LU, bfs); the base and dram variants share them
    assert info.host_trace_events == 2 * T
    # the reference's record of its shard check, key for key
    assert info.shard_check == jres.info.shard_check == {
        "group": 0, "primary": "vmap", "alt": "('shard', 1)", "systems": 4,
        "bit_exact": True}
    assert info.eager_check == {"group": 0, "primary": "steps", "alt": "eager",
                                "systems": 4, "bit_exact": True}
    assert info.spans is None
    assert info.as_dict()["groups"][0]["launches"] == 0     # CPU: plain version


def test_result_lookup(small_results):
    _, tres = small_results
    m = tres.get(workload="bfs", variant="dram")
    assert m is tres.metrics_for(tres.points[3])
    assert set(m) >= {"ipc", "fam_latency", "cache_occupancy"} and m["ipc"].shape == (1,)
    assert tres.t_pad_for(tres.points[0]) == T
    with pytest.raises(KeyError, match="axes present"):
        tres.get(workload="bfs")
    with pytest.raises(KeyError):
        tres.get(workload="mg", variant="dram")


def test_execute_mixed_T_group_bit_exact():
    """Two true lengths in one T bucket run as one group at t_pad, the
    shorter one masked: equal to the reference's masked run."""
    def recipe(mod, flags_cls):
        return (mod.grid_axis("len", {"short": {"T": 500}, "long": {"T": 700}}),
                mod.workload_axis(["LU", "bfs"]))
    jexp, texp = _pair(recipe=recipe)
    tplan = texp.plan()
    assert tplan.num_groups == 1 and tplan.groups[0].t_pad == 700
    jres = jexp.run(trace_backend="numpy")
    tres = texp.run(trace_backend="numpy", device="cpu")
    _assert_results_equal(jres, tres)
    assert tres.info.padded_events == 2 * 200


def test_execute_padded_systems_bit_exact():
    """Nine systems pad to the canonical width 10 (``s_bucket(9)``): the
    padded system is dropped, the rest equal the reference's."""
    def recipe(mod, flags_cls):
        return (mod.workload_axis(["LU", "bfs", "mg"]),
                mod.flag_axis("variant", {**_flags(flags_cls),
                                          "adapt": flags_cls(bw_adapt=True)}))
    jexp, texp = _pair(recipe=recipe, T=300)
    tplan = texp.plan()
    assert tplan.groups[0].s_pad == 10 and tplan.padded_systems() == 1
    jres = jexp.run(trace_backend="numpy")
    tres = texp.run(trace_backend="numpy", device="cpu")
    _assert_results_equal(jres, tres)
    assert tres.info.padded_systems == 1 and tres.info.groups[0]["S_exec"] == 10


def test_seed_threads_through_to_traces():
    """Points differing only in seed simulate different traces: each equals
    build_sim on the numpy traces of node_seed(seed, node)."""
    def recipe(mod, flags_cls):
        return (mod.seed_axis([0, 5]),)
    _, texp = _pair(recipe=recipe, T=300, workloads=("LU", "bfs"))
    res = texp.run(trace_backend="numpy", device="cpu")
    a, b = res.get(seed=0), res.get(seed=5)
    assert not np.array_equal(a["fam_latency"], b["fam_latency"])
    for seed in (0, 5):
        addrs, gaps = system_traces(["LU", "bfs"], 300, seed)
        assert node_seed(seed, 1) != node_seed(seed, 0)
        want = tfam.build_sim(texp.base, texp.flags, 2, device="cpu")(addrs, gaps)
        for k, v in want.items():
            np.testing.assert_array_equal(v.numpy(), res.get(seed=seed)[k])


def test_execute_device_backend_within_tolerance():
    """Device traces: generated on the executing device at t_pad (none on
    the host), the metrics within DEVICE_RTOL of the reference's."""
    def recipe(mod, flags_cls):
        return (mod.workload_axis(["XSBench", "cc"]),
                mod.flag_axis("variant", _flags(flags_cls)))
    jexp, texp = _pair(recipe=recipe)
    jres = jexp.run(trace_backend="device")
    tres = texp.run(trace_backend="device", device="cpu")
    assert tres.info.host_trace_events == 0 and tres.info.trace_backend == "device"
    assert tres.info.trace_device_s > 0
    for jp, tp in zip(jres.points, tres.points):
        for k, v in jres.metrics_for(jp).items():
            np.testing.assert_allclose(tres.metrics_for(tp)[k], np.asarray(v),
                                       rtol=DEVICE_RTOL, atol=0, err_msg=f"{jp.coords} {k}")


def test_execute_refuses_what_is_not_ported():
    _, texp = _pair()
    # sharding over devices is ported (tests/test_torch_parallel.py runs
    # it); a count below one is refused
    assert tx.group_cache_keys(texp.plan(), devices=2)[0][6] == ("shard", 2)
    with pytest.raises(ValueError, match="at least one"):
        texp.run(devices=0, device="cpu")
    with pytest.raises(ValueError, match="unknown trace backend"):
        texp.run(trace_backend="pcg", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            texp.run()
    keys = tx.group_cache_keys(texp.plan())
    assert len(keys) == 1 and keys[0][6] == "vmap"


def test_cli_plan_equals_reference(capsys):
    """``python -m repro_torch.benchmarks.run --plan`` prints the
    reference's ``--plan`` lines for every figure, and for fig12's policy
    matrix under ``--policies``, modulo the kernel tag."""
    from benchmarks.run import main as jmain
    from repro_torch.benchmarks.run import main as tmain
    jmain(["--plan"])
    want = capsys.readouterr().out.replace("'xla'", "'cuda'")
    tmain(["--plan"])
    assert capsys.readouterr().out == want
    tmain(["--plan", "--only", "fig14", "--full"])
    assert capsys.readouterr().out.startswith("fig14_mixes: 1 group(s), 42 points")
    matrix = ["--plan", "--policies", "scheduler=fifo,wfq,strict",
              "--policies", "prefetch=spp,nextline,bestoffset", "fig12"]
    jmain(matrix)
    want = capsys.readouterr().out.replace("'xla'", "'cuda'")
    tmain(matrix)
    assert capsys.readouterr().out == want
    assert want.startswith("fig12_wfq_policies: 12 group(s), 108 points")
    with pytest.raises(SystemExit):
        tmain(["--plan", "--policies", "prefetch=spp,nextline", "fig15"])
    assert "not supported by ['fig15']" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the runner cache
# ---------------------------------------------------------------------------

CACHE_T = 300
#: two candidate grids of one runner key, their traced params apart
CACHE_A = {"a": {"policies": PolicySet(scheduler="wfq").override("scheduler", weight=2.0)},
           "b": {"flags": SimFlags(bw_adapt=True)},
           "c": {}}
CACHE_B = {"a": {"policies": PolicySet(scheduler="wfq").override(
                 "scheduler", weight=0.7, backlog_cap=800.0)},
           "b": {"policies": PolicySet().override("adaptation", mimd_increase=1.3,
                                                  min_issue_rate=0.3)},
           "c": {"flags": SimFlags(bw_adapt=True),
                 "policies": PolicySet(scheduler="wfq").override("adaptation", ema_alpha=0.5)}}


def _cache_plan(values, telemetry=0, T=CACHE_T):
    """The candidates over one 2-node mix, numpy traces."""
    return tx.Experiment(name="cache", T=T, base=FamConfig(telemetry=telemetry),
                         trace_backend="numpy",
                         axes=(tx.grid_axis("candidate", values),
                               tx.mix_axis({"m1": ["LU", "bfs"]}))).plan()


def _assert_bit_equal(a, b):
    for pa, pb in zip(a.points, b.points):
        ma, mb = a.metrics_for(pa), b.metrics_for(pb)
        assert ma.keys() == mb.keys()
        for k in ma:
            assert np.array_equal(ma[k], mb[k]), (pa.coords, k)


def test_runner_cache_same_plan_twice():
    tx.executor._clear_exec_cache()
    plan = _cache_plan(CACHE_A)
    n = plan.num_groups
    first = tx.execute(plan, device="cpu", assert_compiles=True)
    second = tx.execute(plan, device="cpu", assert_compiles=True)
    i1, i2 = first.info, second.info
    assert (i1.exec_cache_misses, i1.exec_cache_hits, i1.groups_reused) == (n, 0, 0)
    assert (i2.exec_cache_hits, i2.groups_reused, i2.exec_cache_misses, i2.compiles) == \
        (n, n, 0, 0)
    assert [g["exec_cache_hit"] for g in i2.groups] == [True] * n
    assert i2.as_dict()["exec_cache_hits"] == n
    _assert_bit_equal(first, second)
    assert tx.executor.exec_cache_bytes() > 0


@pytest.mark.parametrize("telemetry", [0, 8])
def test_runner_cache_replays_other_traced_params(telemetry):
    """A cached runner refilled with another plan's params, carry and
    events gives the rows of a fresh runner, bit for bit."""
    plan_a, plan_b = _cache_plan(CACHE_A, telemetry), _cache_plan(CACHE_B, telemetry)
    assert tx.group_cache_keys(plan_a) == tx.group_cache_keys(plan_b)
    tx.executor._clear_exec_cache()
    a = tx.execute(plan_a, device="cpu", assert_compiles=True)
    cached = tx.execute(plan_b, device="cpu", assert_compiles=True)
    assert cached.info.exec_cache_hits == cached.info.groups_reused == plan_b.num_groups
    tx.executor._clear_exec_cache()
    fresh = tx.execute(plan_b, device="cpu", assert_compiles=True)
    assert fresh.info.exec_cache_misses == plan_b.num_groups
    _assert_bit_equal(cached, fresh)
    # the params moved the rows: the test would see a carry or param left over
    assert any(not np.array_equal(a.metrics_for(pa)[k], cached.metrics_for(pb)[k])
               for pa, pb in zip(a.points, cached.points) for k in ("ipc", "issue_rate"))
    if telemetry:
        assert cached.metrics_for(cached.points[0])["telemetry"].shape[0] == telemetry


def test_runner_cache_misses_on_another_key():
    tx.executor._clear_exec_cache()
    base = _cache_plan(CACHE_A)
    tx.execute(base, device="cpu")
    wider = _cache_plan({**CACHE_A, "d": {}, "e": {}})          # S 3 -> 5
    longer = _cache_plan(CACHE_A, T=2 * CACHE_T)                  # another t_pad
    for plan in (wider, longer):
        assert tx.group_cache_keys(plan) != tx.group_cache_keys(base)
        info = tx.execute(plan, device="cpu", assert_compiles=True).info
        assert (info.exec_cache_misses, info.exec_cache_hits, info.groups_reused) == (1, 0, 0)
