"""The port's tenants package (``repro_torch.tenants``) and the Pond fleet
driver (``repro_torch.benchmarks.fig_pond``) against ``repro.tenants`` on
the CPU, and the golden values the card is held to.

* ``make_tenants``, ``admit`` and the lowering's cell dict equal JAX's
  (policy sets compared by compile tags and params); every fleet, whatever
  its admission, plans into one group.
* ``t_live``: a lifetime-gated point equals a shorter run bit for bit, a
  ``t_live`` of 0 is inert, and LU / bfs x {full, 350, 120} at T 500 on
  numpy traces equals JAX's executor bit for bit (1,940 events, 1,060
  padded).
* ``fleet_report`` at small fleets (tenant counts {4, 8}, T 160) gives
  JAX's summaries and records (numpy traces: exact), with the schema
  complete; ``fig_pond.main`` at that size writes its rows under
  ``--out`` only.
* The golden file ``src/repro_torch/testdata/obs_tenants_golden.json``
  holds JAX's fig12 quick grid at T 2,000 with 8 telemetry windows
  (numpy traces: rows with their ``windowed_tail``, every point's metrics
  and windows) and the quick Pond sweep's fleet summaries and tenant
  records on numpy and on device traces; ``pond_numpy_traces.npz`` the
  distinct numpy traces of the Pond fleets (numpy's ``Generator.zipf``
  differs across releases). ``chip_smoke.py`` holds the card against
  them. Regenerate both with ``python tests/test_torch_tenants.py``
  (through ``repro.tenants.lower_fleets`` and ``Experiment.run``, never
  the reference driver's ``run()``, which rewrites ``results/``).
  Tier-1 checks their keys and rebuilds small entries only.
* ``python tests/test_torch_tenants.py --compare-device`` runs the port's
  quick Pond sweep on device traces on the CPU against the golden and
  prints the largest differences, measured as ``chip_smoke.py`` measures
  the card's: the tolerance the card's device-trace run is held to
  (``chip_smoke.POND_BUCKETS``, ``POND_LOG_SLOWDOWN``) was set from it.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from repro import experiments as jx  # noqa: E402
from repro import tenants as jt  # noqa: E402
from repro.configs.base import FamConfig as JFamConfig  # noqa: E402
from repro_torch import experiments as tx  # noqa: E402
from repro_torch import tenants as tt  # noqa: E402
from repro_torch.benchmarks import fig_pond  # noqa: E402
from repro_torch.configs.base import FamConfig  # noqa: E402
from repro_torch.obs.telemetry import N_COUNTERS  # noqa: E402

GOLDEN = REPO / "src" / "repro_torch" / "testdata" / "obs_tenants_golden.json"
POND_TRACES = GOLDEN.with_name("pond_numpy_traces.npz")
#: fig12's telemetry golden: the quick grid at TELE_T, numpy traces
TELE_T = 2_000
TELE_WINDOWS = 8
#: small fleets for the CPU tests
SMALL_COUNTS = (4, 8)
SMALL_T = 160
SMALL_WORKLOADS = ["LU", "bfs", "mg"]


def test_obs_and_tenants_import_nothing_of_jax():
    """The new packages and their entry points load without jax or the
    JAX package (the source grep in test_torch_core.py covers them too)."""
    code = ("import sys, repro_torch.obs, repro_torch.obs.__main__, repro_torch.tenants, "
            "repro_torch.benchmarks.fig_pond, repro_torch.benchmarks.run; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=str(REPO / "src")))


# ---------------------------------------------------------------------------
# specs, admission, lowering
# ---------------------------------------------------------------------------

def _fleets(fleet_cls, make, counts=SMALL_COUNTS, workloads=SMALL_WORKLOADS,
            admissions=("none", "cap", "load_shed"), **kw):
    return [fleet_cls(name=f"c{c}_{skew}_{adm}",
                      tenants=make(c, skew=skew, workloads=workloads),
                      admission=adm, max_tenants=c // 2, **kw)
            for c in counts for skew in ("uniform", "zipf") for adm in admissions]


def _as_dict(x):
    return dataclasses.asdict(x)


@pytest.mark.parametrize("skew", ["uniform", "zipf"])
def test_make_tenants_equal(skew):
    for count in (1, 5, 40):
        for wls in (None, SMALL_WORKLOADS):
            a = jt.make_tenants(count, skew=skew, workloads=wls)
            b = tt.make_tenants(count, skew=skew, workloads=wls)
            assert [_as_dict(x) for x in a] == [_as_dict(x) for x in b]
            assert [x.trace_seed for x in a] == [x.trace_seed for x in b]
    assert jt.tenant_seed("LU", 2.0, 0.5) == tt.tenant_seed("LU", 2.0, 0.5)
    for w in (0.5, 1.0, 2.0, 4.0, 8.0):
        assert jt.qos_for_weight(w) == tt.qos_for_weight(w)


def test_spec_validation_equal():
    for kw in ({"workload": "nope"}, {"workload": "LU", "weight": 0.0},
               {"workload": "LU", "rate": 1.5}, {"workload": "LU", "slo_latency": 0}):
        with pytest.raises(ValueError) as je:
            jt.TenantSpec(name="x", **kw)
        with pytest.raises(ValueError) as te:
            tt.TenantSpec(name="x", **kw)
        assert str(je.value).replace("repro.", "repro_torch.") == str(te.value)
    with pytest.raises(ValueError, match="duplicate"):
        tt.FleetSpec(name="f", tenants=tt.make_tenants(2) * 2)
    with pytest.raises(ValueError, match="unknown weight skew"):
        tt.make_tenants(2, skew="pareto")


@pytest.mark.parametrize("admission", ["none", "cap", "load_shed"])
def test_admission_and_contention_equal(admission):
    """Live fractions, offered loads and the contention model's floats
    equal JAX's exactly (Python floats in the same operation order)."""
    for scale in (0.25, 1.0, 32.0):
        jf = _fleets(jt.FleetSpec, jt.make_tenants, counts=(8, 24), workloads=None,
                     admissions=(admission,), pool_bw_scale=scale)
        tf = _fleets(tt.FleetSpec, tt.make_tenants, counts=(8, 24), workloads=None,
                     admissions=(admission,), pool_bw_scale=scale)
        for a, b in zip(jf, tf):
            ca, cb = jt.contention(a, JFamConfig()), tt.contention(b, FamConfig())
            assert _as_dict(ca) == _as_dict(cb)
            assert jt.priority_order(a) == tt.priority_order(b)
            assert jt.cache_slice_bytes(a, JFamConfig()) == \
                tt.cache_slice_bytes(b, FamConfig())
    bad = tt.FleetSpec(name="f", tenants=tt.make_tenants(2), admission="lottery")
    with pytest.raises(ValueError, match="unknown admission"):
        tt.admit(bad, [1.0, 1.0], 10.0)


def _policy_key(ps):
    return (ps.describe(), ps.compile_tags(), ps.overrides)


def test_lowering_cells_equal():
    """The lowering's cell dict (labels, workloads, seeds, t_live, config
    values and per-tenant policy sets) and join metadata equal JAX's."""
    jf = _fleets(jt.FleetSpec, jt.make_tenants, pool_bw_scale=0.5)
    tf = _fleets(tt.FleetSpec, tt.make_tenants, pool_bw_scale=0.5)
    base_j, base_t = jt.lower.ensure_telemetry(None), tt.lower.ensure_telemetry(None)
    assert base_t.telemetry == base_j.telemetry == tt.lower.DEFAULT_WINDOWS
    jv, jc, ji = jt.fleet_axis_cells(jf, base_j, T=SMALL_T)
    tv, tc, ti = tt.fleet_axis_cells(tf, base_t, T=SMALL_T)
    assert list(jv) == list(tv) and ji == ti
    for label in jv:
        a, b = dict(jv[label]), dict(tv[label])
        pa, pb = a.pop("policies"), b.pop("policies")
        assert a == b, label
        assert _policy_key(pa) == _policy_key(pb), label
    for a, b in zip(jc, tc):
        da, db = _as_dict(a), _as_dict(b)
        assert da == db
    # the experiment resolves into the same points, one group
    jl = jt.lower_fleets(jf, T=SMALL_T, trace_backend="numpy")
    tl = tt.lower_fleets(tf, T=SMALL_T, trace_backend="numpy")
    jp, tp = jl.experiment.points(), tl.experiment.points()
    assert [(p.coords, p.workloads, p.seed, p.t_true) for p in jp] == \
        [(p.coords, p.workloads, p.seed, p.t_true) for p in tp]
    assert tl.experiment.plan().num_groups == 1


def test_one_group_whatever_the_admission():
    """Admission only moves per-system values: fleets that differ in their
    admission mechanism alone plan into identical compile groups."""
    keys = []
    for adm in ("none", "cap", "load_shed"):
        fl = _fleets(tt.FleetSpec, tt.make_tenants, admissions=(adm,))
        plan = tt.lower_fleets(fl, T=SMALL_T).experiment.plan()
        assert plan.num_groups == 1
        keys.append(tx.group_cache_keys(plan))
    assert keys[0] == keys[1] == keys[2]


# ---------------------------------------------------------------------------
# lifetimes
# ---------------------------------------------------------------------------

def _t_live_experiment(mod, cfg, T, lives, workloads=("LU", "bfs")):
    cells = {}
    for w in workloads:
        for life in lives:
            cells[f"{w}/{life}"] = {"workload": w, "t_live": life}
    return mod.Experiment(name="t_live", T=T, base=cfg,
                          axes=(mod.grid_axis("cell", cells),),
                          trace_backend="numpy")


@pytest.fixture(scope="module")
def t_live_runs():
    """LU / bfs x {full, 350, 120} at T 500, numpy traces: the port's and
    JAX's executor."""
    lives = [None, 350, 120]
    j = _t_live_experiment(jx, JFamConfig(), 500, lives).run()
    t = _t_live_experiment(tx, FamConfig(), 500, lives).run(device="cpu")
    return j, t


def test_t_live_equals_jax_bit_for_bit(t_live_runs):
    j, t = t_live_runs
    assert j.info.events == t.info.events == 1940
    assert j.info.padded_events == t.info.padded_events == 1060
    assert t.info.planned_groups == 1
    for pj, pt in zip(j.points, t.points):
        mj, mt = j.metrics_for(pj), t.metrics_for(pt)
        assert sorted(mj) == sorted(mt)
        for k in mj:
            np.testing.assert_array_equal(np.asarray(mj[k]), mt[k], err_msg=f"{pt.coords} {k}")


def test_t_live_equals_a_shorter_run():
    """T 512 gated to t_live 256 is bit-identical, every metric and the
    telemetry windows, to a plain T 256 point of the same group (same
    t_pad, same device-generated trace prefix, same warm-up)."""
    exp = tx.Experiment(
        name="tlive", workloads=("LU",), trace_backend="device",
        base=dataclasses.replace(FamConfig(), telemetry=4),
        axes=(tx.grid_axis("cell", {"short": {"T": 256},
                                    "gated": {"T": 512, "t_live": 256}}),))
    assert exp.plan().num_groups == 1
    res = exp.run(device="cpu")
    short, gated = res.get(cell="short"), res.get(cell="gated")
    assert set(short) == set(gated)
    for k in short:
        np.testing.assert_array_equal(short[k], gated[k], err_msg=k)


def test_t_live_zero_is_inert():
    """A never-admitted lane (t_live 0) runs no live step: its counters
    stay zero, its telemetry windows are all zero, and its neighbours'
    metrics equal a run without it."""
    cfg = dataclasses.replace(FamConfig(), telemetry=4)
    both = _t_live_experiment(tx, cfg, 200, [None, 0], workloads=("LU",)).run(device="cpu")
    alone = _t_live_experiment(tx, cfg, 200, [None], workloads=("LU",)).run(device="cpu")
    dead = both.get(cell="LU/0")
    assert both.info.events == 200                  # only live events count
    assert not dead["telemetry"].any()
    assert dead["prefetches_issued"].sum() == 0 and dead["ipc"].sum() == 0
    for k, v in alone.get(cell="LU/None").items():
        np.testing.assert_array_equal(both.get(cell="LU/None")[k], v, err_msg=k)
    with pytest.raises(ValueError, match="t_live"):
        _t_live_experiment(tx, cfg, 200, [201]).points()


# ---------------------------------------------------------------------------
# fleet metrics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_fleet_reports():
    """Small fleets (counts {4, 8} x {uniform, zipf} x {none, cap,
    load_shed}, a contended pool) at T 160 on numpy traces: JAX's and the
    port's fleet_report."""
    jl = jt.lower_fleets(_fleets(jt.FleetSpec, jt.make_tenants, pool_bw_scale=0.5),
                         T=SMALL_T, trace_backend="numpy")
    tl = tt.lower_fleets(_fleets(tt.FleetSpec, tt.make_tenants, pool_bw_scale=0.5),
                         T=SMALL_T, trace_backend="numpy")
    jres = jl.experiment.run()
    tres = tl.experiment.run(device="cpu")
    return jt.fleet_report(jres, jl), tt.fleet_report(tres, tl), tres


def test_fleet_report_equals_jax(small_fleet_reports):
    (js, jr), (ts, tr), _ = small_fleet_reports
    assert ts == js
    assert tr == jr
    # the scenario exercises what it should: rejections, partial
    # admission, SLO violations and slowdowns above 1
    assert any(s["rejected"] for s in ts)
    assert any(0.0 < r["admitted_frac"] < 1.0 for r in tr)
    assert any(s["slo_violations"] > 0 for s in ts)
    assert max(s["slowdown_geomean"] for s in ts) > 1.0


def test_fleet_record_schema_complete(small_fleet_reports):
    _, (ts, tr), res = small_fleet_reports
    tt.validate_tenant_records(tr)
    assert tuple(tt.TENANT_SCHEMA) == tuple(jt.TENANT_SCHEMA)
    with pytest.raises(ValueError, match="schema"):
        tt.validate_tenant_records([{k: v for k, v in tr[0].items() if k != "p99"}])
    assert all("_hist" not in r for r in tr)
    json.dumps(tr)
    assert res.info.planned_groups == 1
    assert tt.jain_index([1.0, 1.0]) == 1.0 and tt.jain_index([]) == 0.0
    with pytest.raises(KeyError, match="telemetry"):
        tt.latency_hist({"ipc": np.ones(1)})


def test_fig_pond_main_writes_only_under_out(tmp_path, monkeypatch, capsys):
    """``fig_pond.main`` at the small size (fleets of 4 tenants, T 160):
    one group, the CSV printed, JSON rows equal to the returned ones only
    under ``--out`` (with --telemetry the windows and the span trace there
    too), nothing in the working directory."""
    fleets = _fleets(tt.FleetSpec, tt.make_tenants, counts=(4,),
                     admissions=("none", "load_shed"))
    monkeypatch.setattr(fig_pond, "default_fleets", lambda quick=True: fleets)
    monkeypatch.setattr(fig_pond, "T_QUICK", SMALL_T)
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    out = tmp_path / "out"
    argv = ["--device", "cpu", "--trace-backend", "numpy"]
    with pytest.raises(AssertionError, match="256"):
        fig_pond.main(argv)
    monkeypatch.setattr(fig_pond, "MIN_LARGEST", 4)
    rows = fig_pond.main(argv + ["--out", str(out), "--telemetry", "4"])
    assert not list(work.iterdir())
    assert sorted(p.relative_to(out).as_posix() for p in out.rglob("*.json")) == \
        ["fig_pond.json", "telemetry/fig_pond.json", "trace/fig_pond.json"]
    assert json.loads((out / "fig_pond.json").read_text()) == json.loads(json.dumps(rows))
    engine = rows[-1]
    assert engine["name"] == "pond_engine" and engine["derived"] == "groups=1"
    assert engine["tenant_lanes"] == 4 * len(fleets)
    assert engine["engine"]["spans"]["execute"]["count"] == 1
    assert [r["name"] for r in rows[:-1]] == [f"pond_{f.name}" for f in fleets]
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in printed[1:]] == [r["name"] for r in rows]


def test_run_py_pond_plan(capsys):
    from repro_torch.benchmarks import run
    assert run.main(["pond", "--plan"]) == []
    text = capsys.readouterr().out
    assert text.startswith("fig_pond: 1 group(s)") and "axes: tenant(" in text


# ---------------------------------------------------------------------------
# the golden file
# ---------------------------------------------------------------------------

def _trace_key(w, T, seed):
    return f"{w}:{T}:{seed}"


def _trace_digest(addrs, gaps):
    h = hashlib.sha256(np.asarray(addrs, np.int64).tobytes())
    h.update(np.asarray(gaps, np.float32).tobytes())
    return h.hexdigest()


def _numpy_trace_keys(points):
    from repro.traces.specs import node_seed
    return {_trace_key(w, p.T, node_seed(p.seed, i)): (w, p.T, node_seed(p.seed, i))
            for p in points for i, w in enumerate(p.workloads)}


def _points(res):
    return [{"coords": [list(c) for c in p.coords],
             "workloads": list(p.workloads), "seed": p.seed,
             **{k: np.asarray(res.metrics_for(p)[k]).astype(float).tolist()
                for k in sorted(res.metrics_for(p))}}
            for p in res.points]


def _tele_rows(rows):
    return {r["name"]: {"derived": r["derived"], "windowed_tail": r["windowed_tail"]}
            for r in rows}


def golden_from_jax():
    """JAX's fig12 telemetry entry and quick Pond sweep (both trace
    backends), with the Pond's distinct numpy traces."""
    import jax

    from benchmarks import fig12_wfq as ref12
    from benchmarks import fig_pond as ref_pond
    from benchmarks.common import workloads
    from repro.traces import host
    out = {"jax": jax.__version__, "numpy": np.__version__}
    exp = dataclasses.replace(ref12.experiment(quick=True, trace_backend="numpy",
                                               telemetry=TELE_WINDOWS), T=TELE_T)
    res = exp.run()
    variants = {f"w{w}": ({"variant": f"w{w}"}, {"variant": "fifo"})
                for w in ref12.WEIGHTS}

    class _Info:
        @staticmethod
        def us_per_call():
            return 0.0
    rows = ref12._rows_for(res, workloads(True), variants,
                           lambda n, label: f"fig12_nodes{n}_{label}", _Info())
    out["telemetry"] = {"figure": "fig12_wfq", "T": TELE_T, "n_windows": TELE_WINDOWS,
                        "trace_backend": "numpy", "groups": res.info.planned_groups,
                        "rows": _tele_rows(rows), "points": _points(res)}
    print(f"fig12 telemetry: {len(rows)} rows", file=sys.stderr)
    out["pond"] = {"T": ref_pond.T_QUICK, "n_windows": ref_pond.N_WINDOWS}
    traces = {}
    for backend in ("numpy", "device"):
        low = ref_pond.lowered(quick=True, trace_backend=backend)
        res = low.experiment.run()
        summaries, records = jt.fleet_report(res, low)
        out["pond"].update(fleets=[f.name for f in low.fleets],
                           tenant_lanes=len(low.cells),
                           isolated_lanes=len(low.iso_labels),
                           groups=res.info.planned_groups)
        out["pond"][backend] = {"summaries": summaries, "records": records}
        if backend == "numpy":
            traces = _numpy_trace_keys(res.points)
        print(f"pond {backend}: {[s['derived'] for s in summaries]}", file=sys.stderr)
    stored, digests = {}, {}
    for key, (w, T, seed) in sorted(traces.items()):
        a, g = host.generate(w, T, seed)
        digests[key] = _trace_digest(a, g)
        stored[key + ":lines"] = (a // 64).astype(np.int32)
        stored[key + ":gaps"] = g
    out["pond"]["numpy_traces"] = digests
    return out, stored


def _golden():
    return json.loads(GOLDEN.read_text())


def test_golden_keys_and_traces():
    """The golden carries what the card's checks read; the stored Pond
    traces are the lowering's distinct ones and hash to their digests."""
    g = _golden()
    tele, pond = g["telemetry"], g["pond"]
    assert (tele["figure"], tele["T"], tele["n_windows"]) == ("fig12_wfq", TELE_T, TELE_WINDOWS)
    assert tele["groups"] == 2 and len(tele["points"]) == 48
    for p in tele["points"]:
        assert np.asarray(p["telemetry"]).shape == (TELE_WINDOWS, N_COUNTERS)
        assert set(p) >= {"coords", "workloads", "seed", "ipc", "telemetry"}
    assert all(set(r) == {"derived", "windowed_tail"} for r in tele["rows"].values())
    low = fig_pond.lowered(quick=True, trace_backend="numpy")
    assert pond["T"] == fig_pond.T_QUICK and pond["n_windows"] == fig_pond.N_WINDOWS
    assert pond["fleets"] == [f.name for f in low.fleets] and pond["groups"] == 1
    assert (pond["tenant_lanes"], pond["isolated_lanes"]) == (len(low.cells), len(low.iso_labels))
    for backend in ("numpy", "device"):
        entry = pond[backend]
        assert [s["fleet"] for s in entry["summaries"]] == pond["fleets"]
        assert [(r["fleet"], r["tenant"]) for r in entry["records"]] == \
            [(c.fleet, c.tenant.name) for c in low.cells]
        tt.validate_tenant_records(entry["records"])
    want = set(_numpy_trace_keys(low.experiment.points()))
    import chip_smoke
    stored = chip_smoke.pond_traces()
    assert {_trace_key(*k) for k in stored} == want == set(pond["numpy_traces"])
    for k, (a, gp) in stored.items():
        assert _trace_digest(a, gp) == pond["numpy_traces"][_trace_key(*k)]


def test_golden_telemetry_rows_rebuild():
    """The port's fig12 row code over the golden's points (windows
    included) rebuilds the golden's rows and their ``windowed_tail``; the
    golden's points are the port's telemetry experiment's, in order."""
    from repro_torch.benchmarks import fig12_wfq as t12
    from repro_torch.benchmarks.common import workloads
    tele = _golden()["telemetry"]
    by = {frozenset((k, v) for k, v in p["coords"]):
          {m: np.asarray(v, np.float32) for m, v in p.items()
           if m not in ("coords", "workloads", "seed")} for p in tele["points"]}
    rows = t12.figure_rows(lambda **c: by[frozenset((k, str(v)) for k, v in c.items())],
                           workloads(True), 0.0)
    got = {r["name"]: {"derived": r["derived"], "windowed_tail": r["windowed_tail"]}
           for r in rows}
    assert got == tele["rows"]
    exp = dataclasses.replace(t12.experiment(quick=True, trace_backend="numpy",
                                             telemetry=TELE_WINDOWS), T=TELE_T)
    assert [[list(c) for c in p.coords] for p in exp.points()] == \
        [p["coords"] for p in tele["points"]]


def test_golden_telemetry_point_rebuilds():
    """One small entry rebuilt: the golden's first fig12 point (2 nodes)
    run by JAX and by the port again, windows and metrics equal."""
    from benchmarks import fig12_wfq as ref12
    from repro_torch.benchmarks import fig12_wfq as t12
    tele = _golden()["telemetry"]
    want = tele["points"][0]
    coords = dict(want["coords"])

    def one(mod, xmod, run_kw):
        exp = dataclasses.replace(mod.experiment(quick=True, trace_backend="numpy",
                                                 telemetry=TELE_WINDOWS), T=TELE_T)
        pts = [p for p in exp.points() if dict(p.coords) == coords]
        assert len(pts) == 1
        res = xmod.execute(xmod.plan_points(pts, name="one", trace_backend="numpy"), **run_kw)
        return res.metrics_for(res.points[0])

    jm = one(ref12, jx, {})
    tm = one(t12, tx, {"device": "cpu"})
    for k in want:
        if k in ("coords", "workloads", "seed"):
            continue
        np.testing.assert_array_equal(np.asarray(jm[k], np.float32),
                                      np.asarray(want[k], np.float32), err_msg=k)
        np.testing.assert_array_equal(tm[k], np.asarray(want[k], np.float32), err_msg=k)


def test_golden_pond_summaries_rebuild():
    """The golden's fleet summaries follow from its tenant records through
    the port's aggregation (both backends): counts, utilization, the
    slowdown geomean, Jain fairness and the SLO-missing tenants (the
    fleet percentiles need the histograms, which the records do not
    keep)."""
    from repro_torch.tenants.metrics import geomean, jain_index
    pond = _golden()["pond"]
    for backend in ("numpy", "device"):
        entry = pond[backend]
        for s in entry["summaries"]:
            recs = [r for r in entry["records"] if r["fleet"] == s["fleet"]]
            live = [r for r in recs if r["admitted_frac"] > 0.0]
            slow = [r["slowdown"] for r in live if r["slowdown"] is not None]
            assert s["tenants"] == len(recs) and s["admitted"] == len(live)
            assert s["rho"] == recs[0]["rho"]
            assert s["slowdown_geomean"] == round(geomean(slow), 4)
            assert s["jain_fairness"] == round(
                jain_index([1.0 / max(x, 1e-12) for x in slow]), 4)
            assert s["slo_miss_tenants"] == sum(r["p99"] > r["slo_latency"] for r in live)


# ---------------------------------------------------------------------------
# the card's device-trace tolerance, measured on the CPU
# ---------------------------------------------------------------------------

def compare_device():
    """The port's quick Pond sweep on device traces on the CPU against
    the golden's (JAX's) summaries."""
    import time

    import chip_smoke
    t0 = time.perf_counter()
    rows = fig_pond.run(trace_backend="device", device="cpu")
    got = [{k: v for k, v in r.items() if k not in ("tenants_detail", "us_per_call", "name")}
           for r in rows[:-1]]
    records = [t for r in rows[:-1] for t in r["tenants_detail"]]
    want = _golden()["pond"]["device"]
    buckets, logs = chip_smoke.pond_differences(got, records, want)
    same = sum(a == b for a, b in zip(got, want["summaries"]))
    same_r = sum(a == b for a, b in zip(records, want["records"]))
    print(f"quick Pond on device traces, port on the CPU vs JAX: {same} of "
          f"{len(got)} fleet summaries and {same_r} of {len(records)} tenant records "
          f"equal; largest percentile bucket distance {buckets}, largest |log| slowdown "
          f"geomean ratio {logs:.5f} ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    # python tests/test_torch_tenants.py [--compare-device]
    if sys.argv[1:2] == ["--compare-device"]:
        compare_device()
        sys.exit()
    golden, traces = golden_from_jax()
    GOLDEN.write_text(json.dumps(golden, separators=(",", ":")) + "\n")
    np.savez_compressed(POND_TRACES, **traces)
    print(f"wrote {GOLDEN} and {POND_TRACES}", file=sys.stderr)
