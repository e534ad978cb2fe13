"""The port's observability layer (``repro_torch.obs``) against
``repro.obs`` on the CPU.

* The span tracer is a copy of the reference's (same code after the
  module docstring); ``window_index`` equals the reference's over a grid.
* Telemetry off: the step's carry and the metrics are what they were (no
  ``"telemetry"``); on: every shared metric bit-equal to off, the windows
  equal JAX's bit for bit in every column (the integer-valued counters
  and histogram buckets, and the float gauges ``wfq_*_backlog``,
  ``token_rate``, ``lat_sum``: the port sums their few nodes in node
  order, as XLA does, so no tolerance is needed), the windows sum to the
  run totals at ``warmup_frac=0``, and a padded tail adds exact zeros
  through ``GroupRunner``.
* The executor with telemetry: one group, every point's windows equal to
  JAX's executor, and the span names and counts of the same plan equal to
  JAX's (``compile`` apart: the port's is its CUDA graph capture, which
  happens on the card only).
* ``report``: derived streams, percentiles, exceedance, time-to-warm and
  the rendered dashboard equal JAX's on seeded windows; trace validation
  agrees on good and broken payloads.
* The surfacing: fig12 with telemetry writes its rows, windows and span
  trace under ``--out`` only (its ``windowed_tail`` rows equal JAX's at
  that T), and ``python -m repro_torch.obs report|validate`` read them.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from repro import experiments as jx  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.configs.base import FamConfig as JFamConfig  # noqa: E402
from repro.configs.base import fam_replace as j_fam_replace  # noqa: E402
from repro.core import famsim as jfam  # noqa: E402
from repro.core.fam_params import FamParams as JFamParams  # noqa: E402
from repro.core.fam_params import stack_params as j_stack_params  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.traces import system_traces  # noqa: E402
from repro_torch import experiments as tx  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs.base import FamConfig, fam_replace  # noqa: E402
from repro_torch.core import famsim as tfam  # noqa: E402
from repro_torch.core.fam_params import FamParams, stack_params  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402
from repro_torch.obs import telemetry as ttele  # noqa: E402

WL4 = ["LU", "bfs", "canneal", "mg"]
T = 500
N_WIN = 8
FLAG_SETS = ({}, {"bw_adapt": True}, {"wfq": True})
#: columns whose values are counts (exact in f32 at these sizes)
INT_COLUMNS = ("events", "demand_fam", "demand_hit", "demand_late", "pf_issued",
               "pf_redundant", "queue_occupancy") + ttele.COUNTERS[ttele.HIST_OFFSET:]


# ---------------------------------------------------------------------------
# the copies and the window index
# ---------------------------------------------------------------------------

def _code_after_docstring(path):
    tree = ast.parse(Path(path).read_text())
    body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body
    return [ast.dump(node) for node in body]


def test_spans_copy_equals_the_original():
    assert _code_after_docstring(REPO / "src/repro/obs/spans.py") == \
        _code_after_docstring(REPO / "src/repro_torch/obs/spans.py")


def test_catalog_equal():
    for name in ("LAT_EDGES", "BASE_COUNTERS", "COUNTERS", "N_COUNTERS",
                 "HIST_OFFSET", "N_BUCKETS"):
        assert getattr(jobs.telemetry, name) == getattr(ttele, name), name
    assert all(jobs.counter_index(c) == tobs.counter_index(c) for c in ttele.COUNTERS)
    assert tuple(ttele.init_windows(N_WIN, 3, "cpu").shape) == (3, N_WIN, ttele.N_COUNTERS)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_window_index_equal(n):
    i = np.arange(0, 1300)
    for t_true in (0, 1, 7, 600):
        want = np.asarray(jobs.window_index(jnp.asarray(i), jnp.int32(t_true), n))
        got = ttele.window_index(torch.as_tensor(i), torch.tensor(t_true, dtype=torch.int32), n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"t_true {t_true}")
    # broadcast over systems, as the masked runner calls it
    t = torch.tensor([0, 1, 7, 600], dtype=torch.int32)
    got = ttele.window_index(torch.arange(700)[:, None], t[None, :], n)
    assert tuple(got.shape) == (700, 4)
    for s, t_true in enumerate((0, 1, 7, 600)):
        np.testing.assert_array_equal(
            got[:, s].numpy(),
            np.asarray(jobs.window_index(jnp.arange(700), jnp.int32(t_true), n)))


# ---------------------------------------------------------------------------
# the windows over the whole simulator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweeps():
    """Three systems of 4 nodes (default, bw_adapt, wfq) at warmup 0:
    JAX with telemetry on, the port with it on and off."""
    addrs, gaps = system_traces(WL4, T, 0)
    A, G = np.stack([addrs] * 3), np.stack([gaps] * 3)
    jcfg = j_fam_replace(JFamConfig(), telemetry=N_WIN)
    jp = j_stack_params([JFamParams.of(jcfg, jfam.SimFlags(**f)) for f in FLAG_SETS])
    jon = jfam.sweep(jcfg, jp, None, A, G, warmup_frac=0.0)
    tp = stack_params([FamParams.of(FamConfig(), tfam.SimFlags(**f), device="cpu")
                       for f in FLAG_SETS])
    on = tfam.sweep(fam_replace(FamConfig(), telemetry=N_WIN), tp, None, A, G,
                    warmup_frac=0.0, device="cpu")
    off = tfam.sweep(FamConfig(), tp, None, A, G, warmup_frac=0.0, device="cpu")
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return as_np(jon), as_np(on), as_np(off)


def test_telemetry_off_adds_no_metric_and_keeps_the_carry():
    cfg = FamConfig()
    p = tfam._per_node(stack_params([FamParams.of(cfg, device="cpu")]))
    carry = tfam._init_carry(cfg, p, 2)
    assert len(carry) == 2 and isinstance(carry[0], tfam.NodeState)
    on = tfam._init_carry(fam_replace(cfg, telemetry=5), p, 2)
    assert len(on) == 3 and tuple(on[2].shape) == (1, 5, ttele.N_COUNTERS)
    assert [tuple(t.shape) for t in tfam._leaves(carry)] == \
        [tuple(t.shape) for t in tfam._leaves(on[:2])]
    metrics = tfam._metrics(carry[0], p)
    assert "telemetry" not in metrics


def test_telemetry_is_purely_observational(sweeps):
    _, on, off = sweeps
    assert set(on) == set(off) | {"telemetry"}
    assert on["telemetry"].shape == (3, N_WIN, ttele.N_COUNTERS)
    for k, v in off.items():
        np.testing.assert_array_equal(v, on[k], err_msg=k)


@pytest.mark.parametrize("column", list(ttele.COUNTERS))
def test_windows_equal_jax(sweeps, column):
    """Every column bit for bit: the counts, and the float gauges too."""
    jon, on, _ = sweeps
    c = ttele.counter_index(column)
    np.testing.assert_array_equal(on["telemetry"][..., c], jon["telemetry"][..., c])
    if column in INT_COLUMNS:
        v = on["telemetry"][..., c]
        assert (v == np.round(v)).all()


def test_window_sums_equal_end_of_run_totals(sweeps):
    _, on, _ = sweeps
    tele = on["telemetry"].astype(np.float64)
    col = lambda name: tele[..., ttele.counter_index(name)]
    assert (col("events").sum(-1) == len(WL4) * T).all()
    np.testing.assert_array_equal(col("pf_issued").sum(-1),
                                  on["prefetches_issued"].sum(-1))
    hist = tele[..., ttele.HIST_OFFSET:]
    np.testing.assert_array_equal(hist.sum((-2, -1)), col("demand_fam").sum(-1))
    assert (col("demand_hit") <= col("demand_fam")).all()
    assert col("pf_redundant").sum() > 0 and col("lat_sum").sum() > 0


def test_padded_tail_adds_exact_zeros():
    """Systems of true lengths 150 and 200 run in one masked call at
    T_pad 200 carry the windows (and every metric) of unpadded runs of
    150 and 200 events: the 50 dead steps add exact zero rows."""
    cfg = fam_replace(FamConfig(), telemetry=5)
    addrs, gaps = system_traces(["LU"], 200, 0)
    p = stack_params([FamParams.of(cfg, device="cpu")] * 2)
    run = tfam.GroupRunner(cfg, 1)
    out = run(p, torch.as_tensor(np.stack([addrs] * 2)), torch.as_tensor(np.stack([gaps] * 2)),
              torch.tensor([150, 200], dtype=torch.int32), torch.tensor([30, 40], dtype=torch.int32))
    for s, t_true in enumerate((150, 200)):
        ref = tfam._make_run(cfg, 1, 0.2)(stack_params([FamParams.of(cfg, device="cpu")]),
                                          torch.as_tensor(addrs[None, :, :t_true]),
                                          torch.as_tensor(gaps[None, :, :t_true]))
        for k, v in ref.items():
            np.testing.assert_array_equal(out[k][s].numpy(), v[0].numpy(), err_msg=f"{t_true} {k}")


def test_run_steps_pads_the_window_stream():
    """A length that is no multiple of the graph window: the dead events
    of the last window read the window stream's last index and add zero."""
    cfg = fam_replace(FamConfig(), telemetry=3)
    addrs, gaps = system_traces(["bfs"], 130, 0)
    p = stack_params([FamParams.of(cfg, device="cpu")])
    a = tfam._make_run(cfg, 1, 0.0)(p, torch.as_tensor(addrs[None]), torch.as_tensor(gaps[None]))
    tele = a["telemetry"][0].numpy()
    want = np.bincount(np.asarray(jobs.window_index(jnp.arange(130), jnp.int32(130), 3)))
    assert tele[:, ttele.counter_index("events")].tolist() == want.tolist() == [44, 43, 43]


# ---------------------------------------------------------------------------
# the executor: groups, windows and spans
# ---------------------------------------------------------------------------

def _obs_experiment(mod, cfg_cls, replace, flags_cls):
    """LU / bfs x {T 250, T 300} on 2 nodes, numpy traces, telemetry 5:
    one group at t_pad 300, one point padded."""
    return mod.Experiment(
        name="obs_exec", T=300, nodes=2, trace_backend="numpy",
        base=replace(cfg_cls(), telemetry=5),
        axes=(mod.workload_axis(["LU", "bfs"]),
              mod.Axis("t", (mod.AxisValue("250", T=250), mod.AxisValue("300", T=300)))))


@pytest.fixture(scope="module")
def executed():
    jtr, ttr = jobs.SpanTracer(), tobs.SpanTracer()
    prev = jobs.set_tracer(jtr)
    try:
        jres = _obs_experiment(jx, JFamConfig, j_fam_replace, jfam.SimFlags).run()
    finally:
        jobs.set_tracer(prev)
    prev = tobs.set_tracer(ttr)
    try:
        tres = _obs_experiment(tx, FamConfig, fam_replace, tfam.SimFlags).run(device="cpu")
    finally:
        tobs.set_tracer(prev)
    return jres, tres, jtr, ttr


def test_executor_windows_equal_jax(executed):
    jres, tres, _, _ = executed
    assert tres.info.planned_groups == 1 and tres.info.compiles == 0
    assert tres.info.padded_events == jres.info.padded_events > 0
    for pj, pt in zip(jres.points, tres.points):
        mj, mt = jres.metrics_for(pj), tres.metrics_for(pt)
        assert mt["telemetry"].shape == (5, ttele.N_COUNTERS)
        for k in mj:
            np.testing.assert_array_equal(mt[k], np.asarray(mj[k]), err_msg=f"{pt.coords} {k}")


def test_executor_spans_equal_jax(executed):
    """Same span names, same counts (``compile`` apart), valid nesting; the
    summary rides RunInfo.spans and as_dict only while a tracer is set."""
    jres, tres, jtr, ttr = executed
    count = lambda s: {k: v["count"] for k, v in s.items() if k != "compile"}
    assert count(ttr.summary()) == count(jtr.summary())
    assert count(tres.info.spans) == count(jres.info.spans)
    assert set(tres.info.spans) >= {"execute", "trace_stage", "run", "device_call", "fetch"}
    assert "compile" not in tres.info.spans          # captures happen on the card only
    assert ttr.summary()["plan"]["count"] == 1
    assert treport.validate_trace_events(ttr.chrome_trace()) == []
    assert tres.info.as_dict()["spans"] == tres.info.spans
    again = _obs_experiment(tx, FamConfig, fam_replace, tfam.SimFlags).run(device="cpu")
    assert again.info.spans is None and "spans" not in again.info.as_dict()


def test_spans_from_the_staging_thread_nest():
    """Two groups on numpy traces stage their traces on the overlap
    thread: the trace_stage spans land on that thread's own lane and the
    trace stays valid."""
    exp = tx.Experiment(name="two_groups", T=120, trace_backend="numpy",
                        axes=(tx.nodes_axis([1, 2]), tx.workload_axis(["LU"])))
    tracer = tobs.SpanTracer()
    prev = tobs.set_tracer(tracer)
    try:
        info = exp.run(device="cpu").info
    finally:
        tobs.set_tracer(prev)
    assert info.planned_groups == 2 and info.spans["trace_stage"]["count"] == 2
    lane = lambda name: {e["tid"] for e in tracer.events if e["name"] == name}
    assert lane("execute") == {0} and lane("trace_stage") == {1}
    assert treport.validate_trace_events(tracer.chrome_trace()) == []


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _seeded_windows(seed, n=6):
    rng = np.random.default_rng(seed)
    w = np.zeros((n, ttele.N_COUNTERS), np.float32)
    hist = rng.integers(0, 50, size=(n, ttele.N_BUCKETS)).astype(np.float32)
    hist[rng.integers(0, n)] = 0.0                      # an empty window
    w[:, ttele.HIST_OFFSET:] = hist
    fam = hist.sum(1)
    col = ttele.counter_index
    w[:, col("events")] = fam + rng.integers(0, 40, n)
    w[:, col("demand_fam")] = fam
    w[:, col("demand_hit")] = np.floor(fam * rng.random(n))
    w[:, col("demand_late")] = np.floor(fam * rng.random(n) * 0.1)
    w[:, col("pf_issued")] = rng.integers(0, 90, n)
    w[:, col("pf_redundant")] = rng.integers(0, 9, n)
    for name in ("queue_occupancy", "wfq_demand_backlog", "wfq_prefetch_backlog",
                 "token_rate", "lat_sum"):
        w[:, col(name)] = (rng.random(n) * 5000).astype(np.float32)
    return w


def _payload(seeds):
    return {"figure": "seeded", "n_windows": 6, "counters": list(ttele.COUNTERS),
            "lat_edges": list(ttele.LAT_EDGES),
            "points": [{"coords": {"workload": "LU", "seed": str(s)}, "nodes": 2, "T": 900,
                        "windows": _seeded_windows(s).tolist()} for s in seeds]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_report_functions_equal_jax(seed):
    w = _seeded_windows(seed)
    jd, td = jreport.derived_streams(w), treport.derived_streams(w)
    assert list(jd) == list(td)
    for k in jd:
        np.testing.assert_array_equal(jd[k], td[k], err_msg=k)
    assert jreport.window_percentiles(w) == treport.window_percentiles(w)
    assert jreport.window_percentiles(w, qs=(90, 99.9)) == \
        treport.window_percentiles(w, qs=(90, 99.9))
    assert jreport.overall_percentiles(w) == treport.overall_percentiles(w)
    assert jreport.time_to_warm(w) == treport.time_to_warm(w)
    assert jreport.sparkline(w[:, 3]) == treport.sparkline(w[:, 3])
    for row in w[:, ttele.HIST_OFFSET:]:
        for q in (0, 1, 50, 95, 99, 100):
            assert jreport.bucket_percentile(row, q) == treport.bucket_percentile(row, q)
        for thr in (0.0, 100.0, 181.0, 700.0, 4096.0, 5000.0, 9000.0):
            assert jreport.bucket_exceedance(row, thr) == treport.bucket_exceedance(row, thr)


def test_render_report_equal_jax(tmp_path):
    payload = _payload([0, 1, 2, 3, 4])
    for kw in ({}, {"fmt": "md"}, {"point": 2}, {"limit": 0}, {"limit": 2}):
        assert jreport.render_report(payload, **kw) == treport.render_report(payload, **kw)
    path = tmp_path / "t.json"
    path.write_text(json.dumps(payload))
    assert treport.load_telemetry(path) == jreport.load_telemetry(path)
    bad = dict(payload, counters=list(ttele.COUNTERS)[::-1])
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="catalog"):
        treport.load_telemetry(path)
    with pytest.raises(ValueError, match="telemetry"):
        treport.derived_streams(np.zeros((4, 3)))


def test_validate_trace_equal_jax(tmp_path):
    tracer = tobs.SpanTracer()
    with tracer.span("outer"):
        with tracer.span("inner", k=1):
            pass
        tracer.instant("mark")
    good = tracer.chrome_trace()
    broken = json.loads(json.dumps(good))
    broken["traceEvents"][-1]["dur"] = -1.0
    overlap = json.loads(json.dumps(good))
    xs = [e for e in overlap["traceEvents"] if e["ph"] == "X"]
    xs[0]["dur"] = xs[1]["dur"] * 10 + 1e3            # inner outlives outer
    for payload in (good, broken, overlap, {"traceEvents": []}, {"traceEvents": [1]}):
        assert jreport.validate_trace_events(payload) == treport.validate_trace_events(payload)
    assert treport.validate_trace_events(good) == []
    assert treport.validate_trace_events(overlap)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert treport.validate_trace(bad)[0].startswith("cannot parse")


# ---------------------------------------------------------------------------
# the surfacing: fig12 with telemetry under --out, and the CLI
# ---------------------------------------------------------------------------

T_SHORT = 160


@pytest.fixture(scope="module")
def fig12_out(tmp_path_factory):
    from repro_torch.benchmarks import fig12_wfq as t12
    out = tmp_path_factory.mktemp("rows")
    results = REPO / "results"
    before = sorted((p, p.stat().st_mtime) for p in results.rglob("*"))
    T0 = t12.T
    t12.T = T_SHORT
    try:
        rows, res = t12.run_result(quick=True, trace_backend="numpy", device="cpu",
                                   out=out, telemetry=4)
    finally:
        t12.T = T0
    assert sorted((p, p.stat().st_mtime) for p in results.rglob("*")) == before
    return out, rows, res


def test_fig12_telemetry_writes_only_under_out(fig12_out):
    out, rows, res = fig12_out
    assert sorted(p.relative_to(out).as_posix() for p in out.rglob("*") if p.is_file()) == \
        ["fig12_wfq.json", "telemetry/fig12_wfq.json", "trace/fig12_wfq.json"]
    payload = json.loads((out / "telemetry/fig12_wfq.json").read_text())
    assert payload["n_windows"] == 4 and len(payload["points"]) == len(res.points)
    assert res.info.planned_groups == 2
    # the span summary rides the engine row, as the reference's does
    spans = rows[-1]["engine"]["spans"]
    assert spans["execute"]["count"] == 1 and spans["run"]["count"] == 2


def test_fig12_windowed_tail_rows_equal_jax(fig12_out):
    """The rows' derived strings and JSON-only windowed tails equal the
    reference's row code over JAX's run at the same T and windows."""
    from benchmarks import fig12_wfq as ref12
    from benchmarks.common import workloads
    _, rows, _ = fig12_out
    jexp = dataclasses.replace(ref12.experiment(quick=True, trace_backend="numpy",
                                                telemetry=4), T=T_SHORT)
    jres = jexp.run()
    variants = {f"w{w}": ({"variant": f"w{w}"}, {"variant": "fifo"}) for w in ref12.WEIGHTS}

    class _Info:
        @staticmethod
        def us_per_call():
            return 0.0
    want = ref12._rows_for(jres, workloads(True), variants,
                           lambda n, label: f"fig12_nodes{n}_{label}", _Info())
    got = {r["name"]: (r["derived"], r["windowed_tail"]) for r in rows[:-1]}
    assert got == {r["name"]: (r["derived"], r["windowed_tail"]) for r in want}


def test_obs_cli_report_and_validate(fig12_out, tmp_path, capsys):
    """``python -m repro_torch.obs validate`` in a process of its own, and
    the CLI's report and failing validate in this one."""
    from repro_torch.obs.__main__ import main
    out, _, _ = fig12_out
    ok = subprocess.run([sys.executable, "-m", "repro_torch.obs", "validate",
                         str(out / "trace/fig12_wfq.json")], capture_output=True,
                        text=True, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert ok.returncode == 0 and "spans nest correctly" in ok.stdout
    assert main(["report", str(out / "telemetry/fig12_wfq.json"), "--format", "md"]) == 0
    rep = capsys.readouterr().out
    assert "# telemetry: fig12_wfq (4 windows, 48 points)" in rep
    assert "| win |" in rep and "more point(s) elided" in rep
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "x", "ph": "X", "ts": 0,
                                                "pid": 0, "tid": 0, "dur": -1}]}))
    assert main(["validate", str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().err


def test_obs_tracer_and_save_telemetry_without_out(tmp_path, monkeypatch):
    """With telemetry on but no --out the tracer is installed (spans reach
    RunInfo) and nothing is written anywhere; with telemetry off the
    tracer is a no-op."""
    from repro_torch.benchmarks.common import obs_tracer, save_telemetry
    monkeypatch.chdir(tmp_path)
    exp = tx.Experiment(name="quiet", T=60, trace_backend="numpy",
                        base=fam_replace(FamConfig(), telemetry=2),
                        axes=(tx.workload_axis(["LU"]),))
    with obs_tracer("quiet", 2) as tracer:
        res = exp.run(device="cpu")
    assert tracer is not None and res.info.spans["execute"]["count"] == 1
    assert save_telemetry("quiet", res, 2) is None
    with obs_tracer("quiet", 0) as none:
        assert none is None and tobs.current_tracer() is None
    assert not list(tmp_path.iterdir())
