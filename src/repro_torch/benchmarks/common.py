"""Shared harness of the port's paper-figure drivers.

Counterpart of the reference's ``benchmarks/common.py``. Each figure module
exposes ``experiment(quick, trace_backend, kernel_backend)`` (its grid as a
:class:`~repro_torch.experiments.Experiment`) and ``run(...) -> list[dict]``
returning rows with at least {name, us_per_call, derived};
:mod:`repro_torch.benchmarks.run` prints the ``name,us_per_call,derived``
CSV and writes the full rows as JSON only into a directory the caller names.

Figures of merit follow paper §V-A: IPC gain against the baseline config
(no core prefetch, no DRAM-cache prefetch) of the same workload / node
count; relative FAM latency likewise.

Execution goes through :mod:`repro_torch.experiments`: ``plan()`` resolves
the grid into compile groups, ``execute()`` runs each group as one batched
runner call on one device (one CUDA graph capture on the card); traces come
from the ``device`` backend (generated on the card) or the ``numpy``
backend (host generators).

Observability (:mod:`repro_torch.obs`): with ``telemetry`` windows on, a
driver runs under :func:`obs_tracer` and, under ``out``, writes the span
timeline to ``<out>/trace/<figure>.json`` and every point's windows to
``<out>/telemetry/<figure>.json`` (:func:`save_telemetry`); fig10's and
fig12's rows gain a JSON-only :func:`windowed_tail`.

Not ported: the deprecated ``Point``/``run_points`` shim.
"""
from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import FamConfig, fam_replace  # noqa: F401
from repro_torch.core.ipc_model import geomean  # noqa: F401
from repro_torch.experiments import (ExperimentResult, ResolvedPoint, RunInfo,
                                     execute, plan_points, trace_arrays)
from repro_torch.policies import SimFlags

# default workload subset (one per suite + the cache/BW-sensitive ones the
# paper highlights); --full runs all 19
QUICK_WORKLOADS = ["603.bwaves_s", "628.pop2_s", "LU", "bfs", "canneal",
                   "mg"]

BASELINE = SimFlags(core_prefetch=False, dram_prefetch=False)
CORE = SimFlags(dram_prefetch=False)
DRAM = SimFlags()
ADAPT = SimFlags(bw_adapt=True)


#: events of the graph-vs-eager check (:func:`eager_check`): eager steps
#: cost ~12 ms an event on the card, so the check runs short
XCHECK_T = 1_000


def WFQ(w: int) -> SimFlags:
    return SimFlags(wfq=True, wfq_weight=w)


def workloads(quick: bool) -> List[str]:
    if quick:
        return QUICK_WORKLOADS
    from repro_torch.traces import WORKLOAD_NAMES
    return list(WORKLOAD_NAMES)


_DEV_TRACE_CACHE: Dict = {}


def _traces(workloads: Sequence[str], T: int, seed: int,
            trace_backend: str = "numpy", device="cuda"
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Node traces of one system on the host: the numpy backend shares the
    executor's memo; the device backend generates on ``device`` (the bits
    the executor feeds a group of that T), memoized per (workloads, T,
    seed, device)."""
    if trace_backend == "device":
        from repro_torch.traces import system_traces
        key = (tuple(workloads), T, seed, str(device))
        if key not in _DEV_TRACE_CACHE:
            _DEV_TRACE_CACHE[key] = system_traces(workloads, T, seed,
                                                  backend="device",
                                                  device=device)
        return _DEV_TRACE_CACHE[key]
    return trace_arrays(workloads, T, seed)


# ---------------------------------------------------------------------------
# Per-point reference path (the engine cross-check)
# ---------------------------------------------------------------------------

_SIM_CACHE: Dict = {}


def run_sim(cfg: FamConfig, flags: SimFlags, workloads: Sequence[str],
            T: int, seed: int = 0, trace_backend: str = "numpy",
            device="cuda") -> Tuple[Dict[str, np.ndarray], float, float]:
    """One system through the per-point path (``famsim.build_sim``).
    Returns (metrics, run seconds, capture seconds): on the card the run
    captures its CUDA graph once (the capture's seconds are reported apart
    from the run's), on the CPU it captures nothing."""
    from repro_torch.core import famsim
    N = len(workloads)
    key = (cfg, flags, N, str(device))
    if key not in _SIM_CACHE:
        _SIM_CACHE[key] = famsim.build_sim(cfg, flags, N, device=device)
    addrs, gaps = _traces(workloads, T, seed, trace_backend, device)
    famsim.last_graph.clear()
    t0 = time.perf_counter()
    out = {k: v.cpu().numpy() for k, v in _SIM_CACHE[key](addrs, gaps).items()}
    wall = time.perf_counter() - t0
    capture = famsim.last_graph.get("capture_s", 0.0)
    return out, wall - capture, capture


def engine_check(points: Sequence[ResolvedPoint],
                 batched: Sequence[Dict[str, np.ndarray]],
                 T: Optional[int] = None, trace_backend: str = "numpy",
                 device="cuda") -> dict:
    """Cross-check batched results against the per-point path fed by the
    same trace backend (so the comparison stays bit-level): the largest
    relative metric difference and the per-point cost split."""
    max_rel = 0.0
    steady = compile_s = 0.0
    for pt, got in zip(points, batched):
        T_pt = getattr(pt, "T", None) or T
        ref, dt, cap = run_sim(pt.cfg, pt.flags, list(pt.workloads), T_pt,
                               pt.seed, trace_backend, device)
        steady += dt
        compile_s += cap
        for k, v in ref.items():
            rel = float(np.max(np.abs(v - got[k]) /
                               np.maximum(np.abs(v), 1e-9)))
            max_rel = max(max_rel, rel)
    return {"points_checked": len(points), "max_rel_diff": max_rel,
            "per_point_steady_s": round(steady, 3),
            "per_point_compile_s": round(compile_s, 3),
            "matches_1e-5": bool(max_rel < 1e-5)}


def engine_row(name: str, result: ExperimentResult,
               check_pts: Sequence[ResolvedPoint], device="cuda") -> dict:
    """The ``*_engine`` row of fig08/fig16: the per-point cross-check and
    the wall-clock comparison against paying one run per point. Device
    traces are shaped by their length, so every checked point must have
    run at its own T (the group's t_pad)."""
    info = result.info
    points = result.points
    if info.trace_backend == "device":
        bad = [(p.coords, p.T, result.t_pad_for(p)) for p in check_pts
               if result.t_pad_for(p) != p.T]
        assert not bad, (
            "device-backend engine_check needs check points that executed "
            "at their own true T (own group's t_pad)", bad)
    check = engine_check(check_pts,
                         [result.metrics_for(p) for p in check_pts],
                         trace_backend=info.trace_backend, device=device)
    uniq = lambda pts: len({(p.cfg, p.flags, len(p.workloads)) for p in pts})
    est_full = (check["per_point_compile_s"] *
                uniq(points) / max(uniq(check_pts), 1) +
                check["per_point_steady_s"] *
                len(points) / max(len(check_pts), 1))
    batched_total = info.compile_s + info.run_s
    return {
        "name": name,
        "us_per_call": info.us_per_call(),
        # derived holds metric content only (identical across processes);
        # timings go in the JSON-only fields
        "derived": (f"max_rel_diff={check['max_rel_diff']:.2e};"
                    f"matches_1e-5={check['matches_1e-5']}"),
        "engine": info.as_dict(),
        "check": check,
        "per_point_est_wall_s": round(est_full, 3),
        "batched_wall_s": round(batched_total, 3),
        "speedup_vs_per_point": round(est_full / max(batched_total, 1e-9), 2),
    }


def eager_check(result: ExperimentResult, device="cuda", shard: bool = False) -> dict:
    """The engine row's re-run checks on a figure's grid, cheaply: the
    result's points re-planned at ``min(XCHECK_T, their T)`` events and
    run with ``cross_check_eager`` (its first group once as the primary
    run, once stepped from the host) and, with ``shard``, with
    ``cross_check_shard`` (once more through the other execution mode, as
    the reference's fig08 / fig16 check theirs). Returns ``{"eager_check":
    info.eager_check with that T and the primary run's cache-step
    launches}`` and, with ``shard``, ``"shard_check"``: the reference's
    record, its keys and values."""
    pts = [dataclasses.replace(p, T=min(XCHECK_T, p.T)) for p in result.points]
    plan = plan_points(pts, name="eager_check",
                       trace_backend=result.info.trace_backend)
    info = execute(plan, cross_check_eager=True, cross_check_shard=shard,
                   assert_compiles=True, device=device).info
    out = {"eager_check": dict(info.eager_check, T=pts[0].T,
                               launches=info.groups[0]["launches"])}
    if shard:
        out["shard_check"] = info.shard_check
    return out


def info_row(name: str, info: RunInfo, **extra) -> dict:
    """The ``*_engine`` row of figures without a per-point cross-check:
    planned groups (in ``derived``) and the full accounting."""
    return {"name": name, "us_per_call": info.us_per_call(),
            "derived": f"groups={info.planned_groups}",
            "engine": info.as_dict(), **extra}


def checked_info_row(name: str, result: ExperimentResult, device="cuda",
                     check_points: int = 0, eager: bool = True) -> dict:
    """:func:`info_row` (the reference's engine row of fig10 / fig12 /
    fig15, ``derived`` the planned groups) with two JSON-only checks: the
    graph-vs-eager check (:func:`eager_check`; left out with ``eager``
    False) and, for the first ``check_points`` points (none by default, as
    the reference), the per-point check (:func:`engine_check`)."""
    extra = eager_check(result, device) if eager else {}
    if check_points:
        pts = result.points[:check_points]
        extra["check"] = engine_check(pts, [result.metrics_for(p) for p in pts],
                                      trace_backend=result.info.trace_backend,
                                      device=device)
    return info_row(name, result.info, **extra)


def trace_gen_compare(plan, device="cuda") -> dict:
    """Device-vs-numpy trace generation wall-clock at a figure's scale:
    ``numpy_host_gen_s`` generates and stages every group's padded
    ``(S_exec, N, T_pad)`` arrays with a cold memo; ``device_host_stage_s``
    stacks the per-node ``TraceParams`` (the device backend's whole host
    cost); ``device_gen_s`` generates the traces on ``device`` (after one
    warm-up call, synchronized)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.experiments import executor as ex
    from repro_torch.traces import device as dev_gen

    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    host_np = host_dev = gen_dev = 0.0
    events = 0
    for g in plan.groups:
        idxs = ex._pad_systems(g.indices, g.s_pad)
        saved = dict(ex._TRACE_CACHE)
        ex._TRACE_CACHE.clear()
        try:
            d_np = ex._prepare(plan.points, idxs, g.t_pad, 0.2, "numpy")
        finally:
            ex._TRACE_CACHE.update(saved)
        dev_gen.trace_params.cache_clear()        # symmetric fresh-process cost
        dev_gen._head_cdf.cache_clear()
        d_dev = ex._prepare(plan.points, idxs, g.t_pad, 0.2, "device")
        host_np += d_np.prep_s
        host_dev += d_dev.prep_s
        tp = dev_gen.to_tensors(d_dev.inputs[0], dev)
        gen = dev_gen.node_generator(g.t_pad)
        gen(tp)
        sync()
        t0 = time.perf_counter()
        gen(tp)
        sync()
        gen_dev += time.perf_counter() - t0
        events += len(idxs) * g.key.num_nodes * g.t_pad
    return {
        "events_staged": events,
        "numpy_host_gen_s": round(host_np, 4),
        "device_host_stage_s": round(host_dev, 4),
        "device_gen_s": round(gen_dev, 4),
        "host_speedup": round(host_np / max(host_dev, 1e-9), 1),
        "device_not_slower": bool(host_dev <= host_np),
    }


# ---------------------------------------------------------------------------
# observability surfacing (repro_torch.obs)
# ---------------------------------------------------------------------------

TRACE_DIR = "trace"
TELEMETRY_DIR = "telemetry"


@contextmanager
def obs_tracer(figure: str, telemetry: int, out=None):
    """Install a host span tracer for one figure run.

    With ``telemetry == 0`` this is a no-op (the default path records
    nothing). Otherwise every instrumented layer under the block
    (``Experiment.run``'s plan, the executor's trace staging, runs,
    captures and fetches) lands in one nested timeline, saved as Chrome
    trace-event JSON to ``<out>/trace/<figure>.json`` when ``out`` is
    given (load it in ui.perfetto.dev); nothing is written otherwise."""
    if not telemetry:
        yield None
        return
    from repro_torch.obs import SpanTracer, set_tracer
    tracer = SpanTracer(process_name=f"repro_torch.benchmarks:{figure}")
    prev = set_tracer(tracer)
    try:
        with tracer.span(figure, cat="figure", telemetry=telemetry):
            yield tracer
    finally:
        set_tracer(prev)
        if out is not None:
            tracer.save(Path(out) / TRACE_DIR / f"{figure}.json")


def save_telemetry(figure: str, result: ExperimentResult, n_windows: int,
                   out=None) -> Optional[Path]:
    """Write every point's windowed counter matrix to
    ``<out>/telemetry/<figure>.json``, the payload ``python -m
    repro_torch.obs report`` renders. Returns None (and writes nothing)
    without ``out`` or when the result carries no telemetry."""
    from repro_torch.obs import COUNTERS, LAT_EDGES
    points = []
    for pt in result.points:
        m = result.metrics_for(pt)
        if "telemetry" not in m:
            continue
        points.append({"coords": dict(pt.coords),
                       "nodes": len(pt.workloads), "T": pt.T,
                       "windows": np.asarray(m["telemetry"]).tolist()})
    if out is None or not points:
        return None
    path = Path(out) / TELEMETRY_DIR / f"{figure}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        {"figure": figure, "n_windows": n_windows,
         "counters": list(COUNTERS), "lat_edges": list(LAT_EDGES),
         "points": points}))
    return path


def windowed_tail(metrics) -> Optional[dict]:
    """JSON-only windowed tail-latency summary (None when telemetry is
    off): per-window p95/p99 plus overall p50/p95/p99, estimated from the
    in-run histogram buckets (:mod:`repro_torch.obs.report`). Accepts one
    point's metrics dict or a raw ``(n_windows, N_COUNTERS)`` matrix
    (histogram counts sum across points, so callers may aggregate). Rides
    the JSON rows of fig10 / fig12, never the ``derived`` string."""
    if isinstance(metrics, dict):
        if "telemetry" not in metrics:
            return None
        w = np.asarray(metrics["telemetry"])
    else:
        w = np.asarray(metrics)
    from repro_torch.obs.report import overall_percentiles, window_percentiles
    return {"overall": overall_percentiles(w),
            **window_percentiles(w, qs=(95, 99))}


def save_outputs(figure: str, rows: List[dict], result: ExperimentResult,
                 telemetry: int, out) -> None:
    """A driver's files under ``out`` (nothing without it): its rows and,
    with telemetry on, every point's windows."""
    if out is None:
        return
    if telemetry:
        save_telemetry(figure, result, telemetry, out)
    save_rows(figure, rows, out)


def save_rows(figure: str, rows: List[dict], out) -> Path:
    """Write ``rows`` to ``<out>/<figure>.json`` (the caller names the
    directory; nothing is written by default)."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{figure}.json"
    path.write_text(json.dumps(rows, indent=2))
    return path


def plan_lines(plan, axes=None) -> List[str]:
    """The ``--plan`` dry-run text for one resolved plan: the summary line,
    an ``axes:`` line and one line per compile group."""
    events = plan.events()
    padded = plan.padded_events()
    lines = [f"{plan.name}: {plan.num_groups} group(s), "
             f"{plan.num_points} points, {events} events "
             f"(+{padded} padded, {padded / max(events, 1):.1%} overhead)"]
    if axes:
        lines.append("  axes: " + " x ".join(
            f"{a.name}({len(a.values)})" for a in axes))
    for i, d in enumerate(plan.describe()):
        lines.append(f"  group {i}: S={d['S']} S_pad={d['S_pad']} "
                     f"N={d['N']} T_pad={d['T_pad']} "
                     f"pad_geom=({d['pad_sets']}x{d['pad_ways']}) "
                     f"key={d['static_shape']}")
    return lines
