"""Render telemetry window streams and validate trace files (host side).

Counterpart of ``repro.obs.report``, a copy of it on the port's
:mod:`repro_torch.obs.telemetry` layout. Two consumers share this module:

* ``python -m repro_torch.obs report <out>/telemetry/<figure>.json`` —
  a text/markdown dashboard per point: time-to-warm, hit-rate ramp,
  prefetch accuracy, queue/backlog gauges, and a tail-latency table
  (p50/p95/p99 estimated from the in-run histogram buckets);
* ``python -m repro_torch.obs validate <out>/trace/<figure>.json`` —
  checks a saved Chrome trace-event JSON parses and its "X" spans nest
  properly per (pid, tid) lane.

Everything here runs on already-fetched numpy arrays; it needs no card.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.telemetry import (COUNTERS, HIST_OFFSET, LAT_EDGES,
                                       N_BUCKETS, N_COUNTERS, counter_index)

_SPARK = "▁▂▃▄▅▆▇█"


# -- derived streams --------------------------------------------------------

def _col(windows: np.ndarray, name: str) -> np.ndarray:
    return windows[:, counter_index(name)]


def derived_streams(windows: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-window derived series from one point's raw counter matrix.

    ``hit_rate`` = demand_hit / demand_fam; ``pf_accuracy`` =
    demand_hit / pf_issued (every cached block was prefetched, so hits
    ARE consumed prefetches); ``late_rate`` = demand_late / demand_fam;
    gauges are normalized per the catalog in ``repro_torch.obs.telemetry``.
    """
    w = np.asarray(windows, np.float64)
    if w.ndim != 2 or w.shape[1] != N_COUNTERS:
        raise ValueError(f"expected (n_windows, {N_COUNTERS}) telemetry "
                         f"matrix, got shape {w.shape}")
    events = _col(w, "events")
    fam = _col(w, "demand_fam")
    hits = _col(w, "demand_hit")
    issued = _col(w, "pf_issued")
    safe = lambda num, den: num / np.maximum(den, 1.0)
    return {
        "events": events,
        "hit_rate": safe(hits, fam),
        "pf_accuracy": safe(hits, issued),
        "late_rate": safe(_col(w, "demand_late"), fam),
        "pf_issued": issued,
        "pf_redundant": _col(w, "pf_redundant"),
        "queue_occupancy": safe(_col(w, "queue_occupancy"), events),
        "demand_backlog": safe(_col(w, "wfq_demand_backlog"), events),
        "prefetch_backlog": safe(_col(w, "wfq_prefetch_backlog"), events),
        "token_rate": safe(_col(w, "token_rate"), events),
        "mean_latency": safe(_col(w, "lat_sum"), fam),
    }


def _hist(windows: np.ndarray) -> np.ndarray:
    return np.asarray(windows, np.float64)[:, HIST_OFFSET:
                                           HIST_OFFSET + N_BUCKETS]


def bucket_percentile(counts: np.ndarray, q: float) -> float:
    """Estimate the q-th percentile from one histogram row by linear
    interpolation inside the covering bucket (last bucket is open-ended;
    its interpolation span caps at 1.5x the last edge).

    THE latency-percentile implementation: the telemetry dashboard
    (:func:`window_percentiles` / :func:`overall_percentiles`) and the
    per-tenant tail metrics (``repro_torch.tenants.metrics``) both call this —
    a second copy would silently drift on the open-bucket convention.
    ``counts`` is one ``(N_BUCKETS,)`` row binned on ``LAT_EDGES``."""
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if total <= 0:
        return 0.0
    target = q / 100.0 * total
    seen, lo = 0.0, 0.0
    for b, n in enumerate(counts):
        hi = LAT_EDGES[b] if b < len(LAT_EDGES) else LAT_EDGES[-1] * 1.5
        if n > 0 and seen + n >= target:
            return lo + (target - seen) / n * (hi - lo)
        seen += n
        lo = hi
    return lo


#: backward-compatible private alias (pre-factor spelling)
_bucket_percentile = bucket_percentile


def bucket_exceedance(counts: np.ndarray, threshold: float) -> float:
    """Estimated number of events whose latency exceeds ``threshold``
    cycles, from one histogram row — the SLO-violation estimator of
    ``repro_torch.tenants.metrics``. Uses the same linear-within-bucket model
    and open-ended last-bucket convention as :func:`bucket_percentile`:
    the covering bucket contributes the fraction of its span above the
    threshold; buckets entirely above contribute fully."""
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if total <= 0 or threshold <= 0:
        return float(total)
    over, lo = 0.0, 0.0
    for b, n in enumerate(counts):
        hi = LAT_EDGES[b] if b < len(LAT_EDGES) else LAT_EDGES[-1] * 1.5
        if threshold <= lo:
            over += n
        elif threshold < hi:
            over += n * (hi - threshold) / (hi - lo)
        lo = hi
    return float(over)


def window_percentiles(windows: np.ndarray,
                       qs: Sequence[float] = (50, 95, 99)
                       ) -> Dict[str, List[float]]:
    """Per-window latency percentiles from the histogram buckets:
    ``{"p50": [...], "p95": [...], "p99": [...]}`` (one entry per
    window). The estimator is deterministic (pure bucket arithmetic)."""
    hist = _hist(windows)
    return {f"p{int(q) if float(q).is_integer() else q}":
            [round(_bucket_percentile(row, q), 1) for row in hist]
            for q in qs}


def overall_percentiles(windows: np.ndarray,
                        qs: Sequence[float] = (50, 95, 99)
                        ) -> Dict[str, float]:
    total = _hist(windows).sum(axis=0)
    return {f"p{int(q) if float(q).is_integer() else q}":
            round(_bucket_percentile(total, q), 1) for q in qs}


def time_to_warm(windows: np.ndarray, frac: float = 0.9) -> Optional[int]:
    """First window whose hit rate reaches ``frac`` of the final
    window's hit rate (None when the stream never hits — e.g. a
    no-prefetch variant)."""
    hr = derived_streams(windows)["hit_rate"]
    if hr.size == 0 or hr[-1] <= 0:
        return None
    idx = np.nonzero(hr >= frac * hr[-1])[0]
    return int(idx[0]) if idx.size else None


def sparkline(series: Sequence[float]) -> str:
    arr = np.asarray(series, np.float64)
    if arr.size == 0:
        return ""
    lo, hi = float(arr.min()), float(arr.max())
    span = (hi - lo) or 1.0
    return "".join(_SPARK[int(round((v - lo) / span * (len(_SPARK) - 1)))]
                   for v in arr)


# -- the dashboard ----------------------------------------------------------

def load_telemetry(path) -> dict:
    payload = json.loads(Path(path).read_text())
    for k in ("figure", "n_windows", "counters", "points"):
        if k not in payload:
            raise ValueError(f"not a telemetry payload (missing {k!r}): "
                             f"{path}")
    if list(payload["counters"]) != list(COUNTERS):
        raise ValueError(
            "telemetry payload counter catalog does not match this "
            f"build: {payload['counters']} vs {list(COUNTERS)}")
    return payload


def _point_label(pt: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(pt["coords"].items()))


def render_point(pt: dict, fmt: str = "text") -> str:
    """One point's dashboard section (text or markdown table)."""
    windows = np.asarray(pt["windows"], np.float64)
    d = derived_streams(windows)
    tails = window_percentiles(windows)
    overall = overall_percentiles(windows)
    ttw = time_to_warm(windows)
    lines = [f"## {_point_label(pt)} (N={pt.get('nodes', '?')}, "
             f"T={pt.get('T', '?')})",
             f"hit-rate ramp   {sparkline(d['hit_rate'])}  "
             f"final={d['hit_rate'][-1]:.3f}",
             f"pf accuracy     {sparkline(d['pf_accuracy'])}  "
             f"final={d['pf_accuracy'][-1]:.3f}",
             f"p95 latency     {sparkline(tails['p95'])}  "
             f"overall p50/p95/p99 = {overall['p50']}/{overall['p95']}/"
             f"{overall['p99']} cycles",
             f"time-to-warm    "
             + (f"window {ttw}/{windows.shape[0]}" if ttw is not None
                else "never (no cache hits)"),
             ""]
    header = ["win", "events", "hit_rate", "pf_acc", "late", "queue",
              "pf_backlog", "p50", "p95", "p99"]
    rows = []
    for i in range(windows.shape[0]):
        rows.append([str(i), f"{d['events'][i]:.0f}",
                     f"{d['hit_rate'][i]:.3f}", f"{d['pf_accuracy'][i]:.3f}",
                     f"{d['late_rate'][i]:.3f}",
                     f"{d['queue_occupancy'][i]:.2f}",
                     f"{d['prefetch_backlog'][i]:.1f}",
                     f"{tails['p50'][i]:.0f}", f"{tails['p95'][i]:.0f}",
                     f"{tails['p99'][i]:.0f}"])
    if fmt == "md":
        lines.append("| " + " | ".join(header) + " |")
        lines.append("|" + "|".join("---" for _ in header) + "|")
        lines += ["| " + " | ".join(r) + " |" for r in rows]
    else:
        widths = [max(len(h), *(len(r[j]) for r in rows))
                  for j, h in enumerate(header)]
        fmt_row = lambda r: "  ".join(c.rjust(w) for c, w in zip(r, widths))
        lines.append(fmt_row(header))
        lines += [fmt_row(r) for r in rows]
    return "\n".join(lines)


def render_report(payload: dict, point: Optional[int] = None,
                  fmt: str = "text", limit: int = 4) -> str:
    """The dashboard for a telemetry payload: header + per-point
    sections (all points when ``point`` is None, capped at ``limit`` —
    pass ``limit=0`` for every point; the cap is stated, never silent).
    """
    pts = payload["points"]
    chosen = pts if point is None else [pts[point]]
    out = [f"# telemetry: {payload['figure']} "
           f"({payload['n_windows']} windows, {len(pts)} points)", ""]
    shown = chosen if not limit else chosen[:limit]
    for pt in shown:
        out.append(render_point(pt, fmt=fmt))
        out.append("")
    if limit and len(chosen) > limit:
        out.append(f"... {len(chosen) - limit} more point(s) elided "
                   f"(--point N for one, --all for every point)")
    return "\n".join(out)


# -- trace validation -------------------------------------------------------

_REQUIRED = ("name", "ph", "ts", "pid", "tid")
_REQUIRED_META = ("name", "ph", "pid")  # "M" metadata events carry no ts


def validate_trace_events(payload: dict) -> List[str]:
    """Structural problems in a Chrome trace-event payload ([] = valid):
    required keys per event, non-negative durations, and proper span
    nesting per (pid, tid) lane — a child "X" span must end no later
    than the enclosing span it starts inside."""
    problems: List[str] = []
    events = payload.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    lanes: Dict[tuple, List[dict]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        required = _REQUIRED_META if ev.get("ph") == "M" else _REQUIRED
        missing = [k for k in required if k not in ev]
        if missing:
            problems.append(f"event {i} ({ev.get('name')!r}) missing "
                            f"{missing}")
            continue
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                problems.append(f"event {i} ({ev['name']!r}) has bad dur "
                                f"{ev.get('dur')!r}")
                continue
            lanes.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    eps = 1e-3
    for lane, evs in sorted(lanes.items()):
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []
        for ev in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= \
                    ev["ts"] + eps:
                stack.pop()
            if stack:
                parent = stack[-1]
                if ev["ts"] + ev["dur"] > parent["ts"] + parent["dur"] + eps:
                    problems.append(
                        f"lane {lane}: span {ev['name']!r} "
                        f"(ts={ev['ts']}, dur={ev['dur']}) overlaps the "
                        f"end of enclosing {parent['name']!r}")
            stack.append(ev)
    return problems


def validate_trace(path) -> List[str]:
    try:
        payload = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot parse {path}: {e}"]
    if not isinstance(payload, dict):
        return ["top level is not a trace object ({'traceEvents': ...})"]
    return validate_trace_events(payload)
