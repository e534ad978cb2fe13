"""The traced run's profiler window and what is read from it.

``torch.profiler`` (CPU and CUDA activities) runs over one sweep of the
cell at a short trace length, already captured at set-up, so the window
holds graph replays and the executor's host work and no capture. The raw
records are read from ``prof.profiler.kineto_results`` (building the
Python event tree of ~10^5 records takes tens of seconds). Kineto drops
records whose device timestamps fall outside its window, and, late in a
process, the first records of a window: so the card idles ``MARGIN_S`` at
each end and the window opens with ``LEAD_IN`` spin kernels, which every
count leaves out.

The executor's host spans (``repro_torch.obs.spans``: trace staging, run,
device call, fetch) are recorded in the same window and placed on the
profiler's clock through the ``SWEEP`` annotation around the call, so each
idle gap of the device is named by the innermost span the host was in.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional, Tuple

LEAD_IN = 64
LEAD_IN_CYCLES = 2_000_000
LEAD_IN_KERNEL = "spin_kernel"
MARGIN_S = 0.1
SWEEP = "perf_harness.sweep"
CACHE_STEP_KERNEL = "cache_step_kernel"
TOP = 10


@dataclass
class Trace:
    """Device records (name, start ns, end ns) inside the window, the
    window's bounds (ns) and the host spans on the same clock."""

    kernels: List[Tuple[str, int, int]]
    copies: List[Tuple[str, int, int]]
    window: Tuple[int, int]
    spans: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds in which any device operation ran (union of intervals)."""
        return _union(self.kernels + self.copies) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The device's idle intervals inside the window."""
        out, cursor = [], self.window[0]
        for _, s, e in sorted(self.kernels + self.copies, key=lambda r: r[1]):
            if s > cursor:
                out.append((cursor, s))
            cursor = max(cursor, e)
        if self.window[1] > cursor:
            out.append((cursor, self.window[1]))
        return out

    def host_at(self, t: int) -> str:
        """The innermost host span around time ``t`` (ns)."""
        inside = [(e - s, name) for name, s, e in self.spans if s <= t <= e]
        return min(inside)[1] if inside else "host"

    def breakdown(self) -> dict:
        by_op = {}
        for name, s, e in self.kernels + self.copies:
            by_op[name] = by_op.get(name, 0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[name, ns / 1e9] for name, ns in ops],
                "idle_gaps": [[self.host_at((s + e) // 2), (e - s) / 1e9] for s, e in gaps]}


def _union(records) -> int:
    total, cursor = 0, None
    for _, s, e in sorted(records, key=lambda r: r[1]):
        if cursor is None or s > cursor:
            total += e - s
            cursor = e
        elif e > cursor:
            total += e - cursor
            cursor = e
    return total


def traced(torch, fn: Callable[[], object]) -> Tuple[object, Trace]:
    """Run ``fn`` under the profiler with the executor's span tracer
    installed; returns (its result, the window's trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.obs.spans import SpanTracer, set_tracer

    created = time.perf_counter()
    tracer = SpanTracer("perf_harness")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN_S)
        for _ in range(LEAD_IN):
            torch.cuda._sleep(LEAD_IN_CYCLES)
        torch.cuda.synchronize()
        previous = set_tracer(tracer)
        try:
            with record_function(SWEEP):
                host0 = time.perf_counter()
                result = fn()
                torch.cuda.synchronize()
        finally:
            set_tracer(previous)
        time.sleep(MARGIN_S)
    device, window = [], None
    for e in prof.profiler.kineto_results.events():
        # a record_function range also shows on the device's timeline: it
        # is an annotation, not an operation that ran there
        annotation = e.name() == SWEEP or getattr(e, "is_user_annotation", bool)()
        if e.device_type() == DeviceType.CUDA:
            if LEAD_IN_KERNEL not in e.name() and not annotation:
                device.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.name() == SWEEP:
            window = (e.start_ns(), e.end_ns())
    if window is None:
        raise RuntimeError(f"the profiler kept no {SWEEP!r} annotation")
    device = [r for r in device if r[1] >= window[0] and r[2] <= window[1]]
    kernels = [r for r in device if not r[0].startswith(("Memcpy", "Memset"))]
    copies = [r for r in device if r[0].startswith(("Memcpy", "Memset"))]
    # the tracer's microseconds since its creation, on the profiler's clock
    offset = window[0] - int((host0 - created) * 1e9)
    spans = [(ev["name"], offset + int(ev["ts"] * 1e3), offset + int((ev["ts"] + ev["dur"]) * 1e3))
             for ev in tracer.events if ev.get("ph") == "X"]
    return result, Trace(kernels, copies, window, spans)


class Replay(NamedTuple):
    """The replayed steps between the first and the last cache-step launch."""

    kernels_per_event: float     # device kernels that start there, a step
    cache_step_s: float          # mean device time of a cache-step launch
    launches: int                # cache-step launches recorded
    step_s: float                # device busy time there, a step


def replay_kernels(trace: Trace) -> Optional[Replay]:
    """The kernels, the cache-step kernel's time and the device's busy time
    a step over the replayed steps: from the first to the last cache-step
    launch, over the steps between them. The busy time leaves out the
    device's idle gaps there, which the profiler's own host work widens
    (the timed window has none: its runners' time a step equals this).
    None when fewer than two cache-step launches were recorded."""
    steps = sorted((r for r in trace.kernels if CACHE_STEP_KERNEL in r[0]), key=lambda r: r[1])
    if len(steps) < 2:
        return None
    t0, t1 = steps[0][1], steps[-1][1]
    n = sum(1 for r in trace.kernels if t0 <= r[1] < t1)
    mean = sum(e - s for _, s, e in steps) / len(steps) / 1e9
    busy = _union([(name, max(s, t0), min(e, t1)) for name, s, e in trace.kernels + trace.copies
                   if s < t1 and e > t0])
    return Replay(n / (len(steps) - 1), mean, len(steps), busy / 1e9 / (len(steps) - 1))
