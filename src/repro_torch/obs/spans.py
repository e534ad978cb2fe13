"""Host span tracing: a dependency-free Chrome/Perfetto trace emitter.

A copy of ``repro.obs.spans`` (the port imports nothing of the JAX
package, so it keeps its own; a test holds the two equal).

One :class:`SpanTracer` records complete ("ph": "X") trace events with
microsecond timestamps relative to its creation; :meth:`SpanTracer.save`
writes the standard Chrome trace-event JSON object format, loadable in
``chrome://tracing`` or https://ui.perfetto.dev.

Instrumented code never talks to a tracer directly: it calls
:func:`maybe_span`, a no-op unless a tracer has been installed with
:func:`set_tracer`. The port's executor instruments plan -> per-group
trace staging -> run (the device call, with the CUDA graph capture inside
it, and the fetch) this way, and ``bench_famsim`` its repeats, so
``repro_torch.benchmarks.run --telemetry`` (or any caller that installs a
tracer) gets one nested timeline of the whole run.

Spans emitted from worker threads (the executor's trace-staging thread)
get their own ``tid`` lane, so nesting stays well-formed per thread; the
tracer's event list is guarded by a lock.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, List, Optional

__all__ = ["SpanTracer", "set_tracer", "current_tracer", "maybe_span"]


def _jsonable(args: Dict) -> Dict:
    out = {}
    for k, v in args.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


class SpanTracer:
    """Record spans/instants and emit Chrome trace-event JSON."""

    def __init__(self, process_name: str = "repro"):
        self.process_name = process_name
        self.events: List[dict] = []
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}

    # -- recording ---------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            return self._tids.setdefault(ident, len(self._tids))

    @contextmanager
    def span(self, name: str, cat: str = "host", **args) -> Iterator[None]:
        """Record the enclosed block as one complete ("X") event."""
        t0 = self._now_us()
        try:
            yield
        finally:
            t1 = self._now_us()
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": round(t0, 1), "dur": round(max(t1 - t0, 0.0), 1),
                  "pid": 0, "tid": self._tid()}
            if args:
                ev["args"] = _jsonable(args)
            with self._lock:
                self.events.append(ev)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": round(self._now_us(), 1), "pid": 0, "tid": self._tid()}
        if args:
            ev["args"] = _jsonable(args)
        with self._lock:
            self.events.append(ev)

    # -- summarizing / emitting -------------------------------------------

    def mark(self) -> int:
        """Bookmark into the event list (for windowed :meth:`summary`)."""
        with self._lock:
            return len(self.events)

    def summary(self, since: int = 0) -> Dict[str, dict]:
        """``{span name: {count, total_s}}`` over events recorded after
        ``since`` (a :meth:`mark`) — the compact form ``RunInfo.spans``
        and the search timings sidecar carry."""
        out: Dict[str, dict] = {}
        with self._lock:
            events = list(self.events[since:])
        for ev in events:
            if ev.get("ph") != "X":
                continue
            s = out.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] += ev["dur"] / 1e6
        return {k: {"count": v["count"], "total_s": round(v["total_s"], 4)}
                for k, v in sorted(out.items())}

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON *object format* payload."""
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": self.process_name}}]
        with self._lock:
            events = list(self.events)
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.chrome_trace(), indent=1))
        return path


# -- process-global current tracer ------------------------------------------

_CURRENT: Optional[SpanTracer] = None


def set_tracer(tracer: Optional[SpanTracer]) -> Optional[SpanTracer]:
    """Install ``tracer`` as the process-global target of
    :func:`maybe_span`; returns the previous one (restore it when done)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer
    return prev


def current_tracer() -> Optional[SpanTracer]:
    return _CURRENT


@contextmanager
def maybe_span(name: str, cat: str = "host",
               **args) -> Iterator[Optional[SpanTracer]]:
    """Span against the current tracer; exact no-op when none installed."""
    tracer = _CURRENT
    if tracer is None:
        yield None
        return
    with tracer.span(name, cat=cat, **args):
        yield tracer
