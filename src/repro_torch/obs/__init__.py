"""repro_torch.obs — the observability layer of the port.

Counterpart of ``repro.obs``, in three parts:

* :mod:`repro_torch.obs.telemetry` — in-run windowed counters: an
  optional ``(S, n_windows, N_COUNTERS)`` accumulator in the carry of
  ``repro_torch.core.famsim``'s step (inside its CUDA graph on the card),
  gated by the static ``FamConfig.telemetry`` tag (0 = off: the step
  launches exactly what it launched without it);
* :mod:`repro_torch.obs.spans` — host span tracing: a dependency-free
  Chrome/Perfetto trace-event emitter the executor and the throughput
  benchmark are instrumented with (``maybe_span`` is a no-op until a
  tracer is installed);
* :mod:`repro_torch.obs.report` — surfacing: ``python -m
  repro_torch.obs report`` over saved window streams, histogram-bucket
  percentile estimation (p50/p95/p99), and Chrome-trace validation.
"""
from repro_torch.obs.report import (bucket_exceedance,  # noqa: F401
                                    bucket_percentile)
from repro_torch.obs.spans import (SpanTracer, current_tracer,  # noqa: F401
                                   maybe_span, set_tracer)
from repro_torch.obs.telemetry import (COUNTERS, LAT_EDGES,  # noqa: F401
                                       N_BUCKETS, N_COUNTERS, counter_index,
                                       init_windows, window_index)
