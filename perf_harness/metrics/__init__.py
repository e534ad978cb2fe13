"""Metric readers, one file a metric of BENCHMARK.json: ``read(run)``
returns its value or None (``perf_harness.lib.runner.Run``)."""
