"""kernels_per_event (kernels): device kernels launched per event step,
counted in the traced sweep's profiler window between its first and last
cache-step launch (device trace)."""
from perf_harness.lib.profile import replay_kernels


def read(run):
    found = replay_kernels(run.trace) if run.trace is not None else None
    return found.kernels_per_event if found else None
