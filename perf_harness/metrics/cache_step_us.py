"""cache_step_us (us): mean device time of a ``cache_step_kernel`` launch
(``fused_cache_step``) in the traced sweep's profiler window (device
trace)."""
from perf_harness.lib.profile import replay_kernels


def read(run):
    found = replay_kernels(run.trace) if run.trace is not None else None
    return found.cache_step_s * 1e6 if found else None
