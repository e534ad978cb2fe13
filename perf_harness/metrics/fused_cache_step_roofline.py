"""fused_cache_step_roofline (%): the cache-step kernel's bytes a launch
(``perf_harness.lib.work.cache_step_lane_bytes`` times the sweep's
simulated lanes; the lanes the executor pads a launch with do no simulated
work) at the card's HBM rate, over its mean device time (device trace)."""
from perf_harness.lib.profile import replay_kernels


def read(run):
    found = replay_kernels(run.trace) if run.trace is not None else None
    if not found or run.peak is None:
        return None
    bound_s = run.cache_step_bytes() / run.peak["hbm_bytes_per_s"]
    return bound_s / found.cache_step_s * 100
