"""sim_step_roofline_pct (%): the whole event step's share of the card's
byte bound — the bytes the simulated work of a step has to move, counted
from the configuration's sizes over the sweep's lanes
(``perf_harness.lib.work``), at the card's HBM rate, over the device time
a step in the traced sweep: the device's busy time from its first to its
last cache-step launch over the steps between them (device trace)."""
from perf_harness.lib.profile import replay_kernels


def read(run):
    found = replay_kernels(run.trace) if run.trace is not None else None
    if not found or run.peak is None:
        return None
    bound_s = run.step_bytes() / run.peak["hbm_bytes_per_s"]
    return bound_s / found.step_s * 100
