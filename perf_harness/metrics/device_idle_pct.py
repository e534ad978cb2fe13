"""device_idle_pct (%): the share of the traced sweep's profiler window in
which no device operation ran (device trace)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return (1 - run.trace.busy_s() / run.trace.window_s) * 100
