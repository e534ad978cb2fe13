"""sim_events_per_s (events/s): simulated events (systems x nodes x T) of
every sweep of the window over the window's wall time, on one card (host
clock)."""


def read(run):
    return run.events / run.window_s if run.window_s > 0 else None
