"""replay_us_per_step (us): the runners' seconds (``RunInfo.run_s``: the
graphed windows of event steps, the window copies, the fetch) over the
padded event steps they ran, summed over the window's sweeps (program
span)."""


def read(run):
    steps, seconds = run.steps_and_replay_s()
    return seconds / steps * 1e6 if steps else None
