"""setup_s (s): process start to the first timed sweep — imports, the
cache-step kernel's build on a checkout's first run, the warm sweep and its
graph captures (host clock)."""


def read(run):
    return run.setup_s
