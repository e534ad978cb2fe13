"""sweep_host_ms (ms): a sweep's executor time outside its runners and
captures (planning, numpy traces, staging, the fetch), ``RunInfo.wall_s -
run_s - compile_s`` averaged over the window's sweeps (program span)."""


def read(run):
    if not run.sweeps:
        return None
    host = [s["wall_s"] - s["run_s"] - s["compile_s"] for s in run.sweeps]
    return sum(host) / len(host) * 1e3
