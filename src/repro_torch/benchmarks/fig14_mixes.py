"""Fig. 14 — multi-workload mixes on a 4-node system, 5 prefetch configs.

Counterpart of the reference's ``benchmarks/fig14_mixes.py``: the same
mixes, configs, T, rows and ``derived`` format. Paper claims: across 7
mixes, BW adaptation and WFQ give ~+10% and ~+9% IPC over the
non-adaptive (FIFO) prefetcher on average; the winner depends on the mix.

All six configs are per-system flags and scheduler params over one policy
program (FIFO and WFQ share the chain scheduler), so the figure is ONE
compile group. fig14 is the trace-backend acceptance figure: with the
``device`` backend the run asserts that no trace was generated on the host,
and the engine row records the generation wall-clock of both backends
(``trace_gen_compare``) and a graph-vs-eager check on a short run of the
grid.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (ADAPT, BASELINE, CORE, DRAM, WFQ,
                                           FamConfig, eager_check, fam_replace,
                                           geomean, info_row, obs_tracer, save_outputs,
                                           trace_gen_compare)
from repro_torch.experiments import Experiment, flag_axis, mix_axis, plan_points

NAME = "fig14_mixes"
T = 10_000

MIXES = {
    "mix1": ["603.bwaves_s", "bfs", "canneal", "mg"],
    "mix2": ["619.lbm_s", "cc", "dedup", "LU"],
    "mix3": ["628.pop2_s", "654.roms_s", "facesim", "is"],
    "mix4": ["bfs", "bc", "sssp", "cc"],
    "mix5": ["canneal", "657.xz_s", "XSBench", "is"],
    "mix6": ["603.bwaves_s", "619.lbm_s", "649.fotonik3d_s", "FFT"],
    "mix7": ["607.cactuBSSN_s", "mg", "LU", "XSBench"],
}

CONFIGS = {"core": CORE, "fifo": DRAM, "adapt": ADAPT,
           "wfq1": WFQ(1), "wfq2": WFQ(2)}


def _mixes(quick: bool):
    return dict(list(MIXES.items())[:4]) if quick else MIXES


def experiment(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", telemetry: int = 0) -> Experiment:
    return Experiment(
        name=NAME, T=T,
        base=fam_replace(FamConfig(), kernel_backend=kernel_backend,
                         telemetry=telemetry),
        trace_backend=trace_backend,
        axes=(mix_axis(_mixes(quick)),
              flag_axis("variant", {"base": BASELINE, **CONFIGS})))


def figure_rows(get, mixes, us_per_call: float):
    """The per-mix rows and the summary from ``get(mix=, variant=)``."""
    rows = []
    adapt_over_fifo, wfq_over_fifo = [], []
    for mix, wls in mixes.items():
        b_ipc = np.maximum(get(mix=mix, variant="base")["ipc"], 1e-9)
        r = {cname: geomean(get(mix=mix, variant=cname)["ipc"] / b_ipc)
             for cname in CONFIGS}
        adapt_over_fifo.append(r["adapt"] / r["fifo"])
        wfq_over_fifo.append(r["wfq2"] / r["fifo"])
        rows.append({
            "name": f"fig14_{mix}",
            "us_per_call": us_per_call,
            "derived": ";".join(f"{k}={v:.3f}" for k, v in r.items()),
            "mix": wls, **{f"ipc_gain_{k}": v for k, v in r.items()},
        })
    rows.append({
        "name": "fig14_summary", "us_per_call": 0.0,
        "derived": (f"adapt_vs_fifo={np.mean(adapt_over_fifo):.3f};"
                    f"wfq2_vs_fifo={np.mean(wfq_over_fifo):.3f}"),
    })
    return rows


def run_figure(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", telemetry: int = 0):
    """(figure rows, ExperimentResult): the whole grid in one executor
    call, as one compile group."""
    res = experiment(quick, trace_backend, kernel_backend, telemetry).run(
        assert_compiles=True, device=device)
    info = res.info
    assert info.planned_groups == 1, info.groups  # one policy program
    if trace_backend == "device":
        # no trace was generated on the host
        assert info.host_trace_events == 0, info.host_trace_events
    return figure_rows(res.get, _mixes(quick), info.us_per_call()), res


def engine(res, device="cuda", quick: bool = True, eager: bool = True) -> dict:
    """The ``fig14_engine`` row: the accounting, the graph-vs-eager check
    at ``XCHECK_T`` events (left out with ``eager`` False) and, at the
    quick size with device traces, the generation wall-clock of both
    backends."""
    extra = eager_check(res, device) if eager else {}
    if quick and res.info.trace_backend == "device":
        plan = plan_points(res.points, name=NAME, trace_backend="device")
        extra["trace_gen_compare"] = trace_gen_compare(plan, device)
    return info_row("fig14_engine", res.info, **extra)


def run_result(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", out=None,
               telemetry: int = 0):
    """(rows, ExperimentResult): :func:`run_figure` (under the span tracer
    when ``telemetry``), then :func:`engine`."""
    with obs_tracer(NAME, telemetry, out):
        rows, res = run_figure(quick, trace_backend, kernel_backend, device,
                               telemetry)
    rows.append(engine(res, device, quick))
    save_outputs(NAME, rows, res, telemetry, out)
    return rows, res


def run(quick: bool = True, trace_backend: str = "device",
        kernel_backend: str = "cuda", device="cuda", out=None, telemetry: int = 0):
    return run_result(quick, trace_backend, kernel_backend, device, out,
                      telemetry=telemetry)[0]
