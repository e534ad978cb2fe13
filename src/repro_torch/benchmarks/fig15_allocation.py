"""Fig. 15 — IPC across allocation ratios (FAM:DRAM footprint split),
4-node, measured against the all-local configuration.

Counterpart of the reference's ``benchmarks/fig15_allocation.py``: the
same axes (ratio x the first 4 quick workloads x {local, core, dram,
adapt, wfq2}), 4 nodes, T, rows and ``derived`` format. Paper claims: with
core-pf only, IPC decrement grows from ~10% (ratio 1) to ~28% (ratio 8);
DRAM prefetch recovers ~5-6% across ratios; the adaptive variants matter
most at high ratios.

The allocation ratio is a per-system ``FamParams`` value and every variant
(the WFQ weight included, a scheduler param) is a per-system flag or
param, so the whole figure is ONE compile group: 80 systems x 4 nodes,
one CUDA graph capture on the card. ``telemetry`` windows, when on, go
only to ``<out>/telemetry/``; the rows do not change.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (ADAPT, CORE, DRAM, WFQ, FamConfig,
                                           checked_info_row, fam_replace, geomean,
                                           obs_tracer, save_outputs, workloads)
from repro_torch.experiments import Experiment, config_axis, flag_axis, workload_axis
from repro_torch.policies import SimFlags

NAME = "fig15_allocation"
T = 10_000
RATIOS = (1, 2, 4, 8)
LOCAL = SimFlags(all_local=True)
VARIANTS = (("core", CORE), ("dram", DRAM), ("adapt", ADAPT),
            ("wfq2", WFQ(2)))


def _wls(quick: bool):
    return workloads(quick)[:4] if quick else workloads(False)


def experiment(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", telemetry: int = 0) -> Experiment:
    return Experiment(
        name=NAME, T=T,
        base=fam_replace(FamConfig(), kernel_backend=kernel_backend,
                         telemetry=telemetry),
        nodes=4, trace_backend=trace_backend,
        axes=(config_axis("ratio", RATIOS, param="allocation_ratio"),
              workload_axis(_wls(quick)),
              flag_axis("variant", {"local": LOCAL, **dict(VARIANTS)})))


def figure_rows(get, wls, us_per_call: float):
    """The per-ratio rows from ``get(ratio=, workload=, variant=)``."""
    rows = []
    for ratio in RATIOS:
        agg = {k: [] for k, _ in VARIANTS}
        for w in wls:
            l_ipc = np.maximum(get(ratio=ratio, workload=w, variant="local")
                               ["ipc"].mean(), 1e-9)
            for key, _ in VARIANTS:
                agg[key].append(get(ratio=ratio, workload=w, variant=key)
                                ["ipc"].mean() / l_ipc)
        rows.append({
            "name": f"fig15_ratio{ratio}",
            "us_per_call": us_per_call,
            "derived": ";".join(f"{k}={geomean(v):.3f}" for k, v in agg.items()),
            "ratio": ratio,
            **{f"ipc_vs_all_local_{k}": geomean(v) for k, v in agg.items()},
        })
    return rows


def run_figure(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", telemetry: int = 0):
    """(figure rows, ExperimentResult): the whole grid in one executor
    call, as one compile group."""
    res = experiment(quick, trace_backend, kernel_backend, telemetry).run(
        assert_compiles=True, device=device)
    info = res.info
    assert info.planned_groups == 1, info.groups  # every axis is per-system
    return figure_rows(res.get, _wls(quick), info.us_per_call()), res


def engine(res, device="cuda", check_points: int = 0, eager: bool = True) -> dict:
    """The ``fig15_engine`` row (:func:`~repro_torch.benchmarks.common.
    checked_info_row`)."""
    return checked_info_row("fig15_engine", res, device, check_points, eager)


def run_result(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", out=None,
               check_points: int = 0, telemetry: int = 0):
    """(rows, ExperimentResult): :func:`run_figure` (under the span tracer
    when ``telemetry``), then :func:`engine`."""
    with obs_tracer(NAME, telemetry, out):
        rows, res = run_figure(quick, trace_backend, kernel_backend, device,
                               telemetry)
    rows.append(engine(res, device, check_points))
    save_outputs(NAME, rows, res, telemetry, out)
    return rows, res


def run(quick: bool = True, trace_backend: str = "device",
        kernel_backend: str = "cuda", device="cuda", out=None, telemetry: int = 0):
    return run_result(quick, trace_backend, kernel_backend, device, out,
                      telemetry=telemetry)[0]
