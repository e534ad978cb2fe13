"""Fig. 16 — DRAM cache size sensitivity, 4-node same-app copies, WFQ 2.

Counterpart of the reference's ``benchmarks/fig16_cachesize.py``: the same
axes (cache size x workload x {base, wfq2}), 4 nodes, T, rows and
``derived`` format. Paper claims: average IPC gain 1.17/1.19/1.20/1.22 for
4/8/16/32 MB (+5% from 8->32 MB).

Cache size is a per-system ``FamParams`` value: the planner pads the cache
to the largest swept capacity (512 sets at 2048 KB), so the whole figure is
ONE compile group. The ``fig16_engine`` row holds the per-point
cross-check and, on a short run of the grid, the reference's
``shard_check`` (the batched mode against ``("shard", 1)``) and the
graph-vs-eager ``eager_check``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (BASELINE, WFQ, FamConfig, eager_check,
                                           engine_row, fam_replace, geomean,
                                           obs_tracer, save_outputs, workloads)
from repro_torch.experiments import (Experiment, config_axis, flag_axis,
                                     workload_axis)

NAME = "fig16_cachesize"
T = 16_000
# cache capacities scaled with the scaled-down node stream (the paper's
# 4-32 MB at full scale; same 8x sweep)
SIZES_KB = (256, 512, 1024, 2048)
CHECK_POINTS = 4       # the reference's engine-check subset


def experiment(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", telemetry: int = 0) -> Experiment:
    return Experiment(
        name=NAME, T=T,
        base=fam_replace(FamConfig(), kernel_backend=kernel_backend,
                         telemetry=telemetry),
        nodes=4, trace_backend=trace_backend,
        axes=(config_axis("cache", [kb << 10 for kb in SIZES_KB],
                          param="dram_cache_bytes",
                          labels=[str(kb) for kb in SIZES_KB]),
              workload_axis(workloads(quick)),
              flag_axis("variant", {"base": BASELINE, "wfq2": WFQ(2)})))


def figure_rows(get, wls, us_per_call: float):
    """The per-cache-size rows from ``get(cache=, workload=, variant=)``."""
    rows = []
    for kb in SIZES_KB:
        gains, occ = [], []
        for w in wls:
            base = get(cache=kb, workload=w, variant="base")
            out = get(cache=kb, workload=w, variant="wfq2")
            gains.append(out["ipc"].mean() / max(base["ipc"].mean(), 1e-9))
            occ.append(out["cache_occupancy"].mean())
        rows.append({
            "name": f"fig16_cache{kb}KB",
            "us_per_call": us_per_call,
            "derived": f"ipc_gain={geomean(gains):.3f};"
                       f"occupancy={np.mean(occ):.2f}",
            "cache_kb": kb,
            "ipc_gain_geomean": geomean(gains),
        })
    return rows


def run_figure(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", telemetry: int = 0):
    """(figure rows, ExperimentResult): the whole grid in one executor
    call, as one compile group."""
    res = experiment(quick, trace_backend, kernel_backend, telemetry).run(
        assert_compiles=True, device=device)
    info = res.info
    assert info.planned_groups == 1, info.groups  # dynamic geometry: 1 group
    return figure_rows(res.get, workloads(quick), info.us_per_call()), res


def engine(res, device="cuda", check_points=CHECK_POINTS, eager: bool = True) -> dict:
    """The ``fig16_engine`` row: the per-point engine check over the first
    ``check_points`` 256 KB points and the shard and
    graph-vs-eager checks at ``XCHECK_T`` events (left out with ``eager``
    False)."""
    check_pts = [p for p in res.points
                 if p.cfg.dram_cache_bytes == SIZES_KB[0] << 10][:check_points]
    row = engine_row("fig16_engine", res, check_pts, device)
    if eager:
        row.update(eager_check(res, device, shard=True))
    return row


def run_result(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", out=None,
               check_points=CHECK_POINTS,
               telemetry: int = 0):
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
