"""Fig. 10 (A-D) + Fig. 11 — DRAM-cache prefetching with and without
prefetch bandwidth adaptation, on 1/2/4-node systems (same-app copies).

Counterpart of the reference's ``benchmarks/fig10_bw_adaptation.py``: the
same axes (nodes x workload x {base, core, dram, adapt}), T, rows and
``derived`` format. Paper claims (geomeans): core-pf IPC gain
1.20/1.18/1.10 for 1/2/4 nodes; +DRAM prefetch -> 1.26/1.24/1.11; BW
adaptation adds +4%/+8% at 2/4 nodes; FAM latency -29%/-34% (1/2 nodes);
prefetches issued -18%/-21% (2/4 nodes).

The four prefetch configs are per-system flags over the default
``PolicySet``, so the planner makes ONE compile group per node count (the
node count sets the arbitration width N): three groups, three CUDA graph
captures on the card. With ``telemetry`` windows on, each per-node-count
row gains a JSON-only ``windowed_tail`` per variant (histogram counts
summed over the workloads); ``derived`` never changes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (ADAPT, BASELINE, CORE, DRAM, FamConfig,
                                           checked_info_row, fam_replace, geomean,
                                           obs_tracer, save_outputs, windowed_tail,
                                           workloads)
from repro_torch.experiments import Experiment, flag_axis, nodes_axis, workload_axis

NAME = "fig10_bw_adaptation"
T = 10_000
NODE_COUNTS = (1, 2, 4)
VARIANTS = {"base": BASELINE, "core": CORE, "dram": DRAM, "adapt": ADAPT}


def experiment(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", telemetry: int = 0) -> Experiment:
    return Experiment(
        name=NAME, T=T,
        base=fam_replace(FamConfig(), kernel_backend=kernel_backend,
                         telemetry=telemetry),
        trace_backend=trace_backend,
        axes=(nodes_axis(NODE_COUNTS),
              workload_axis(workloads(quick)),
              flag_axis("variant", VARIANTS)))


def figure_rows(get, wls, us_per_call: float):
    """The per-node-count rows and the fig11 row from
    ``get(nodes=, workload=, variant=)``; with telemetry in the metrics,
    each per-node-count row's ``windowed_tail``."""
    rows = []
    per_wl_4node = {}
    for n in NODE_COUNTS:
        agg = {k: [] for k in ("core", "dram", "adapt")}
        rel_lat = {k: [] for k in ("core", "dram", "adapt")}
        rel_pf = []
        hits = {"demand": [], "corepf": [], "demand_ad": [], "corepf_ad": []}
        for w in wls:
            out = {k: get(nodes=n, workload=w, variant=k) for k in VARIANTS}
            b_ipc = np.maximum(out["base"]["ipc"].mean(), 1e-9)
            b_lat = np.maximum(out["base"]["fam_latency"].mean(), 1e-9)
            for k in ("core", "dram", "adapt"):
                agg[k].append(out[k]["ipc"].mean() / b_ipc)
                rel_lat[k].append(out[k]["fam_latency"].mean() / b_lat)
            rel_pf.append(out["adapt"]["prefetches_issued"].sum() /
                          max(out["dram"]["prefetches_issued"].sum(), 1.0))
            hits["demand"].append(out["dram"]["demand_hit_fraction"].mean())
            hits["corepf"].append(out["dram"]["corepf_hit_fraction"].mean())
            hits["demand_ad"].append(out["adapt"]["demand_hit_fraction"].mean())
            hits["corepf_ad"].append(out["adapt"]["corepf_hit_fraction"].mean())
            if n == 4:
                per_wl_4node[w] = {k: float(out[k]["ipc"].mean() / b_ipc)
                                   for k in ("core", "dram", "adapt")}
        row = {
            "name": f"fig10_nodes{n}",
            "us_per_call": us_per_call,
            "derived": (f"core={geomean(agg['core']):.3f};"
                        f"dram={geomean(agg['dram']):.3f};"
                        f"adapt={geomean(agg['adapt']):.3f};"
                        f"rel_pf={np.mean(rel_pf):.3f}"),
            "nodes": n,
            "ipc_gain": {k: geomean(v) for k, v in agg.items()},
            "rel_fam_latency": {k: geomean(v) for k, v in rel_lat.items()},
            "rel_prefetches_adapt": float(np.mean(rel_pf)),
            "hit_fractions": {k: float(np.mean(v)) for k, v in hits.items()},
        }
        if "telemetry" in get(nodes=n, workload=wls[0], variant="base"):
            # JSON-only windowed tails: histogram counts summed over the
            # workloads, one aggregate per variant
            row["windowed_tail"] = {
                k: windowed_tail(sum(np.asarray(get(nodes=n, workload=w,
                                                    variant=k)["telemetry"])
                                     for w in wls))
                for k in VARIANTS}
        rows.append(row)
    rows.append({"name": "fig11_per_workload_4node", "us_per_call": 0.0,
                 "derived": "see per_workload field",
                 "per_workload": per_wl_4node})
    return rows


def run_figure(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", telemetry: int = 0):
    """(figure rows, ExperimentResult): the whole grid in one executor
    call, one compile group per node count."""
    res = experiment(quick, trace_backend, kernel_backend, telemetry).run(
        assert_compiles=True, device=device)
    info = res.info
    assert info.planned_groups == len(NODE_COUNTS), info.groups
    return figure_rows(res.get, workloads(quick), info.us_per_call()), res


def engine(res, device="cuda", check_points: int = 0, eager: bool = True) -> dict:
    """The ``fig10_engine`` row (:func:`~repro_torch.benchmarks.common.
    checked_info_row`)."""
    return checked_info_row("fig10_engine", res, device, check_points, eager)


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
