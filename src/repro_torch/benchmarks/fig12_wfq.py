"""Fig. 12 (A-D) + Fig. 13 — WFQ scheduling at the FAM controller with
weights 1/2/3 vs FIFO, on 2/4-node systems (same-app copies).

Counterpart of the reference's ``benchmarks/fig12_wfq.py``: the same axes
(nodes x workload x {fifo, w1, w2, w3}), T, rows and ``derived`` format.
Paper claims: weights 1/2/3 improve mean IPC by ~8/9/9% (4-node) and
~3/4/4% (2-node) over FIFO; FAM latency -24% (4n) / -10% (2n); DRAM
prefetches issued fall 17/31/37% with weight.

FIFO and WFQ share the ``scheduler:chain`` program and the weight is a
scheduler param, so the grid is ONE compile group per node count.

fig12 is also the policy-matrix driver: ``run(policies=...)`` (``python -m
repro_torch.benchmarks.run --policies``) sweeps ``PolicySet`` combinations
through a ``policy_axis`` (e.g. {fifo, wfq, strict} x {spp, nextline,
bestoffset}), each row measured against the all-default combo. The matrix's
``spp+wfq`` rows equal the plain run's ``w2`` rows byte for byte (same
traces, same program, default weight 2). A combo with ``random``
replacement needs ``kernel_backend="torch"``: the CUDA cache step raises
for it. With ``telemetry`` windows on, every row gains a JSON-only
``windowed_tail`` (the tail latency WFQ is judged on; histogram counts
summed over the workloads); ``derived`` never changes.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from repro_torch.benchmarks.common import (DRAM, WFQ, FamConfig, checked_info_row,
                                           fam_replace, geomean, obs_tracer,
                                           save_outputs, windowed_tail, workloads)
from repro_torch.experiments import (Experiment, PolicySet, flag_axis, nodes_axis,
                                     policy_axis, workload_axis)

NAME = "fig12_wfq"
POLICY_NAME = "fig12_wfq_policies"
T = 10_000
WEIGHTS = (1, 2, 3)
NODE_COUNTS = (2, 4)
VARIANTS = {"fifo": DRAM, **{f"w{w}": WFQ(w) for w in WEIGHTS}}


def _baseline_label(policies: Mapping[str, PolicySet]) -> str:
    """The matrix's baseline combo: the all-default PolicySet (spp + fifo +
    lru + token_bucket, no param overrides), the configuration the plain
    run's ``fifo`` variant executes. Full-dataclass equality, so an
    overridden look-alike is never picked as the baseline."""
    default = PolicySet()
    for label, ps in policies.items():
        if ps == default:
            return label
    raise ValueError(
        "policy matrix needs the all-default baseline combo "
        f"({default.describe()}, no overrides); got {sorted(policies)}")


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


def policy_experiment(policies: Mapping[str, PolicySet], quick: bool = True,
                      trace_backend: str = "device",
                      kernel_backend: str = "cuda", telemetry: int = 0) -> Experiment:
    """The fig12 grid with the flag-variant axis replaced by a policy axis:
    nodes x workloads x PolicySet combos, prefetching on (flags=DRAM).
    Same-tag combos (spp+fifo, spp+wfq, any weight) share a compile group
    per node count; combos with another program (strict, nextline,
    bestoffset, random) plan into their own groups."""
    return Experiment(
        name=POLICY_NAME, T=T,
        base=fam_replace(FamConfig(), kernel_backend=kernel_backend,
                         telemetry=telemetry),
        flags=DRAM, trace_backend=trace_backend,
        axes=(nodes_axis(NODE_COUNTS),
              workload_axis(workloads(quick)),
              policy_axis(dict(policies))))


def _rows_for(get, wls, variants, name_of, us_per_call: float):
    """Each variant vs its baseline, per node count: ``variants`` maps a
    row label to (lookup kwargs, baseline kwargs) of ``get``. With
    telemetry in the metrics, each row's ``windowed_tail`` (histogram
    counts summed over the workloads)."""
    rows = []
    for n in NODE_COUNTS:
        for label, (kw, base_kw) in variants.items():
            gains, lat, pf, dh, ch = [], [], [], [], []
            tele = None
            for w in wls:
                fifo = get(nodes=n, workload=w, **base_kw)
                var = get(nodes=n, workload=w, **kw)
                gains.append(var["ipc"].mean() / max(fifo["ipc"].mean(), 1e-9))
                lat.append(var["fam_latency"].mean() /
                           max(fifo["fam_latency"].mean(), 1e-9))
                pf.append(var["prefetches_issued"].sum() /
                          max(fifo["prefetches_issued"].sum(), 1.0))
                dh.append(var["demand_hit_fraction"].mean())
                ch.append(var["corepf_hit_fraction"].mean())
                if "telemetry" in var:
                    t = np.asarray(var["telemetry"])
                    tele = t if tele is None else tele + t
            row = {
                "name": name_of(n, label),
                "us_per_call": us_per_call,
                "derived": (f"ipc_vs_fifo={geomean(gains):.3f};"
                            f"rel_lat={geomean(lat):.3f};"
                            f"rel_pf={np.mean(pf):.3f}"),
                "nodes": n, "variant": label,
                "ipc_gain_vs_fifo": geomean(gains),
                "rel_fam_latency_vs_fifo": geomean(lat),
                "rel_prefetches": float(np.mean(pf)),
                "demand_hit_fraction": float(np.mean(dh)),
                "corepf_hit_fraction": float(np.mean(ch)),
            }
            if tele is not None:
                row["windowed_tail"] = windowed_tail(tele)
            rows.append(row)
    return rows


def figure_rows(get, wls, us_per_call: float):
    """The w1-w3 rows (each vs fifo) from ``get(nodes=, workload=, variant=)``."""
    variants = {f"w{w}": ({"variant": f"w{w}"}, {"variant": "fifo"})
                for w in WEIGHTS}
    rows = _rows_for(get, wls, variants, lambda n, label: f"fig12_nodes{n}_{label}",
                     us_per_call)
    for row in rows:
        row["weight"] = int(row.pop("variant")[1:])
    return rows


def policy_rows(get, wls, policies: Mapping[str, PolicySet], us_per_call: float):
    """One row per node count and non-baseline combo, each vs the
    baseline combo, from ``get(nodes=, workload=, policy=)``."""
    baseline = _baseline_label(policies)
    variants = {label: ({"policy": label}, {"policy": baseline})
                for label in policies if label != baseline}
    return _rows_for(get, wls, variants, lambda n, label: f"fig12_nodes{n}_{label}",
                     us_per_call)


def run_figure(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda",
               policies: Optional[Mapping[str, PolicySet]] = None,
               telemetry: int = 0):
    """(figure rows, ExperimentResult): the grid (or with ``policies`` the
    policy matrix) in one executor call."""
    wls = workloads(quick)
    if policies is not None:
        _baseline_label(policies)                # before running anything
        res = policy_experiment(policies, quick, trace_backend, kernel_backend,
                                telemetry).run(assert_compiles=True,
                                               device=device)
        return policy_rows(res.get, wls, policies, res.info.us_per_call()), res
    res = experiment(quick, trace_backend, kernel_backend, telemetry).run(
        assert_compiles=True, device=device)
    assert res.info.planned_groups == len(NODE_COUNTS), res.info.groups
    return figure_rows(res.get, wls, res.info.us_per_call()), res


def engine(res, device="cuda", check_points: int = 0,
           policies: Optional[Mapping[str, PolicySet]] = None, eager: bool = True) -> dict:
    """The ``fig12_engine`` row, or with ``policies`` the
    ``fig12_policies_engine`` row naming the matrix
    (:func:`~repro_torch.benchmarks.common.checked_info_row`)."""
    if policies is None:
        return checked_info_row("fig12_engine", res, device, check_points, eager)
    row = checked_info_row("fig12_policies_engine", res, device, check_points, eager)
    row["policy_matrix"] = sorted(policies)
    return row


def run_result(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", out=None,
               check_points: int = 0,
               policies: Optional[Mapping[str, PolicySet]] = None,
               telemetry: int = 0):
    """(rows, ExperimentResult): :func:`run_figure` (under the span tracer
    when ``telemetry``), then :func:`engine`."""
    name = NAME if policies is None else POLICY_NAME
    with obs_tracer(name, telemetry, out):
        rows, res = run_figure(quick, trace_backend, kernel_backend, device,
                               policies, telemetry)
    rows.append(engine(res, device, check_points, policies))
    save_outputs(name, rows, res, telemetry, out)
    return rows, res


def run(quick: bool = True, trace_backend: str = "device",
        kernel_backend: str = "cuda", device="cuda", out=None,
        policies: Optional[Mapping[str, PolicySet]] = None, telemetry: int = 0):
    return run_result(quick, trace_backend, kernel_backend, device, out,
                      policies=policies, telemetry=telemetry)[0]
