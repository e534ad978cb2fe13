"""Per-tenant tail/fairness metrics over one executed fleet sweep.

A copy of ``repro.tenants.metrics`` on the port's executor and
:mod:`repro_torch.obs`. The headline metric here is TAIL LATENCY rather
than mean IPC: per-tenant p50/p95/p99 come from the in-run 12-bucket
latency histogram (:mod:`repro_torch.obs.telemetry`, summed over the
run's windows), estimated by the same in-bucket-interpolated helper the
telemetry dashboard uses (:func:`repro_torch.obs.report.bucket_percentile`).
SLO violations are the estimated event count above the tenant's target
(:func:`repro_torch.obs.report.bucket_exceedance`); slowdown-vs-isolated
divides the embedded uncontended baseline's IPC by the fleet lane's IPC
(both lanes share workload + seed, so it is a clean A/B); fairness is the
Jain index over per-tenant normalized throughput. Everything here is
host-side numpy over fetched results.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.experiments.executor import ExperimentResult
from repro_torch.obs.report import bucket_exceedance, bucket_percentile
from repro_torch.obs.telemetry import HIST_OFFSET, N_BUCKETS
from repro_torch.tenants.lower import Lowered, TenantCell

#: Required keys of one per-tenant record — the schema
#: :func:`validate_tenant_records` holds every record to.
TENANT_SCHEMA = (
    "fleet", "tenant", "workload", "weight", "rate", "slo_latency",
    "admitted_frac", "t_live", "ipc", "p50", "p95", "p99",
    "slo_violations", "violation_rate", "slowdown", "iso_label",
)


def latency_hist(metrics: Dict[str, np.ndarray]) -> np.ndarray:
    """One point's run-total latency histogram ``(N_BUCKETS,)``: the
    telemetry windows' histogram columns summed over windows."""
    if "telemetry" not in metrics:
        raise KeyError("point has no telemetry matrix — lower the fleet "
                       "with a telemetry-enabled base config "
                       "(repro_torch.tenants.lower forces it on by default)")
    w = np.asarray(metrics["telemetry"], np.float64)
    return w[:, HIST_OFFSET:HIST_OFFSET + N_BUCKETS].sum(axis=0)


def _ipc(metrics: Dict[str, np.ndarray]) -> float:
    return float(np.asarray(metrics["ipc"], np.float64).mean())


def geomean(values: Sequence[float]) -> float:
    vals = [max(float(v), 1e-12) for v in values]
    if not vals:
        return 0.0
    return float(math.exp(sum(math.log(v) for v in vals) / len(vals)))


def jain_index(values: Sequence[float]) -> float:
    """Jain fairness index over per-tenant normalized throughputs:
    1.0 = perfectly even, 1/n = maximally unfair."""
    x = np.asarray(list(values), np.float64)
    if x.size == 0 or float((x * x).sum()) <= 0.0:
        return 0.0
    return float(x.sum() ** 2 / (x.size * (x * x).sum()))


def tenant_record(result: ExperimentResult, cell: TenantCell) -> dict:
    """One tenant's joined record: engine metrics for its fleet lane +
    its isolated baseline lane, scored against its SLO."""
    m = result.get(tenant=cell.label)
    hist = latency_hist(m)
    total = float(hist.sum())
    viol = bucket_exceedance(hist, float(cell.tenant.slo_latency))
    ipc = _ipc(m)
    slowdown = None
    if cell.frac > 0.0:
        iso_ipc = _ipc(result.get(tenant=cell.iso_label))
        slowdown = round(iso_ipc / max(ipc, 1e-12), 4)
    return {
        "fleet": cell.fleet, "tenant": cell.tenant.name,
        "workload": cell.tenant.workload,
        "weight": cell.tenant.weight, "rate": cell.tenant.rate,
        "slo_latency": cell.tenant.slo_latency,
        "admitted_frac": round(cell.frac, 4), "t_live": cell.t_live,
        "ipc": round(ipc, 4),
        "p50": round(bucket_percentile(hist, 50), 1),
        "p95": round(bucket_percentile(hist, 95), 1),
        "p99": round(bucket_percentile(hist, 99), 1),
        "slo_violations": round(viol, 1),
        "violation_rate": round(viol / total, 4) if total > 0 else 0.0,
        "slowdown": slowdown, "iso_label": cell.iso_label,
        "rho": round(cell.rho, 4), "slice_bytes": cell.slice_bytes,
        "bw_gbps": round(cell.bw_gbps, 3), "mem_latency": cell.mem_latency,
    }


def validate_tenant_records(records: Sequence[dict]) -> None:
    """Raise if any record is missing a :data:`TENANT_SCHEMA` key (the
    schema gate)."""
    for i, r in enumerate(records):
        missing = [k for k in TENANT_SCHEMA if k not in r]
        if missing:
            raise ValueError(f"tenant record {i} "
                             f"({r.get('tenant', '?')!r}) missing schema "
                             f"keys {missing}")


def fleet_summary(fleet_name: str, records: Sequence[dict]) -> dict:
    """Fleet-level aggregates over that fleet's tenant records, plus the
    deterministic ``derived`` string the benchmark CSV row carries."""
    recs = [r for r in records if r["fleet"] == fleet_name]
    if not recs:
        raise ValueError(f"no tenant records for fleet {fleet_name!r}")
    live = [r for r in recs if r["admitted_frac"] > 0.0]
    hist = np.zeros(N_BUCKETS, np.float64)
    for r in live:
        hist += np.asarray(r["_hist"], np.float64)
    total = float(hist.sum())
    viol = float(sum(r["slo_violations"] for r in live))
    slowdowns = [r["slowdown"] for r in live if r["slowdown"] is not None]
    speedups = [1.0 / max(s, 1e-12) for s in slowdowns]
    p99 = bucket_percentile(hist, 99)
    gm = geomean(slowdowns)
    jain = jain_index(speedups)
    slo_miss = sum(1 for r in live if r["p99"] > r["slo_latency"])
    out = {
        "fleet": fleet_name, "tenants": len(recs), "admitted": len(live),
        "rejected": len(recs) - len(live),
        "rho": recs[0]["rho"],
        "p50": round(bucket_percentile(hist, 50), 1),
        "p95": round(bucket_percentile(hist, 95), 1),
        "p99": round(p99, 1),
        "slowdown_geomean": round(gm, 4),
        "jain_fairness": round(jain, 4),
        "slo_violations": round(viol, 1),
        "violation_rate": round(viol / total, 4) if total > 0 else 0.0,
        "slo_miss_tenants": slo_miss,
    }
    out["derived"] = (f"admitted={len(live)}/{len(recs)};"
                      f"rho={recs[0]['rho']:.3f};p99={p99:.1f};"
                      f"slowdown={gm:.4f};jain={jain:.4f};"
                      f"viol={viol:.0f}")
    return out


def fleet_report(result: ExperimentResult, lowered: Lowered
                 ) -> Tuple[List[dict], List[dict]]:
    """The full report for one executed fleet sweep: ``(summaries,
    tenant_records)`` — one summary per fleet (with ``derived``), one
    record per tenant (schema-validated). Tenant records keep a private
    ``_hist`` array while aggregating; it is stripped before return so
    the records serialize to JSON directly."""
    records = []
    for cell in lowered.cells:
        r = tenant_record(result, cell)
        r["_hist"] = latency_hist(result.get(tenant=cell.label)).tolist()
        records.append(r)
    summaries = [fleet_summary(f.name, records) for f in lowered.fleets]
    for r in records:
        del r["_hist"]
    validate_tenant_records(records)
    return summaries, records
