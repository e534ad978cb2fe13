"""The fleet scenario as a ``repro_torch.search`` objective (``pond_tail``).

Counterpart of ``repro.tenants.search``. One generation evaluates every
candidate's fleet-wide QoS setting — WFQ weight, scheduler backlog cap,
issue-rate entitlement, all traced policy params (:func:`qos_space`) —
against the same tenant fleet, and scores it by per-tenant p99 uplift vs
the embedded baseline candidate minus an SLO-violation penalty. Every knob
is traced, so after generation 1 the whole search (all generations x all
candidates x all tenants) replays ONE cached runner's CUDA graph.

Usage::

    from repro_torch.search import run_search
    from repro_torch.tenants.search import qos_space
    run_search(qos_space(), objective="pond_tail", out_dir="/tmp/pond_search", ...)

The generation grid is ``grid_axis("candidate", ...)`` (baseline +
samples — candidate policies apply fleet-wide) crossed with the tenant
axis from :func:`repro_torch.tenants.lower.fleet_axis_cells` *without*
per-tenant policies or embedded isolated baselines (the baseline
candidate plays that role, as in fig14's search).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.experiments import Experiment, grid_axis
from repro_torch.obs.report import bucket_exceedance, bucket_percentile
from repro_torch.policies import PolicySet
from repro_torch.search.objectives import Objective, register_objective
from repro_torch.search.space import SearchSpace, continuous, policy_param
from repro_torch.tenants.lower import ensure_telemetry, fleet_axis_cells
from repro_torch.tenants.metrics import geomean, latency_hist
from repro_torch.tenants.spec import FleetSpec, make_tenants


def qos_space() -> SearchSpace:
    """The fleet-wide QoS design space: every dimension targets a traced
    ``FamParams.policy`` tensor, so no proposer move changes the runner
    key."""
    base = PolicySet(scheduler="wfq", adaptation="static")
    return SearchSpace(
        dimensions=(
            continuous("wfq_weight",
                       policy_param("scheduler", "weight"), 0.5, 8.0),
            continuous("backlog_cap",
                       policy_param("scheduler", "backlog_cap"),
                       500.0, 4000.0),
            continuous("issue_rate",
                       policy_param("adaptation", "rate"), 0.25, 1.0),
        ),
        base_policies=base)


def default_search_fleet() -> FleetSpec:
    """A small contended fleet for QoS tuning: 16 tenants, zipf weight
    skew, everyone admitted (the knobs under test do the throttling)."""
    return FleetSpec(name="pondsearch",
                     tenants=make_tenants(16, skew="zipf"),
                     admission="none")


class PondObjective(Objective):
    """Per-tenant tail-latency fitness over a multi-tenant fleet.

    Score for one candidate: geomean over live tenants of
    ``baseline_p99 / candidate_p99`` (tail uplift; >1 = candidate
    shortens tails) minus ``slo_penalty`` times the candidate's mean
    per-tenant SLO-violation rate. The per-key dict (one entry per
    tenant lane) feeds the standard ``derived_string`` replay
    contract."""

    name = "pond_tail"

    def __init__(self, fleet: Optional[FleetSpec] = None,
                 slo_penalty: float = 0.25):
        self.fleet = fleet if fleet is not None else default_search_fleet()
        self.slo_penalty = float(slo_penalty)
        self._cells = None

    def header_mixes(self) -> dict:
        wls = list(dict.fromkeys(t.workload for t in self.fleet.tenants))
        return {"scenario": "pond", "fleet": self.fleet.name,
                "tenants": self.fleet.size,
                "admission": self.fleet.admission,
                "slo_penalty": self.slo_penalty, "workloads": wls}

    def build(self, space, samples, labels, *, base, T, seed,
              trace_backend, name) -> Experiment:
        base = ensure_telemetry(base)
        tenant_values, cells, _ = fleet_axis_cells(
            [self.fleet], base, T=T, include_isolated=False,
            include_policies=False)
        self._cells = cells
        cand = {"baseline": {"policies": space.base_policies,
                             "flags": space.base_flags}}
        for lb, s in zip(labels, samples):
            cand[lb] = space.axis_fields(s)
        return Experiment(name=name, base=base, T=T, seed=seed,
                          trace_backend=trace_backend,
                          axes=(grid_axis("candidate", cand),
                                grid_axis("tenant", tenant_values)))

    def score(self, result, label: str) -> Tuple[Dict[str, float], float]:
        if self._cells is None:
            raise RuntimeError("score() before build() — the objective "
                               "joins results against the cells of the "
                               "generation it built")
        per_tenant: Dict[str, float] = {}
        viol_rates = []
        for cell in self._cells:
            if cell.frac <= 0.0:
                continue
            h_c = latency_hist(result.get(candidate=label,
                                          tenant=cell.label))
            h_b = latency_hist(result.get(candidate="baseline",
                                          tenant=cell.label))
            p99_c = max(bucket_percentile(h_c, 99), 1.0)
            p99_b = max(bucket_percentile(h_b, 99), 1.0)
            per_tenant[cell.label] = p99_b / p99_c
            total = float(h_c.sum())
            viol = bucket_exceedance(h_c, float(cell.tenant.slo_latency))
            viol_rates.append(viol / total if total > 0 else 0.0)
        uplift = geomean(list(per_tenant.values()))
        penalty = self.slo_penalty * (sum(viol_rates) / len(viol_rates)
                                      if viol_rates else 0.0)
        return per_tenant, uplift - penalty


register_objective(PondObjective.name, PondObjective)
