"""Lower a tenant fleet onto the experiment engine: one compile group.

A copy of ``repro.tenants.lower`` on the port's experiments. The mapping:

* **tenant -> system lane.** Every tenant of every fleet (plus every
  deduplicated isolated baseline) becomes one single-node
  ``grid_axis("tenant", ...)`` cell of ONE Experiment. All cells share
  the base config's geometry-free shape and one
  ``PolicySet(scheduler="wfq", adaptation=...)`` compile tag, so the
  planner folds the whole population into one padded compile group (one
  CUDA graph capture on the card); fleet size only widens the system
  axis.
* **QoS -> per-system policy params.** Per-tenant WFQ ``weight`` and
  issue-``rate`` ride as ``PolicySet.override`` numeric params.
* **contention -> per-system config values.** A deterministic host-side
  model (:func:`contention`, Python float arithmetic in the reference's
  operation order, so its values equal the reference's exactly) splits
  the pool bandwidth by weighted share and inflates FAM latency with
  utilization; the results ride ``fam_bw_gbps`` / ``fam_mem_latency``.
  The pool's DRAM cache is sliced evenly (the group pads to the largest
  slice).
* **admission -> lifetime.** :mod:`repro_torch.tenants.admission` returns
  per-tenant live fractions; the lowering turns them into ``t_live`` (the
  masked runner's per-system ``t_true``).
* **isolated baselines -> embedded cells.** Each distinct tenant
  archetype (workload, weight, rate, cache slice, adaptation, seed)
  contributes ONE extra cell at base (uncontended) bandwidth/latency,
  the denominator of slowdown-vs-isolated, in the same compile group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import FamConfig, fam_replace
from repro_torch.experiments.spec import Experiment, grid_axis
from repro_torch.policies import PolicySet
from repro_torch.tenants.admission import admit
from repro_torch.tenants.spec import FleetSpec, TenantSpec
from repro_torch.traces.backend import DEFAULT_BACKEND
from repro_torch.traces.specs import WORKLOADS

#: Telemetry windows a fleet run defaults to when the base config has
#: observability off — tenant metrics NEED the in-graph latency
#: histogram (p50/p95/p99 come from its buckets).
DEFAULT_WINDOWS = 8


# -- the deterministic contention model -------------------------------------

def offered_load(t: TenantSpec, cfg: FamConfig, fleet: FleetSpec) -> float:
    """Offered FAM traffic of one tenant, bytes/cycle: the workload's
    miss intensity (``mpki`` at the modeled core stream) times the bytes
    moved per miss (a demand line plus ``pf_intensity`` prefetched
    blocks), derated by the fleet duty cycle. Pure spec arithmetic — the
    admission controller and bandwidth-sharing model both consume it."""
    spec = WORKLOADS[t.workload]
    misses_per_cycle = (cfg.base_ipc * cfg.cores_per_node
                        * spec.mpki / 1000.0 * fleet.duty)
    bytes_per_miss = (cfg.demand_bytes
                      + fleet.pf_intensity * cfg.block_bytes)
    return misses_per_cycle * bytes_per_miss * t.rate


@dataclass(frozen=True)
class Contention:
    """Per-tenant contention outcome (spec order) + fleet utilization."""

    fracs: Tuple[float, ...]        # admitted live fraction per tenant
    bw_gbps: Tuple[float, ...]      # effective FAM bandwidth per tenant
    mem_latency: Tuple[int, ...]    # effective FAM latency per tenant
    loads: Tuple[float, ...]        # offered bytes/cycle per tenant
    rho: float                      # admitted load / pool capacity


def contention(fleet: FleetSpec, cfg: FamConfig) -> Contention:
    """Split the pool among admitted tenants, deterministically.

    Bandwidth: tenant i's weighted share ``s_i`` of the pool is
    guaranteed; idle capacity (``1 - rho``) is shared work-conserving,
    and the result clamps to the per-node link (the base
    ``fam_bw_gbps`` — a tenant never beats its isolated bandwidth).
    Latency: one shared queueing term, ``base * (1 + q_gain *
    min(rho, 8))``, rounded to integer cycles. Rejected tenants keep
    base values (they never execute a live step)."""
    pool_bw = fleet.pool_bw_gbps if fleet.pool_bw_gbps is not None \
        else fleet.pool_bw_scale * cfg.fam_bw_gbps
    pool_bpc = pool_bw / cfg.clock_ghz
    loads = [offered_load(t, cfg, fleet) for t in fleet.tenants]
    fracs = admit(fleet, loads, pool_bpc)
    admitted = sum(f * ld for f, ld in zip(fracs, loads))
    rho = admitted / max(pool_bpc, 1e-12)
    total_w = sum(t.weight * f for t, f in zip(fleet.tenants, fracs))
    lat = int(round(cfg.fam_mem_latency
                    * (1.0 + fleet.q_gain * min(rho, 8.0))))
    bw_out, lat_out = [], []
    for t, f in zip(fleet.tenants, fracs):
        if f <= 0.0 or total_w <= 0.0:
            bw_out.append(cfg.fam_bw_gbps)
            lat_out.append(cfg.fam_mem_latency)
            continue
        share = t.weight * f / total_w
        bpc = pool_bpc * (share + (1.0 - share) * max(0.0, 1.0 - rho))
        # clamp in gbps space so an uncontended tenant's value is the
        # base float EXACTLY (bit-clean slowdown == 1.0)
        bw_out.append(min(cfg.fam_bw_gbps, bpc * cfg.clock_ghz))
        lat_out.append(lat)
    return Contention(fracs=tuple(fracs), bw_gbps=tuple(bw_out),
                      mem_latency=tuple(lat_out), loads=tuple(loads),
                      rho=rho)


def cache_slice_bytes(fleet: FleetSpec, cfg: FamConfig) -> int:
    """Even DRAM-cache slice per tenant, floored at one set."""
    pool = fleet.pool_cache_bytes if fleet.pool_cache_bytes is not None \
        else cfg.dram_cache_bytes
    return max(cfg.block_bytes * cfg.cache_ways, pool // fleet.size)


# -- per-tenant policies ----------------------------------------------------

def tenant_policies(fleet: FleetSpec, t: TenantSpec) -> PolicySet:
    """The per-tenant QoS PolicySet: ``wfq`` scheduler with the tenant's
    per-system ``weight``, plus the fleet's adaptation mechanism carrying
    the tenant's issue-``rate`` entitlement (``static`` pins the rate;
    ``token_bucket`` uses it as the adaptive floor). Same compile tags
    for every tenant — only per-system params differ."""
    pol = PolicySet(scheduler="wfq", adaptation=fleet.adaptation)
    pol = pol.override("scheduler", weight=float(t.weight))
    if fleet.adaptation == "static":
        pol = pol.override("adaptation", rate=float(t.rate))
    else:
        pol = pol.override("adaptation", min_issue_rate=float(t.rate))
    return pol


# -- the lowering -----------------------------------------------------------

@dataclass(frozen=True)
class TenantCell:
    """Host-side metadata for one fleet lane (what the metrics layer
    joins against the engine's per-point results)."""

    fleet: str
    tenant: TenantSpec
    label: str                     # "tenant" axis coordinate
    iso_label: str                 # its isolated baseline's coordinate
    frac: float                    # admitted live fraction
    t_live: int
    rho: float                     # fleet utilization at admission time
    slice_bytes: int
    bw_gbps: float
    mem_latency: int


@dataclass(frozen=True)
class Lowered:
    """One planned fleet sweep: the Experiment plus the join metadata."""

    experiment: Experiment
    cells: Tuple[TenantCell, ...]
    iso_labels: Tuple[str, ...]
    fleets: Tuple[FleetSpec, ...]
    T: int


def _iso_label(adaptation: str, t: TenantSpec, slice_b: int) -> str:
    return (f"iso/{adaptation}/{t.workload}/w{t.weight:g}/r{t.rate:g}"
            f"/{slice_b >> 10}k/s{t.trace_seed}")


def ensure_telemetry(base: Optional[FamConfig]) -> FamConfig:
    """Fleet runs NEED the in-graph latency histogram — force a default
    window count when the base config has observability off."""
    base = base if base is not None else FamConfig()
    if base.telemetry <= 0:
        base = fam_replace(base, telemetry=DEFAULT_WINDOWS)
    return base


def fleet_axis_cells(fleets: Sequence[FleetSpec], base: FamConfig, *,
                     T: int, include_isolated: bool = True,
                     include_policies: bool = True
                     ) -> Tuple[Dict[str, dict], Tuple[TenantCell, ...],
                                Tuple[str, ...]]:
    """The raw ``grid_axis("tenant", ...)`` cell dict for a fleet list,
    plus the join metadata: ``(values, cells, iso_labels)``.

    ``include_policies=False`` drops the per-tenant PolicySet from the
    cells (the search objective crosses the tenant axis with a candidate
    axis that owns the policies fleet-wide — axis policies override
    wholesale, so the tenant axis must not carry any);
    ``include_isolated=False`` drops the embedded baselines."""
    names = [f.name for f in fleets]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate fleet names: {names}")
    values: Dict[str, dict] = {}
    cells: List[TenantCell] = []
    iso_seen: Dict[str, dict] = {}
    for fleet in fleets:
        con = contention(fleet, base)
        slice_b = cache_slice_bytes(fleet, base)
        for i, t in enumerate(fleet.tenants):
            label = f"{fleet.name}/{t.name}"
            if label in values:
                raise ValueError(f"duplicate tenant label {label!r}")
            t_live = int(T * con.fracs[i])
            cell = {
                "workload": t.workload, "seed": t.trace_seed,
                "t_live": t_live,
                "cfg": {"dram_cache_bytes": slice_b,
                        "fam_bw_gbps": con.bw_gbps[i],
                        "fam_mem_latency": con.mem_latency[i]},
            }
            if include_policies:
                cell["policies"] = tenant_policies(fleet, t)
            values[label] = cell
            iso_label = _iso_label(fleet.adaptation, t, slice_b)
            if include_isolated and iso_label not in iso_seen:
                iso_seen[iso_label] = {
                    "workload": t.workload, "seed": t.trace_seed,
                    "policies": tenant_policies(fleet, t),
                    "cfg": {"dram_cache_bytes": slice_b,
                            "fam_bw_gbps": base.fam_bw_gbps,
                            "fam_mem_latency": base.fam_mem_latency},
                }
            cells.append(TenantCell(
                fleet=fleet.name, tenant=t, label=label,
                iso_label=iso_label, frac=con.fracs[i], t_live=t_live,
                rho=con.rho, slice_bytes=slice_b,
                bw_gbps=con.bw_gbps[i], mem_latency=con.mem_latency[i]))
    values.update(iso_seen)
    return values, tuple(cells), tuple(iso_seen)


def lower_fleets(fleets: Sequence[FleetSpec], *,
                 base: Optional[FamConfig] = None, T: int = 4096,
                 trace_backend: str = DEFAULT_BACKEND,
                 name: str = "fig_pond",
                 include_isolated: bool = True) -> Lowered:
    """Build the single-axis Experiment for a list of fleets.

    Every tenant of every fleet is one ``grid_axis("tenant", ...)``
    cell; distinct archetypes additionally contribute one isolated-
    baseline cell each (``include_isolated=False`` drops them — the
    search objective brings its own baseline candidate instead). The
    base config's ``telemetry`` is forced on (histogram windows) when
    unset."""
    base = ensure_telemetry(base)
    values, cells, iso_labels = fleet_axis_cells(
        fleets, base, T=T, include_isolated=include_isolated)
    exp = Experiment(name=name, axes=(grid_axis("tenant", values),),
                     base=base, T=T, trace_backend=trace_backend)
    return Lowered(experiment=exp, cells=cells,
                   iso_labels=iso_labels, fleets=tuple(fleets), T=T)
