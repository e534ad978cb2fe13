"""Declarative tenant/fleet specs: the Pond-style multi-tenant scenario.

A copy of ``repro.tenants.spec`` on the port's ``traces.specs`` (a test
holds the fleets equal). The paper evaluates a handful of compute nodes
sharing one FAM device; Pond is the production form of the same problem:
hundreds of tenants per CXL pool where per-tenant QoS, noisy neighbors
and p99 tail latency are the headline metrics. This package models that
scenario declaratively and lowers it onto the simulator's experiment
engine (:mod:`repro_torch.tenants.lower`):

* a :class:`TenantSpec` is one tenant: a workload drawn from the 19
  :data:`repro_torch.traces.specs.WORKLOADS`, a WFQ weight, an issue-rate
  share, and an SLO latency target;
* a :class:`FleetSpec` is one co-located population plus the fleet-level
  knobs: the admission mechanism (:mod:`repro_torch.tenants.admission`),
  the pool bandwidth/cache capacity being contended for, and the
  parameters of the deterministic contention model.

Everything here is plain host-side dataclasses. Per-tenant QoS knobs
become per-system ``FamParams.policy`` values (WFQ ``weight``,
static-rate ``rate``) and per-tenant contention effects per-system config
values, so a 1000-tenant fleet is a wider system axis of ONE compile
group (one CUDA graph capture on the card), never a new one.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

from repro_torch.traces.specs import WORKLOADS

#: QoS classes by WFQ weight: ``weight -> (issue-rate share, SLO p99
#: latency target in cycles)``. Heavier tenants get a larger guaranteed
#: share and a tighter tail target (the Pond framing: premium VMs buy
#: both bandwidth and latency).
QOS_BY_WEIGHT = ((4.0, 1.0, 512), (2.0, 0.5, 1024), (0.0, 0.25, 2048))


def qos_for_weight(weight: float) -> Tuple[float, int]:
    """(rate, slo_latency) of the QoS class ``weight`` falls into."""
    for floor, rate, slo in QOS_BY_WEIGHT:
        if weight >= floor:
            return rate, slo
    return QOS_BY_WEIGHT[-1][1:]


def tenant_seed(workload: str, weight: float, rate: float) -> int:
    """Deterministic per-archetype trace seed (crc32, the
    ``traces.specs.trace_seed`` idiom — never Python ``hash``, which is
    salted per process). Shared by a fleet lane and its isolated
    baseline lane so slowdown-vs-isolated is a clean A/B over the SAME
    trace."""
    key = f"tenant|{workload}|{weight:.4f}|{rate:.4f}"
    return zlib.crc32(key.encode()) & 0x7FFFFFFF


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: a workload plus its QoS contract.

    ``weight`` rides the ``wfq`` scheduler policy's per-system ``weight``
    param; ``rate`` rides the ``static`` adaptation policy's per-system
    ``rate`` param (fraction of full issue rate the tenant is entitled
    to); ``slo_latency`` is the p99 target (cycles) the violation
    metrics score against. ``seed=None`` derives deterministically from
    the (workload, weight, rate) archetype."""

    name: str
    workload: str
    weight: float = 2.0
    rate: float = 0.5
    slo_latency: int = 1024
    seed: Optional[int] = None

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(f"tenant {self.name!r}: unknown workload "
                             f"{self.workload!r} (see repro_torch.traces.specs)")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(f"tenant {self.name!r}: rate must be in "
                             f"(0, 1], got {self.rate}")
        if self.slo_latency <= 0:
            raise ValueError(f"tenant {self.name!r}: slo_latency must be "
                             "> 0 cycles")

    @property
    def trace_seed(self) -> int:
        return self.seed if self.seed is not None else \
            tenant_seed(self.workload, self.weight, self.rate)


@dataclass(frozen=True)
class FleetSpec:
    """One co-located tenant population on one FAM pool.

    ``admission`` names the mechanism (:data:`repro_torch.tenants.admission.
    ADMISSIONS`) — a host-side gate feeding the masked runner's per-system
    ``t_true`` input, never a compile key; ``max_tenants`` /
    ``rho_target`` are its thresholds. ``pool_bw_gbps`` (default
    ``pool_bw_scale`` x the base config's ``fam_bw_gbps``) and
    ``pool_cache_bytes`` (default: the base config's whole
    ``dram_cache_bytes``) size the shared pool the deterministic
    contention model (:func:`repro_torch.tenants.lower.contention`) divides;
    ``duty`` / ``pf_intensity`` / ``q_gain`` are that model's offered-
    load and queueing parameters."""

    name: str
    tenants: Tuple[TenantSpec, ...]
    admission: str = "none"
    max_tenants: int = 0           # "cap" threshold (0 = no cap)
    rho_target: float = 0.85       # "load_shed" utilization target
    pool_bw_scale: float = 32.0
    pool_bw_gbps: Optional[float] = None
    pool_cache_bytes: Optional[int] = None
    duty: float = 0.5              # fraction of cycles a tenant offers load
    pf_intensity: float = 0.25     # prefetch blocks per demand miss
    q_gain: float = 0.35           # latency inflation per unit utilization
    adaptation: str = "static"     # per-tenant rate mechanism

    def __post_init__(self):
        if not self.tenants:
            raise ValueError(f"fleet {self.name!r}: no tenants")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"fleet {self.name!r}: duplicate tenant "
                             f"names")
        if not 0.0 < self.rho_target:
            raise ValueError(f"fleet {self.name!r}: rho_target must be "
                             "> 0")

    @property
    def size(self) -> int:
        return len(self.tenants)


#: Deterministic zipf-ish weight ladder: rank 0 is the one noisy heavy
#: tenant, a small premium tier follows, the tail is best-effort.
_ZIPF_LADDER = ((1, 8.0), (4, 4.0), (16, 2.0))


def skew_weight(rank: int, skew: str) -> float:
    if skew == "uniform":
        return 2.0
    if skew == "zipf":
        for bound, w in _ZIPF_LADDER:
            if rank < bound:
                return w
        return 1.0
    raise ValueError(f"unknown weight skew {skew!r} "
                     "(choose from: uniform, zipf)")


def make_tenants(count: int, *, skew: str = "uniform",
                 workloads: Optional[Sequence[str]] = None,
                 prefix: str = "t") -> Tuple[TenantSpec, ...]:
    """``count`` tenants: workloads round-robin over ``workloads``
    (default: all 19 specs in table order), weights from the ``skew``
    ladder, rate/SLO from the weight's QoS class. Fully deterministic —
    same arguments, same fleet."""
    if count <= 0:
        raise ValueError("count must be > 0")
    pool = list(workloads) if workloads is not None else list(WORKLOADS)
    out = []
    for i in range(count):
        w = skew_weight(i, skew)
        rate, slo = qos_for_weight(w)
        out.append(TenantSpec(name=f"{prefix}{i:04d}",
                              workload=pool[i % len(pool)],
                              weight=w, rate=rate, slo_latency=slo))
    return tuple(out)
