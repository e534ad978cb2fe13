"""Fleet-level admission control: live fractions, never compile keys.

A copy of ``repro.tenants.admission``. An admission mechanism decides how
much of the run each tenant is *live* for: a per-tenant fraction in
[0, 1] that the lowering turns into the masked runner's per-system
``t_true`` input (``t_live = int(T * frac)``, see
:class:`repro_torch.experiments.spec.AxisValue.t_live`). The mechanism is
a host-side choice and its thresholds feed per-system values only: two
fleets that differ solely in admission policy plan into identical
compile groups.

Mechanisms are registered by name in :data:`ADMISSIONS`; each takes the
fleet, the per-tenant offered loads (bytes/cycle, spec order), and the
pool capacity (bytes/cycle) and returns the live fractions in spec
order. Priority is deterministic: heavier WFQ weight first, spec order
breaking ties.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

from repro_torch.tenants.spec import FleetSpec

AdmissionFn = Callable[[FleetSpec, Sequence[float], float], List[float]]

ADMISSIONS: Dict[str, AdmissionFn] = {}


def register_admission(name: str):
    def deco(fn: AdmissionFn) -> AdmissionFn:
        if name in ADMISSIONS:
            raise ValueError(f"admission mechanism {name!r} already "
                             "registered")
        ADMISSIONS[name] = fn
        return fn
    return deco


def admit(fleet: FleetSpec, loads: Sequence[float],
          pool_bpc: float) -> List[float]:
    """Dispatch to ``fleet.admission``; validates the mechanism name and
    the returned fractions."""
    try:
        fn = ADMISSIONS[fleet.admission]
    except KeyError:
        raise ValueError(
            f"fleet {fleet.name!r}: unknown admission mechanism "
            f"{fleet.admission!r} (available: {sorted(ADMISSIONS)})"
        ) from None
    fracs = fn(fleet, loads, pool_bpc)
    if len(fracs) != fleet.size:
        raise ValueError(f"admission {fleet.admission!r} returned "
                         f"{len(fracs)} fractions for {fleet.size} "
                         "tenants")
    if any(not 0.0 <= f <= 1.0 for f in fracs):
        raise ValueError(f"admission {fleet.admission!r} returned "
                         "fractions outside [0, 1]")
    return fracs


def priority_order(fleet: FleetSpec) -> List[int]:
    """Tenant indices, heaviest weight first, spec order breaking ties —
    the deterministic order every mechanism admits in."""
    return sorted(range(fleet.size),
                  key=lambda i: (-fleet.tenants[i].weight, i))


@register_admission("none")
def _admit_none(fleet: FleetSpec, loads: Sequence[float],
                pool_bpc: float) -> List[float]:
    """Admit everyone for the full run (the contention model still
    inflates latency with utilization — "none" is how a fleet
    oversubscribes)."""
    return [1.0] * fleet.size


@register_admission("cap")
def _admit_cap(fleet: FleetSpec, loads: Sequence[float],
               pool_bpc: float) -> List[float]:
    """Hard population cap: the ``fleet.max_tenants`` highest-priority
    tenants run fully, the rest are rejected outright (t_live = 0).
    ``max_tenants <= 0`` means uncapped."""
    cap = fleet.max_tenants if fleet.max_tenants > 0 else fleet.size
    fracs = [0.0] * fleet.size
    for rank, i in enumerate(priority_order(fleet)):
        fracs[i] = 1.0 if rank < cap else 0.0
    return fracs


@register_admission("load_shed")
def _admit_load_shed(fleet: FleetSpec, loads: Sequence[float],
                     pool_bpc: float) -> List[float]:
    """Utilization-targeted shedding: admit in priority order while the
    admitted offered load stays under ``rho_target * pool``; the
    marginal tenant is admitted *partially* (the leftover headroom as a
    live fraction — a tenant that arrives and is later throttled), and
    everyone past it is rejected."""
    budget = fleet.rho_target * pool_bpc
    fracs = [0.0] * fleet.size
    used = 0.0
    for i in priority_order(fleet):
        load = max(float(loads[i]), 1e-12)
        headroom = budget - used
        if headroom <= 0.0:
            break
        frac = min(1.0, headroom / load)
        fracs[i] = frac
        used += frac * load
    return fracs
