"""repro_torch.tenants — Pond-style multi-tenant fleets on the port's
experiment engine.

Counterpart of ``repro.tenants``: tenants as one axis over the existing
workload specs, scheduler/adaptation policies and padded system axis,
scaled to ~1000 tenants under ONE compile group (one CUDA graph capture
on the card). Four pieces:

* :mod:`repro_torch.tenants.spec` — declarative :class:`TenantSpec` /
  :class:`FleetSpec` (workload, WFQ weight, rate entitlement, SLO);
* :mod:`repro_torch.tenants.admission` — fleet-level admission mechanisms
  (``none`` / ``cap`` / ``load_shed``) returning per-tenant live
  fractions, lowered onto the masked runner's per-system lifetime;
* :mod:`repro_torch.tenants.lower` — the lowering: tenants -> system
  lanes, QoS -> policy params, contention -> config values, admission ->
  ``t_live``, isolated baselines embedded per archetype;
* :mod:`repro_torch.tenants.metrics` — per-tenant p50/p95/p99 (the
  :mod:`repro_torch.obs` histogram estimator), SLO violations,
  slowdown-vs-isolated, Jain fairness.

:mod:`repro_torch.tenants.search` (imported on first lookup of its
objective, not here) registers the ``pond_tail`` search objective with
:mod:`repro_torch.search`.

Driver: :mod:`repro_torch.benchmarks.fig_pond` (``python -m
repro_torch.benchmarks.run pond``).
"""
from repro_torch.tenants.admission import (ADMISSIONS, admit,  # noqa: F401
                                           priority_order, register_admission)
from repro_torch.tenants.lower import (Contention, Lowered,  # noqa: F401
                                       TenantCell, cache_slice_bytes,
                                       contention, fleet_axis_cells,
                                       lower_fleets, offered_load,
                                       tenant_policies)
from repro_torch.tenants.metrics import (TENANT_SCHEMA,  # noqa: F401
                                         fleet_report, fleet_summary,
                                         jain_index, latency_hist,
                                         tenant_record,
                                         validate_tenant_records)
from repro_torch.tenants.spec import (FleetSpec, TenantSpec,  # noqa: F401
                                      make_tenants, qos_for_weight,
                                      skew_weight, tenant_seed)
