"""FAM-controller scheduling policies (paper §IV-A + QoS variants).

Counterpart of ``repro.policies.scheduler``:

* ``fifo`` / ``wfq`` — one code path (``repro_torch.core.fam_controller.
  arbitrate``) that evaluates FIFO and fluid two-class DWRR and selects
  per system on the ``use_wfq`` param;
* ``strict`` — strict demand-over-prefetch priority (idealized preemptive
  fluid model).

Parameters arrive with shape ``(S, 1)``; ``fam_busy`` is ``(S, 2)`` and
the node clocks ``(S, N)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.fam_controller import FamTimings, arbitrate, service_chain
from repro_torch.policies.base import register


class ChainScheduler:
    """FIFO / WFQ over the shared service-chain model."""

    kind = "scheduler"

    def __init__(self, name: str, use_wfq: bool):
        self.name = name
        self._use_wfq = use_wfq

    def params_of(self, cfg):
        return {"use_wfq": torch.tensor(self._use_wfq),
                "weight": torch.tensor(float(cfg.wfq_weight), dtype=torch.float32),
                "backlog_cap": torch.tensor(cfg.wfq_backlog_cap, dtype=torch.float32)}

    def backlog_ok(self, p, pol, fam_busy, clock):
        # finite prefetch input queue at the controller: CXL backpressure
        # stops prefetch issue at the nodes. FIFO mode: no gate.
        return ((fam_busy[:, 1:2] - clock) < pol["backlog_cap"]) | ~pol["use_wfq"]

    def arbitrate(self, p, pol, busy0, d_arr, d_valid, d_bytes,
                  p_arr, p_valid, p_bytes):
        return arbitrate(p, busy0, d_arr, d_valid, d_bytes,
                         p_arr, p_valid, p_bytes,
                         use_wfq=pol["use_wfq"], weight=pol["weight"])


class StrictScheduler:
    """Strict demand priority: demands see no prefetch occupancy; prefetch
    arrivals wait for the demand chain to drain, then queue in order. The
    CXL backlog gate applies unconditionally."""

    kind = "scheduler"
    name = "strict"

    def params_of(self, cfg):
        return {"backlog_cap": torch.tensor(cfg.wfq_backlog_cap, dtype=torch.float32)}

    def backlog_ok(self, p, pol, fam_busy, clock):
        return (fam_busy[:, 1:2] - clock) < pol["backlog_cap"]

    def arbitrate(self, p, pol, busy0, d_arr, d_valid, d_bytes,
                  p_arr, p_valid, p_bytes):
        d_service = p.fam_service_cycles(1) * d_bytes
        p_service = p.fam_service_cycles(1) * p_bytes
        d_fin, d_busy = service_chain(d_arr, d_service, d_valid, busy0[:, 0])
        # prefetches wait out the (post-step) demand backlog, then queue
        # among themselves
        p_fin, p_busy = service_chain(torch.maximum(p_arr, d_busy.unsqueeze(-1)),
                                      p_service, p_valid, busy0[:, 1])
        lat_fixed = p.fam_mem_latency + p.cxl_min_latency_cycles
        return FamTimings(
            demand_finish=torch.where(d_valid, d_fin + lat_fixed, 0.0),
            prefetch_finish=torch.where(p_valid, p_fin + lat_fixed, 0.0),
            new_busy=torch.stack([d_busy, torch.maximum(p_busy, d_busy)], -1))


FIFO = register(ChainScheduler("fifo", use_wfq=False))
WFQ = register(ChainScheduler("wfq", use_wfq=True))
STRICT = register(StrictScheduler())
