"""FAM controller service model (paper §III-D, §IV-A).

Counterpart of ``repro.core.fam_controller``, batched over systems: each
row of the ``(S, K)`` inputs is one system's step of arrivals. A request's
completion follows the queueing recurrence

    busy_i = max(arrival_i, busy_{i-1}) + service_i

in closed form:  busy_i = cs_i + max_{j<=i}(arr_j - cs_{j-1}),
with cs = cumsum(service).

FIFO is one service chain at pooled-DDR bandwidth; WFQ a fluid two-class
DWRR with one chain per class. Parameters arrive with shape ``(S, 1)``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis as a sequential float32 sum —
    the order XLA's CPU reduce-window takes. ``torch.cumsum`` accumulates
    float32 in double on the CPU and in a parallel scan on CUDA, either of
    which can move the last bit, and a finish time then compares against a
    clock."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, -1)


def service_chain(arrivals, service, valid, busy0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized busy-chain. arrivals/service/valid: (S, K) in issue
    order; busy0: (S,). Returns (finish (S, K), new_busy (S,)). Invalid
    slots take zero service and don't advance the chain."""
    service = torch.where(valid, service, 0.0)
    arr = torch.where(valid, arrivals, -torch.inf)
    cs = cumsum_f32(service)
    b0 = busy0.unsqueeze(-1)
    base = torch.maximum(torch.cummax(arr - (cs - service), -1).values, b0)
    finish = cs + base
    new_busy = torch.where(valid, finish, b0).amax(-1)
    return finish, torch.maximum(new_busy, busy0)


class FamTimings(NamedTuple):
    demand_finish: torch.Tensor     # (S, ND) completion time per demand slot
    prefetch_finish: torch.Tensor   # (S, NP) completion time per prefetch slot
    new_busy: torch.Tensor          # (S, 2) [demand_chain, prefetch_chain]


def arbitrate(p, busy0, d_arr, d_valid, d_bytes, p_arr, p_valid, p_bytes, *,
              use_wfq, weight) -> FamTimings:
    """Time one step's arrivals through the DDR service model.

    busy0: (S, 2) chain state [demand, prefetch] (equal in FIFO mode).
    Within a class, requests are served in arrival (FIFO) order. Both
    disciplines are evaluated and ``use_wfq`` (S, 1) selects per system.
    """
    ND = d_arr.shape[-1]
    d_service = p.fam_service_cycles(1) * d_bytes
    p_service = p.fam_service_cycles(1) * p_bytes

    # --- WFQ: fluid two-class DWRR, one service chain per class
    W = weight
    d_busy0, p_busy0 = busy0[:, 0], busy0[:, 1]
    # demand chain: slowed to its W/(W+1) share while prefetch backlogged
    f_d = torch.where(p_busy0.unsqueeze(-1) > d_arr, (W + 1.0) / W, 1.0)
    w_d_fin, w_d_busy = service_chain(d_arr, d_service * f_d, d_valid, d_busy0)
    # prefetch chain: gets the 1/(W+1) share while demands backlogged
    f_p = torch.where(d_busy0.unsqueeze(-1) > p_arr, W + 1.0, 1.0)
    w_p_fin, w_p_busy = service_chain(p_arr, p_service * f_p, p_valid, p_busy0)

    # --- FIFO: single queue in arrival order (prefetches delay demands)
    arr_k = torch.cat([d_arr, p_arr], -1)
    srv_k = torch.cat([d_service, p_service], -1)
    val_k = torch.cat([d_valid, p_valid], -1)
    order = torch.sort(torch.where(val_k, arr_k, torch.inf), stable=True,
                       dim=-1).indices
    finish_o, busy = service_chain(arr_k.gather(-1, order),
                                   srv_k.gather(-1, order),
                                   val_k.gather(-1, order), busy0[:, 0])
    finish_k = torch.zeros_like(finish_o).scatter(-1, order, finish_o)

    d_fin = torch.where(use_wfq, w_d_fin, finish_k[:, :ND])
    p_fin = torch.where(use_wfq, w_p_fin, finish_k[:, ND:])
    new_busy = torch.where(use_wfq, torch.stack([w_d_busy, w_p_busy], -1),
                           torch.stack([busy, busy], -1))

    lat_fixed = p.fam_mem_latency + p.cxl_min_latency_cycles
    d_fin = torch.where(d_valid, d_fin + lat_fixed, 0.0)
    p_fin = torch.where(p_valid, p_fin + lat_fixed, 0.0)
    return FamTimings(d_fin, p_fin, new_busy)
