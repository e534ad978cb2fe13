"""Weighted Fair Queueing at the FAM controller — paper §IV-A, Algorithm 1.

Counterpart of ``repro.core.wfq``: work-conserving Deficit Weighted
Round-Robin (DWRR) over two input queues (demand, prefetch), integer
arithmetic that matches the JAX reference bit for bit. Weight W =>
demands:prefetches served W:1 under saturation; the prefetch deficit must
reach r = prefetch_block/demand_block before a prefetch may issue.

One cycle, :func:`_issue`, is written once over a pair of primitives
(``where``, ``minimum``) and runs two ways:

* :func:`issue` / :func:`schedule_batch` on tensors (any lane shape), one
  handful of element-wise ops per cycle;
* :func:`schedule_batch_host` on Python ints, for a caller that has the
  backlogs on the host already (the tiering runtime syncs once per access
  instead of launching some 30 ops per cycle for up to 260 cycles).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from repro_torch.device import resolve_device


class WfqState(NamedTuple):
    current_round: torch.Tensor      # (*B,) int32 in [0, W]
    demand_deficit: torch.Tensor     # (*B,) int32
    prefetch_deficit: torch.Tensor   # (*B,) int32


def init_wfq(batch=(), device="cuda") -> WfqState:
    device = resolve_device(device)
    z = lambda: torch.zeros(tuple(batch), dtype=torch.int32, device=device)
    return WfqState(z(), z(), z())


# issue decision codes
IDLE, DEMAND, PREFETCH = 0, 1, 2

_TENSOR_OPS = (torch.where, lambda a, b: torch.clamp(a, max=b))
_HOST_OPS = (lambda c, a, b: a if c else b, min)


def _issue(ops, cr, dd, pd, demand_ready, prefetch_ready, W, quantum,
           max_deficit, r):
    """One IssueRequests() cycle of Algorithm 1 on (round, demand deficit,
    prefetch deficit); the same expressions as the JAX reference."""
    where, minimum = ops
    cr = (cr + 1) % (W + 1)
    demand_turn = cr != 0

    # demand-preferred rounds
    dd_d = minimum(dd + quantum, max_deficit)              # replenish
    d_can = demand_ready & (dd_d > 0)
    p_can_wc = prefetch_ready & (pd > r)                   # work-conserving alt
    choice_d = where(d_can, DEMAND, where(p_can_wc, PREFETCH, IDLE))
    dd_after_d = where(choice_d == DEMAND, dd_d - 1, dd_d)
    pd_after_d = where(choice_d == PREFETCH, pd - r, pd)

    # prefetch-preferred round
    pd_p = minimum(pd + quantum * r, max_deficit * r)      # replenish
    p_can = prefetch_ready & (pd_p > r)
    d_can_wc = demand_ready & (dd > 0)
    choice_p = where(p_can, PREFETCH, where(d_can_wc, DEMAND, IDLE))
    pd_after_p = where(choice_p == PREFETCH, pd_p - r, pd_p)
    dd_after_p = where(choice_p == DEMAND, dd - 1, dd)

    choice = where(demand_turn, choice_d, choice_p)
    # work-conserving floor: never idle while a queue is non-empty
    fallback = where(demand_ready, DEMAND, where(prefetch_ready, PREFETCH, IDLE))
    floored = (choice == IDLE) & (fallback != IDLE)
    choice = where(choice == IDLE, fallback, choice)
    dd_new = where(demand_turn, dd_after_d, dd_after_p)
    pd_new = where(demand_turn, pd_after_d, pd_after_p)
    dd_new = where(floored & (choice == DEMAND), dd_new - 1, dd_new)
    pd_new = where(floored & (choice == PREFETCH), pd_new - r, pd_new)
    return cr, dd_new, pd_new, choice


def issue(state: WfqState, demand_ready, prefetch_ready, *, weight: int,
          quantum: int = 1, max_deficit: int = 8, r: int = 4
          ) -> Tuple[WfqState, torch.Tensor]:
    """One cycle on tensors. demand_ready / prefetch_ready: queue non-empty
    flags (bool tensors of the lane shape). Returns (state, choice int32 in
    {IDLE, DEMAND, PREFETCH})."""
    cr, dd, pd, choice = _issue(_TENSOR_OPS, *state, demand_ready,
                                prefetch_ready, weight, quantum, max_deficit, r)
    i32 = lambda t: t.to(torch.int32)
    return WfqState(i32(cr), i32(dd), i32(pd)), i32(choice)


def schedule_batch(state: WfqState, n_demand, n_prefetch, *, weight: int,
                   quantum: int = 1, max_deficit: int = 8, r: int = 4,
                   max_issues: int = 64) -> Tuple[WfqState, torch.Tensor]:
    """Drain up to ``max_issues`` requests from the two queues via DWRR.

    Returns (state, order) with order an int32 (*B, max_issues) tensor of
    choices (IDLE/DEMAND/PREFETCH), consuming the given backlogs."""
    nd, npf = n_demand.to(torch.int32), n_prefetch.to(torch.int32)
    order = []
    for _ in range(max_issues):
        state, choice = issue(state, nd > 0, npf > 0, weight=weight,
                              quantum=quantum, max_deficit=max_deficit, r=r)
        nd = nd - (choice == DEMAND).to(torch.int32)
        npf = npf - (choice == PREFETCH).to(torch.int32)
        order.append(choice)
    return state, torch.stack(order, -1)


def schedule_batch_host(state: Tuple[int, int, int], n_demand: int,
                        n_prefetch: int, *, weight: int, quantum: int = 1,
                        max_deficit: int = 8, r: int = 4, max_issues: int = 64
                        ) -> Tuple[Tuple[int, int, int], List[int]]:
    """:func:`schedule_batch` for one lane on Python ints: state is
    (current_round, demand_deficit, prefetch_deficit). The deficits only
    move by at most ``max(1, r)`` per cycle, so they stay far inside int32
    for any run the tiering runtime makes."""
    cr, dd, pd = state
    nd, npf = n_demand, n_prefetch
    order = []
    for _ in range(max_issues):
        cr, dd, pd, choice = _issue(_HOST_OPS, cr, dd, pd, nd > 0, npf > 0,
                                    weight, quantum, max_deficit, r)
        nd -= choice == DEMAND
        npf -= choice == PREFETCH
        order.append(choice)
    return (cr, dd, pd), order
