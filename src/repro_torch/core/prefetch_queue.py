"""Prefetch queue — fixed-length in-flight window at the root complex
(paper §III-A2). Counterpart of ``repro.core.prefetch_queue``, batched
over leading lane dimensions; ``try_insert`` and ``complete_until`` write
in place.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.device import resolve_device


class PrefetchQueue(NamedTuple):
    block: torch.Tensor    # (*B, Q) int32 block addr (+1; 0 = empty)
    finish: torch.Tensor   # (*B, Q) float32 completion time (cycles)


def init_queue(size: int, batch=(), device="cuda") -> PrefetchQueue:
    device = resolve_device(device)
    shape = tuple(batch) + (size,)
    return PrefetchQueue(block=torch.zeros(shape, dtype=torch.int32, device=device),
                         finish=torch.zeros(shape, dtype=torch.float32, device=device))


def occupancy(q: PrefetchQueue) -> torch.Tensor:
    return (q.block > 0).sum(-1, dtype=torch.int32)


def contains(q: PrefetchQueue, block_addr) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (in_flight, finish_time). Demand probe (MSHR-style hit).

    ``block_addr`` has the lane shape, or the lane shape plus one query
    dimension."""
    block, finish = q.block, q.finish
    if block_addr.dim() == block.dim():
        block, finish = block.unsqueeze(-2), finish.unsqueeze(-2)
    match = block == (block_addr + 1)[..., None]
    inflight = match.any(-1)
    fin = torch.where(match, finish, 0.0).amax(-1)
    return inflight, fin


def try_insert(q: PrefetchQueue, block_addr, finish_time,
               threshold: float = 1.0, enable=True
               ) -> Tuple[PrefetchQueue, torch.Tensor]:
    """Insert if a slot is free and occupancy < threshold * capacity.

    The cap truncates like ``jnp.int32(threshold * size)`` (0.95 x 64 ->
    60). Returns (queue, inserted?); writes in place, masked by ``enable``.
    """
    size = q.block.shape[-1]
    free = q.block == 0
    ok = free.any(-1) & (occupancy(q) < int(threshold * size)) & enable
    slot = free.to(torch.int32).argmax(-1, keepdim=True)
    old_b = q.block.gather(-1, slot).squeeze(-1)
    old_f = q.finish.gather(-1, slot).squeeze(-1)
    q.block.scatter_(-1, slot, torch.where(ok, block_addr + 1, old_b).unsqueeze(-1))
    q.finish.scatter_(-1, slot, torch.where(ok, finish_time, old_f).unsqueeze(-1))
    return q, ok


def complete_until(q: PrefetchQueue, now) -> Tuple[PrefetchQueue, torch.Tensor, torch.Tensor]:
    """Retire all entries with finish <= now (``now`` has the lane shape).

    Returns (queue, completed_blocks (*B, Q), completed_mask (*B, Q)) so
    the caller can fill the DRAM cache for each completed prefetch; the
    retired slots are emptied in place."""
    now = torch.as_tensor(now, dtype=q.finish.dtype, device=q.finish.device)
    done = (q.block > 0) & (q.finish <= now[..., None])
    blocks = torch.where(done, q.block - 1, -1)
    q.block.copy_(torch.where(done, 0, q.block))
    return q, blocks, done
