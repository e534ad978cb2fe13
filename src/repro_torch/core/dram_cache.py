"""DRAM cache metadata — set-associative, LRU, sub-page blocks (paper §III-B).

Counterpart of ``repro.core.dram_cache``, batched: every state tensor
carries leading lane dimensions ``B`` (the simulator uses ``(S, N)``,
systems x nodes) in front of ``(sets, ways)``, and every query carries the
same ``B`` (optionally one more query dimension for a batch of probes).

**Padded geometry.** The arrays may be allocated at a maximum
``(sets, ways)`` while each lane's effective ``num_sets``/``ways`` ride
along as tensors: the set hash is taken modulo the effective set count
and tag matches, vacancy and victim selection are restricted to the
first ``ways`` ways, so the padded region stays invalid forever.

**In place.** Where JAX returns new arrays, ``insert`` and ``touch``
write the lanes' rows of ``tags``/``lru``/``stamp`` in place and return
the same state: the fig08 grid holds about 150 MB of metadata, and a
copy per operation would dominate the step.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

HASH_MULT = 0x9E3779B1
_U32 = 0xFFFFFFFF
I32_MAX = torch.iinfo(torch.int32).max


class CacheState(NamedTuple):
    tags: torch.Tensor     # (*B, sets, ways) int32: block_addr + 1; 0 = invalid
    lru: torch.Tensor      # (*B, sets, ways) int32: last-touch stamp
    stamp: torch.Tensor    # (*B,) int32 monotonic counter


def init_cache(num_sets: int, ways: int, batch=(), device="cpu") -> CacheState:
    z = lambda *s: torch.zeros(*s, dtype=torch.int32, device=device)
    batch = tuple(batch)
    return CacheState(tags=z(batch + (num_sets, ways)),
                      lru=z(batch + (num_sets, ways)), stamp=z(batch))


def u32_hash(x, mult: int, shift: int) -> torch.Tensor:
    """``(uint32(x) * mult) >> shift`` as int64 in [0, 2**32): PyTorch has
    no ``>>`` for uint32 on the CPU, so the product is taken in int64 and
    cut to its low 32 bits (wrap-around keeps those exact)."""
    return (((x.to(torch.int64) & _U32) * mult) & _U32) >> shift


def _set_index(block_addr, num_sets):
    """Set hash modulo the effective set count (uint32 arithmetic)."""
    mod = torch.as_tensor(num_sets, device=block_addr.device).to(torch.int64) & _U32
    return (u32_hash(block_addr, HASH_MULT, 7) % mod).to(torch.int32)


def _way_mask(state: CacheState, ways):
    """(..., W_pad) bool: True for the effective ways."""
    w_pad = state.tags.shape[-1]
    col = torch.arange(w_pad, device=state.tags.device)
    return col < torch.as_tensor(ways, device=state.tags.device)[..., None]


def _row_index(state: CacheState, si):
    """Gather index for the rows ``si``: ``si`` has the lane shape, or the
    lane shape plus one query dimension."""
    w_pad = state.tags.shape[-1]
    idx = si.to(torch.int64).unsqueeze(-1)
    if si.dim() == state.tags.dim() - 2:
        idx = idx.unsqueeze(-2)
    return idx.expand(*idx.shape[:-1], w_pad)


def _rows(t, idx, squeeze: bool):
    rows = t.gather(-2, idx)
    return rows.squeeze(-2) if squeeze else rows


def _effective(state: CacheState, num_sets, ways):
    lanes = state.tags.shape[:-2]
    dev = state.tags.device
    if num_sets is None:
        num_sets = state.tags.shape[-2]
    if ways is None:
        ways = state.tags.shape[-1]
    num_sets = torch.as_tensor(num_sets, dtype=torch.int32, device=dev)
    ways = torch.as_tensor(ways, dtype=torch.int32, device=dev)
    return num_sets.expand(lanes), ways.expand(lanes)


def lookup(state: CacheState, block_addr, num_sets=None, ways=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (hit, set_idx, way). Pure query; no state change.

    ``block_addr`` has the lane shape, or the lane shape plus one query
    dimension (then the effective geometry broadcasts over the queries).
    """
    num_sets, ways = _effective(state, num_sets, ways)
    extra = block_addr.dim() > num_sets.dim()
    if extra:
        num_sets, ways = num_sets[..., None], ways[..., None]
    si = _set_index(block_addr, num_sets)
    row = _rows(state.tags, _row_index(state, si), not extra)
    match = (row == (block_addr + 1)[..., None]) & _way_mask(state, ways)
    hit = match.any(-1)
    way = match.to(torch.int32).argmax(-1).to(torch.int32)
    return hit, si, way


def _write(t, si, way, value):
    """t[lane, si, way] = value for every lane (in place)."""
    flat = t.view(-1, t.shape[-2] * t.shape[-1])
    pos = (si.to(torch.int64) * t.shape[-1] + way).reshape(-1, 1)
    flat.scatter_(1, pos, value.reshape(-1, 1).to(t.dtype))


def touch(state: CacheState, set_idx, way, enable=True,
          policy=None) -> CacheState:
    """Recency update on a hit, masked by ``enable`` (in place).

    ``policy`` is a *bound* replacement policy supplying the hit-time
    recency value; ``None`` is the classic LRU stamp."""
    en = torch.as_tensor(enable, device=state.tags.device).expand(set_idx.shape)
    stamp = state.stamp + en.to(torch.int32)
    flat = state.lru.view(-1, state.lru.shape[-2] * state.lru.shape[-1])
    pos = (set_idx.to(torch.int64) * state.lru.shape[-1] + way).reshape(-1, 1)
    old = flat.gather(1, pos).reshape(set_idx.shape)
    hit_val = stamp if policy is None else policy.on_hit(old, stamp)
    _write(state.lru, set_idx, way, torch.where(en, hit_val, old))
    state.stamp.copy_(stamp)
    return state


def insert(state: CacheState, block_addr, enable=True,
           num_sets=None, ways=None, policy=None
           ) -> Tuple[CacheState, torch.Tensor, torch.Tensor]:
    """Fill one block per lane: evict the replacement policy's victim if
    no vacancy (in place, masked by ``enable``).

    Returns (state, evicted_tag-1 or -1, slot) where slot = set*W_pad + way.
    ``policy=None`` is the classic set-LRU single-element update; a bound
    policy (SRRIP) may age the whole row on eviction and chooses the
    victim way; hit/vacancy handling is shared.
    """
    num_sets, ways = _effective(state, num_sets, ways)
    en = torch.as_tensor(enable, device=state.tags.device).expand(num_sets.shape)
    si = _set_index(block_addr, num_sets)
    idx = _row_index(state, si)
    row_tags = _rows(state.tags, idx, True)
    row_lru = _rows(state.lru, idx, True)
    tag = block_addr + 1
    wmask = _way_mask(state, ways)
    already = (row_tags == tag[..., None]) & wmask
    vacant = (row_tags == 0) & wmask
    has = already.any(-1)
    has_vacant = vacant.any(-1)
    stamp = state.stamp + en.to(torch.int32)
    w_pad = state.tags.shape[-1]
    first = lambda m: m.to(torch.int32).argmax(-1)
    if policy is None:
        victim = torch.where(wmask, row_lru, I32_MAX).argmin(-1)
    else:
        aged_row, victim = policy.evict(row_lru, wmask, stamp, si, ways)
    way = torch.where(has, first(already),
                      torch.where(has_vacant, first(vacant), victim))
    way_i = way.unsqueeze(-1)
    old_tag = row_tags.gather(-1, way_i).squeeze(-1)
    evicted = torch.where(en & ~(has | has_vacant), old_tag - 1, -1)
    _write(state.tags, si, way, torch.where(en, tag, old_tag))
    if policy is None:
        old_lru = row_lru.gather(-1, way_i).squeeze(-1)
        _write(state.lru, si, way, torch.where(en, stamp, old_lru))
    else:
        # aging applies only on the eviction path; a redundant fill of an
        # already-present block is a re-reference (the policy's hit value)
        base_row = torch.where((has | has_vacant)[..., None], row_lru, aged_row)
        old_lru = row_lru.gather(-1, way_i).squeeze(-1)
        fill_val = torch.where(has, policy.on_hit(old_lru, stamp),
                               policy.insert_value(stamp))
        new_row = base_row.scatter(-1, way_i, fill_val.unsqueeze(-1))
        new_row = torch.where(en[..., None], new_row, row_lru)
        state.lru.scatter_(-2, idx, new_row.unsqueeze(-2))
    state.stamp.copy_(stamp)
    return state, evicted, si * w_pad + way.to(torch.int32)


def invalidate(state: CacheState, block_addr, num_sets=None, ways=None
               ) -> CacheState:
    """Clear the tag of each lane's ``block_addr`` where it is cached (in
    place; ``block_addr`` has the lane shape). Recency is left as is."""
    hit, si, way = lookup(state, block_addr, num_sets=num_sets, ways=ways)
    row = _rows(state.tags, _row_index(state, si), True)
    old = row.gather(-1, way.to(torch.int64).unsqueeze(-1)).squeeze(-1)
    _write(state.tags, si, way.to(torch.int64), torch.where(hit, 0, old))
    return state


def occupancy(state: CacheState, num_sets=None, ways=None) -> torch.Tensor:
    """Fraction of the EFFECTIVE cache entries holding a valid tag.

    0/1 partial sums are integers, exact in float32 below 2**24 entries,
    so the quotient is bit-identical to the JAX reference's."""
    filled = (state.tags > 0).to(torch.float32).sum((-2, -1))
    num_sets, ways = _effective(state, num_sets, ways)
    return filled / (num_sets * ways).to(torch.float32)
