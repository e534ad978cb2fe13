"""Plain PyTorch version of the set-associative cache lookup.

Counterpart of ``repro.kernels.cache_lookup.ref``; the CUDA kernel
(:mod:`repro_torch.kernels.cache_lookup.kernel`) must match it bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.dram_cache import HASH_MULT, u32_hash


def set_index_ref(block_addr, num_sets: int) -> torch.Tensor:
    """``(uint32(block_addr) * HASH_MULT >> 7) % num_sets`` as int32."""
    return (u32_hash(block_addr, HASH_MULT, 7) % num_sets).to(torch.int32)


def cache_lookup_ref(tags, queries):
    """tags: (sets, ways) int32 (+1 encoded; 0 invalid); queries: (K,).

    Returns (hit (K,) bool, way (K,) int32, slot (K,) int32) with slot =
    set * ways + way, -1 on a miss; way is the first matching way, 0 on a
    miss."""
    sets, ways = tags.shape
    si = set_index_ref(queries, sets)
    rows = tags[si.to(torch.int64)]                       # (K, ways)
    match = rows == (queries.to(torch.int32) + 1)[:, None]
    hit = match.any(1)
    way = match.to(torch.int32).argmax(1).to(torch.int32)
    return hit, way, torch.where(hit, si * ways + way, -1)
