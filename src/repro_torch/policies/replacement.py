"""DRAM-cache replacement policies (victim selection, paper §III-B).

Counterpart of ``repro.policies.replacement``. ``bind(pol)`` returns the
object the cache ops consume: ``None`` selects the classic set-LRU path of
:mod:`repro_torch.core.dram_cache`; ``srrip`` binds to an object with
``on_hit``, ``evict`` and ``insert_value`` that reuses the recency field
as a 2-bit RRPV (hit -> 0, insert at 2, victim = the aged max-RRPV way).
``random`` waits for the threefry port and is not registered.
"""
from __future__ import annotations

import torch

from repro_torch.policies.base import register


class LruReplacement:
    """Set-LRU (the paper's policy): stamp-per-touch, evict the min stamp."""

    kind = "replacement"
    name = "lru"
    compile_tag = "replacement:lru"
    fused_mode = "lru"

    def params_of(self, cfg):
        return {}

    def bind(self, pol):
        return None


class _SrripBound:
    fused_mode = "srrip"

    def __init__(self, max_rrpv):
        self.max_rrpv = max_rrpv

    def on_hit(self, old, stamp):
        return torch.zeros_like(old)      # near-immediate re-reference

    def evict(self, row_lru, wmask, stamp, set_idx, eff_ways):
        eff = torch.where(wmask, row_lru, 0)
        bump = torch.clamp(self.max_rrpv - eff.amax(-1, keepdim=True), min=0)
        aged = torch.where(wmask, row_lru + bump, row_lru)
        way = torch.where(wmask, aged, -1).argmax(-1)
        return aged, way

    def insert_value(self, stamp):
        return torch.full_like(stamp, self.max_rrpv - 1)   # long re-reference


class SrripReplacement:
    """Static RRIP with 2-bit RRPVs stored in the recency field."""

    kind = "replacement"
    name = "srrip"
    compile_tag = "replacement:srrip"
    fused_mode = "srrip"

    MAX_RRPV = 3

    def params_of(self, cfg):
        return {}

    def bind(self, pol):
        return _SrripBound(self.MAX_RRPV)


LRU = register(LruReplacement())
SRRIP = register(SrripReplacement())
