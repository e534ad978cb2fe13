"""DRAM-cache replacement policies (victim selection, paper §III-B).

Counterpart of ``repro.policies.replacement``. ``bind(pol)`` returns the
object the cache ops consume: ``None`` selects the classic set-LRU path of
:mod:`repro_torch.core.dram_cache`; ``srrip`` binds to an object with
``on_hit``, ``evict`` and ``insert_value`` that reuses the recency field
as a 2-bit RRPV (hit -> 0, insert at 2, victim = the aged max-RRPV way);
``random`` picks a threefry-derived victim, deterministic in (stamp, set):
the same draws as ``jax.random`` (:mod:`repro_torch.traces.threefry`).
``random`` has no ``fused_mode``: the CUDA cache step cannot express it,
so it runs with ``kernel_backend="torch"`` only, as the reference keeps it
off its Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.policies.base import register
from repro_torch.traces import threefry


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


class _RandomBound:
    #: jax.random.PRNGKey(0x5EED)
    _SEED = 0x5EED

    def on_hit(self, old, stamp):
        return old                      # recency untracked

    def evict(self, row_lru, wmask, stamp, set_idx, eff_ways):
        # the key built on the device (no host copy inside a CUDA graph)
        s = stamp.to(torch.int64)
        base = torch.stack([torch.zeros_like(s), torch.full_like(s, self._SEED)], -1)
        key = threefry.fold_in(threefry.fold_in(base, stamp), set_idx)
        ways = eff_ways.to(torch.int32)
        way = threefry.randint(key, (), torch.zeros_like(ways),
                               torch.clamp(ways, min=1))
        return row_lru, way.to(torch.int64)

    def insert_value(self, stamp):
        return stamp


class RandomReplacement:
    """Uniform-random victim via threefry: deterministic in the cache's
    monotonic stamp and the set index, uniform over the *effective* ways
    of a padded state."""

    kind = "replacement"
    name = "random"
    compile_tag = "replacement:random"

    def params_of(self, cfg):
        return {}

    def bind(self, pol):
        return _RandomBound()


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
RANDOM = register(RandomReplacement())
SRRIP = register(SrripReplacement())
