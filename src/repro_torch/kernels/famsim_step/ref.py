"""Plain PyTorch version of the fused cache step.

Counterpart of ``repro.kernels.famsim_step.ref``: the exact
:mod:`repro_torch.core.dram_cache` op sequence, in the JAX reference's
order — sequential fills, demand probe + recency touch, then the pure
redundancy probes — batched over lanes. The CUDA kernel
(:mod:`repro_torch.kernels.famsim_step.kernel`) must match it bit for bit.
"""
from __future__ import annotations

from repro_torch.core import dram_cache as dc


def cache_step_ref(cache: dc.CacheState, fill_blocks, fill_enable,
                   demand_block, demand_enable, probe_blocks,
                   num_sets, ways, policy=None):
    """One event's cache work on every lane's (padded) metadata state.

    fill_blocks/fill_enable: (*B, C) retired prefetch fills, gathered from
        DISTINCT queue slots, inserted in order (same-set fills interact).
    demand_block/demand_enable: (*B,) the demand probe; ``demand_enable``
        masks the hit (and therefore the recency touch), not the probe.
    probe_blocks: (*B, P) tag-only probes on the post-touch state.
    num_sets/ways: (*B,) effective geometry; ``policy``: a bound
        replacement policy (None = classic LRU).

    Updates ``cache`` in place; returns (cache, hit (*B,), probe_hits
    (*B, P)) with hit already enable-masked.
    """
    for i in range(fill_blocks.shape[-1]):
        dc.insert(cache, fill_blocks[..., i], enable=fill_enable[..., i],
                  num_sets=num_sets, ways=ways, policy=policy)
    raw, si, way = dc.lookup(cache, demand_block, num_sets=num_sets, ways=ways)
    hit = raw & demand_enable
    dc.touch(cache, si, way, enable=hit, policy=policy)
    probe_hits = dc.lookup(cache, probe_blocks, num_sets=num_sets, ways=ways)[0]
    return cache, hit, probe_hits
