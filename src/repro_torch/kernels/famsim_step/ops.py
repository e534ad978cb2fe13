"""Backend dispatch for the fused cache step.

``cache_step`` is what famsim calls once per event for all lanes.
``backend="cuda"`` (the default) goes through the CUDA wrapper
(:func:`kernel.fused_cache_step`), which runs its plain version on CPU
tensors; ``backend="torch"`` runs the plain version on any device. The
kernel bakes the replacement policy in as a mode, so only policies that
declare ``fused_mode`` ("lru", "srrip") can ride it.
"""
from __future__ import annotations

from repro_torch.configs.base import KERNEL_BACKENDS
from repro_torch.core import dram_cache as dc
from repro_torch.kernels.famsim_step.kernel import fused_cache_step
from repro_torch.kernels.famsim_step.ref import cache_step_ref

FUSED_REPLACEMENT_MODES = ("lru", "srrip")


def fused_replacement_mode(policy):
    """The kernel's ``(mode, max_rrpv)`` for a *bound* policy (or the
    policy object itself — both carry ``fused_mode``). Raises for policies
    the kernel cannot express."""
    mode = "lru" if policy is None else getattr(policy, "fused_mode", None)
    if mode not in FUSED_REPLACEMENT_MODES:
        raise ValueError(
            f"kernel_backend='cuda' supports replacement policies "
            f"{FUSED_REPLACEMENT_MODES} only, got "
            f"{getattr(policy, 'name', type(policy).__name__)!r}")
    return mode, int(getattr(policy, "max_rrpv", 0))


def cache_step(cache: dc.CacheState, fill_blocks, fill_enable,
               demand_block, demand_enable, probe_blocks,
               num_sets, ways, policy=None, backend: str = "cuda"):
    """One event's fused cache work; see :func:`ref.cache_step_ref`.
    Updates ``cache`` in place and returns (cache, hit, probe_hits)."""
    if backend == "torch":
        return cache_step_ref(cache, fill_blocks, fill_enable, demand_block,
                              demand_enable, probe_blocks, num_sets, ways,
                              policy=policy)
    if backend != "cuda":
        raise ValueError(f"unknown kernel backend {backend!r}; expected "
                         f"one of {KERNEL_BACKENDS}")
    mode, max_rrpv = fused_replacement_mode(policy)
    hit, probe_hits = fused_cache_step(
        cache.tags, cache.lru, cache.stamp, fill_blocks, fill_enable,
        demand_block, demand_enable, probe_blocks, num_sets, ways,
        mode=mode, max_rrpv=max_rrpv)
    return cache, hit, probe_hits
