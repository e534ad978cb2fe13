"""Per-system simulator parameters as tensors.

Counterpart of ``repro.core.fam_params``. :class:`FamConfig` keeps the
shape parameters (the padded cache allocation, table sizes, degrees);
:class:`FamParams` carries every other value — latencies, bandwidths, the
allocation ratio, the feature flags, the *effective* cache geometry and
each policy's numeric params — as tensors: 0-d from :meth:`FamParams.of`,
with a leading system axis ``S`` after :func:`stack_params`.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FamConfig
from repro_torch.core.addresses import block_bits
from repro_torch.policies import PolicySet, SimFlags


class FamParams(NamedTuple):
    """Per-system dynamic values (0-d tensors, or (S,) after stacking)."""

    # core / memory timing
    base_ipc: torch.Tensor
    mlp: torch.Tensor
    cores_per_node: torch.Tensor
    llc_latency: torch.Tensor
    local_mem_latency: torch.Tensor
    fam_mem_latency: torch.Tensor
    cxl_min_latency_cycles: torch.Tensor
    fam_cycles_per_byte: torch.Tensor  # DDR occupancy per byte moved
    demand_bytes: torch.Tensor
    block_bytes: torch.Tensor          # service size (bytes moved per fill)
    # effective cache geometry (the cache is allocated at the padded maximum)
    num_sets: torch.Tensor             # i32 effective set count
    cache_ways: torch.Tensor           # i32 effective associativity
    block_bits: torch.Tensor           # i32 log2(block_bytes)
    # placement
    allocation_ratio: torch.Tensor
    # feature flags
    core_prefetch: torch.Tensor
    dram_prefetch: torch.Tensor
    bw_adapt: torch.Tensor
    all_local: torch.Tensor
    #: per-policy numeric params: {kind: {param: tensor}}
    policy: Dict[str, Dict[str, torch.Tensor]]

    @classmethod
    def of(cls, cfg: FamConfig, flags: Optional[SimFlags] = None,
           policies: Optional[PolicySet] = None,
           device="cuda") -> "FamParams":
        """Concrete params from a config (+ optional SimFlags and PolicySet;
        ``policies=None`` derives the set from the flags)."""
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32)
        b = lambda v: torch.tensor(bool(v))
        if flags is None:
            flags = SimFlags()
        if policies is None:
            policies = PolicySet.from_flags(flags)
        p = cls(
            base_ipc=f32(cfg.base_ipc), mlp=f32(cfg.mlp),
            cores_per_node=f32(cfg.cores_per_node),
            llc_latency=f32(cfg.llc_latency),
            local_mem_latency=f32(cfg.local_mem_latency),
            fam_mem_latency=f32(cfg.fam_mem_latency),
            cxl_min_latency_cycles=f32(cfg.cxl_min_latency_cycles),
            fam_cycles_per_byte=f32(cfg.fam_service_cycles(1)),
            demand_bytes=f32(cfg.demand_bytes),
            block_bytes=f32(cfg.block_bytes),
            num_sets=i32(cfg.num_sets),
            cache_ways=i32(cfg.cache_ways),
            block_bits=i32(block_bits(cfg.block_bytes)),
            allocation_ratio=i32(cfg.allocation_ratio),
            core_prefetch=b(flags.core_prefetch),
            dram_prefetch=b(flags.dram_prefetch),
            bw_adapt=b(flags.bw_adapt),
            all_local=b(flags.all_local),
            policy=policies.numeric_params(cfg))
        return tree_map(lambda t: t.to(device), p)

    def fam_service_cycles(self, nbytes) -> torch.Tensor:
        return self.fam_cycles_per_byte * nbytes

    def with_flags(self, flags: SimFlags) -> "FamParams":
        """Replace the flag fields (broadcast over any system axis); the
        ``wfq``/``wfq_weight`` flags map onto the scheduler's params where
        its schema has them."""
        like = self.base_ipc
        full = lambda v, dt: torch.full(like.shape, v, dtype=dt, device=like.device)
        pol = {k: dict(v) for k, v in self.policy.items()}
        sched = pol.get("scheduler", {})
        if "use_wfq" in sched:
            sched["use_wfq"] = full(flags.wfq, torch.bool)
        if "weight" in sched:
            sched["weight"] = full(float(flags.wfq_weight), torch.float32)
        return self._replace(
            core_prefetch=full(flags.core_prefetch, torch.bool),
            dram_prefetch=full(flags.dram_prefetch, torch.bool),
            bw_adapt=full(flags.bw_adapt, torch.bool),
            all_local=full(flags.all_local, torch.bool),
            policy=pol)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a tree of NamedTuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    raise TypeError(f"unexpected tree node {type(tree).__name__}")


def stack_params(params: Sequence[FamParams]) -> FamParams:
    """Stack S per-system FamParams into one batch with leading axis S."""
    def rec(nodes):
        n0 = nodes[0]
        if isinstance(n0, torch.Tensor):
            return torch.stack(nodes)
        if isinstance(n0, dict):
            return {k: rec([n[k] for n in nodes]) for k in n0}
        return type(n0)(*(rec([n[i] for n in nodes]) for i in range(len(n0))))

    return rec(list(params))


def _state_types():
    from repro_torch.core.dram_cache import CacheState
    from repro_torch.core.famsim import NodeState
    from repro_torch.core.prefetch_queue import PrefetchQueue
    from repro_torch.core.spp import SppState
    from repro_torch.core.throttle import ThrottleState
    return (FamParams, NodeState, CacheState, PrefetchQueue, SppState,
            ThrottleState)


def from_numpy(tree: Any, device="cuda"):
    """Carry a JAX-side tree across: ``FamParams`` or any state NamedTuple
    (``NodeState``, ``CacheState``, ``PrefetchQueue``, ``SppState``,
    ``ThrottleState``), given as nested NamedTuples or dicts of numpy
    arrays with the same field names, becomes the port's counterpart with
    tensors on ``device``. A node whose field names match none of those
    types (the ``policy`` dict) stays a dict."""
    by_fields = {frozenset(t._fields): t for t in _state_types()}

    def rec(node):
        if isinstance(node, (dict, tuple)) and not isinstance(node, np.ndarray):
            if isinstance(node, dict):
                items = dict(node)
            elif hasattr(node, "_fields"):
                items = dict(zip(node._fields, node))
            else:
                raise TypeError("plain tuples have no field names")
            conv = {k: rec(v) for k, v in items.items()}
            typ = by_fields.get(frozenset(conv))
            return conv if typ is None else typ(**conv)
        return torch.as_tensor(np.array(node), device=device)

    return rec(tree)
