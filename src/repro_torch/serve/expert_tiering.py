"""MoE expert-weight tiering.

Counterpart of ``repro.serve.expert_tiering``. The full expert set lives
in the pooled (slow) tier and the fast tier holds the hot experts. The
access stream is the router's top-k history: per step, the (layer,
expert) slabs the batch activated. ``TieredBlockPool`` serves it with
block id = layer * E + expert and "page" = one layer's expert row, so SPP
learns intra-layer expert locality.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import FamConfig
from repro_torch.core.tiering import TieredBlockPool, TierState


class ExpertTier:
    def __init__(self, fam_cfg: FamConfig, num_layers: int, num_experts: int,
                 slab_elems: int, fast_slabs: int, dtype=torch.bfloat16,
                 device="cuda"):
        self.L, self.E = num_layers, num_experts
        self.pool = TieredBlockPool(
            fam_cfg, num_blocks=num_layers * num_experts,
            fast_blocks=fast_slabs, block_elems=slab_elems,
            page_span=num_experts, dtype=dtype, device=device)
        self.device = self.pool.device

    def slab_ids(self, layer, experts: torch.Tensor) -> torch.Tensor:
        """(layer int or 0-d tensor, experts (k,)) -> flat slab ids (k,)."""
        return (layer * self.E + experts.to(self.device)).to(torch.int32)

    def init(self, slow_slabs: torch.Tensor) -> TierState:
        return self.pool.init(slow_slabs)

    def gather_experts(self, st: TierState, slow: torch.Tensor, layer,
                       experts: torch.Tensor) -> Tuple[TierState, torch.Tensor]:
        """Ensure the routed experts' slabs are resident; return their
        fast-tier contents (k, slab_elems). SPP prefetches the slabs the
        routing history predicts."""
        ids = self.slab_ids(layer, experts)
        st, slots = self.pool.access(st, slow, ids)
        return st, self.pool.read(st, slots)
