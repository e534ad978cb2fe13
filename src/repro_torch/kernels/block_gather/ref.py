"""Plain PyTorch version of block_gather (``repro.kernels.block_gather.ref``)."""
from __future__ import annotations

import torch


def block_gather_ref(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool: (num_blocks, block_elems); idx: (K,) int32 -> (K, block_elems)."""
    return pool[idx.to(torch.int64)]
