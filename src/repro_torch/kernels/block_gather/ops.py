"""Backend dispatch for the block gather: ``backend="cuda"`` (the default)
goes through the CUDA wrapper, which runs its plain version on CPU
tensors; ``backend="torch"`` runs the plain version on any device."""
from __future__ import annotations

from repro_torch.configs.base import KERNEL_BACKENDS
from repro_torch.kernels.block_gather.kernel import block_gather
from repro_torch.kernels.block_gather.ref import block_gather_ref


def gather_blocks(pool, idx, backend: str = "cuda"):
    if backend == "torch":
        return block_gather_ref(pool, idx)
    if backend != "cuda":
        raise ValueError(f"unknown kernel backend {backend!r}; expected one "
                         f"of {KERNEL_BACKENDS}")
    return block_gather(pool, idx)
