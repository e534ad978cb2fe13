"""Backend dispatch for paged decode attention: ``backend="cuda"`` (the
default) goes through the CUDA wrapper, which runs its plain version on
CPU tensors; ``backend="torch"`` runs the plain version on any device."""
from __future__ import annotations

from repro_torch.configs.base import KERNEL_BACKENDS
from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def decode_attention(q, k_pool, v_pool, block_table, lengths,
                     backend: str = "cuda"):
    if backend == "torch":
        return paged_attention_ref(q, k_pool, v_pool, block_table, lengths)
    if backend != "cuda":
        raise ValueError(f"unknown kernel backend {backend!r}; expected one "
                         f"of {KERNEL_BACKENDS}")
    return paged_attention(q, k_pool, v_pool, block_table, lengths)
