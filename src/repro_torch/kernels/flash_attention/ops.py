"""Backend dispatch for tiled attention: ``backend="cuda"`` (the default)
goes through the CUDA wrapper, which runs its plain version on CPU
tensors; ``backend="torch"`` runs the plain version on any device."""
from __future__ import annotations

from repro_torch.configs.base import KERNEL_BACKENDS
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def attention(q, k, v, *, causal: bool = True, backend: str = "cuda"):
    if backend == "torch":
        return flash_attention_ref(q, k, v, causal=causal)
    if backend != "cuda":
        raise ValueError(f"unknown kernel backend {backend!r}; expected one "
                         f"of {KERNEL_BACKENDS}")
    return flash_attention(q, k, v, causal=causal)
