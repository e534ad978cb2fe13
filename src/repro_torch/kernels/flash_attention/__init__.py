"""Tiled causal attention (the prefill's attention) as one CUDA kernel
launch (:mod:`kernel`), with its plain PyTorch version in :mod:`ref` and
the dispatcher in :mod:`ops`."""
from repro_torch.kernels.flash_attention.kernel import build, flash_attention
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["attention", "build", "flash_attention", "flash_attention_ref"]
