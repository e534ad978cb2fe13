"""Decode attention over a block-pooled (paged) KV cache as one CUDA
kernel launch (:mod:`kernel`), with its plain PyTorch version in
:mod:`ref` and the dispatcher in :mod:`ops`."""
from repro_torch.kernels.paged_attention.kernel import build, paged_attention
from repro_torch.kernels.paged_attention.ops import decode_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

__all__ = ["build", "decode_attention", "paged_attention", "paged_attention_ref"]
