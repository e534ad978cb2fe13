"""Gather of whole rows of a block pool (the tiering runtime's fast-tier
read) as one CUDA kernel launch (:mod:`kernel`), with its plain PyTorch
version in :mod:`ref` and the dispatcher in :mod:`ops`."""
from repro_torch.kernels.block_gather.kernel import block_gather, build
from repro_torch.kernels.block_gather.ops import gather_blocks
from repro_torch.kernels.block_gather.ref import block_gather_ref

__all__ = ["block_gather", "block_gather_ref", "build", "gather_blocks"]
