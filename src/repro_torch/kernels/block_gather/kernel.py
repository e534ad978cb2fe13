"""CUDA wrapper for the block gather.

:func:`block_gather` launches ``csrc/block_gather.cu`` (a byte copy, one
block per 32 KB chunk of a row) on CUDA tensors and runs the plain version
(:func:`ref.block_gather_ref`) on CPU tensors. It replaces the TPU kernel
``block_gather`` of ``repro.kernels.block_gather.kernel``. The source is
built at first use by :mod:`repro_torch.kernels.nvcc`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.block_gather.ref import block_gather_ref

SOURCE = Path(__file__).with_name("csrc") / "block_gather.cu"
MAX_ROWS = 65535          # one grid row of blocks per gathered row

_entry = nvcc.CudaEntry(SOURCE, "block_gather",
                        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                        + [ctypes.c_int, ctypes.c_void_p])
build = _entry.build


def block_gather(pool, idx):
    """pool: (num_blocks, E) of any dtype, contiguous; idx: (K,) int32.

    Returns (K, E) rows ``pool[idx]``, the values of
    :func:`ref.block_gather_ref`. CUDA tensors launch the kernel (counted
    in ``block_gather.launches``); CPU tensors run the plain version."""
    nvcc.check_tensor("pool", pool, None, (None, None), None)
    dev = pool.device
    nvcc.check_tensor("idx", idx, torch.int32, (None,), dev)
    if pool.shape[0] == 0:
        raise ValueError("pool must hold at least one block")
    if dev.type == "cpu":
        return block_gather_ref(pool, idx)
    if dev.type != "cuda":
        raise ValueError(f"block_gather runs on cuda or cpu tensors, not {dev}")
    K = idx.shape[0]
    if K > MAX_ROWS:
        raise ValueError(f"idx gathers at most {MAX_ROWS} rows a launch, got {K}")
    out = torch.empty((K, pool.shape[1]), dtype=pool.dtype, device=dev)
    if out.numel():
        _entry(pool.data_ptr(), idx.data_ptr(), out.data_ptr(), pool.shape[0],
               pool.shape[1] * pool.element_size(), K, nvcc.stream(dev))
        block_gather.launches += 1
    return out


block_gather.launches = 0
