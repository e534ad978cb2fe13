"""CUDA wrapper for the batched set-associative cache lookup.

:func:`cache_lookup` launches ``csrc/cache_lookup.cu`` (one warp per query)
on CUDA tensors and runs the plain version (:func:`ref.cache_lookup_ref`)
on CPU tensors. It replaces the TPU kernel ``cache_lookup`` of
``repro.kernels.cache_lookup.kernel``. The source is built at first use by
:mod:`repro_torch.kernels.nvcc`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref

SOURCE = Path(__file__).with_name("csrc") / "cache_lookup.cu"

_entry = nvcc.CudaEntry(SOURCE, "cache_lookup",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
build = _entry.build


def cache_lookup(tags, queries):
    """tags: (sets, ways) int32, +1 encoded; queries: (K,) int32.

    Returns (hit (K,) bool, way (K,) int32, slot (K,) int32), the values of
    :func:`ref.cache_lookup_ref`. CUDA tensors launch the kernel (counted
    in ``cache_lookup.launches``); CPU tensors run the plain version."""
    nvcc.check_tensor("tags", tags, torch.int32, (None, None), None)
    dev = tags.device
    nvcc.check_tensor("queries", queries, torch.int32, (None,), dev)
    sets, ways = tags.shape
    if sets == 0 or ways == 0:
        raise ValueError(f"tags must have at least one set and way, got {tuple(tags.shape)}")
    if dev.type == "cpu":
        return cache_lookup_ref(tags, queries)
    if dev.type != "cuda":
        raise ValueError(f"cache_lookup runs on cuda or cpu tensors, not {dev}")
    K = queries.shape[0]
    hit = torch.empty(K, dtype=torch.bool, device=dev)
    way = torch.empty(K, dtype=torch.int32, device=dev)
    slot = torch.empty(K, dtype=torch.int32, device=dev)
    if K:
        _entry(tags.data_ptr(), queries.data_ptr(), hit.data_ptr(),
               way.data_ptr(), slot.data_ptr(), K, sets, ways, nvcc.stream(dev))
        cache_lookup.launches += 1
    return hit, way, slot


cache_lookup.launches = 0
