"""CUDA wrapper for paged decode attention.

:func:`paged_attention` launches ``csrc/paged_attention.cu`` (each
sequence's blocks split over the grid, online softmax in float32, the
splits merged by the last block) on CUDA tensors and runs
the plain version (:func:`ref.paged_attention_ref`) on CPU tensors. It
replaces the TPU kernel ``paged_attention`` of
``repro.kernels.paged_attention.kernel``. The K and V pools may be strided
views (D contiguous): their strides go to the kernel, nothing is copied.
The source is built at first use by :mod:`repro_torch.kernels.nvcc`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SOURCE = Path(__file__).with_name("csrc") / "paged_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WARPS = 4                       # kWarps in the source
MAX_SHARED_BYTES = 227 * 1024   # kMaxSharedBytes in the source

_entry = nvcc.CudaEntry(SOURCE, "paged_attention",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                        + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
build = _entry.build


def shared_bytes(G: int, D: int, T: int, itemsize: int) -> int:
    """Shared memory of one block, as the source's ``Smem`` lays it out:
    the queries in f32, then per warp a K tile (rows padded by 16 bytes), a
    V tile, one tile's scores and the warp's (acc, m, l)."""
    r16 = lambda x: (x + 15) // 16 * 16
    vrow = r16(D * itemsize)
    warp = (r16(T * (vrow + 16)) + r16(T * vrow) + r16(4 * G * T) + r16(4 * G * D)
            + r16(8 * G))
    return r16(4 * G * D) + WARPS * warp


def split_plan(pairs: int, NB: int, sms: int):
    """(chunk, splits): each (sequence, kv head) pair's NB table blocks in
    ``splits`` chunks of ``chunk``, about two blocks of the grid per SM."""
    if NB == 0:
        return 1, 1
    splits = max(1, min(NB, -(-2 * sms // pairs)))
    chunk = -(-NB // splits)
    return chunk, -(-NB // chunk)


def paged_attention(q, k_pool, v_pool, block_table, lengths):
    """q: (B, Hq, D) float32 or bfloat16; k/v_pool: (P, T, Hkv, D) of the
    same type, any strides with D contiguous; block_table: (B, NB) int32;
    lengths: (B,) int32 -> (B, Hq, D) of q's type.

    CUDA tensors launch the kernel (counted in ``paged_attention.launches``);
    CPU tensors run the plain version."""
    nvcc.check_tensor("q", q, tuple(DTYPES), (None, None, None), None)
    dev = q.device
    B, Hq, D = q.shape
    nvcc.check_tensor("k_pool", k_pool, q.dtype, (None, None, None, D), dev,
                      contiguous=False)
    nvcc.check_tensor("v_pool", v_pool, q.dtype, tuple(k_pool.shape), dev,
                      contiguous=False)
    P, T, Hkv, _ = k_pool.shape
    nvcc.check_tensor("block_table", block_table, torch.int32, (B, None), dev)
    nvcc.check_tensor("lengths", lengths, torch.int32, (B,), dev)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"query heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    if P == 0 or T == 0:
        raise ValueError(f"k_pool must hold at least one block of one token, got {tuple(k_pool.shape)}")
    if dev.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, lengths)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, not {dev}")
    G, NB = Hq // Hkv, block_table.shape[1]
    smem = shared_bytes(G, D, T, q.element_size())
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"G={G}, D={D}, T={T} need {smem} B of shared memory, "
                         f"more than {MAX_SHARED_BYTES}")
    out = torch.empty_like(q)
    if out.numel():
        chunk, splits = split_plan(B * Hkv, NB, _sm_count(dev))
        ws = torch.empty(B * Hkv * splits * G * (D + 2), dtype=torch.float32, device=dev)
        done = torch.zeros(B * Hkv, dtype=torch.int32, device=dev)
        _entry(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
               block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
               ws.data_ptr(), done.data_ptr(), B, Hkv, G, D, T, NB, P, chunk, splits,
               *k_pool.stride()[:3], *v_pool.stride()[:3], DTYPES[q.dtype],
               nvcc.stream(dev))
        paged_attention.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


paged_attention.launches = 0
