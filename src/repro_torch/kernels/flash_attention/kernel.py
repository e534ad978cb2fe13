"""CUDA wrapper for tiled attention.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` (one block per
64 (query position, query head) rows of a kv head, key tiles of 64 walked
with an online softmax in float32, tiles above the diagonal skipped) on
CUDA tensors and runs the plain version (:func:`ref.flash_attention_ref`)
on CPU tensors. It replaces the TPU kernel ``flash_attention`` of
``repro.kernels.flash_attention.kernel``. Unlike the TPU kernel it takes
any ``Sq`` and ``Sk``: the tile sizes are the kernel's own constants, tail
keys are masked and tail query rows are not written. q, k and v may be
strided views along B, S and H; D must be contiguous. The source is built
at first use by :mod:`repro_torch.kernels.nvcc`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).with_name("csrc") / "flash_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 64                      # kRows in the source
MAX_D = 256                    # kMaxD in the source

_entry = nvcc.CudaEntry(SOURCE, "flash_attention",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                        + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p])
build = _entry.build


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, Hq, D) float32 or bfloat16; k/v: (B, Sk, Hkv, D) of the
    same type, Hq a multiple of Hkv, D a multiple of 8 up to 256, D
    contiguous -> (B, Sq, Hq, D) of q's type.

    CUDA tensors launch the kernel (counted in ``flash_attention.launches``);
    CPU tensors run the plain version."""
    nvcc.check_tensor("q", q, tuple(DTYPES), (None, None, None, None), None,
                      contiguous=False)
    dev = q.device
    B, Sq, Hq, D = q.shape
    nvcc.check_tensor("k", k, q.dtype, (B, None, None, D), dev, contiguous=False)
    nvcc.check_tensor("v", v, q.dtype, tuple(k.shape), dev, contiguous=False)
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"query heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    if D == 0 or D % 8 or D > MAX_D:
        raise ValueError(f"head dim must be a multiple of 8 up to {MAX_D}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D")
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {dev}")
    isz = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s * isz % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must start on 16-byte boundaries "
                             f"(strides {t.stride()}, pointer {t.data_ptr():#x})")
    if max(B, Hkv) > 65535 or Sq * (Hq // Hkv) >= 2**31 - ROWS:
        raise ValueError(f"grid too large for B={B}, Hkv={Hkv}, Sq={Sq}, Hq={Hq}")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    if out.numel():
        _entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
               Hkv, Hq // Hkv, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               int(bool(causal)), DTYPES[q.dtype], nvcc.stream(dev))
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
