"""CUDA wrapper for tiled attention.

:func:`flash_attention` launches one of the two kernels of
``csrc/flash_attention.cu`` on CUDA tensors and runs the plain version
(:func:`ref.flash_attention_ref`) on CPU tensors. :func:`variant` picks the
kernel from the type and head dim alone:

- ``"tensor_core"``, bfloat16 with D 64, 80, 128 or 256:
  ``flash_attention_wgmma``, 128 (query position, query head) rows of a kv
  head a CTA, K/V tiles (128 keys, 64 at D 256) brought by TMA from a
  producer warpgroup, q.k and p.v on the tensor cores (wgmma), P as two
  bfloat16 terms (hi + lo, about 16 bits) for p.v; tiles in 64-column
  blocks in the 128-byte swizzle at D 64 / 128 / 256, in 16-column blocks
  in the 32-byte swizzle at D 80;
- ``"cuda_core"``, float32 and bfloat16 at any other D: ``flash_attention``,
  64 rows a block, 64-key tiles, everything in float32 on the CUDA cores.

A failed build or launch raises; neither variant stands in for the other.
Both replace the TPU kernel ``flash_attention`` of
``repro.kernels.flash_attention.kernel`` and walk the key tiles with an
online softmax, skipping tiles above the diagonal. Unlike the TPU kernel
they take any ``Sq`` and ``Sk``: tail keys are masked and tail query rows
are not written. q, k and v may be strided views along B, S and H; D must
be contiguous. The source is built at first use by
:mod:`repro_torch.kernels.nvcc`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.roofline import op_cost

SOURCE = Path(__file__).with_name("csrc") / "flash_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 64                      # kRows in the source (CUDA-core kernel)
MAX_D = 256                    # kMaxD in the source
TC_ROWS = 128                  # kTcRows: rows of a tensor-core CTA
TC_KEYS = 128                  # kTcKeys: keys of a K/V tile
TC_KEYS_256 = 64               # kTcKeys256: at D 256
TC_STAGES = {64: 3, 80: 2, 128: 2, 256: 2}       # kTcStages<D>: K/V ring stages
TC_DIMS = tuple(TC_STAGES)                       # head dims the tensor-core kernel takes
VARIANTS = ("tensor_core", "cuda_core")

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
_entry = nvcc.CudaEntry(SOURCE, "flash_attention",
                        _ARGS + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_wgmma_entry = nvcc.CudaEntry(SOURCE, "flash_attention_wgmma",
                              _ARGS + [ctypes.c_int, ctypes.c_void_p])
build = _entry.build


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that runs (dtype, head_dim) on the card: "tensor_core"
    for bfloat16 at D 64, 80, 128 or 256, "cuda_core" for everything else."""
    return "tensor_core" if dtype == torch.bfloat16 and head_dim in TC_DIMS else "cuda_core"


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, Hq, D) float32 or bfloat16; k/v: (B, Sk, Hkv, D) of the
    same type, Hq a multiple of Hkv, D a multiple of 8 up to 256, D
    contiguous -> (B, Sq, Hq, D) of q's type.

    CUDA tensors launch the kernel that :func:`variant` names (counted in
    ``flash_attention.launches`` and, per variant, in
    ``flash_attention.variant_launches``); CPU tensors run the plain
    version. Under an active op counter the call is charged
    ``op_cost.attention_cost`` (the ``"torch"`` attention's dots at these
    shapes) and its plain version is not counted. The kernel has no backward: under grad mode, inputs that
    require grad raise on any device (train through the ``"torch"``
    attention)."""
    nvcc.refuse_grad("flash_attention", q, k, v)
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
    if op_cost.active():
        op_cost.charge("flash_attention",
                       *op_cost.attention_cost(q.shape, k.shape, q.element_size()))
    if dev.type == "cpu":
        with op_cost.uncounted():
            return flash_attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {dev}")
    isz = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s * isz % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must start on 16-byte boundaries "
                             f"(strides {t.stride()}, pointer {t.data_ptr():#x})")
    which = variant(q.dtype, D)
    G = Hq // Hkv
    # the CUDA-core grid is (row tiles, Hkv, B), the tensor-core one flat
    rows = TC_ROWS if which == "tensor_core" else ROWS
    grid_x = -(-Sq * G // rows) * (Hkv * B if which == "tensor_core" else 1)
    if max(B, Hkv) > 65535 or Sq * G >= 2**31 - rows or grid_x >= 2**31:
        raise ValueError(f"grid too large for B={B}, Hkv={Hkv}, Sq={Sq}, Hq={Hq}")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    if out.numel():
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
                Hkv, G, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(bool(causal)))
        if which == "tensor_core":
            _wgmma_entry(*args, nvcc.stream(dev))
        else:
            _entry(*args, DTYPES[q.dtype], nvcc.stream(dev))
        flash_attention.launches += 1
        flash_attention.variant_launches[which] += 1
    return out


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)
