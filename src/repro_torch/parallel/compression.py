"""int8 error-feedback gradient compression for slow inter-pod links.

Counterpart of ``repro.parallel.compression`` (its ``compression.py:23-65``).
Each gradient slab is quantized to int8 with per-block absmax scales
before the cross-pod all-reduce, and the quantization error is carried
into the next step (error feedback keeps convergence; Karimireddy et al.
2019). As in the reference, the all-reduce runs on the dequantized values
(a sum ``all_reduce`` over the axis's group divided by its size:
``pmean``); codes and scales are what the wire would carry.

Usage in a data-parallel step over axis "pod":
    g, err = ef_compress_allreduce(g, err, mesh, "pod")
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.parallel.compat import Mesh, pmean

Q_BLOCK = 256


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes (n_blocks, Q_BLOCK) int8, scales (n_blocks, 1) float32): the
    flattened x zero-padded to whole blocks, each block's absmax / 127 +
    1e-12 as its scale, codes rounded half to even (``jnp.round``'s rule)
    and clipped to [-127, 127]."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % Q_BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, Q_BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """Quantization round trip (what the wire sees)."""
    q, s = _quantize(x)
    return _dequantize(q, s, x.shape)


def ef_compress_allreduce(g: torch.Tensor, err: torch.Tensor, mesh: Mesh, axis: str
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce over ``axis``. Returns (reduced
    gradient, new error residual)."""
    x = g + err
    q, s = _quantize(x)
    xq = _dequantize(q, s, g.shape)
    new_err = x - xq
    return pmean(xq, mesh, axis), new_err


def init_error(params) -> Dict[str, torch.Tensor]:
    """Zero float32 residuals, one per parameter (by dotted name)."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named.items()}
