"""``jax.random``'s threefry draws, reproduced bit for bit in PyTorch.

The device trace generator (:mod:`repro_torch.traces.device`) draws from
threefry2x32 keys exactly as ``repro.traces.device`` does through
``jax.random``, so every draw here equals JAX's under its default
``jax_threefry_partitionable=True``:

* :func:`threefry2x32` — the 20-round Threefry-2x32 hash
  (``jax/_src/prng.py``, ``_threefry2x32_lowering``);
* counters — ``iota_2x32_shape``: the row-major flat index of each element
  as (hi, lo) 32-bit halves (hi is 0 below 2**32 elements);
* :func:`fold_in` — ``threefry2x32(key, (0, data))``, ``data`` an int or
  one integer per key;
* :func:`split` — the fold-like split: key i is ``threefry2x32(key, (0, i))``;
* :func:`random_bits` — ``bits1 ^ bits2`` of the hash over the counters;
* :func:`randint` — two split keys give higher and lower bits, folded
  into the per-element span with JAX's uint32 ``multiplier`` arithmetic
  (wrapping included; ``span = 1`` where ``maxval <= minval``);
* :func:`uniform` — 23 mantissa bits OR'd into 1.0, minus 1, scaled into
  ``[minval, maxval)`` and clamped below at ``minval``;
* :func:`normal` — ``sqrt(2) * erfinv(u)`` of a uniform on
  ``(nextafter(-1, 0), 1)``.

A key is an int64 tensor of shape ``(..., 2)`` holding the two uint32
words (``jax.random.PRNGKey(s)`` is ``[0, s]`` for a 32-bit seed ``s``);
every function batches over its leading dimensions (where JAX vmaps).
The uint32 arithmetic runs in int64 tensors masked to 32 bits: torch has
no ``>>`` for ``uint32`` on the CPU, and the same code path on every
device keeps the CPU and the card equal. The integer draws are exact on
any device; ``normal`` goes through ``torch.erfinv``, which is not XLA's
``erf_inv`` and differs from it in the last bits.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: nextafter(-1, 0) in float32: the lower end of the normal's uniform
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the counter pairs (x1, x2) under the key
    (k1, k2); all int64 tensors holding uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & M32
    return a, b


def _counters(shape, device) -> torch.Tensor:
    n = math.prod(shape)
    if n > M32:
        raise NotImplementedError("more than 2**32 draws from one key")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def _hash(k: torch.Tensor, shape) -> tuple:
    """Both threefry words for counters of ``shape`` under every key of
    ``k`` (..., 2): each of shape ``k.shape[:-1] + shape``."""
    lo = _counters(shape, k.device)
    pad = (slice(None),) * (k.dim() - 1) + (None,) * len(shape)
    return threefry2x32(k[..., 0][pad], k[..., 1][pad], torch.zeros_like(lo), lo)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``: ``data`` a Python int, or an
    integer tensor that broadcasts against ``k[..., 0]`` (one datum per
    key, where JAX vmaps ``fold_in``), taken as uint32."""
    if isinstance(data, torch.Tensor):
        d = (data.to(torch.int64) & M32).expand_as(k[..., 0])
    else:
        d = torch.full_like(k[..., 0], int(data) & M32)
    a, b = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], -1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)``: (..., num, 2)."""
    a, b = _hash(k, (num,))
    return torch.stack([a, b], -1)


def random_bits(k: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``), as int64 uint32
    values of shape ``k.shape[:-1] + shape``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    a, b = _hash(k, shape)
    return a ^ b


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2**32 for uint32 values held in int64 (no int64 overflow)."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def _as_int(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=like.device)


def _is_int32(v) -> bool:
    """An int32 tensor: within int32 by its type, so its bounds need no
    check (a check would sync the host, which a CUDA graph forbids)."""
    return isinstance(v, torch.Tensor) and v.dtype == torch.int32


def randint(k: torch.Tensor, shape: Shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32). ``minval``
    and ``maxval`` are ints or integer tensors that broadcast against
    ``k.shape[:-1] + shape`` (a per-lane bound is shaped ``(..., 1)``),
    within int32 (checked unless both are int32 tensors)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    k1, k2 = split(k).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    lo, hi = _as_int(minval, k), _as_int(maxval, k)
    if not (_is_int32(minval) and _is_int32(maxval)) and (
            bool((hi > 2 ** 31 - 1).any()) or bool((lo < -2 ** 31).any())):
        raise ValueError("randint bounds must lie within int32")
    span = (hi - lo) & M32
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    multiplier = (2 ** 16) % span
    multiplier = _mul32(multiplier, multiplier) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & M32
    offset = offset % span
    return (lo + offset).to(torch.int32)


def uniform(k: torch.Tensor, shape: Shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    bits = random_bits(k, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=k.device)
    # XLA contracts f * (hi - lo) + lo into one fused multiply-add; the
    # product is exact in float64, so the sum is taken there and rounded
    # to float32 (two float32 roundings differ in ~40 % of draws)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def normal(k: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` (float32), up to ``erfinv``'s last
    bits (the uniform it inverts is exact)."""
    return _SQRT2 * torch.erfinv(uniform(k, shape, _NORMAL_LO, 1.0))
