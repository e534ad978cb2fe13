"""Plain PyTorch version of tiled attention.

Counterpart of ``repro.kernels.flash_attention.ref``: one einsum for the
scores in float32, the causal mask (top-left aligned: query row ``i`` sees
keys ``0..i``, also when ``Sq != Sk``), softmax, one einsum for the values,
the result in q's type. The CUDA kernel
(:mod:`repro_torch.kernels.flash_attention.kernel`) takes the softmax
online, tile by tile, so the two agree to rounding.
"""
from __future__ import annotations

import numpy as np
import torch


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32)) / np.sqrt(D)
    if causal:
        pos_k = torch.arange(Sk, device=q.device)
        pos_q = torch.arange(Sq, device=q.device)
        s = torch.where(pos_k[None, :] > pos_q[:, None], -1e30, s)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
