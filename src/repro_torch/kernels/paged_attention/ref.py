"""Plain PyTorch version of paged decode attention.

Counterpart of ``repro.kernels.paged_attention.ref``: gather the blocks,
one einsum for the scores, mask, softmax, one einsum for the values, all
in float32. Masked positions then weigh exactly 0, as in the TPU kernel
(``repro.kernels.paged_attention.kernel``), so a sequence of length 0
gives zeros (``repro.kernels.paged_attention.ref`` gives the mean of V
there); at any other length this changes nothing, since a masked
position's weight is already 0. The CUDA kernel
(:mod:`repro_torch.kernels.paged_attention.kernel`) takes the softmax
online, block by block, so the two agree to rounding.
"""
from __future__ import annotations

import numpy as np
import torch


def paged_attention_ref(q, k_pool, v_pool, block_table, lengths):
    """Decode attention over block-pooled KV.

    q:           (B, Hq, D)          one query token per sequence
    k/v_pool:    (P, T, Hkv, D)      P pool blocks of T tokens
    block_table: (B, NB) int32       logical block -> pool slot
    lengths:     (B,) int32          valid tokens per sequence
    -> (B, Hq, D)
    """
    B, Hq, D = q.shape
    P, T, Hkv, _ = k_pool.shape
    NB = block_table.shape[1]
    G = Hq // Hkv
    idx = block_table.to(torch.int64)
    k = k_pool[idx].reshape(B, NB * T, Hkv, D)      # (B, NB*T, Hkv, D)
    v = v_pool[idx].reshape(B, NB * T, Hkv, D)
    qg = q.reshape(B, Hkv, G, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.to(torch.float32),
                          k.to(torch.float32)) / np.sqrt(D)
    pos = torch.arange(NB * T, device=q.device)
    mask = pos[None, :] < lengths[:, None]           # (B, S)
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    p = torch.where(mask[:, None, None, :], torch.softmax(scores, dim=-1), 0.0)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32))
    return out.reshape(B, Hq, D).to(q.dtype)
