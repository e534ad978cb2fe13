"""Attention: GQA/MQA/MHA with chunked (memory-efficient) prefill
attention, contiguous-KV decode, sliding windows and cross-attention.

Counterpart of ``repro.models.attention`` (its ``attention.py:31-237``);
the buffered decode waits for the launcher that uses it.

Layouts, as in the reference:

    activations     x : (B, S, d_model)
    q after proj      : (B, S, Hq, D)
    k/v after proj    : (B, S, Hkv, D)
    KV cache (layer)  : k, v : (B, S_max, Hkv, D), plus the write index.

Routing (:func:`attend`): with ``backend="cuda"`` and no window, two
cases go to the hand-written kernel
:func:`repro_torch.kernels.flash_attention.ops.attention` (its plain
version on CPU tensors): causal self-attention with ``Sq == Sk`` under
the ``"rect"`` schedule (the prefill and forward case), and unmasked
attention at any ``Sq`` and ``Sk`` (an encoder's bidirectional layers,
cross-attention in a prefill). Every other case, and every case with
``backend="torch"``, runs the reference's jnp path written in torch:
full attention for short queries, query chunks for long ones, the
triangular group schedule for ``schedule="grouped"``. The rule is
explicit: nothing falls back on failure. Decode attention, self and
cross, is plain torch over the cache, as the reference computes it
outside any kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import KERNEL_BACKENDS, ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init, param, torch_dtype

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
ROTARY = ("rope", "mrope")     # positions that rotate q and k


class Attention(nn.Module):
    """``wq`` (d_model, q_dim), ``wk``/``wv`` (kv_in, kv_dim), ``wo``
    (q_dim, d_model)."""

    def __init__(self, cfg: ModelConfig, gen=None, device=None,
                 kv_input_dim: Optional[int] = None):
        super().__init__()
        pdt = torch_dtype(cfg.param_dtype)
        kv_in = kv_input_dim or cfg.d_model
        self.wq = param(dense_init(gen, cfg.d_model, cfg.q_dim, pdt, device))
        self.wk = param(dense_init(gen, kv_in, cfg.kv_dim, pdt, device))
        self.wv = param(dense_init(gen, kv_in, cfg.kv_dim, pdt, device))
        self.wo = param(dense_init(gen, cfg.q_dim, cfg.d_model, pdt, device,
                                   scale=1.0 / np.sqrt(cfg.q_dim * 2 * cfg.num_layers)))


def init_attention(gen, cfg: ModelConfig, device=None,
                   kv_input_dim: Optional[int] = None) -> Attention:
    return Attention(cfg, gen, device, kv_input_dim)


def qkv_proj(cfg: ModelConfig, p: Attention, x: torch.Tensor,
             kv_x: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S = x.shape[:2]
    q = (x @ p.wq.to(x.dtype)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k, v = kv_proj(cfg, p, x if kv_x is None else kv_x)
    return q, k, v


def kv_proj(cfg: ModelConfig, p: Attention, kv_x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K/V projections of ``kv_x`` (B, Skv, d); alone, the encoder's
    K/V for cross-attention."""
    B, Skv = kv_x.shape[:2]
    dt = kv_x.dtype
    k = (kv_x @ p.wk.to(dt)).reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    v = (kv_x @ p.wv.to(dt)).reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    return k, v


def out_proj(cfg: ModelConfig, p: Attention, attn_out: torch.Tensor) -> torch.Tensor:
    B, S = attn_out.shape[:2]
    return attn_out.reshape(B, S, cfg.q_dim) @ p.wo.to(attn_out.dtype)


def _group_q(cfg: ModelConfig, q: torch.Tensor) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,Hkv,G,D) grouping query heads onto kv heads."""
    B, S, Hq, D = q.shape
    G = Hq // cfg.num_kv_heads
    return q.reshape(B, S, cfg.num_kv_heads, G, D)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int, k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Sq, Sk) additive float32 bias from positions."""
    m = torch.zeros(q_pos.shape[-1:] + k_pos.shape[-1:], dtype=torch.float32,
                    device=q_pos.device)
    if causal:
        m = torch.where(k_pos[None, :] > q_pos[:, None], NEG_INF, m)
    if window > 0:
        m = torch.where(k_pos[None, :] <= q_pos[:, None] - window, NEG_INF, m)
    if k_valid is not None:
        m = torch.where(k_valid[None, :], m, NEG_INF)
    return m


def _sdpa(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """Grouped attention. q:(B,Sq,Hkv,G,D) k/v:(B,Sk,Hkv,D) bias:(Sq,Sk)."""
    scale = 1.0 / np.sqrt(cfg.head_dim)
    # float32 scores from the compute type, as preferred_element_type=f32
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = scores + bias
    # the probabilities are cast to q's type before p.v
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def attend_full(cfg: ModelConfig, q, k, v, *, causal: bool, window: int = 0,
                q_offset=0) -> torch.Tensor:
    """Direct attention for short sequences. Returns (B,S,Hq,D)."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    qg = _group_q(cfg, q)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    bias = _mask_bias(q_pos, k_pos, causal, window)
    return _sdpa(cfg, qg, k, v, bias).reshape(B, Sq, Hq, D)


def attend_chunked(cfg: ModelConfig, q, k, v, *, causal: bool, window: int = 0,
                   chunk: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Memory-efficient attention: a loop over query chunks; full-KV einsum
    per chunk with float32 softmax. Peak memory O(B*H*chunk*Sk)."""
    B, Sq, Hq, D = q.shape
    if Sq <= chunk:
        return attend_full(cfg, q, k, v, causal=causal, window=window,
                           q_offset=q_offset)
    if Sq % chunk:  # pad queries to a chunk multiple (rows are independent)
        pad = chunk - Sq % chunk
        qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        out = attend_chunked(cfg, qp, k, v, causal=causal, window=window,
                             chunk=chunk, q_offset=q_offset)
        return out[:, :Sq]
    qg = _group_q(cfg, q)
    k_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for i in range(Sq // chunk):
        q_pos = q_offset + i * chunk + torch.arange(chunk, device=q.device)
        bias = _mask_bias(q_pos, k_pos, causal, window)
        outs.append(_sdpa(cfg, qg[:, i * chunk:(i + 1) * chunk], k, v, bias))
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, D)


def attend_grouped(cfg: ModelConfig, q, k, v, *, window: int = 0,
                   chunk: int = 512, groups: int = 8) -> torch.Tensor:
    """Triangular group schedule for causal attention: group g's queries
    see only kv[:end_g], which cuts the chunked path's full-rectangle
    scores to (groups + 1) / (2 groups) of them."""
    B, Sq, Hq, D = q.shape
    if Sq % (groups * chunk):
        return attend_chunked(cfg, q, k, v, causal=True, window=window,
                              chunk=chunk)
    gsize = Sq // groups
    outs = []
    for g in range(groups):
        kv_end = (g + 1) * gsize
        outs.append(attend_chunked(
            cfg, q[:, g * gsize:kv_end], k[:, :kv_end], v[:, :kv_end],
            causal=True, window=window, chunk=chunk, q_offset=g * gsize))
    return torch.cat(outs, dim=1)


def attend(cfg: ModelConfig, q, k, v, *, causal=True, window: int = 0,
           chunk: int = 512, schedule: str = "rect", groups: int = 8,
           backend: str = "cuda") -> torch.Tensor:
    if backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; expected one "
                         f"of {KERNEL_BACKENDS}")
    if backend == "cuda" and window == 0 and (
            not causal or (schedule == "rect" and q.shape[1] == k.shape[1])):
        return flash_ops.attention(q, k, v, causal=causal)
    if causal and schedule == "grouped" and q.shape[1] > chunk:
        return attend_grouped(cfg, q, k, v, window=window, chunk=chunk,
                              groups=groups)
    if q.shape[1] > chunk:
        return attend_chunked(cfg, q, k, v, causal=causal, window=window, chunk=chunk)
    return attend_full(cfg, q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Decode with a contiguous KV cache
# ---------------------------------------------------------------------------

def decode_attend(cfg: ModelConfig, q, k_cache, v_cache, index, *,
                  window: int = 0) -> torch.Tensor:
    """One-token attention against the cache.

    q: (B, 1, Hq, D); k/v_cache: (B, S_max, Hkv, D); index: number of valid
    cache entries *including* the current token (already written).
    """
    B, _, Hq, D = q.shape
    S = k_cache.shape[1]
    qg = _group_q(cfg, q)
    k_pos = torch.arange(S, device=q.device)
    k_valid = k_pos < index
    q_pos = torch.as_tensor(index - 1, device=q.device).reshape(1)
    bias = _mask_bias(q_pos, k_pos, True, window, k_valid)
    return _sdpa(cfg, qg, k_cache, v_cache, bias).reshape(B, 1, Hq, D)


def cache_update(k_cache, v_cache, k_new, v_new, index: int):
    """Write (B, S_new, Hkv, D) at position ``index`` of the cache, in place
    (the reference's dynamic_update_slice returns new arrays)."""
    S_new = k_new.shape[1]
    k_cache[:, index:index + S_new] = k_new.to(k_cache.dtype)
    v_cache[:, index:index + S_new] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# Full attention block (pre-norm residual), shared by dense archs
# ---------------------------------------------------------------------------

def self_attention(cfg: ModelConfig, p: Attention, x, positions, *,
                   causal: bool = True, window: int = 0, chunk: int = 512,
                   schedule: str = "rect", backend: str = "cuda") -> torch.Tensor:
    q, k, v = qkv_proj(cfg, p, x)
    if cfg.position in ROTARY:
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    out = attend(cfg, q, k, v, causal=causal, window=window, chunk=chunk,
                 schedule=schedule, backend=backend)
    return out_proj(cfg, p, out)


def cross_attention(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor], *,
                    backend: str = "cuda") -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V, unmasked
    (the reference's ``attend_full(causal=False)``), routed by
    :func:`attend`: the kernel under ``backend="cuda"``."""
    dt = x.dtype
    B, S = x.shape[:2]
    q = (x @ p.wq.to(dt)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k, v = enc_kv
    return out_proj(cfg, p, attend(cfg, q, k, v, causal=False, backend=backend))
