"""Attention: GQA/MQA/MHA with chunked (memory-efficient) prefill
attention, contiguous-KV decode, sliding windows and cross-attention.

Counterpart of ``repro.models.attention`` (its ``attention.py:31-291``),
the two-source decode of the buffered decode included.

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

On DTensors (the model's sharded run) :func:`attend` runs on each rank's
shard: q, k and v keep the batch's sharding and are split by heads over
the axis that holds the projections' heads when both ``Hq`` and ``Hkv``
divide it (else the heads are gathered, so the GQA grouping sees whole
groups); the local call, the kernel's included, takes plain tensors and
its output is the same shard of the DTensor result.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import KERNEL_BACKENDS, ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init, param, torch_dtype
from repro_torch.parallel.sharding import is_dtensor

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


def _whole(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """DTensor ``t`` with ``dim`` gathered along every mesh axis whose split
    ``parts`` does not divide: DTensor splits a sharded dim into ``parts``
    outer pieces only where the ranks divide them."""
    from torch.distributed.tensor import Replicate
    dim, split, placements = dim % t.ndim, 1, []
    for i, pl in enumerate(t.placements):
        if pl.is_shard() and pl.dim % t.ndim == dim:
            split *= t.device_mesh.size(i)
            if parts % split:
                pl = Replicate()
        placements.append(pl)
    return t.redistribute(t.device_mesh, tuple(placements))


class _WholeGrad(torch.autograd.Function):
    """The identity, whose backward hands on a cotangent with ``dim``
    gathered as :func:`_whole` gathers it, for the backward of a split
    of that dim into ``parts``."""

    @staticmethod
    def forward(ctx, x, dim, parts):
        ctx.dim, ctx.parts = dim, parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole(g, ctx.dim, ctx.parts), None, None


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, heads * head_dim) -> (B, S, heads, head_dim). A DTensor whose
    last dim is split over more ranks than ``heads`` divides is gathered
    along it first (DTensor splits a sharded dim only at its outer
    factor)."""
    if is_dtensor(t):
        t = _whole(t, -1, heads)
    return t.reshape(t.shape[:2] + (heads, head_dim))


def qkv_proj(cfg: ModelConfig, p: Attention, x: torch.Tensor,
             kv_x: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = split_heads(x @ p.wq.to(x.dtype), cfg.num_heads, cfg.head_dim)
    k, v = kv_proj(cfg, p, x if kv_x is None else kv_x)
    return q, k, v


def kv_proj(cfg: ModelConfig, p: Attention, kv_x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K/V projections of ``kv_x`` (B, Skv, d); alone, the encoder's
    K/V for cross-attention."""
    dt = kv_x.dtype
    k = split_heads(kv_x @ p.wk.to(dt), cfg.num_kv_heads, cfg.head_dim)
    v = split_heads(kv_x @ p.wv.to(dt), cfg.num_kv_heads, cfg.head_dim)
    return k, v


def out_proj(cfg: ModelConfig, p: Attention, attn_out: torch.Tensor) -> torch.Tensor:
    B, S = attn_out.shape[:2]
    x = attn_out.reshape(B, S, cfg.q_dim)
    if is_dtensor(x):
        # the backward splits x's cotangent back into the heads
        x = _WholeGrad.apply(x, -1, cfg.num_heads)
    return x @ p.wo.to(attn_out.dtype)


def _group_q(cfg: ModelConfig, q: torch.Tensor) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,Hkv,G,D) grouping query heads onto kv heads."""
    B, S, Hq, D = q.shape
    G = Hq // cfg.num_kv_heads
    if is_dtensor(q):
        q = _whole(q, 2, cfg.num_kv_heads)
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


def _head_placements(q, k) -> Tuple[tuple, int]:
    """(placements for q / k / v of a sharded attention, the heads' split):
    per mesh axis, the batch's ``Shard(0)`` where q has it, ``Shard(2)``
    where q's heads are split and both head counts divide, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    Hq, Hkv = q.shape[2], k.shape[2]
    out, split = [], 1
    for i, pl in enumerate(q.placements):
        n = q.device_mesh.size(i)
        if pl == Shard(0):
            out.append(pl)
        elif pl == Shard(2) and Hq % (split * n) == 0 and Hkv % (split * n) == 0:
            out.append(pl)
            split *= n
        else:
            out.append(Replicate())
    return tuple(out), split


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous cotangent: the
    DTensor views of the projections' backward take no other."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _attend_local(cfg: ModelConfig, q, k, v, **kw):
    """:func:`attend` on each rank's shard of DTensor q / k / v."""
    from torch.distributed.tensor import DTensor
    placements, split = _head_placements(q, k)
    mesh = q.device_mesh
    ql, kl, vl = (_ContiguousGrad.apply(t.redistribute(mesh, placements).to_local())
                  for t in (q, k, v))
    if split > 1:
        cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // split,
                                  num_kv_heads=cfg.num_kv_heads // split)
    out = attend(cfg, ql, kl, vl, **kw)
    return DTensor.from_local(out, mesh, placements, run_check=False)


def attend(cfg: ModelConfig, q, k, v, *, causal=True, window: int = 0,
           chunk: int = 512, schedule: str = "rect", groups: int = 8,
           backend: str = "cuda") -> torch.Tensor:
    if is_dtensor(q):
        return _attend_local(cfg, q, k, v, causal=causal, window=window, chunk=chunk,
                             schedule=schedule, groups=groups, backend=backend)
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


def update_start(index: int, size: int, length: int) -> int:
    """Where ``jax.lax.dynamic_update_slice`` writes ``size`` rows at
    ``index`` into ``length``: the start clamped to ``[0, length - size]``."""
    return min(max(int(index), 0), length - size)


def cache_update(k_cache, v_cache, k_new, v_new, index: int):
    """Write (B, S_new, Hkv, D) at position ``index`` of the cache, in place
    (the reference's dynamic_update_slice returns new arrays, and clamps a
    start that would run past the end, as :func:`update_start` does)."""
    S_new = k_new.shape[1]
    index = update_start(index, S_new, k_cache.shape[1])
    k_cache[:, index:index + S_new] = k_new.to(k_cache.dtype)
    v_cache[:, index:index + S_new] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# Two-source decode attention (read-only cache + recent-token write buffer)
#
# The buffered decode keeps the big cache read-only while it decodes,
# writes each token into a small (B, W, Hkv, D) buffer and merges the two
# sources' partial softmaxes; a flush folds the buffer into the cache every
# W tokens. Plain torch ops, as the reference computes them outside any
# kernel.
# ---------------------------------------------------------------------------

def _partial_sdpa(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor):
    """Online-softmax partial over one KV source -> (m, l, acc), float32.

    q: (B, 1, Hkv, G, D) grouped; k/v: (B, S, Hkv, D); bias: (1, S)
    float32."""
    scale = 1.0 / np.sqrt(cfg.head_dim)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = s + bias
    m = torch.amax(s, dim=-1)                                  # (B,H,G,1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    # the probabilities are cast to q's type before p.v
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype), v)
    return m, l, acc.to(torch.float32)


def merge_partials(parts):
    """Merge ``[(m, l, acc), ...]`` online-softmax partials."""
    m = parts[0][0]
    for p in parts[1:]:
        m = torch.maximum(m, p[0])
    l = sum(p[1] * torch.exp(p[0] - m) for p in parts)
    acc = sum(p[2] * torch.exp(p[0] - m)[..., None] for p in parts)
    return acc / torch.clamp(l, min=1e-20)[..., None]


def decode_attend_buffered(cfg: ModelConfig, q, k_cache, v_cache, k_buf, v_buf,
                           base_len: int, buf_len: int) -> torch.Tensor:
    """q: (B, 1, Hq, D); cache (B, S, Hkv, D) read-only, valid below
    ``base_len``; buffer (B, W, Hkv, D), valid below ``buf_len``. Returns
    (B, 1, Hq, D). A source with no valid row weighs exactly zero (its
    scores sit at the finite ``NEG_INF``, far below the other source's)."""
    B, _, Hq, D = q.shape
    qg = _group_q(cfg, q)
    S, W = k_cache.shape[1], k_buf.shape[1]

    def bias(n, valid):
        return torch.where(torch.arange(n, device=q.device)[None, :] < valid,
                           0.0, NEG_INF).to(torch.float32)
    part_c = _partial_sdpa(cfg, qg, k_cache, v_cache, bias(S, base_len))
    part_b = _partial_sdpa(cfg, qg, k_buf, v_buf, bias(W, buf_len))
    out = merge_partials([part_c, part_b])                     # (B,H,G,1,D)
    return out.movedim(3, 1).reshape(B, 1, Hq, D).to(q.dtype)


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
    q = split_heads(x @ p.wq.to(x.dtype), cfg.num_heads, cfg.head_dim)
    k, v = enc_kv
    return out_proj(cfg, p, attend(cfg, q, k, v, causal=False, backend=backend))
