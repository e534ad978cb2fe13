"""Decoder-only transformer assembly: the dense, MoE and M-RoPE (VLM)
families.

Counterpart of ``repro.models.transformer`` (its ``transformer.py:30-290``).
One ``nn.Module`` per decoder layer (:class:`DecoderLayer`: ``norm1``,
``attn``, ``norm2``, then ``mlp``, or ``moe`` and with a dense residual
``dense_mlp``) and one for the LM (:class:`LM`: ``embed``, ``layers``,
``final_norm``), with the reference's param keys as parameter names
(``layers.3.attn.wq``, ``layers.3.moe.w_gate``, ...). The layers run in a
Python loop in place of ``lax.scan``; the KV cache ``{"k", "v"}`` of shape
(L, B, S_max, Hkv, D) is written in place. ``backend`` picks the prefill
attention (see :func:`repro_torch.models.attention.attend`). Positions
default to ``arange(S)``, as (3, B, S) planes under M-RoPE; the embedding
takes their first plane.

:func:`forward` returns ``(logits, aux)``, the MoE load-balance loss
summed over the layers (0 for dense layers). It takes no stance on
gradients: under grad mode each layer runs inside
``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint`` on the
scan body) unless a parallel context says ``remat="none"``, so the
backward recomputes one layer's activations at a time.

``ctx`` is the model's :class:`repro_torch.parallel.ParallelContext` (or
None), read where the reference reads it: MoE layers take the
expert-parallel path under a context with ``use_ep``, and the attention's
chunk and schedule come from its ``attn_chunk`` / ``attn_schedule``
(otherwise from ``chunk`` / ``schedule``). Serving's
:func:`prefill` and :func:`decode_step` run under ``torch.no_grad``.
:func:`lm_loss` trains through the ``"torch"`` attention, as the reference
trains through its jnp attention: the hand-written kernel has no backward.

The buffered decode (:func:`init_kv_buffer`, :func:`decode_step_buffered`,
:func:`flush_buffer`) reads the cache and never writes it: each step
writes its token's K/V into a W-slot buffer (in place) and attends over
both sources (:func:`repro_torch.models.attention.decode_attend_buffered`);
a flush writes the buffer into the cache every W steps.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.parallel.sharding import is_dtensor, spmd

Cache = Dict[str, torch.Tensor]


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        self.norm1 = L.init_norm(cfg, device=device)
        self.attn = attn_lib.init_attention(gen, cfg, device)
        self.norm2 = L.init_norm(cfg, device=device)
        if cfg.moe is not None:
            self.moe = init_moe(gen, cfg, device)
            if cfg.moe.dense_residual:
                self.dense_mlp = L.init_mlp(gen, cfg, cfg.moe.dense_d_ff or cfg.d_ff,
                                            device=device)
        else:
            self.mlp = L.init_mlp(gen, cfg, device=device)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        self.embed = L.init_embedding(gen, cfg, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, gen, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.init_norm(cfg, device=device)


def init_lm(gen, cfg: ModelConfig, device=None) -> LM:
    """The LM with weights from ``gen`` (uninitialised when ``gen`` is
    None)."""
    return LM(cfg, gen, device)


def attn_options(ctx, chunk: int, schedule: str) -> Tuple[int, str]:
    """The attention's (chunk, schedule): the context's when there is
    one, else the arguments."""
    if ctx is not None:
        return ctx.attn_chunk, ctx.attn_schedule
    return chunk, schedule


def checkpointed(ctx) -> bool:
    """Per-layer recompute in the backward: without a context, or under
    ``remat="layer"`` (the reference's ``ctx is None or ctx.remat ==
    "layer"``)."""
    return ctx is None or ctx.remat == "layer"


def _ffn(cfg: ModelConfig, p: DecoderLayer, x: torch.Tensor, ctx=None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feed-forward (dense MLP, or MoE plus the optional dense residual)
    -> (y, aux)."""
    if cfg.moe is not None:
        y, aux = moe_apply(cfg, p.moe, x, parallel=ctx)
        if cfg.moe.dense_residual:
            y = y + L.apply_mlp(cfg, p.dense_mlp, x)
        return y, aux
    return L.apply_mlp(cfg, p.mlp, x), torch.zeros((), dtype=torch.float32,
                                                   device=x.device)


def apply_layer(cfg: ModelConfig, p: DecoderLayer, x, positions, *,
                chunk: int = 512, schedule: str = "rect",
                backend: str = "cuda", ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    chunk, schedule = attn_options(ctx, chunk, schedule)
    h = L.apply_norm(cfg, p.norm1, x)
    h = attn_lib.self_attention(cfg, p.attn, h, positions,
                                window=cfg.sliding_window, chunk=chunk,
                                schedule=schedule, backend=backend)
    if ctx:
        h = ctx.constrain(h, ("batch", "seq", "embed"))
    x = x + h
    h = L.apply_norm(cfg, p.norm2, x)
    h, aux = _ffn(cfg, p, h, ctx)
    if ctx:
        h = ctx.constrain(h, ("batch", "seq", "embed"))
    return x + h, aux


def apply_layer_decode(cfg: ModelConfig, p: DecoderLayer, x, positions,
                       k_cache, v_cache, index: int, ctx=None):
    """Single-token decode for one layer; returns (x, (k_cache, v_cache)),
    the caches written in place."""
    h = L.apply_norm(cfg, p.norm1, x)
    q, k, v = attn_lib.qkv_proj(cfg, p.attn, h)
    if cfg.position in attn_lib.ROTARY:
        q = L.apply_rope(cfg, q, positions)
        k = L.apply_rope(cfg, k, positions)
    k_cache, v_cache = attn_lib.cache_update(k_cache, v_cache, k, v, index)
    o = attn_lib.decode_attend(cfg, q, k_cache, v_cache, index + 1,
                               window=cfg.sliding_window)
    x = x + attn_lib.out_proj(cfg, p.attn, o)
    h = L.apply_norm(cfg, p.norm2, x)
    h, _ = _ffn(cfg, p, h, ctx)
    return x + h, (k_cache, v_cache)


def _positions_for(cfg: ModelConfig, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor]) -> torch.Tensor:
    if positions is not None:
        return positions
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    if cfg.position == "mrope":
        pos = pos.expand(3, B, S)
    return pos


def _embed(cfg: ModelConfig, params: LM, tokens, positions) -> torch.Tensor:
    """Token embeddings, plus learned position rows (M-RoPE's first
    plane)."""
    lpos = positions[0] if cfg.position == "mrope" else positions
    return L.embed_tokens(cfg, params.embed, tokens,
                          lpos if cfg.position == "learned" else None)


@spmd
def forward(cfg: ModelConfig, params: LM, tokens, positions=None, *,
            chunk: int = 512, schedule: str = "rect",
            backend: str = "cuda", ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, V), aux_loss). Under grad
    mode each layer is checkpointed (recomputed in the backward) unless
    ``ctx.remat`` is ``"none"``."""
    positions = _positions_for(cfg, tokens, positions)
    x = _embed(cfg, params, tokens, positions)
    if ctx:
        x = ctx.constrain(x, ("batch", "seq", "embed"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    run = (functools.partial(checkpoint, apply_layer, use_reentrant=False,
                             preserve_rng_state=False)
           if torch.is_grad_enabled() and checkpointed(ctx) else apply_layer)
    for layer in params.layers:
        x, a = run(cfg, layer, x, positions, chunk=chunk, schedule=schedule,
                   backend=backend, ctx=ctx)
        aux = aux + a
    x = L.apply_norm(cfg, params.final_norm, x)
    logits = L.unembed(cfg, params.embed, x)
    if ctx:
        logits = ctx.constrain(logits, ("batch", "seq", "vocab"))
    return logits, aux


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  num_layers: Optional[int] = None, dtype=None, device=None) -> Cache:
    nl = num_layers or cfg.num_layers
    dt = dtype or L.torch_dtype(cfg.dtype)
    shape = (nl, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


@torch.no_grad()
@spmd
def prefill(cfg: ModelConfig, params: LM, tokens, positions=None, *,
            chunk: int = 512, schedule: str = "rect",
            backend: str = "cuda", ctx=None) -> Tuple[torch.Tensor, Cache]:
    """Forward + emit KV caches -> (logits_last (B, V), cache of S
    positions, each layer's K/V written into it in place). On a sharded
    model (DTensors) the cache is the layers' K/V stacked, as the
    reference's scan emits it."""
    chunk, schedule = attn_options(ctx, chunk, schedule)
    B, S = tokens.shape
    positions = _positions_for(cfg, tokens, positions)
    x = _embed(cfg, params, tokens, positions)
    if ctx:
        x = ctx.constrain(x, ("batch", "seq", "embed"))
    sharded = is_dtensor(x)
    cache = None if sharded else init_kv_cache(cfg, B, S, device=tokens.device)
    ks, vs = [], []
    for i, layer in enumerate(params.layers):
        h = L.apply_norm(cfg, layer.norm1, x)
        q, k, v = attn_lib.qkv_proj(cfg, layer.attn, h)
        if cfg.position in attn_lib.ROTARY:
            q = L.apply_rope(cfg, q, positions)
            k = L.apply_rope(cfg, k, positions)
        o = attn_lib.attend(cfg, q, k, v, causal=True, window=cfg.sliding_window,
                            chunk=chunk, schedule=schedule, backend=backend)
        x = x + attn_lib.out_proj(cfg, layer.attn, o)
        h = L.apply_norm(cfg, layer.norm2, x)
        h, _ = _ffn(cfg, layer, h, ctx)
        x = x + h
        if ctx:
            x = ctx.constrain(x, ("batch", "seq", "embed"))
            k = ctx.constrain(k, ("batch", "kv_seq", "kv_heads", "head_dim"))
            v = ctx.constrain(v, ("batch", "kv_seq", "kv_heads", "head_dim"))
        if sharded:
            ks.append(k.to(L.torch_dtype(cfg.dtype)))
            vs.append(v.to(L.torch_dtype(cfg.dtype)))
        else:
            attn_lib.cache_update(cache["k"][i], cache["v"][i], k, v, 0)
    if sharded:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    x = L.apply_norm(cfg, params.final_norm, x[:, -1:, :])
    logits = L.unembed(cfg, params.embed, x)[:, 0, :]
    return logits, cache


@torch.no_grad()
@spmd
def decode_step(cfg: ModelConfig, params: LM, cache: Cache, tokens, index: int,
                positions=None, ctx=None) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. tokens: (B, 1); index: tokens already cached.

    Returns (logits (B, V), cache), the cache written in place."""
    B = tokens.shape[0]
    if positions is None:
        positions = torch.full((B, 1), index, dtype=torch.int32, device=tokens.device)
        if cfg.position == "mrope":
            positions = positions.expand(3, B, 1)
    x = _embed(cfg, params, tokens, positions)
    for i, layer in enumerate(params.layers):
        x, _ = apply_layer_decode(cfg, layer, x, positions, cache["k"][i],
                                  cache["v"][i], index, ctx)
    x = L.apply_norm(cfg, params.final_norm, x)
    logits = L.unembed(cfg, params.embed, x)[:, 0, :]
    return logits, cache


@spmd
def lm_loss(cfg: ModelConfig, params: LM, batch: Dict[str, torch.Tensor], *,
            chunk: int = 512, ctx=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over ``batch["mask"]`` (default: every
    position) plus the MoE aux loss -> (loss, {"xent", "aux"}).

    Attention runs through the ``"torch"`` backend, as the reference
    trains through its jnp attention: the hand-written kernel has no
    backward (its wrapper refuses inputs that require grad)."""
    logits, aux = forward(cfg, params, batch["tokens"], batch.get("positions"),
                          chunk=chunk, backend="torch", ctx=ctx)
    labels = batch["labels"].to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(ll)
    mask = mask.to(torch.float32)
    xent = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    loss = xent + aux
    return loss, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# Buffered decode: a read-only cache and a write buffer
# ---------------------------------------------------------------------------

def init_kv_buffer(cfg: ModelConfig, batch: int, window: int, dtype=None,
                   device=None) -> Cache:
    """The write buffer ``{"k", "v"}``: (L, B, W, Hkv, D) zeros."""
    dt = dtype or L.torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, window, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


@torch.no_grad()
def decode_step_buffered(cfg: ModelConfig, params: LM, cache: Cache, buffer: Cache,
                         tokens, base_len: int, buf_len: int,
                         ctx=None) -> Tuple[torch.Tensor, Cache]:
    """One-token decode against a read-only cache plus a small write buffer.

    cache k/v: (L, B, S, Hkv, D) holds the first ``base_len`` tokens and
    is not written; buffer k/v: (L, B, W, Hkv, D) holds ``buf_len`` recent
    tokens and takes this token's K/V at ``buf_len`` (in place, the start
    clamped as ``dynamic_update_slice`` clamps it). The position is
    ``base_len + buf_len`` (on every plane under M-RoPE); the embedding
    adds no learned position, as in the reference. Returns (logits (B, V),
    buffer)."""
    B = tokens.shape[0]
    index = int(base_len) + int(buf_len)
    positions = torch.full((B, 1), index, dtype=torch.int32, device=tokens.device)
    if cfg.position == "mrope":
        positions = positions.expand(3, B, 1)
    x = L.embed_tokens(cfg, params.embed, tokens)
    for i, layer in enumerate(params.layers):
        h = L.apply_norm(cfg, layer.norm1, x)
        q, k, v = attn_lib.qkv_proj(cfg, layer.attn, h)
        if cfg.position in attn_lib.ROTARY:
            q = L.apply_rope(cfg, q, positions)
            k = L.apply_rope(cfg, k, positions)
        kb, vb = attn_lib.cache_update(buffer["k"][i], buffer["v"][i], k, v, buf_len)
        o = attn_lib.decode_attend_buffered(cfg, q, cache["k"][i], cache["v"][i], kb, vb,
                                            base_len, buf_len + 1)
        x = x + attn_lib.out_proj(cfg, layer.attn, o)
        h = L.apply_norm(cfg, layer.norm2, x)
        h, _ = _ffn(cfg, layer, h, ctx)
        x = x + h
    x = L.apply_norm(cfg, params.final_norm, x)
    logits = L.unembed(cfg, params.embed, x)[:, 0, :]
    return logits, buffer


@torch.no_grad()
def flush_buffer(cfg: ModelConfig, cache: Cache, buffer: Cache, base_len: int) -> Cache:
    """Write the whole buffer into the cache at ``base_len``, in place (a
    start past ``S - W`` is clamped, as ``dynamic_update_slice`` clamps
    it); the W decode steps between flushes write only the buffer."""
    for key in ("k", "v"):
        c, b = cache[key], buffer[key]
        start = attn_lib.update_start(base_len, b.shape[2], c.shape[2])
        c[:, :, start:start + b.shape[2]] = b.to(c.dtype)
    return cache
