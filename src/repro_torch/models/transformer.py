"""Decoder-only transformer assembly, dense FFN.

Counterpart of ``repro.models.transformer`` (its ``transformer.py:30-216``).
One ``nn.Module`` per decoder layer (:class:`DecoderLayer`: ``norm1``,
``attn``, ``norm2``, ``mlp``) and one for the LM (:class:`LM`: ``embed``,
``layers``, ``final_norm``), with the reference's param keys as
parameter names (``layers.3.attn.wq``, ``layers.3.mlp.gate``, ...). The
layers run in a Python loop in place of ``lax.scan``; the KV cache
``{"k", "v"}`` of shape (L, B, S_max, Hkv, D) is written in place.
``backend`` picks the prefill attention (see
:func:`repro_torch.models.attention.attend`). Dense FFN only: an MoE
config raises (ROADMAP A14), so there is no aux loss; ``lm_loss`` waits
for training.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L

Cache = Dict[str, torch.Tensor]


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError("MoE layers are not ported (models/moe.py, "
                                      "ROADMAP A14)")
        self.norm1 = L.init_norm(cfg, device=device)
        self.attn = attn_lib.init_attention(gen, cfg, device)
        self.norm2 = L.init_norm(cfg, device=device)
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


def apply_layer(cfg: ModelConfig, p: DecoderLayer, x, positions, *,
                chunk: int = 512, schedule: str = "rect",
                backend: str = "cuda") -> torch.Tensor:
    h = L.apply_norm(cfg, p.norm1, x)
    h = attn_lib.self_attention(cfg, p.attn, h, positions,
                                window=cfg.sliding_window, chunk=chunk,
                                schedule=schedule, backend=backend)
    x = x + h
    h = L.apply_norm(cfg, p.norm2, x)
    return x + L.apply_mlp(cfg, p.mlp, h)


def apply_layer_decode(cfg: ModelConfig, p: DecoderLayer, x, positions,
                       k_cache, v_cache, index: int):
    """Single-token decode for one layer; returns (x, (k_cache, v_cache)),
    the caches written in place."""
    h = L.apply_norm(cfg, p.norm1, x)
    q, k, v = attn_lib.qkv_proj(cfg, p.attn, h)
    if cfg.position == "rope":
        q = L.apply_rope(cfg, q, positions)
        k = L.apply_rope(cfg, k, positions)
    k_cache, v_cache = attn_lib.cache_update(k_cache, v_cache, k, v, index)
    o = attn_lib.decode_attend(cfg, q, k_cache, v_cache, index + 1,
                               window=cfg.sliding_window)
    x = x + attn_lib.out_proj(cfg, p.attn, o)
    h = L.apply_norm(cfg, p.norm2, x)
    return x + L.apply_mlp(cfg, p.mlp, h), (k_cache, v_cache)


def _positions_for(tokens: torch.Tensor, positions: Optional[torch.Tensor]) -> torch.Tensor:
    if positions is not None:
        return positions
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)


@torch.no_grad()
def forward(cfg: ModelConfig, params: LM, tokens, positions=None, *,
            chunk: int = 512, schedule: str = "rect",
            backend: str = "cuda") -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    positions = _positions_for(tokens, positions)
    x = L.embed_tokens(cfg, params.embed, tokens)
    for layer in params.layers:
        x = apply_layer(cfg, layer, x, positions, chunk=chunk, schedule=schedule,
                        backend=backend)
    x = L.apply_norm(cfg, params.final_norm, x)
    return L.unembed(cfg, params.embed, x)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  num_layers: Optional[int] = None, dtype=None, device=None) -> Cache:
    nl = num_layers or cfg.num_layers
    dt = dtype or L.torch_dtype(cfg.dtype)
    shape = (nl, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: LM, tokens, positions=None, *,
            chunk: int = 512, schedule: str = "rect",
            backend: str = "cuda") -> Tuple[torch.Tensor, Cache]:
    """Forward + emit KV caches -> (logits_last (B, V), cache of S
    positions, each layer's K/V written into it in place)."""
    B, S = tokens.shape
    positions = _positions_for(tokens, positions)
    x = L.embed_tokens(cfg, params.embed, tokens)
    cache = init_kv_cache(cfg, B, S, device=tokens.device)
    for i, layer in enumerate(params.layers):
        h = L.apply_norm(cfg, layer.norm1, x)
        q, k, v = attn_lib.qkv_proj(cfg, layer.attn, h)
        if cfg.position == "rope":
            q = L.apply_rope(cfg, q, positions)
            k = L.apply_rope(cfg, k, positions)
        o = attn_lib.attend(cfg, q, k, v, causal=True, window=cfg.sliding_window,
                            chunk=chunk, schedule=schedule, backend=backend)
        x = x + attn_lib.out_proj(cfg, layer.attn, o)
        h = L.apply_norm(cfg, layer.norm2, x)
        x = x + L.apply_mlp(cfg, layer.mlp, h)
        attn_lib.cache_update(cache["k"][i], cache["v"][i], k, v, 0)
    x = L.apply_norm(cfg, params.final_norm, x[:, -1:, :])
    logits = L.unembed(cfg, params.embed, x)[:, 0, :]
    return logits, cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: LM, cache: Cache, tokens, index: int,
                positions=None) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. tokens: (B, 1); index: tokens already cached.

    Returns (logits (B, V), cache), the cache written in place."""
    B = tokens.shape[0]
    if positions is None:
        positions = torch.full((B, 1), index, dtype=torch.int32, device=tokens.device)
    x = L.embed_tokens(cfg, params.embed, tokens)
    for i, layer in enumerate(params.layers):
        x, _ = apply_layer_decode(cfg, layer, x, positions, cache["k"][i],
                                  cache["v"][i], index)
    x = L.apply_norm(cfg, params.final_norm, x)
    logits = L.unembed(cfg, params.embed, x)[:, 0, :]
    return logits, cache
