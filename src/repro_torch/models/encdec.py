"""whisper-style encoder-decoder backbone.

Counterpart of ``repro.models.encdec``. The conv / mel frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings
``frames`` (B, encoder_seq, d_model). Encoder: bidirectional
self-attention layers; decoder: causal self-attention, then
cross-attention to the encoder's output.

Modules, with the reference's keys: :class:`EncDec` holds ``embed``
(learned positions, tied), ``enc_pos`` (encoder_seq, d_model),
``encoder`` (``encoder.N.norm1`` / ``attn`` / ``norm2`` / ``mlp``),
``enc_norm``, ``decoder`` (``decoder.N.norm1`` / ``attn`` / ``norm_x`` /
``xattn`` / ``norm2`` / ``mlp``) and ``final_norm``. The cache is
``{"k", "v": (L, B, S_max, Hkv, D) self-attention, "xk", "xv": (L, B,
encoder_seq, Hkv, D) cross}``; decode writes ``k`` / ``v`` in place.
Attention routing (:func:`repro_torch.models.attention.attend`): under
``backend="cuda"`` the encoder's bidirectional attention, the decoder's
causal self-attention and its cross-attention in the prefill reach the
hand-written kernel; decode attends over its caches in plain torch, as
every family's decode does.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.transformer import attn_options, checkpointed
from repro_torch.parallel.sharding import spmd

Cache = Dict[str, torch.Tensor]


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        self.norm1 = L.init_norm(cfg, device=device)
        self.attn = attn_lib.init_attention(gen, cfg, device)
        self.norm2 = L.init_norm(cfg, device=device)
        self.mlp = L.init_mlp(gen, cfg, device=device)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        self.norm1 = L.init_norm(cfg, device=device)
        self.attn = attn_lib.init_attention(gen, cfg, device)
        self.norm_x = L.init_norm(cfg, device=device)
        self.xattn = attn_lib.init_attention(gen, cfg, device)
        self.norm2 = L.init_norm(cfg, device=device)
        self.mlp = L.init_mlp(gen, cfg, device=device)


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        pdt = L.torch_dtype(cfg.param_dtype)
        self.embed = L.init_embedding(gen, cfg, device)
        self.enc_pos = L.param(L.normal(gen, (cfg.encoder_seq, cfg.d_model), 0.02, pdt,
                                        device))
        self.encoder = nn.ModuleList(EncoderLayer(cfg, gen, device)
                                     for _ in range(cfg.encoder_layers))
        self.enc_norm = L.init_norm(cfg, device=device)
        self.decoder = nn.ModuleList(DecoderLayer(cfg, gen, device)
                                     for _ in range(cfg.num_layers))
        self.final_norm = L.init_norm(cfg, device=device)


def init_encdec(gen, cfg: ModelConfig, device=None) -> EncDec:
    return EncDec(cfg, gen, device)


def _layer_runner(fn, ctx):
    """``fn`` under ``torch.utils.checkpoint`` when grad mode is on and
    the reference would remat the layer (``ctx is None or ctx.remat ==
    "layer"``), else ``fn``."""
    if torch.is_grad_enabled() and checkpointed(ctx):
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    return fn


def _enc_layer(cfg: ModelConfig, lp: EncoderLayer, x, backend: str):
    h = L.apply_norm(cfg, lp.norm1, x)
    q, k, v = attn_lib.qkv_proj(cfg, lp.attn, h)
    o = attn_lib.attend(cfg, q, k, v, causal=False, backend=backend)
    x = x + attn_lib.out_proj(cfg, lp.attn, o)
    h = L.apply_norm(cfg, lp.norm2, x)
    return x + L.apply_mlp(cfg, lp.mlp, h)


@spmd
def encode(cfg: ModelConfig, params: EncDec, frames: torch.Tensor, *,
           backend: str = "cuda", ctx=None) -> torch.Tensor:
    """frames: (B, encoder_seq, d_model) precomputed embeddings -> the
    encoder's normed output in the compute type. Under grad mode each
    layer is checkpointed unless ``ctx.remat`` is ``"none"``."""
    dt = L.torch_dtype(cfg.dtype)
    x = frames.to(dt) + params.enc_pos.to(dt)
    if ctx:
        x = ctx.constrain(x, ("batch", "seq", "embed"))
    run = _layer_runner(_enc_layer, ctx)
    for lp in params.encoder:
        x = run(cfg, lp, x, backend)
    return L.apply_norm(cfg, params.enc_norm, x)


def _cross_and_mlp(cfg: ModelConfig, lp: DecoderLayer, x, enc_kv, backend: str):
    h = L.apply_norm(cfg, lp.norm_x, x)
    x = x + attn_lib.cross_attention(cfg, lp.xattn, h, enc_kv, backend=backend)
    h = L.apply_norm(cfg, lp.norm2, x)
    return x + L.apply_mlp(cfg, lp.mlp, h)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)


def _dec_layer(cfg: ModelConfig, lp: DecoderLayer, x, enc_out, positions, chunk: int,
               schedule: str, backend: str, ctx=None):
    h = L.apply_norm(cfg, lp.norm1, x)
    x = x + attn_lib.self_attention(cfg, lp.attn, h, positions, chunk=chunk,
                                    schedule=schedule, backend=backend)
    x = _cross_and_mlp(cfg, lp, x, attn_lib.kv_proj(cfg, lp.xattn, enc_out), backend)
    if ctx:
        x = ctx.constrain(x, ("batch", "seq", "embed"))
    return x


@spmd
def forward(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor,
            frames: torch.Tensor, *, chunk: int = 512, backend: str = "cuda", ctx=None):
    """Teacher-forced decoder forward -> (logits (B, S, V), aux = 0).
    Under grad mode each layer is checkpointed unless ``ctx.remat`` is
    ``"none"``; a context also sets the attention's chunk and schedule."""
    chunk, schedule = attn_options(ctx, chunk, "rect")
    enc_out = encode(cfg, params, frames, backend=backend, ctx=ctx)
    positions = _positions(tokens)
    x = L.embed_tokens(cfg, params.embed, tokens, positions)
    run = _layer_runner(_dec_layer, ctx)
    for lp in params.decoder:
        x = run(cfg, lp, x, enc_out, positions, chunk, schedule, backend, ctx)
    x = L.apply_norm(cfg, params.final_norm, x)
    return L.unembed(cfg, params.embed, x), torch.zeros((), dtype=torch.float32,
                                                        device=x.device)


@torch.no_grad()
@spmd
def prefill(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor,
            frames: torch.Tensor, *, chunk: int = 512, backend: str = "cuda", ctx=None):
    """(last logits (B, V), cache with the self K/V of S positions and the
    cross K/V of the encoder's output)."""
    chunk, schedule = attn_options(ctx, chunk, "rect")
    enc_out = encode(cfg, params, frames, backend=backend, ctx=ctx)
    positions = _positions(tokens)
    x = L.embed_tokens(cfg, params.embed, tokens, positions)
    dt = L.torch_dtype(cfg.dtype)
    ks, vs, xks, xvs = [], [], [], []
    for lp in params.decoder:
        h = L.apply_norm(cfg, lp.norm1, x)
        q, k, v = attn_lib.qkv_proj(cfg, lp.attn, h)
        o = attn_lib.attend(cfg, q, k, v, causal=True, chunk=chunk, schedule=schedule,
                            backend=backend)
        x = x + attn_lib.out_proj(cfg, lp.attn, o)
        ek, ev = attn_lib.kv_proj(cfg, lp.xattn, enc_out)
        x = _cross_and_mlp(cfg, lp, x, (ek, ev), backend)
        ks.append(k.to(dt))
        vs.append(v.to(dt))
        xks.append(ek.to(dt))
        xvs.append(ev.to(dt))
    x = L.apply_norm(cfg, params.final_norm, x[:, -1:, :])
    logits = L.unembed(cfg, params.embed, x)[:, 0, :]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "xk": torch.stack(xks), "xv": torch.stack(xvs)}


@torch.no_grad()
@spmd
def decode_step(cfg: ModelConfig, params: EncDec, cache: Cache, tokens: torch.Tensor,
                index: int):
    """One-token decode -> (logits (B, V), cache with k / v written in
    place)."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), index, dtype=torch.int32, device=tokens.device)
    x = L.embed_tokens(cfg, params.embed, tokens, positions)
    for i, lp in enumerate(params.decoder):
        h = L.apply_norm(cfg, lp.norm1, x)
        q, k, v = attn_lib.qkv_proj(cfg, lp.attn, h)
        kc, vc = attn_lib.cache_update(cache["k"][i], cache["v"][i], k, v, index)
        o = attn_lib.decode_attend(cfg, q, kc, vc, index + 1)
        x = x + attn_lib.out_proj(cfg, lp.attn, o)
        x = _cross_and_mlp(cfg, lp, x, (cache["xk"][i], cache["xv"][i]), "torch")
    x = L.apply_norm(cfg, params.final_norm, x)
    return L.unembed(cfg, params.embed, x)[:, 0, :], cache
