"""zamba2 hybrid assembly: a Mamba2 backbone and ONE shared attention block.

Counterpart of ``repro.models.zamba``. ``num_layers`` Mamba2 blocks run
in ``num_layers // attn_every`` groups; after each group the *shared*
attention transformer block (one weight set, reused) runs, so only
``n_groups`` KV caches exist.

Modules, with the reference's keys: :class:`Zamba` holds ``embed``,
``mamba_layers`` (``mamba_layers.N.norm`` / ``.mixer``), ``shared_attn``
(``norm1``, ``attn``, ``norm2``, ``mlp``) and ``final_norm``. The cache
is ``{"mamba": {"ssm": (L, B, H, P, N) float32, "conv": (L, B, d_conv - 1,
conv_dim)}, "attn_k" / "attn_v": (G, B, S_max, Hkv, D)}``, written in
place by :func:`zamba_decode_step`. The prefill's shared attention goes
through :func:`repro_torch.models.attention.attend` (the hand-written
kernel under ``backend="cuda"``); the loss runs the ``"torch"``
attention (:func:`repro_torch.models.model_zoo.Model.loss`).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import apply_mamba2, init_mamba2, init_mamba_state
from repro_torch.models.transformer import attn_options
from repro_torch.parallel.sharding import spmd

Cache = Dict[str, object]


def n_groups(cfg: ModelConfig) -> int:
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.num_layers} layers are not groups of {cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        self.norm = L.init_norm(cfg, device=device)
        self.mixer = init_mamba2(gen, cfg, device)


class SharedAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        self.norm1 = L.init_norm(cfg, device=device)
        self.attn = attn_lib.init_attention(gen, cfg, device)
        self.norm2 = L.init_norm(cfg, device=device)
        self.mlp = L.init_mlp(gen, cfg, device=device)


class Zamba(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        n_groups(cfg)
        self.embed = L.init_embedding(gen, cfg, device)
        self.mamba_layers = nn.ModuleList(MambaLayer(cfg, gen, device)
                                          for _ in range(cfg.num_layers))
        self.shared_attn = SharedAttention(cfg, gen, device)
        self.final_norm = L.init_norm(cfg, device=device)


def init_zamba(gen, cfg: ModelConfig, device=None) -> Zamba:
    return Zamba(cfg, gen, device)


def _mamba_layer(cfg: ModelConfig, lp: MambaLayer, x, state, single_step: bool,
                 ctx=None):
    h = L.apply_norm(cfg, lp.norm, x)
    h, state = apply_mamba2(cfg, lp.mixer, h, state, single_step=single_step)
    if ctx:
        h = ctx.constrain(h, ("batch", "seq", "embed"))
    return x + h, state


def _shared_mlp(cfg: ModelConfig, sa: SharedAttention, x):
    h = L.apply_norm(cfg, sa.norm2, x)
    return x + L.apply_mlp(cfg, sa.mlp, h)


@spmd
def zamba_forward(cfg: ModelConfig, params: Zamba, tokens: torch.Tensor,
                  state: Optional[Cache] = None, *, emit_cache: bool = False,
                  chunk: int = 512, backend: str = "cuda", ctx=None):
    """Full-sequence forward from ``state`` (zeros when None) ->
    (logits (B, S, V), aux = 0, cache or None). With ``emit_cache`` the
    cache holds each layer's final SSM and conv state and each group's
    K/V (in the compute type). Under a parallel context the attention's
    chunk and schedule are its ``attn_chunk`` / ``attn_schedule``, and
    with ``remat="layer"`` each Mamba2 layer is checkpointed under grad
    mode (none is without a context, as in the reference)."""
    chunk, schedule = attn_options(ctx, chunk, "rect")
    layer = (functools.partial(checkpoint, _mamba_layer, use_reentrant=False,
                               preserve_rng_state=False)
             if ctx is not None and ctx.remat == "layer" and torch.is_grad_enabled()
             else _mamba_layer)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = L.embed_tokens(cfg, params.embed, tokens)
    if ctx:
        x = ctx.constrain(x, ("batch", "seq", "embed"))
    G, per = n_groups(cfg), cfg.attn_every
    sa = params.shared_attn
    dt = L.torch_dtype(cfg.dtype)
    states, ks, vs = [], [], []
    for g in range(G):
        for j in range(per):
            i = g * per + j
            st = None if state is None else {k: t[i] for k, t in state["mamba"].items()}
            x, st = layer(cfg, params.mamba_layers[i], x, st, False, ctx)
            states.append(st)
        h = L.apply_norm(cfg, sa.norm1, x)
        q, k, v = attn_lib.qkv_proj(cfg, sa.attn, h)
        q = L.apply_rope(cfg, q, positions)
        k = L.apply_rope(cfg, k, positions)
        o = attn_lib.attend(cfg, q, k, v, causal=True, chunk=chunk, schedule=schedule,
                            backend=backend)
        x = _shared_mlp(cfg, sa, x + attn_lib.out_proj(cfg, sa.attn, o))
        if ctx:
            x = ctx.constrain(x, ("batch", "seq", "embed"))
        if emit_cache:
            ks.append(k.to(dt))
            vs.append(v.to(dt))
    x = L.apply_norm(cfg, params.final_norm, x)
    logits = L.unembed(cfg, params.embed, x)
    if ctx:
        logits = ctx.constrain(logits, ("batch", "seq", "vocab"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    if emit_cache:
        cache = {"mamba": {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")},
                 "attn_k": torch.stack(ks), "attn_v": torch.stack(vs)}
    return logits, aux, cache


@torch.no_grad()
@spmd
def zamba_prefill(cfg: ModelConfig, params: Zamba, tokens: torch.Tensor, *,
                  backend: str = "cuda", ctx=None):
    """(last logits (B, V), cache of S positions)."""
    logits, _, cache = zamba_forward(cfg, params, tokens, emit_cache=True,
                                     backend=backend, ctx=ctx)
    return logits[:, -1, :], cache


@torch.no_grad()
@spmd
def zamba_decode_step(cfg: ModelConfig, params: Zamba, cache: Cache,
                      tokens: torch.Tensor, index: int):
    """One-token decode: each layer's Mamba2 single step and each group's
    shared attention over its KV cache -> (logits (B, V), cache written
    in place)."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), index, dtype=torch.int32, device=tokens.device)
    x = L.embed_tokens(cfg, params.embed, tokens)
    G, per = n_groups(cfg), cfg.attn_every
    sa = params.shared_attn
    mamba = cache["mamba"]
    for g in range(G):
        for j in range(per):
            i = g * per + j
            x, st = _mamba_layer(cfg, params.mamba_layers[i], x,
                                 {k: t[i] for k, t in mamba.items()}, single_step=True)
            for k, t in mamba.items():
                t[i].copy_(st[k])
        h = L.apply_norm(cfg, sa.norm1, x)
        q, k, v = attn_lib.qkv_proj(cfg, sa.attn, h)
        q = L.apply_rope(cfg, q, positions)
        k = L.apply_rope(cfg, k, positions)
        kc, vc = attn_lib.cache_update(cache["attn_k"][g], cache["attn_v"][g], k, v, index)
        o = attn_lib.decode_attend(cfg, q, kc, vc, index + 1)
        x = x + attn_lib.out_proj(cfg, sa.attn, o)
        x = _shared_mlp(cfg, sa, x)
    x = L.apply_norm(cfg, params.final_norm, x)
    return L.unembed(cfg, params.embed, x)[:, 0, :], cache


def init_zamba_state(cfg: ModelConfig, batch: int, device=None) -> Cache:
    one = init_mamba_state(cfg, batch, device)
    return {"mamba": {k: t[None].repeat((cfg.num_layers,) + (1,) * t.dim())
                      for k, t in one.items()}}


def init_zamba_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Cache:
    st = init_zamba_state(cfg, batch, device)
    shape = (n_groups(cfg), batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dt = L.torch_dtype(cfg.dtype)
    st["attn_k"] = torch.zeros(shape, dtype=dt, device=device)
    st["attn_v"] = torch.zeros(shape, dtype=dt, device=device)
    return st
