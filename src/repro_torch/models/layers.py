"""Shared layer primitives: norms, embeddings, RoPE / M-RoPE, gated MLPs.

Counterpart of ``repro.models.layers``. Each parameter group is a small
``nn.Module`` whose parameters carry the reference's dict keys (``scale``,
``embedding``, ``gate``, ...), and the ``apply_*`` functions take it where
the reference takes the dict. Params are stored in ``param_dtype``
(float32) and cast to the compute ``dtype`` (bfloat16) at use; norm
statistics run in float32. Weights are drawn from an explicit
``torch.Generator``; ``gen=None`` leaves them uninitialised, to be loaded
(:func:`repro_torch.models.model_zoo.params_from_numpy`) or shapes only
on the ``meta`` device (``train.steps.abstract_train_state``: nothing
drawn, nothing allocated).

The same functions run the model's sharded run, on DTensor parameters
and activations (:func:`repro_torch.parallel.sharding.shard_params`):
the embedding is a lookup (``F.embedding``) that DTensor runs on a
``vocab``-sharded table, rows sharded, and every cast of a float32
weight to the compute type (``.to(dt)``) keeps the weight's placement.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import is_dtensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def param(t: torch.Tensor) -> nn.Parameter:
    """A trainable parameter. Serving stays gradient-free through its
    ``torch.no_grad`` entry points (``transformer.prefill`` /
    ``decode_step``, ``Engine.generate``), not through frozen weights."""
    return nn.Parameter(t)


def truncated_normal(gen: Optional[torch.Generator], shape, scale, dtype,
                     device=None) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2]; uninitialised
    when ``gen`` is None."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)


def normal(gen: Optional[torch.Generator], shape, scale, dtype,
           device=None) -> torch.Tensor:
    """``scale`` times a standard normal; uninitialised when ``gen`` is
    None."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return t.mul_(scale).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device=None,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else (1.0 / np.sqrt(in_dim))
    return truncated_normal(gen, (in_dim, out_dim), scale, dtype, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """``scale`` (and ``bias`` for layernorm)."""

    def __init__(self, cfg: ModelConfig, dim: Optional[int] = None, device=None):
        super().__init__()
        dim = dim or cfg.d_model
        pdt = torch_dtype(cfg.param_dtype)
        self.scale = param(torch.ones((dim,), dtype=pdt, device=device))
        if cfg.norm == "layernorm":
            self.bias = param(torch.zeros((dim,), dtype=pdt, device=device))


def init_norm(cfg: ModelConfig, dim: Optional[int] = None, device=None) -> Norm:
    return Norm(cfg, dim, device)


def apply_norm(cfg: ModelConfig, p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + eps)
        y = y * p.scale.to(torch.float32) + p.bias.to(torch.float32)
    else:  # rmsnorm
        ms = x.square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(ms + eps) * p.scale.to(torch.float32)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """``embedding`` (vocab, d_model), ``unembed`` (d_model, vocab) unless
    the embeddings are tied, and ``pos_embedding`` (max(encoder_seq,
    65536), d_model) for learned positions."""

    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        pdt = torch_dtype(cfg.param_dtype)
        self.embedding = param(truncated_normal(gen, (cfg.vocab_size, cfg.d_model),
                                                0.02, pdt, device))
        if not cfg.tie_embeddings:
            self.unembed = param(truncated_normal(gen, (cfg.d_model, cfg.vocab_size),
                                                  1.0 / np.sqrt(cfg.d_model), pdt, device))
        if cfg.position == "learned":
            # sized for the largest decoder shape of the reference's grid
            max_pos = max(cfg.encoder_seq, 1 << 16)
            self.pos_embedding = param(truncated_normal(gen, (max_pos, cfg.d_model),
                                                        0.02, pdt, device))


def init_embedding(gen, cfg: ModelConfig, device=None) -> Embedding:
    return Embedding(cfg, gen, device)


def embed_tokens(cfg: ModelConfig, p: Embedding, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token rows in the compute type; with learned positions and
    ``positions`` (B, S) given, plus their position rows."""
    dt = torch_dtype(cfg.dtype)
    # rows gathered, then cast: the values of the reference's cast table
    x = _summed(F.embedding(tokens, p.embedding)).to(dt)
    if cfg.embedding_scale:
        # the scale is rounded to the compute type before the multiply
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dt)
    if cfg.position == "learned" and positions is not None:
        x = x + _summed(F.embedding(positions, p.pos_embedding)).to(dt)
    return x


def _summed(rows: torch.Tensor) -> torch.Tensor:
    """A lookup in a row-sharded DTensor table comes back partial (each
    rank holds the rows of its slice of the vocab): its sum, replicated
    where it was partial, so that the cotangent reaches the lookup
    replicated. Plain tensors pass through."""
    if not is_dtensor(rows):
        return rows
    from torch.distributed.tensor import Replicate
    return rows.redistribute(rows.device_mesh, tuple(
        Replicate() if pl.is_partial() else pl for pl in rows.placements))


def unembed(cfg: ModelConfig, p: Embedding, x: torch.Tensor) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings:
        logits = x @ p.embedding.to(dt).t()
    else:
        logits = x @ p.unembed.to(dt)
    if cfg.logit_softcap > 0.0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# ---------------------------------------------------------------------------
# RoPE and M-RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


# The cached constants are made with every dispatch mode off: real tensors
# even when first asked for under a fake-tensor mode (the dry run), so no
# fake tensor outlives its mode, and no op counter charges a step for them.

@functools.lru_cache(maxsize=None)
def _inv_frequencies(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    with _disable_current_modes():
        return torch.tensor(rope_frequencies(head_dim, theta), dtype=torch.float32,
                            device=device)


@functools.lru_cache(maxsize=None)
def _mrope_planes(sections: tuple, device: torch.device) -> torch.Tensor:
    """(half,) int64: the position plane (0 t, 1 h, 2 w) of each frequency
    pair."""
    with _disable_current_modes():
        return torch.repeat_interleave(torch.arange(3, device=device),
                                       torch.tensor(sections, device=device))


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., S, H, D) by per-token ``positions``: (..., S) for
    RoPE, or (3, ..., S) for M-RoPE, whose planes are (t, h, w) and
    ``cfg.mrope_sections`` gives the number of frequency pairs each plane
    drives (qwen2-vl)."""
    half = cfg.head_dim // 2
    inv = _inv_frequencies(cfg.head_dim, cfg.rope_theta, x.device)
    angles = positions.to(torch.float32)[..., None] * inv           # ([3,] ..., S, half)
    if cfg.position == "mrope":
        sec = tuple(cfg.mrope_sections)
        if sum(sec) != half:
            raise ValueError(f"mrope_sections {sec} must sum to head_dim // 2 = {half}")
        plane = _mrope_planes(sec, x.device)
        # pair j takes its angle from plane[j]: (3, half, ..., S) indexed by
        # (plane, j) -> (half, ..., S) -> (..., S, half)
        pairs = torch.arange(half, device=x.device)
        angles = angles.movedim(-1, 1)[plane, pairs].movedim(0, -1)
    sin = torch.sin(angles)[..., None, :]                            # (..., S, 1, half)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``gate``, ``up`` (d_model, d_ff) and ``down`` (d_ff, d_model); no
    ``gate`` for the plain gelu MLP."""

    def __init__(self, cfg: ModelConfig, gen=None, d_ff: Optional[int] = None,
                 device=None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        pdt = torch_dtype(cfg.param_dtype)
        if cfg.activation in ("swiglu", "geglu"):
            self.gate = param(dense_init(gen, cfg.d_model, d_ff, pdt, device))
        self.up = param(dense_init(gen, cfg.d_model, d_ff, pdt, device))
        self.down = param(dense_init(gen, d_ff, cfg.d_model, pdt, device))


def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None, device=None) -> MLP:
    return MLP(cfg, gen, d_ff, device)


def apply_mlp(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.activation in ("swiglu", "geglu"):
        g = x @ p.gate.to(dt)
        u = x @ p.up.to(dt)
        act = F.silu(g) if cfg.activation == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(x @ p.up.to(dt), approximate="tanh")
    return h @ p.down.to(dt)
