"""Mamba2 (SSD) mixer: the chunked parallel form and the O(1) decode step.

Counterpart of ``repro.models.mamba2``. Within a chunk the state-space
duality's quadratic attention-like term, across chunks a linear
recurrence (a Python loop over the chunks in place of ``lax.scan``),
behind a causal depthwise conv; zamba2's backbone.

Shapes (one layer):

    x_in        : (B, S, d_model)
    d_inner     : expand * d_model
    heads H     : d_inner // head_dim (P)
    B_, C_      : (B, S, G, N)  state projections (G groups, N = d_state)
    ssm state   : (B, H, P, N)  float32
    conv state  : (B, d_conv - 1, conv_dim)

The reference's four-operand einsums are written as pairwise products
whose intermediates are known: the C.B scores at group level (one
(Q, Q) block a (batch, chunk, group), repeated over the group's heads),
then the decay mask, then the (Q, Q) x (Q, P) product. ``jax.nn.softplus``
is ``logaddexp(x, 0)``, which ``F.softplus`` is not above its threshold.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, normal, param, torch_dtype

State = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, H, conv_dim


class Mamba2(nn.Module):
    """``in_proj`` (d_model, 2 d_inner + 2 G N + H), ``conv_w`` (d_conv,
    conv_dim), ``A_log`` / ``D`` / ``dt_bias`` (H,), ``norm_scale``
    (d_inner,) and ``out_proj`` (d_inner, d_model)."""

    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        s, d_in, H, conv_dim = _dims(cfg)
        pdt = torch_dtype(cfg.param_dtype)
        proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + H
        # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba2's
        # default), from numpy's seed 0 as in the reference
        dt = np.exp(np.random.default_rng(0).uniform(np.log(1e-3), np.log(1e-1), H))
        dt_bias = dt + np.log(-np.expm1(-dt))
        self.in_proj = param(dense_init(gen, cfg.d_model, proj_out, pdt, device))
        self.conv_w = param(normal(gen, (s.d_conv, conv_dim), 1.0 / np.sqrt(s.d_conv),
                                   pdt, device))
        self.A_log = param(torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                                  device=device)).to(pdt))
        self.D = param(torch.ones((H,), dtype=pdt, device=device))
        self.dt_bias = param(torch.tensor(dt_bias, dtype=pdt, device=device))
        self.norm_scale = param(torch.ones((d_in,), dtype=pdt, device=device))
        self.out_proj = param(dense_init(gen, d_in, cfg.d_model, pdt, device,
                                         scale=1.0 / np.sqrt(d_in * 2 * cfg.num_layers)))


def init_mamba2(gen, cfg: ModelConfig, device=None) -> Mamba2:
    return Mamba2(cfg, gen, device)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, d_in, H, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * gn, H], dim=-1)
    return z, xbc, dt  # gate, conv channels, per-head dt


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    s, d_in, H, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    x, B_, C_ = torch.split(xbc, [d_in, gn, gn], dim=-1)
    B, S = x.shape[:2]
    return (x.reshape(B, S, H, s.head_dim),
            B_.reshape(B, S, s.n_groups, s.d_state),
            C_.reshape(B, S, s.n_groups, s.d_state))


def _gated_norm(p: Mamba2, y: torch.Tensor, z: torch.Tensor, eps=1e-6) -> torch.Tensor:
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    yf = y.to(torch.float32)
    ms = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * p.norm_scale.to(torch.float32)).to(y.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decays -> (..., Q, Q) lower-triangular cumulative
    sums, -inf above the diagonal."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]          # sum_{j<i<=k} a
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, float("-inf"))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd(cfg: ModelConfig, x, dt, A, B_, C_, init_state=None):
    """Chunked SSD core. x: (B, S, H, P); dt: (B, S, H) float32 (after
    softplus); A: (H,) negative; B_/C_: (B, S, G, N). Returns (y of x's
    type, final state (B, H, P, N) float32)."""
    s = cfg.ssm
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(s.chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {Q}")
    nc, rep = S // Q, H // G
    f32 = torch.float32

    dtf = dt.to(f32)
    a = dtf * A                                            # (B,S,H) log decay <= 0
    xb = x.to(f32) * dtf[..., None]                        # dt-weighted input

    def ch(t):  # (B,S,...) -> (B,nc,Q,...)
        return t.reshape((Bb, nc, Q) + tuple(t.shape[2:]))

    xb_c = ch(xb)                                          # (B,nc,Q,H,P)
    B_c, C_c = ch(B_.to(f32)), ch(C_.to(f32))              # (B,nc,Q,G,N)
    a_hc = ch(a).movedim(-1, 2)                            # (B,nc,H,Q)
    L = torch.exp(_segsum(a_hc))                           # (B,nc,H,Q,Q)
    L = torch.where(torch.isfinite(L), L, 0.0)

    # intra-chunk: (C.B scores of the group) * decay mask, then . x
    CB = torch.einsum("bcqgn,bckgn->bcgqk", C_c, B_c)      # (B,nc,G,Q,Q)
    M = CB.repeat_interleave(rep, dim=2) * L               # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M, xb_c)
    del CB, M

    # per-chunk final states
    cum = torch.cumsum(a_hc, dim=-1)                       # (B,nc,H,Q)
    decay_to_end = torch.exp(cum[..., -1:] - cum)          # (B,nc,H,Q)
    xw = (xb_c * decay_to_end.movedim(2, 3)[..., None]).reshape(Bb, nc, Q, G, rep, P)
    S_chunk = torch.einsum("bckgn,bckgrp->bcgrpn", B_c, xw).reshape(Bb, nc, H, P, N)
    del xw

    # cross-chunk recurrence
    chunk_decay = torch.exp(cum[..., -1])                  # (B,nc,H)
    h = torch.zeros((Bb, H, P, N), dtype=f32, device=x.device) if init_state is None \
        else init_state.to(f32)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_chunk[:, c]
    h_prev = torch.stack(h_prevs, dim=1).reshape(Bb, nc, G, rep, P, N)

    # inter-chunk contribution: (C . state before the chunk) * decay from its start
    in_decay = torch.exp(cum)                              # (B,nc,H,Q)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", C_c, h_prev).reshape(Bb, nc, Q, H, P)
    y_off = y_off * in_decay.movedim(2, 3)[..., None]

    y = (y_diag + y_off).reshape(Bb, S, H, P)
    return y.to(x.dtype), h


def _causal_conv(w: torch.Tensor, xbc: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width K. xbc: (B, S, C), w: (K, C).
    Returns (silu(out) (B, S, C), new conv state (B, K - 1, C))."""
    K = w.shape[0]
    B, S, C = xbc.shape
    if conv_state is None:
        conv_state = xbc.new_zeros((B, K - 1, C))
    padded = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    out = padded[:, 0:S] * w[0].to(xbc.dtype)
    for i in range(1, K):
        out = out + padded[:, i:i + S] * w[i].to(xbc.dtype)
    return F.silu(out), padded[:, S:]


def apply_mamba2(cfg: ModelConfig, p: Mamba2, x_in: torch.Tensor,
                 state: Optional[State] = None, *, single_step: bool = False):
    """The mixer. x_in: (B, S, d_model); ``state`` = {"ssm", "conv"} to
    continue from (required with ``single_step``, the decode form).

    Returns (y (B, S, d_model), new state)."""
    s, d_in, H, conv_dim = _dims(cfg)
    f32 = torch.float32
    zxbcdt = x_in @ p.in_proj.to(x_in.dtype)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xbc, new_conv = _causal_conv(p.conv_w, xbc, None if state is None else state["conv"])
    x, B_, C_ = _split_xbc(cfg, xbc)
    dt = _softplus(dt_raw.to(f32) + p.dt_bias.to(f32))
    A = -torch.exp(p.A_log.to(f32))

    if single_step:
        h = state["ssm"].to(f32)                           # (B,H,P,N)
        rep = H // s.n_groups
        Bh = B_[:, 0].to(f32).repeat_interleave(rep, dim=1)    # (B,H,N)
        Ch = C_[:, 0].to(f32).repeat_interleave(rep, dim=1)
        dt0 = dt[:, 0]                                     # (B,H)
        dec = torch.exp(dt0 * A)
        xin = x[:, 0].to(f32) * dt0[..., None]             # (B,H,P)
        h = dec[..., None, None] * h + xin[..., :, None] * Bh[..., None, :]
        y = torch.einsum("bhpn,bhn->bhp", h, Ch)
        y = y + p.D.to(f32)[:, None] * x[:, 0].to(f32)
        y = y[:, None]                                     # (B,1,H,P)
        new_ssm = h
    else:
        y, new_ssm = ssd(cfg, x, dt, A, B_, C_, None if state is None else state["ssm"])
        y = y.to(f32) + p.D.to(f32)[None, None, :, None] * x.to(f32)

    Bb, S = x_in.shape[:2]
    y = y.reshape(Bb, S, d_in).to(x_in.dtype)
    y = _gated_norm(p, y, z)
    return y @ p.out_proj.to(x_in.dtype), {"ssm": new_ssm, "conv": new_conv}


def init_mamba_state(cfg: ModelConfig, batch: int, device=None) -> State:
    s, d_in, H, conv_dim = _dims(cfg)
    return {"ssm": torch.zeros((batch, H, s.head_dim, s.d_state), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                                dtype=torch_dtype(cfg.dtype), device=device)}
