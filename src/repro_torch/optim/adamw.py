"""AdamW with global-norm clipping and a warmup-cosine schedule.

Counterpart of ``repro.optim.adamw`` (its ``adamw.py:17-187``). The state
is plain tensors keyed by parameter name (``LM.named_parameters()``):
``{"mu": {name: t}, "nu": {name: t}, "step": int32 scalar}``, the moments
float32, or with :func:`init_opt_state_q8` int8 codes and float32 block
scales ``{name: {"q", "s"}}``. ``params`` may be the LM module or a
``{name: tensor}`` dict. Updates run under ``torch.no_grad`` and write the
parameters, the moments and (when clipping) the gradients in place: each
leaf's values are the reference's, only the buffers are reused. The
schedule and the bias corrections are float32 tensors on the parameters'
device, as the reference computes them in float32.

:func:`global_norm` sums the leaves in ``named_parameters`` order, one
per-layer tensor after another (the reference sums its stacked leaves in
sorted-key order); the two sums differ in the float32 rounding of their
order only.

On a sharded model (DTensor parameters,
:func:`repro_torch.parallel.sharding.shard_params`) the moments are
DTensors placed as their parameters (the q8 scales with their last dim
whole), a gradient that arrives ``Partial`` (over the data axis) is
reduced to its parameter's placements first, and the norm is the global
one. The int8 blocks run along the last dim, as in JAX's global
computation: where that dim is sharded, a rank's slice is not a whole
number of blocks (the smoke configs' 32-wide slices against
``Q_BLOCK`` 128), so the q8 update gathers each row first and quantizes
the rank's rows whole.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.sharding import is_dtensor, spmd


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named_leaves(params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of an ``nn.Module`` (its named parameters) or of a
    mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _step0(params) -> torch.Tensor:
    dev = next(iter(named_leaves(params).values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def init_opt_state(params) -> Dict[str, Any]:
    leaves = named_leaves(params)
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
                     for n, p in leaves.items()}
    return {"mu": zeros(), "nu": zeros(), "step": _step0(params)}


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """The float32 norm of all leaves (a plain tensor, DTensor leaves
    included)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in named_leaves(tree).values()) + 1e-20)
    return norm.full_tensor() if is_dtensor(norm) else norm


@torch.no_grad()
def reduce_grads(grads, params) -> Dict[str, torch.Tensor]:
    """Each DTensor gradient redistributed to its parameter's placements
    (a ``Partial`` sum over the data axis reduced); plain ones as they
    are."""
    leaves = named_leaves(params)
    return {n: g.redistribute(leaves[n].device_mesh, leaves[n].placements)
            if is_dtensor(g) else g for n, g in named_leaves(grads).items()}


@torch.no_grad()
@spmd
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / (norm + 1e-9))`` as float32,
    norm). float32 gradients are scaled in place."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {n: g.to(torch.float32).mul_(scale) for n, g in named_leaves(grads).items()}, norm


def _corrections(cfg: AdamWConfig, opt_state):
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    return step, lr, 1 - cfg.b1 ** stepf, 1 - cfg.b2 ** stepf


@torch.no_grad()
@spmd
def adamw_update(cfg: AdamWConfig, grads, params, opt_state
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step -> (params, opt_state, {"grad_norm", "lr"}); the
    parameters and moments are written in place."""
    grads, gnorm = clip_by_global_norm(reduce_grads(grads, params), cfg.clip_norm)
    step, lr, bc1, bc2 = _corrections(cfg, opt_state)
    b1, b2 = cfg.b1, cfg.b2
    mus, nus = opt_state["mu"], opt_state["nu"]
    for name, p in named_leaves(params).items():
        g, mu, nu = grads[name], mus[name], nus[name]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = mu / bc1
        vhat = nu / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
    new_state = {"mu": mus, "nu": nus, "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# 8-bit moment state (Dettmers-style block-quantized Adam)
#
# For pool-scale models (arctic-480b: 469 B params) fp32 moments do not fit
# a card's memory: mu/nu live as int8 codes + per-block fp32 scales and
# dequantize inside the update.
# ---------------------------------------------------------------------------

Q_BLOCK = 128


def _q8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x float32 -> (int8 codes [same shape as x], float32 per-block scales
    [x's shape with the last dim replaced by its block count]). Rounds half
    to even, as ``jnp.round``."""
    shape = x.shape
    pad = (-shape[-1]) % Q_BLOCK
    xp = F.pad(x, (0, pad)) if pad else x
    blocks = xp.reshape(xp.shape[:-1] + (xp.shape[-1] // Q_BLOCK, Q_BLOCK))
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0 + 1e-12
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    codes = codes.reshape(xp.shape)[..., : shape[-1]].contiguous()
    return codes, scale[..., 0].to(torch.float32)


def _q8_decode(codes: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    pad = (-shape[-1]) % Q_BLOCK
    cp = F.pad(codes, (0, pad)) if pad else codes
    blocks = cp.reshape(cp.shape[:-1] + (cp.shape[-1] // Q_BLOCK, Q_BLOCK))
    x = blocks.to(torch.float32) * scale[..., None]
    return x.reshape(cp.shape)[..., : shape[-1]]


def _rows(p) -> tuple:
    """A DTensor's placements with its last dim whole (``Shard(last)`` ->
    ``Replicate()``): those of its q8 scales, and where its blocks are
    quantized."""
    from torch.distributed.tensor import Replicate
    last = p.ndim - 1
    return tuple(Replicate() if pl.is_shard() and pl.dim % p.ndim == last else pl
                 for pl in p.placements)


def init_opt_state_q8(params) -> Dict[str, Any]:
    def enc_zero(p):
        # _q8_encode of zeros, built directly: codes 0, scales 0 / 127 + 1e-12
        c = torch.zeros_like(p, dtype=torch.int8, requires_grad=False)
        s = torch.full(tuple(p.shape[:-1]) + (-(-p.shape[-1] // Q_BLOCK),), 1e-12,
                       dtype=torch.float32, device=p.device)
        if is_dtensor(p):
            from torch.distributed.tensor import distribute_tensor
            s = distribute_tensor(s, p.device_mesh, _rows(p), src_data_rank=None)
        return {"q": c, "s": s}
    leaves = named_leaves(params)
    return {"mu": {n: enc_zero(p) for n, p in leaves.items()},
            "nu": {n: enc_zero(p) for n, p in leaves.items()},
            "step": _step0(params)}


@torch.no_grad()
@spmd
def adamw_update_q8(cfg: AdamWConfig, grads, params, opt_state):
    """AdamW with int8 moments. Same signature and return as
    :func:`adamw_update`; codes and scales are rewritten in place.

    The reference streams a big stacked leaf (more than 64 MB, a leading
    layer axis) through a ``lax.scan`` so the transient float32 decode of
    its moments never holds the whole slab. The port's leaves are per
    layer already: the loop over them decodes one layer's slab of one
    leaf at a time, the scan's granularity, and splits nothing further."""
    grads, gnorm = clip_by_global_norm(reduce_grads(grads, params), cfg.clip_norm)
    step, lr, bc1, bc2 = _corrections(cfg, opt_state)
    b1, b2 = cfg.b1, cfg.b2
    mus, nus = opt_state["mu"], opt_state["nu"]

    def update(g, p, mq, nq):
        """One leaf on plain tensors, written in place."""
        mu = _q8_decode(mq["q"], mq["s"], p.shape)
        nu = _q8_decode(nq["q"], nq["s"], p.shape)
        mu = b1 * mu + (1 - b1) * g
        nu = torch.clamp(b2 * nu + (1 - b2) * torch.square(g), min=0.0)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        for moment, state in ((mu, mq), (nu, nq)):
            codes, scales = _q8_encode(moment)
            state["q"].copy_(codes)
            state["s"].copy_(scales)

    for name, p in named_leaves(params).items():
        g, mq, nq = grads[name].to(torch.float32), mus[name], nus[name]
        if not is_dtensor(p):
            update(g, p, mq, nq)
            continue
        # whole rows on each rank: its slice of every leaf, gathered along
        # the last dim, updated, and written back to its placements
        from torch.distributed.tensor import DTensor
        mesh, rows = p.device_mesh, _rows(p)
        whole = [t.redistribute(mesh, rows).to_local()
                 for t in (g, p, mq["q"], mq["s"], nq["q"], nq["s"])]
        update(whole[0], whole[1], {"q": whole[2], "s": whole[3]},
               {"q": whole[4], "s": whole[5]})
        for dst, src in zip((p, mq["q"], mq["s"], nq["q"], nq["s"]), whole[1:]):
            dst.copy_(DTensor.from_local(src, mesh, rows, run_check=False)
                      .redistribute(mesh, dst.placements))
    return params, {"mu": mus, "nu": nus, "step": step}, {"grad_norm": gnorm, "lr": lr}


def state_bytes(opt_state: Mapping[str, Any]) -> int:
    """Bytes the optimizer state holds (every tensor leaf)."""
    def walk(t):
        if isinstance(t, torch.Tensor):
            return t.numel() * t.element_size()
        return sum(walk(v) for v in t.values())
    return walk(opt_state)
