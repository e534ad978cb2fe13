"""Mixture-of-Experts: routing, the load-balance loss and the dense
reference combine.

Counterpart of ``repro.models.moe`` (its ``moe.py:30-216``):

* :class:`MoE` (:func:`init_moe`): ``router`` (d_model, E), ``w_gate`` /
  ``w_up`` (E, d_model, d_ff) and ``w_down`` (E, d_ff, d_model), the
  reference's keys;
* :func:`route`: router logits in the compute type, then float32 softmax,
  top-k, renormalised with ``+ 1e-9``, and the Switch load-balance loss
  ``E * sum(density * mean_prob) * load_balance_coef``. ``density`` counts
  the chosen experts (no gradient); ``mean_prob`` carries the router's.
  Top-k is a stable descending sort, so equal probabilities keep the lower
  expert first, as ``jax.lax.top_k`` does;
* :func:`moe_dense`: every expert for every token, combined by the routing
  weights through a one-hot, as the reference's single-device path;
* :func:`moe_sharded` (``moe.py:90-206``): expert parallelism over the
  context's ``ep_axis``. Each rank takes its batch slice (``dp_axes``) and
  its experts (``ep_axis``), splits its tokens into chunks of at most
  ``moe_token_chunk``, and per chunk ranks each (token, choice) slot
  within its expert (:func:`_rank_within_expert`), drops the slots past
  the expert's capacity, sends the kept tokens to their expert's rank in
  an ``(M, E_loc, C, d)`` buffer by ``all_to_all``, runs its experts'
  FFNs and sends the results back for the weighted combine; the batch
  slices are gathered over ``dp_axes`` at the end (or, on DTensors, stay
  sharded). The capacity is the
  reference's ``max(8, ceil(chunk * k * capacity_factor / E))`` in
  float64. It falls back to the dense path when E does not divide the
  axis, and replicates the batch when B does not divide ``dp_axes``;
* :func:`moe_apply`: the entry point; a context with ``use_ep`` takes
  :func:`moe_sharded`, none (or ``use_ep`` off) :func:`moe_dense`.

Inputs are the whole batch and the whole parameters on every rank (the
model runs replicated; the expert dispatch is the only sharded step), or
DTensors of the model's sharded run. Either way every rank's gradients
are those of the global loss, as ``jax.grad`` of the reference gives
them.
:func:`dispatch_record` collects each dispatch's slot and drop counts.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, normal, param, torch_dtype
from repro_torch.parallel.sharding import is_dtensor


class MoE(nn.Module):
    """``router``, ``w_gate``, ``w_up`` and ``w_down``."""

    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        m = cfg.moe
        pdt = torch_dtype(cfg.param_dtype)
        d, f, E = cfg.d_model, m.d_ff, m.num_experts
        self.router = param(dense_init(gen, d, E, pdt, device))
        self.w_gate = param(normal(gen, (E, d, f), 1.0 / np.sqrt(d), pdt, device))
        self.w_up = param(normal(gen, (E, d, f), 1.0 / np.sqrt(d), pdt, device))
        self.w_down = param(normal(gen, (E, f, d), 1.0 / np.sqrt(f), pdt, device))


def init_moe(gen, cfg: ModelConfig, device=None) -> MoE:
    return MoE(cfg, gen, device)


def route(cfg: ModelConfig, p: MoE, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (top_w (B,S,k) float32, top_i (B,S,k) int64, aux_loss scalar)."""
    m = cfg.moe
    logits = (x @ p.router.to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    sorted_w, sorted_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = sorted_w[..., :m.top_k], sorted_i[..., :m.top_k]
    top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance loss
    E = m.num_experts
    density = F.one_hot(top_i, E).to(torch.float32).mean(dim=(0, 1, 2))
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(density * mean_prob) * m.load_balance_coef
    return top_w, top_i, aux


def moe_dense(cfg: ModelConfig, p: MoE, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert for every token: (B, S, E, d_model) outputs, summed with
    the routing weights (zero for the experts a token did not choose)."""
    m = cfg.moe
    dt = x.dtype
    top_w, top_i, aux = route(cfg, p, x)
    g = torch.einsum("bsd,edf->bsef", x, p.w_gate.to(dt))
    u = torch.einsum("bsd,edf->bsef", x, p.w_up.to(dt))
    act = F.silu(g) if cfg.activation == "swiglu" else F.gelu(g, approximate="tanh")
    y_all = torch.einsum("bsef,efd->bsed", act * u, p.w_down.to(dt))
    one_hot = F.one_hot(top_i, m.num_experts).to(dt)               # (B,S,k,E)
    w = torch.einsum("bske,bsk->bse", one_hot, top_w.to(dt))        # (B,S,E)
    y = torch.einsum("bsed,bse->bsd", y_all, w)
    return y, aux


# ---------------------------------------------------------------------------
# Sharded EP implementation
# ---------------------------------------------------------------------------

#: the active :func:`dispatch_record` list, or None
_record: Optional[List[dict]] = None


@contextlib.contextmanager
def dispatch_record():
    """Collect one ``{"slots", "dropped", "capacity", "experts_rows"}``
    dict per dispatched chunk while active (``dropped`` a device tensor:
    nothing synchronizes). Under checkpointing a recomputed forward
    records again."""
    global _record
    outer, _record = _record, []
    try:
        yield _record
    finally:
        _record = outer


def _rank_within_expert(ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """ids: (T,) expert id per token-slot -> rank of each slot within its
    expert's arrival order (stable), int32."""
    T = ids.shape[0]
    sorted_ids, order = torch.sort(ids, stable=True)
    first_occ = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    rank_sorted = torch.arange(T, device=ids.device) - first_occ
    rank = torch.zeros(T, dtype=torch.int32, device=ids.device)
    rank[order] = rank_sorted.to(torch.int32)
    return rank


def _expert_ffn(cfg: ModelConfig, w_gate, w_up, w_down, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, d) tokens grouped per (local) expert."""
    g = torch.einsum("ecd,edf->ecf", xs, w_gate)
    u = torch.einsum("ecd,edf->ecf", xs, w_up)
    act = F.silu(g) if cfg.activation == "swiglu" else F.gelu(g, approximate="tanh")
    return torch.einsum("ecf,efd->ecd", act * u, w_down)


def _dispatch_compute_local(cfg: ModelConfig, mesh, ep_axis: str, capacity: int,
                            x_flat, top_w, top_i, w_gate, w_up, w_down):
    """One chunk on this rank. x_flat: (T, d); top_*: (T, k); w_*: this
    rank's experts (E_loc, d, f) / (E_loc, f, d)."""
    from repro_torch.parallel.compat import all_to_all, axis_size
    m = cfg.moe
    T, d = x_flat.shape
    k = m.top_k
    M = axis_size(mesh, ep_axis)
    E_loc = m.num_experts // M
    C = capacity
    dt = x_flat.dtype

    ids = top_i.reshape(T * k).to(torch.int32)
    rank = _rank_within_expert(ids, m.num_experts)
    keep = rank < C
    rank_c = torch.clamp(rank, max=C - 1).long()
    tok = torch.arange(T, device=x_flat.device).repeat_interleave(k)
    if _record is not None:
        _record.append({"slots": T * k, "dropped": (~keep).sum(), "capacity": C,
                        "experts_rows": m.num_experts * C})

    # scatter tokens into the (dest rank, local expert, slot) send buffer;
    # a dropped slot adds exact zeros at its expert's last slot
    dest = (ids // E_loc).long()
    le = (ids % E_loc).long()
    vals = x_flat[tok] * keep[:, None].to(dt)
    send = torch.zeros((M, E_loc, C, d), dtype=dt, device=x_flat.device)
    send = send.index_put((dest, le, rank_c), vals, accumulate=True)

    # tokens travel to their expert's rank
    recv = all_to_all(send, mesh, ep_axis)                      # (M_src, E_loc, C, d)
    recv = recv.transpose(0, 1).reshape(E_loc, M * C, d)

    out = _expert_ffn(cfg, w_gate, w_up, w_down, recv)          # (E_loc, M*C, d)

    # send results home
    back = out.reshape(E_loc, M, C, d).transpose(0, 1)          # (M_src, E_loc, C, d)
    got = all_to_all(back, mesh, ep_axis)                       # (M_dest, E_loc, C, d)

    # combine: gather each slot's result, weight, sum over k
    slot_out = got[dest, le, rank_c]                            # (T*k, d)
    w = top_w.reshape(T * k).to(dt) * keep.to(dt)
    return (slot_out * w[:, None]).reshape(T, k, d).sum(dim=1)


def moe_sharded(cfg: ModelConfig, p: MoE, x: torch.Tensor, *, mesh, dp_axes,
                ep_axis: str, capacity_factor: float = 1.25,
                token_chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """EP MoE. x: (B, S, d), the whole batch on every rank, or a DTensor.
    Experts are split over ``ep_axis``, the batch over ``dp_axes``; falls
    back to the dense path when the experts do not divide the axis.

    On plain tensors it returns the whole (B, S, d) output on every rank
    and the aux loss. The gradients are those of the global loss on every
    rank, as ``jax.grad`` through the reference's ``shard_map`` gives
    them: the gather's backward takes this rank's slice of the replicated
    cotangent, and the dispatch's partial gradients of x, the routing
    weights and the experts are summed over the mesh and divided by the
    ranks that hold each data shard (R = mesh size / data shards: each
    shard's tokens are dispatched by R ranks, its experts' outputs reach
    M = the expert axis's size copies), which is the reference's division
    of the output's cotangent by its unmentioned axes.

    On a DTensor x (and DTensor parameters) it routes on the DTensors,
    dispatches this rank's local shard of the batch with its local
    experts, and returns a DTensor sharded as the reference's ``spec_x``.
    The experts' gradients come back ``Partial`` over the other axes,
    divided by R."""
    from repro_torch.parallel.compat import (all_gather, axis_index, axis_size,
                                             grad_psum)
    m = cfg.moe
    M = mesh.shape.get(ep_axis, 1)
    if m.num_experts % max(M, 1) != 0:
        return moe_dense(cfg, p, x)

    top_w, top_i, aux = route(cfg, p, x)
    B, S, d = x.shape
    dt = x.dtype
    dp_axes = tuple(a for a in dp_axes if a in mesh.shape)
    dp_size = axis_size(mesh, dp_axes)
    if B % max(dp_size, 1) != 0:   # e.g. batch=1 long-context: replicate batch
        dp_axes, dp_size = (), 1
    T_loc = max((B + dp_size - 1) // dp_size * S, 1)
    chunk = min(token_chunk, T_loc)
    n_chunks = max(T_loc // chunk, 1)
    chunk = T_loc // n_chunks
    capacity = int(max(8, np.ceil(chunk * m.top_k * capacity_factor / m.num_experts)))
    if chunk * n_chunks != T_loc:
        raise ValueError(f"{T_loc} local tokens do not split into {n_chunks} chunks "
                         f"of {chunk}")
    Bl = B // dp_size
    E_loc = m.num_experts // M
    # ranks that dispatch each data shard
    R = int(np.prod(list(mesh.shape.values()), dtype=np.int64)) // dp_size
    weights = (p.w_gate, p.w_up, p.w_down)
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        dmesh = x.device_mesh
        spec_x = tuple(Shard(0) if a in dp_axes else Replicate() for a in mesh.axis_names)
        spec_w = tuple(Shard(0) if a == ep_axis else Replicate() for a in mesh.axis_names)
        grad_w = tuple(Shard(0) if a == ep_axis else Partial() for a in mesh.axis_names)
        xf, twf, tif = (t.redistribute(dmesh, spec_x).to_local()
                        for t in (x, top_w.to(dt), top_i))
        wg, wu, wd = (grad_psum(w.to(dt).redistribute(dmesh, spec_w)
                                .to_local(grad_placements=grad_w), mesh, scale=1.0 / R)
                      for w in weights)
    else:
        b0 = axis_index(mesh, dp_axes) * Bl
        e0 = axis_index(mesh, ep_axis) * E_loc
        x = grad_psum(x, mesh, mesh.axis_names, 1.0 / R)
        top_w = grad_psum(top_w, mesh, mesh.axis_names, 1.0 / R)
        wg, wu, wd = (grad_psum(w, mesh, mesh.axis_names, 1.0 / R)[e0:e0 + E_loc].to(dt)
                      for w in weights)
        xf, twf, tif = x[b0:b0 + Bl], top_w[b0:b0 + Bl].to(dt), top_i[b0:b0 + Bl]
    xf = xf.reshape(Bl * S, d)
    twf = twf.reshape(Bl * S, m.top_k)
    tif = tif.reshape(Bl * S, m.top_k)
    ys = [_dispatch_compute_local(cfg, mesh, ep_axis, capacity,
                                  xf[i * chunk:(i + 1) * chunk],
                                  twf[i * chunk:(i + 1) * chunk],
                                  tif[i * chunk:(i + 1) * chunk], wg, wu, wd)
          for i in range(n_chunks)]
    y = (ys[0] if n_chunks == 1 else torch.cat(ys)).reshape(Bl, S, d)
    if is_dtensor(x):
        return DTensor.from_local(y, dmesh, spec_x, run_check=False), aux
    # the batch slices back in order, the last dp axis the minor one
    for a in reversed(dp_axes):
        y = all_gather(y, mesh, a)
    return y, aux


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor, *, parallel=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entry point: the sharded path under a parallel context with
    ``use_ep``, else the dense path."""
    if parallel is not None and parallel.use_ep:
        return moe_sharded(cfg, p, x, mesh=parallel.mesh, dp_axes=parallel.dp_axes,
                           ep_axis=parallel.ep_axis,
                           capacity_factor=parallel.capacity_factor,
                           token_chunk=parallel.moe_token_chunk)
    return moe_dense(cfg, p, x)
