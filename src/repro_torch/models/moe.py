"""Mixture-of-Experts: routing, the load-balance loss and the dense
reference combine.

Counterpart of ``repro.models.moe`` (its ``moe.py:30-87,209-216``):

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
* :func:`moe_apply`: the entry point. The expert-parallel path
  (``moe_sharded`` and ``_rank_within_expert``) waits for ``parallel/``,
  so a parallel context that asks for it raises.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, normal, param, torch_dtype


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


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor, *, parallel=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entry point: the dense path, the reference's route without a
    parallel context. A context with ``use_ep`` (expert parallelism) would
    take ``moe_sharded``, which is not ported."""
    if parallel is not None and getattr(parallel, "use_ep", False):
        raise NotImplementedError(
            "expert-parallel MoE (moe_sharded, _rank_within_expert) waits for "
            "parallel/ (ROADMAP A4 \"Parallelism\")")
    return moe_dense(cfg, p, x)
