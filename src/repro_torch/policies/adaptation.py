"""Compute-node prefetch rate-control policies (paper §IV-B).

Counterpart of ``repro.policies.adaptation``:

* ``token_bucket`` — sampling-based MIMD congestion control over a
  deterministic token bucket (:mod:`repro_torch.core.throttle`), gated by
  the ``bw_adapt`` flag;
* ``static`` — the issue rate pinned at the ``rate`` param, enforced
  through the same token bucket, always active.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.throttle import (init_throttle, maybe_adapt, observe,
                                       take_tokens)
from repro_torch.policies.base import register


class _AdaptCfg(NamedTuple):
    """The policy's params in the attribute names ``maybe_adapt`` reads."""

    sample_interval: object
    latency_noise_threshold: object
    mimd_increase: object
    ema_alpha: object
    min_issue_rate: object


class TokenBucketAdaptation:
    """MIMD/RED adaptation over a token bucket."""

    kind = "adaptation"
    name = "token_bucket"

    def params_of(self, cfg):
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        return {"sample_interval": torch.tensor(cfg.sample_interval, dtype=torch.int32),
                "latency_noise_threshold": f32(cfg.latency_noise_threshold),
                "mimd_increase": f32(cfg.mimd_increase),
                "ema_alpha": f32(cfg.ema_alpha),
                "min_issue_rate": f32(cfg.min_issue_rate)}

    def gate(self, p):
        return p.bw_adapt

    def init(self, p, pol, shape):
        return init_throttle(p, shape)

    def take(self, p, pol, state, want, enable):
        return take_tokens(state, want, enable)

    def observe(self, p, pol, state, demand_latency, is_fam_demand,
                was_pf_hit, pf_issued_now, enable):
        return observe(state, demand_latency, is_fam_demand, was_pf_hit,
                       pf_issued_now, enable=enable)

    def adapt(self, p, pol, state, enable):
        view = _AdaptCfg(pol["sample_interval"], pol["latency_noise_threshold"],
                         pol["mimd_increase"], pol["ema_alpha"],
                         pol["min_issue_rate"])
        return maybe_adapt(view, state, enabled=enable)


class StaticRateAdaptation:
    """Fixed issue rate: enforcement without adaptation."""

    kind = "adaptation"
    name = "static"

    def params_of(self, cfg):
        return {"rate": torch.tensor(1.0, dtype=torch.float32)}

    def gate(self, p):
        return torch.ones_like(p.bw_adapt)

    def init(self, p, pol, shape):
        s = init_throttle(p, shape)
        return s._replace(issue_rate=torch.broadcast_to(pol["rate"], shape).clone())

    def take(self, p, pol, state, want, enable):
        return take_tokens(state, want, enable)

    def observe(self, p, pol, state, demand_latency, is_fam_demand,
                was_pf_hit, pf_issued_now, enable):
        return state                     # nothing to learn

    def adapt(self, p, pol, state, enable):
        return state                     # nothing to adapt


TOKEN_BUCKET = register(TokenBucketAdaptation())
STATIC = register(StaticRateAdaptation())
