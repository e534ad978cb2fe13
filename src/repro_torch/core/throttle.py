"""Prefetch bandwidth adaptation at the compute node — paper §IV-B.

Counterpart of ``repro.core.throttle``: sampling-based MIMD congestion
control on the prefetch issue rate over a deterministic token bucket.
Every field carries the lane shape; parameters broadcast against it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class ThrottleState(NamedTuple):
    issue_rate: torch.Tensor        # float32 in [min_rate, 1]
    tokens: torch.Tensor            # float32 token bucket
    min_latency: torch.Tensor       # float32 min avg demand latency seen
    lat_sum: torch.Tensor           # float32 demand latency accumulator
    lat_cnt: torch.Tensor           # float32
    lat_ema: torch.Tensor           # float32 EMA of avg demand latency
    pf_issued: torch.Tensor         # float32 prefetches issued (window)
    pf_useful: torch.Tensor         # float32 prefetch hits (window)
    acc_ema: torch.Tensor           # float32 accuracy EMA
    events: torch.Tensor            # int32 events since last sample


def init_throttle(p, shape) -> ThrottleState:
    """``p``: a ``FamParams`` whose fields broadcast to ``shape``."""
    dev = p.fam_mem_latency.device

    def f(v):          # a Python number is filled on the device, not copied
        if isinstance(v, torch.Tensor):
            return torch.broadcast_to(v.to(torch.float32), shape).clone()
        return torch.full(shape, v, dtype=torch.float32, device=dev)
    # minimum achievable demand latency: seeded with the unloaded fabric +
    # DDR latency (the EMA-min refines it)
    unloaded = (p.fam_mem_latency + p.cxl_min_latency_cycles
                + p.fam_service_cycles(p.demand_bytes))
    return ThrottleState(
        issue_rate=f(1.0), tokens=f(0.0), min_latency=f(unloaded),
        lat_sum=f(0.0), lat_cnt=f(0.0), lat_ema=f(0.0),
        pf_issued=f(0.0), pf_useful=f(0.0), acc_ema=f(0.5),
        events=torch.zeros(shape, dtype=torch.int32, device=dev))


def observe(s: ThrottleState, demand_latency, is_fam_demand, was_pf_hit,
            pf_issued_now, enable=True) -> ThrottleState:
    """Record one event: FAM demand latency (masked) + issue counts; a
    disabled observation leaves every counter untouched."""
    en = torch.as_tensor(enable, device=s.events.device)
    enf = en.to(torch.float32)
    m = is_fam_demand.to(torch.float32) * enf
    return s._replace(
        lat_sum=s.lat_sum + demand_latency * m,
        lat_cnt=s.lat_cnt + m,
        pf_useful=s.pf_useful + was_pf_hit.to(torch.float32) * enf,
        pf_issued=s.pf_issued + pf_issued_now.to(torch.float32) * enf,
        events=s.events + en.to(torch.int32))


def maybe_adapt(cfg, s: ThrottleState, enabled=True) -> ThrottleState:
    """Run the Fig. 9 adaptation once per sampling cycle. ``cfg`` carries
    the tuning knobs as tensors broadcasting against the lane shape."""
    due = (s.events >= cfg.sample_interval) & enabled
    avg_lat = s.lat_sum / torch.clamp(s.lat_cnt, min=1.0)
    lat_ema = torch.where(s.lat_ema == 0.0, avg_lat,
                          (1 - cfg.ema_alpha) * s.lat_ema + cfg.ema_alpha * avg_lat)
    min_lat = torch.minimum(s.min_latency, lat_ema)
    acc = s.pf_useful / torch.clamp(s.pf_issued, min=1.0)
    acc_ema = (1 - cfg.ema_alpha) * s.acc_ema + cfg.ema_alpha * acc

    thresh = cfg.latency_noise_threshold * min_lat
    congested = lat_ema > thresh
    # RED-like: decrease factor linear in latency excess, softened by accuracy
    excess = torch.clamp((lat_ema - thresh) / torch.clamp(thresh, min=1.0), 0.0, 1.0)
    dec = 1.0 - (0.5 * excess) * (1.0 - 0.5 * acc_ema)
    new_rate = torch.where(congested, s.issue_rate * dec,
                           s.issue_rate * cfg.mimd_increase)
    new_rate = torch.clamp(torch.maximum(new_rate, cfg.min_issue_rate), max=1.0)

    zero = torch.zeros_like(s.lat_sum)
    adapted = ThrottleState(
        issue_rate=new_rate, tokens=s.tokens, min_latency=min_lat,
        lat_sum=zero, lat_cnt=zero, lat_ema=lat_ema,
        pf_issued=zero, pf_useful=zero, acc_ema=acc_ema,
        events=torch.zeros_like(s.events))
    return ThrottleState(*(torch.where(due, a, b) for a, b in zip(adapted, s)))


def take_tokens(s: ThrottleState, want, enabled
                ) -> Tuple[ThrottleState, torch.Tensor]:
    """Token bucket: grant min(want, floor(tokens + rate)) prefetch issues;
    disabled lanes grant everything and leave the bucket untouched."""
    tokens = torch.clamp(s.tokens + s.issue_rate * torch.clamp(want, min=1), max=8.0)
    grant = torch.minimum(want, torch.floor(tokens).to(torch.int32))
    grant = torch.where(enabled, grant, want)
    tokens = torch.where(enabled, tokens - grant, s.tokens)
    return s._replace(tokens=tokens), grant
