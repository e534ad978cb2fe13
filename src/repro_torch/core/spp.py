"""Signature Path Prefetcher (SPP) — paper §II-B, adapted to sub-page blocks.

Counterpart of ``repro.core.spp``, batched over leading lane dimensions:

* Signature table: page-indexed; holds (page tag, last accessed block,
  signature), ``signature = ((signature << 4) ^ delta) & SIG_MASK``.
* Pattern table: signature-indexed; 4 (delta, weight) slots plus a
  signature weight counter. Lookahead walks the pattern table, multiplying
  per-step path confidence and stopping below the confidence threshold.

``update`` writes the tables in place.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import FamConfig
from repro_torch.core.dram_cache import HASH_MULT, u32_hash

SIG_SHIFT = 4
PT_WAYS = 4
MAX_WEIGHT = 15          # 4-bit saturating counters, as in SPP


class SppState(NamedTuple):
    st_tag: torch.Tensor        # (*B, ST) int32 page tag (+1; 0 = invalid)
    st_last: torch.Tensor       # (*B, ST) int32 last block within page
    st_sig: torch.Tensor        # (*B, ST) int32 current signature
    pt_delta: torch.Tensor      # (*B, PT, 4) int32 delta (signed)
    pt_weight: torch.Tensor     # (*B, PT, 4) int32 saturating weights
    pt_sigw: torch.Tensor       # (*B, PT) int32 signature weight


def init_spp(cfg: FamConfig, batch=(), device="cpu") -> SppState:
    ST, PT = cfg.spp_signature_entries, cfg.spp_pattern_entries
    b = tuple(batch)
    z = lambda *s: torch.zeros(b + s, dtype=torch.int32, device=device)
    return SppState(st_tag=z(ST), st_last=z(ST), st_sig=z(ST),
                    pt_delta=z(PT, PT_WAYS), pt_weight=z(PT, PT_WAYS),
                    pt_sigw=z(PT))


def _sig_mask(cfg: FamConfig) -> int:
    return (1 << cfg.spp_signature_bits) - 1


def _st_index(cfg: FamConfig, page):
    return (u32_hash(page, HASH_MULT, 8) % cfg.spp_signature_entries).to(torch.int32)


def _pt_index(cfg: FamConfig, sig):
    return sig % cfg.spp_pattern_entries


def _take(t, i):
    """t[..., i] for a lane-shaped index ``i``."""
    return t.gather(-1, i.to(torch.int64).unsqueeze(-1)).squeeze(-1)


def _take_row(t, i):
    """t[..., i, :] for a lane-shaped index ``i``."""
    idx = i.to(torch.int64)[..., None, None].expand(*i.shape, 1, t.shape[-1])
    return t.gather(-2, idx).squeeze(-2)


def _put(t, i, v):
    t.scatter_(-1, i.to(torch.int64).unsqueeze(-1), v.unsqueeze(-1))


def update(cfg: FamConfig, s: SppState, page, block, enable=True
           ) -> Tuple[SppState, torch.Tensor]:
    """Train on one access (page, block) per lane. Returns (state, current
    signature); ``enable`` masks every write."""
    en = torch.as_tensor(enable, device=page.device)
    idx = _st_index(cfg, page)
    tag = page + 1
    st_tag, st_last, old_sig = (_take(s.st_tag, idx), _take(s.st_last, idx),
                                _take(s.st_sig, idx))
    hit = st_tag == tag
    delta = block - st_last
    train = hit & (delta != 0) & en

    # --- pattern table update (only on ST hit with nonzero delta)
    pt_i = _pt_index(cfg, old_sig)
    row_d = _take_row(s.pt_delta, pt_i)
    row_w = _take_row(s.pt_weight, pt_i)
    live = (row_d == delta[..., None]) & (row_w > 0)
    has_match = live.any(-1)
    way = torch.where(has_match, live.to(torch.int32).argmax(-1),
                      row_w.argmin(-1)).unsqueeze(-1)
    w_way = row_w.gather(-1, way).squeeze(-1)
    new_w = torch.where(has_match, torch.clamp(w_way + 1, max=MAX_WEIGHT), 1)
    row_d = row_d.scatter(-1, way, torch.where(
        train, delta, row_d.gather(-1, way).squeeze(-1)).unsqueeze(-1))
    row_w = row_w.scatter(-1, way, torch.where(train, new_w, w_way).unsqueeze(-1))
    row_idx = pt_i.to(torch.int64)[..., None, None].expand(*pt_i.shape, 1, PT_WAYS)
    s.pt_delta.scatter_(-2, row_idx, row_d.unsqueeze(-2))
    s.pt_weight.scatter_(-2, row_idx, row_w.unsqueeze(-2))
    sigw = _take(s.pt_sigw, pt_i)
    _put(s.pt_sigw, pt_i, sigw + (train & (sigw < 4 * MAX_WEIGHT)).to(torch.int32))

    # --- signature table update (allocate on miss)
    mask = _sig_mask(cfg)
    new_sig = torch.where(hit, ((old_sig << SIG_SHIFT) ^ (delta & mask)) & mask,
                          block & mask)   # bootstrap signature on allocation
    _put(s.st_tag, idx, torch.where(en, tag, st_tag))
    _put(s.st_last, idx, torch.where(en, block, st_last))
    _put(s.st_sig, idx, torch.where(en, new_sig, old_sig))
    return s, new_sig


def predict(cfg: FamConfig, s: SppState, page, block, sig, degree: int,
            bpp=64, threshold=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Path-confidence lookahead from (page, block, sig), ``degree`` steps.

    Returns (block_addrs (*B, degree), valid (*B, degree)) — global block
    addrs; predictions stay within the page (``bpp`` blocks per page).
    ``threshold`` defaults to ``cfg.spp_confidence_threshold``.
    """
    mask = _sig_mask(cfg)
    if threshold is None:
        threshold = cfg.spp_confidence_threshold
    bpp = torch.as_tensor(bpp, device=page.device)
    cur_sig, cur_block = sig, block
    conf = torch.ones(sig.shape, dtype=torch.float32, device=sig.device)
    alive = torch.ones(sig.shape, dtype=torch.bool, device=sig.device)
    outs = []
    for _ in range(degree):
        pt_i = _pt_index(cfg, cur_sig)
        row_w = _take_row(s.pt_weight, pt_i)
        row_d = _take_row(s.pt_delta, pt_i)
        way = row_w.argmax(-1, keepdim=True)
        w = row_w.gather(-1, way).squeeze(-1)
        sigw = torch.clamp(_take(s.pt_sigw, pt_i), min=1)
        step_conf = w.to(torch.float32) / sigw.to(torch.float32)
        new_conf = conf * torch.clamp(step_conf * 4.0, max=1.0)
        delta = row_d.gather(-1, way).squeeze(-1)
        nb = cur_block + delta
        ok = alive & (w > 0) & (new_conf >= threshold) & \
            (nb >= 0) & (nb < bpp) & (delta != 0)
        nsig = ((cur_sig << SIG_SHIFT) ^ (delta & mask)) & mask
        outs.append(torch.where(ok, nb, -1))
        cur_sig = torch.where(ok, nsig, cur_sig)
        cur_block = torch.where(ok, nb, cur_block)
        conf = torch.where(ok, new_conf, conf)
        alive = ok
    blocks = torch.stack(outs, -1)
    valid = blocks >= 0
    return page[..., None] * bpp[..., None] + torch.clamp(blocks, min=0), valid


def storage_bits(cfg: FamConfig) -> int:
    """Rough metadata budget (paper: ~11 kB, 2x SPP)."""
    st = cfg.spp_signature_entries * (16 + 6 + cfg.spp_signature_bits)
    pt = cfg.spp_pattern_entries * (PT_WAYS * (7 + 4) + 8)
    return st + pt
