"""DRAM-cache prefetch policies (paper §III-A and related-work families).

Counterpart of ``repro.policies.prefetch``:

* ``spp`` — the paper's Signature Path Prefetcher, delegating to
  :mod:`repro_torch.core.spp` (the default);
* ``nextline`` — stateless next-N-blocks prefetcher with a ``distance``
  numeric param;
* ``bestoffset`` — a Best-Offset-style offset prefetcher (Michaud,
  HPCA'16, miniaturized): a recent-access ring scores a fixed candidate
  offset list per training round; the winning offset drives degree-deep
  in-page prefetches once its score clears a threshold.

Every state is a tuple of tensors with leading lane dimensions ``B`` (the
simulator's ``(S, N)``), every write masked by ``enable``, so a non-live
step is an exact no-op and the event loop's CUDA graph can replay it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core import spp as spp_lib
from repro_torch.policies.base import register


class SppPrefetch:
    """SPP as a policy; the confidence threshold is the numeric param."""

    kind = "prefetch"
    name = "spp"
    compile_tag = "prefetch:spp"

    def params_of(self, cfg):
        return {"confidence_threshold":
                torch.tensor(cfg.spp_confidence_threshold, dtype=torch.float32)}

    def init(self, cfg, batch, device):
        return spp_lib.init_spp(cfg, batch, device)

    def train(self, cfg, pol, state, page, block, enable):
        return spp_lib.update(cfg, state, page, block, enable=enable)

    def predict(self, cfg, pol, state, page, block, ctx, degree, bpp):
        return spp_lib.predict(cfg, state, page, block, ctx, degree,
                               bpp=bpp, threshold=pol["confidence_threshold"])


class NextLinePrefetch:
    """Stateless sequential prefetcher: blocks ``+d, +2d, ... +degree*d``
    within the page (``distance`` d, truncated to int32)."""

    kind = "prefetch"
    name = "nextline"
    compile_tag = "prefetch:nextline"

    def params_of(self, cfg):
        return {"distance": torch.tensor(1.0, dtype=torch.float32)}

    def init(self, cfg, batch, device):
        # stateless: a placeholder carried like a state
        return torch.zeros(tuple(batch), dtype=torch.int32, device=device)

    def train(self, cfg, pol, state, page, block, enable):
        return state, None

    def predict(self, cfg, pol, state, page, block, ctx, degree, bpp):
        step = pol["distance"].to(torch.int32)
        return _offset_candidates(page, block, step, step != 0, degree, bpp)


def _offset_candidates(page, block, step, enable, degree, bpp):
    """Global block addrs of ``block + step * (1..degree)`` on ``page`` and
    their validity (``enable`` and inside the page)."""
    k = torch.arange(1, degree + 1, dtype=torch.int32, device=page.device)
    nb = block.to(torch.int32)[..., None] + step[..., None] * k
    bpp = torch.as_tensor(bpp, dtype=torch.int32, device=page.device)[..., None]
    valid = enable[..., None] & (nb >= 0) & (nb < bpp)
    return page.to(torch.int32)[..., None] * bpp + torch.where(valid, nb, 0), valid


RECENT_ENTRIES = 16
#: candidate offsets scored each round (the list size is a shape)
BO_OFFSETS = (1, 2, 3, 4, 6, 8, -1, -2)


@functools.lru_cache(maxsize=None)
def _bo_offsets(device) -> torch.Tensor:
    """BO_OFFSETS on ``device``, made once: a step's first call on a device
    runs before any CUDA graph capture of it (the warm-up step), and a
    copy from the host is not allowed inside a capture."""
    return torch.tensor(BO_OFFSETS, dtype=torch.int32, device=device)


class BoState(NamedTuple):
    r_page: torch.Tensor    # (*B, RECENT_ENTRIES) recent access pages (+1; 0 empty)
    r_block: torch.Tensor   # (*B, RECENT_ENTRIES) recent in-page blocks
    ptr: torch.Tensor       # (*B,) ring pointer
    scores: torch.Tensor    # (*B, len(BO_OFFSETS)) current-round scores
    best: torch.Tensor      # (*B,) winning offset (0 = untrained/disabled)
    round: torch.Tensor     # (*B,) accesses into the current round


class BestOffsetPrefetch:
    """Best-Offset-style scoring: each trained access tests every candidate
    offset ``o`` against the recent-access ring (did ``block - o`` on the
    same page happen recently?); after ``round_len`` accesses the
    best-scoring offset (the first of equal scores) wins if it clears
    ``score_threshold``, else the prefetcher disables itself until a later
    round."""

    kind = "prefetch"
    name = "bestoffset"
    compile_tag = "prefetch:bestoffset"

    def params_of(self, cfg):
        return {"round_len": torch.tensor(64.0, dtype=torch.float32),
                "score_threshold": torch.tensor(8.0, dtype=torch.float32)}

    def init(self, cfg, batch, device):
        b = tuple(batch)
        z = lambda *s: torch.zeros(b + s, dtype=torch.int32, device=device)
        return BoState(r_page=z(RECENT_ENTRIES), r_block=z(RECENT_ENTRIES),
                       ptr=z(), scores=z(len(BO_OFFSETS)), best=z(), round=z())

    def train(self, cfg, pol, state, page, block, enable):
        en = torch.as_tensor(enable, device=page.device).expand(page.shape)
        eni = en.to(torch.int32)
        page = page.to(torch.int32)
        block = block.to(torch.int32)
        offs = _bo_offsets(page.device)
        src = block[..., None] - offs                              # (*B, K)
        seen = (state.r_page[..., None, :] == (page + 1)[..., None, None]) & \
            (state.r_block[..., None, :] == src[..., None])         # (*B, K, R)
        scores = state.scores + seen.any(-1).to(torch.int32) * eni[..., None]
        rnd = state.round + eni
        done = rnd >= pol["round_len"].to(torch.int32)
        best_i = scores.argmax(-1, keepdim=True)                   # first max
        winner = torch.where(
            scores.gather(-1, best_i).squeeze(-1) >=
            pol["score_threshold"].to(torch.int32),
            offs[best_i.squeeze(-1)], 0)
        best = torch.where(done, winner, state.best)
        scores = torch.where(done[..., None], 0, scores)
        rnd = torch.where(done, 0, rnd)
        ptr = state.ptr.to(torch.int64)[..., None]
        r_page = state.r_page.scatter(-1, ptr, torch.where(
            en, page + 1, state.r_page.gather(-1, ptr).squeeze(-1))[..., None])
        r_block = state.r_block.scatter(-1, ptr, torch.where(
            en, block, state.r_block.gather(-1, ptr).squeeze(-1))[..., None])
        ptr = (state.ptr + eni) % RECENT_ENTRIES
        return BoState(r_page, r_block, ptr, scores, best, rnd), None

    def predict(self, cfg, pol, state, page, block, ctx, degree, bpp):
        return _offset_candidates(page, block, state.best, state.best != 0,
                                  degree, bpp)


SPP = register(SppPrefetch())
NEXTLINE = register(NextLinePrefetch())
BESTOFFSET = register(BestOffsetPrefetch())
