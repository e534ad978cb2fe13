"""DRAM-cache prefetch policies (paper §III-A).

Counterpart of ``repro.policies.prefetch``: ``spp``, the paper's Signature
Path Prefetcher, delegating to :mod:`repro_torch.core.spp`. ``nextline``
and ``bestoffset`` are not ported yet.
"""
from __future__ import annotations

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


SPP = register(SppPrefetch())
