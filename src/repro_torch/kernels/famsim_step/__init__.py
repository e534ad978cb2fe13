"""Fused DRAM-cache step: one simulator event's cache work for every lane
— retire up to ``completions_per_step`` prefetch fills, probe + touch the
demand block, probe the prefetch-candidate and core-prefetch blocks — as
one CUDA kernel launch (:mod:`kernel`), with its plain PyTorch version in
:mod:`ref` and the dispatcher in :mod:`ops`."""
from repro_torch.kernels.famsim_step.kernel import build, fused_cache_step
from repro_torch.kernels.famsim_step.ops import (FUSED_REPLACEMENT_MODES,
                                                 cache_step,
                                                 fused_replacement_mode)
from repro_torch.kernels.famsim_step.ref import cache_step_ref

__all__ = ["FUSED_REPLACEMENT_MODES", "build", "cache_step", "cache_step_ref",
           "fused_cache_step", "fused_replacement_mode"]
