"""Batched set-associative probe of the tiering runtime's cache metadata
(hash -> tag row -> compare) as one CUDA kernel launch (:mod:`kernel`),
with its plain PyTorch version in :mod:`ref` and the dispatcher in
:mod:`ops`."""
from repro_torch.kernels.cache_lookup.kernel import build, cache_lookup
from repro_torch.kernels.cache_lookup.ops import lookup
from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref, set_index_ref

__all__ = ["build", "cache_lookup", "cache_lookup_ref", "lookup", "set_index_ref"]
