"""The tiering runtime's cache metadata on the card: the batched
set-associative probe (hash -> tag row -> compare) as one CUDA kernel
launch, and the whole tier access (demand probes, touches and fills, SPP
training, DWRR and prefetch fills) as a chain kernel and a copy kernel
(:mod:`kernel`); the probe's plain PyTorch version is in :mod:`ref` and
its dispatcher in :mod:`ops`; the access's plain version is
``TieredBlockPool._access_torch``, and the pool routes between the two."""
from repro_torch.kernels.cache_lookup.kernel import build, cache_lookup, tier_access
from repro_torch.kernels.cache_lookup.ops import lookup
from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref, set_index_ref

__all__ = ["build", "cache_lookup", "cache_lookup_ref", "lookup",
           "set_index_ref", "tier_access"]
