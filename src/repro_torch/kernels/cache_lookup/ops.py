"""Backend dispatch for the cache lookup: ``backend="cuda"`` (the default)
goes through the CUDA wrapper, which runs its plain version on CPU
tensors; ``backend="torch"`` runs the plain version on any device."""
from __future__ import annotations

from repro_torch.configs.base import KERNEL_BACKENDS
from repro_torch.kernels.cache_lookup.kernel import cache_lookup
from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref


def lookup(tags, queries, backend: str = "cuda"):
    if backend == "torch":
        return cache_lookup_ref(tags, queries)
    if backend != "cuda":
        raise ValueError(f"unknown kernel backend {backend!r}; expected one "
                         f"of {KERNEL_BACKENDS}")
    return cache_lookup(tags, queries)
