"""Pluggable policy layer for the FAM simulator (counterpart of
``repro.policies``). Importing this package registers the ported zoo:

===========  =============================================
kind         policies
===========  =============================================
prefetch     ``spp`` (default), ``nextline``, ``bestoffset``
scheduler    ``fifo`` (default), ``wfq``, ``strict``
replacement  ``lru`` (default), ``random``, ``srrip``
adaptation   ``token_bucket`` (default), ``static``
===========  =============================================

``random`` replacement runs on ``kernel_backend="torch"`` only: the CUDA
cache step bakes the policy in as a mode (lru, srrip) and raises for it.
"""
from repro_torch.policies.base import (  # noqa: F401
    DEFAULT_POLICY_SET,
    POLICY_KINDS,
    PolicySet,
    ResolvedPolicies,
    SimFlags,
    available,
    get_policy,
    register,
)
from repro_torch.policies import adaptation  # noqa: F401  (registers the zoo)
from repro_torch.policies import prefetch  # noqa: F401
from repro_torch.policies import replacement  # noqa: F401
from repro_torch.policies import scheduler  # noqa: F401
