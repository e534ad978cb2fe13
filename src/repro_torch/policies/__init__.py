"""Pluggable policy layer for the FAM simulator (counterpart of
``repro.policies``). Importing this package registers the ported zoo:

===========  =======================================
kind         policies
===========  =======================================
prefetch     ``spp`` (default)
scheduler    ``fifo`` (default), ``wfq``, ``strict``
replacement  ``lru`` (default), ``srrip``
adaptation   ``token_bucket`` (default), ``static``
===========  =======================================
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
