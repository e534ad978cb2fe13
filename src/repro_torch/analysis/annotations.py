"""Source-level annotations the analyzer recognizes.

Counterpart of ``repro.analysis.annotations``. Dependency-free on
purpose: simulator modules import these markers, so this module must
never import torch or the rest of ``repro_torch.analysis``.
"""
from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def host_metric(fn: F) -> F:
    """Declare ``fn`` a *host-side metrics* function: it runs on numpy
    arrays already fetched from the device (after the runner's
    synchronize and the executor's fetch), never inside the captured
    window, so Python control flow and scalar coercion are intentional
    there.

    The analyzer excludes ``@host_metric`` functions from the TC/HS
    (tensor-control-flow / host-sync) checks, by *name* at the AST
    level; the decorator itself is an identity function. Using it on
    anything reachable from the captured step would be a bug: the
    annotation is a claim, and the claim is what reviewers check.
    """
    fn.__host_metric__ = True
    return fn
