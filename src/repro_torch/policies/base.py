"""Policy registry and the :class:`PolicySet` value object.

Counterpart of ``repro.policies.base``. The simulator's four decision
points — DRAM-cache prefetcher, FAM-controller scheduler, cache
replacement, compute-node rate adaptation — are registered by name and
selected through a frozen, hashable :class:`PolicySet`. Each policy's
numeric knobs are tensors on ``FamParams.policy`` (``{kind: {param:
tensor}}``), one value per simulated system.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

POLICY_KINDS = ("prefetch", "scheduler", "replacement", "adaptation")


@dataclass(frozen=True)
class SimFlags:
    """Feature toggles of the simulator API. ``core_prefetch`` /
    ``dram_prefetch`` / ``bw_adapt`` / ``all_local`` are per-system gates;
    ``wfq`` / ``wfq_weight`` select the scheduler policy through
    :meth:`PolicySet.from_flags`."""

    core_prefetch: bool = True
    dram_prefetch: bool = True
    bw_adapt: bool = False
    wfq: bool = False
    wfq_weight: int = 2
    all_local: bool = False


_REGISTRY: Dict[str, Dict[str, Any]] = {k: {} for k in POLICY_KINDS}


def register(policy):
    """Register a policy instance under ``(policy.kind, policy.name)``."""
    if policy.kind not in _REGISTRY:
        raise ValueError(f"unknown policy kind {policy.kind!r} "
                         f"(kinds: {POLICY_KINDS})")
    _REGISTRY[policy.kind][policy.name] = policy
    return policy


def get_policy(kind: str, name: str):
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        raise KeyError(
            f"no {kind!r} policy named {name!r}; available: "
            f"{available(kind)}") from None


def available(kind: str) -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY[kind]))


class ResolvedPolicies(NamedTuple):
    """The four implementation objects a :class:`PolicySet` names."""

    prefetch: Any
    scheduler: Any
    replacement: Any
    adaptation: Any


@dataclass(frozen=True)
class PolicySet:
    """One named policy per decision point + numeric-param overrides
    (``overrides`` maps a kind to ``(param, value)`` pairs applied over the
    policy's ``params_of(cfg)`` defaults)."""

    prefetch: str = "spp"
    scheduler: str = "fifo"
    replacement: str = "lru"
    adaptation: str = "token_bucket"
    overrides: Tuple[Tuple[str, Tuple[Tuple[str, float], ...]], ...] = ()

    def impl(self, kind: str):
        return get_policy(kind, getattr(self, kind))

    def impls(self) -> ResolvedPolicies:
        return ResolvedPolicies(*(self.impl(k) for k in POLICY_KINDS))

    def compile_tags(self) -> Tuple[str, ...]:
        """One tag per kind: policies that run one program share a tag
        (``fifo`` and ``wfq`` are both ``scheduler:chain``). The planner
        keys compile groups on it."""
        return tuple(self.impl(k).compile_tag for k in POLICY_KINDS)

    def numeric_params(self, cfg) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{kind: {param: 0-d CPU tensor}}``: defaults from each policy's
        ``params_of(cfg)`` with ``overrides`` applied (cast to the default
        leaf's dtype)."""
        ov = dict((k, dict(v)) for k, v in self.overrides)
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for kind in POLICY_KINDS:
            params = dict(self.impl(kind).params_of(cfg))
            for name, value in ov.pop(kind, {}).items():
                if name not in params:
                    raise ValueError(
                        f"{kind} policy {getattr(self, kind)!r} has no "
                        f"numeric param {name!r}; schema: {sorted(params)}")
                params[name] = torch.tensor(value, dtype=params[name].dtype)
            out[kind] = params
        if ov:
            raise ValueError(f"overrides for unknown policy kinds: "
                             f"{sorted(ov)} (kinds: {POLICY_KINDS})")
        return out

    def override(self, kind: str, **values) -> "PolicySet":
        """A copy with ``values`` merged into ``kind``'s param overrides;
        names are checked against the chosen policy's schema here."""
        if kind not in POLICY_KINDS:
            raise ValueError(f"unknown policy kind {kind!r}")
        from repro_torch.configs.base import FamConfig
        schema = set(self.impl(kind).params_of(FamConfig()))
        bad = sorted(set(values) - schema)
        if bad:
            raise ValueError(
                f"{kind} policy {getattr(self, kind)!r} has no numeric "
                f"param(s) {bad}; valid params: {sorted(schema)}")
        merged = dict((k, dict(v)) for k, v in self.overrides)
        merged.setdefault(kind, {}).update(values)
        canon = tuple(sorted(
            (k, tuple(sorted(v.items()))) for k, v in merged.items() if v))
        return replace(self, overrides=canon)

    def describe(self) -> str:
        return "+".join(getattr(self, k) for k in POLICY_KINDS)

    @classmethod
    def from_flags(cls, flags: Optional[SimFlags]) -> "PolicySet":
        """``wfq=True`` selects the ``wfq`` scheduler (``wfq_weight`` becomes
        its ``weight`` param); everything else is the default set."""
        if flags is None:
            flags = SimFlags()
        ps = cls(scheduler="wfq" if flags.wfq else "fifo")
        return ps.override("scheduler", weight=float(flags.wfq_weight))


#: The paper's default configuration: SPP prefetching, FIFO service order,
#: LRU replacement, token-bucket MIMD rate adaptation.
DEFAULT_POLICY_SET = PolicySet()
