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
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

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


#: ``(kind, policy name) -> sorted param names``: ``params_of`` keys do not
#: depend on the config, so each policy is probed once
_SCHEMA_CACHE: Dict[Tuple[str, str], Tuple[str, ...]] = {}


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

    def param_schema(self, kind: str) -> Tuple[str, ...]:
        """The numeric-param names of ``kind``'s chosen policy (the keys of
        its ``params_of``), cached per policy."""
        if kind not in POLICY_KINDS:
            raise ValueError(f"unknown policy kind {kind!r} "
                             f"(kinds: {POLICY_KINDS})")
        impl = self.impl(kind)
        cached = _SCHEMA_CACHE.get((kind, impl.name))
        if cached is None:
            from repro_torch.configs.base import FamConfig
            cached = tuple(sorted(impl.params_of(FamConfig())))
            _SCHEMA_CACHE[(kind, impl.name)] = cached
        return cached

    def override(self, kind: str, **values) -> "PolicySet":
        """A copy with ``values`` merged into ``kind``'s param overrides;
        names are checked against :meth:`param_schema` here."""
        if kind not in POLICY_KINDS:
            raise ValueError(f"unknown policy kind {kind!r}")
        schema = self.param_schema(kind)
        bad = sorted(set(values) - set(schema))
        if bad:
            raise ValueError(
                f"{kind} policy {getattr(self, kind)!r} has no numeric "
                f"param(s) {bad}; valid params: {list(schema)}")
        merged = dict((k, dict(v)) for k, v in self.overrides)
        merged.setdefault(kind, {}).update(values)
        canon = tuple(sorted(
            (k, tuple(sorted(v.items()))) for k, v in merged.items() if v))
        return replace(self, overrides=canon)

    def as_dict(self) -> Dict[str, Any]:
        """JSON-able form: the four policy names and the overrides as
        nested dicts (the search's candidate and ``best.json`` format);
        :meth:`from_dict` inverts it."""
        return {
            **{k: getattr(self, k) for k in POLICY_KINDS},
            "overrides": {k: dict(v) for k, v in self.overrides},
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PolicySet":
        """Inverse of :meth:`as_dict`; the overrides are validated again
        against the chosen policies' schemas."""
        unknown = set(d) - set(POLICY_KINDS) - {"overrides"}
        if unknown:
            raise ValueError(f"PolicySet.from_dict: unknown keys "
                             f"{sorted(unknown)}")
        ps = cls(**{k: str(d[k]) for k in POLICY_KINDS if k in d})
        for kind, params in dict(d.get("overrides", {})).items():
            ps = ps.override(kind, **params)
        return ps

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
