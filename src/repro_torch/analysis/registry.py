"""The authoritative static-vs-traced field registry — introspected.

Counterpart of ``repro.analysis.registry``, over the port's own classes
(``repro_torch.core.fam_params.FamParams``,
``repro_torch.configs.base.FamConfig``,
``repro_torch.policies.base.PolicySet``).

The compile-key purity checks need to know which field names are traced
``FamParams`` leaves and which are static configuration. Hand-writing
that list would rot the moment a field moves; instead the registry is
built by importing the real classes:

* ``FamParams._fields``                — the traced side (every leaf the
  executor stacks into the runner's parameter buffers, including the effective
  geometry ``num_sets``/``cache_ways``/``block_bits`` and the
  ``policy`` numeric-param pytree);
* ``dataclasses.fields(FamConfig)``    — static configuration (the
  geometry-free shape comes off these);
* ``dataclasses.fields(PolicySet)``    — static policy choice (compile
  tags).

Note the deliberate overlap: ``num_sets`` / ``cache_ways`` /
``block_bits`` appear on BOTH sides — as padded allocation shape on
``FamConfig`` and as the traced *effective* geometry on ``FamParams``.
That is why the CK101 check is receiver-sensitive (``cfg.num_sets`` in a
key is fine; ``params.num_sets`` is a violation), not name-only.

:func:`build_registry` also runs the runtime half of the CK family on
the real classes — frozen-ness and tag hashability — returning any
violation as ordinary findings (CK102/CK103) so ``python -m
repro_torch.analysis`` reports an un-frozen ``PolicySet`` exactly like a bad
line of source.
"""
from __future__ import annotations

import dataclasses
import inspect
from dataclasses import dataclass
from typing import FrozenSet, List, Tuple

from repro_torch.analysis.findings import Finding


@dataclass(frozen=True)
class Registry:
    traced_param_fields: FrozenSet[str]   # FamParams leaves (buffer tensors)
    static_config_fields: FrozenSet[str]  # FamConfig dataclass fields
    static_policy_fields: FrozenSet[str]  # PolicySet dataclass fields
    #: names on BOTH sides (padded static shape vs traced effective
    #: geometry) — the reason CK101 is receiver-sensitive
    overlap_fields: FrozenSet[str]
    compile_tags: Tuple[str, ...]         # DEFAULT_POLICY_SET tags


def _class_finding(cls, check: str, message: str, hint: str) -> Finding:
    try:
        path = inspect.getsourcefile(cls) or "<unknown>"
        line = inspect.getsourcelines(cls)[1]
    except (OSError, TypeError):
        path, line = "<unknown>", 0
    return Finding(check=check, path=path, line=line, col=0,
                   symbol=cls.__name__, message=message, hint=hint)


def build_registry() -> Tuple[Registry, List[Finding]]:
    """Introspect the live classes; returns (registry, runtime findings)."""
    from repro_torch.configs.base import FamConfig
    from repro_torch.core.fam_params import FamParams
    from repro_torch.policies import DEFAULT_POLICY_SET
    from repro_torch.policies.base import PolicySet

    findings: List[Finding] = []

    traced = frozenset(FamParams._fields)
    static_cfg = frozenset(f.name for f in dataclasses.fields(FamConfig))
    static_pol = frozenset(f.name for f in dataclasses.fields(PolicySet))

    for cls in (FamConfig, PolicySet):
        if not cls.__dataclass_params__.frozen:       # type: ignore[attr-defined]
            findings.append(_class_finding(
                cls, "CK103",
                f"{cls.__name__} is a non-frozen dataclass but participates "
                "in compile keys",
                "declare it @dataclass(frozen=True) so instances are "
                "hashable and immutable as cache keys"))

    try:
        hash(FamConfig())
    except TypeError as e:
        findings.append(_class_finding(
            FamConfig, "CK102",
            f"FamConfig() is unhashable ({e}) but is used as a cache key",
            "keep every FamConfig field a hashable Python value "
            "(tuples, not lists/arrays)"))

    tags: Tuple[str, ...] = ()
    try:
        tags = tuple(DEFAULT_POLICY_SET.compile_tags())
    except TypeError as e:
        findings.append(_class_finding(
            PolicySet, "CK102",
            f"PolicySet.compile_tags() failed to hash/tuple ({e})", ""))
    for t in tags:
        if not isinstance(t, str):
            findings.append(_class_finding(
                PolicySet, "CK102",
                f"compile tag {t!r} is not a string — tags join the "
                "planner's membership key and must be plain hashables",
                "make every policy's compile_tag a str"))

    return Registry(traced_param_fields=traced,
                    static_config_fields=static_cfg,
                    static_policy_fields=static_pol,
                    overlap_fields=traced & static_cfg,
                    compile_tags=tags), findings
