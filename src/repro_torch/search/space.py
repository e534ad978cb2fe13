r"""Declarative design spaces over the batched simulator.

Counterpart of ``repro.search.space``. A :class:`SearchSpace` is a tuple
of typed :class:`Dimension`\ s, each mapping a sampled value onto one knob
of an :class:`~repro_torch.experiments.Experiment` grid cell:

* ``policy_param(kind, param)`` — a numeric-param override on the
  candidate's :class:`~repro_torch.policies.PolicySet` (a ``FamParams.policy``
  tensor: moving it never changes the runner key);
* ``policy_choice(kind)``       — the policy *name* for one decision
  point (a compile tag: unless every choice shares a tag, like the
  ``fifo``/``wfq`` chain schedulers, a move changes the runner key);
* ``cfg_field(field)``          — a ``FamConfig`` override (a ``FamParams``
  value for the dynamic params and the cache geometry; part of the key for
  the geometry-free shape fields — table sizes, degrees, queue depths,
  ``kernel_backend``, ``telemetry`` — and ``num_nodes``);
* ``flag(field)``               — a ``SimFlags`` gate (always a ``FamParams``
  boolean).

:meth:`SearchSpace.split` classifies every dimension as *static* (a move
changes the planner's runner key: a new CUDA graph capture on the card) or
*traced* (a move lands in the same compile group, whose cached runner
replays its graph: free after the first generation), so proposers can
weigh moves by their capture cost (:mod:`repro_torch.search.proposers`).
The names follow the reference, where "static" means an XLA recompile.

Geometry caveat: ``cfg_field`` dimensions on the cache geometry
(``block_bytes`` / ``dram_cache_bytes`` / ``cache_ways``) ride
``FamParams``, but the planner pads each group's allocation to the
members' largest geometry: sampling above the experiment's base geometry
grows the padded allocation and changes the key. :meth:`SearchSpace.split`
classifies an up-sizing geometry dimension as static for that reason.

Sampling draws from a caller-supplied ``numpy.random.Generator`` (never
global state: the proposer loop owns and serializes the generator), and
every sampled value is a JSON primitive, so samples round-trip through
the trajectory file unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.configs.base import FamConfig
from repro_torch.policies import POLICY_KINDS, PolicySet, SimFlags, get_policy

#: FamConfig fields whose values are part of the runner key (the
#: geometry-free shape, see ``FamConfig.geometry_free_shape``) plus the
#: node count (the arbitration width ``N``). Everything else on
#: FamConfig rides as a ``FamParams`` tensor.
STATIC_CFG_FIELDS = frozenset({
    "prefetch_queue", "prefetch_degree", "spp_signature_bits",
    "spp_pattern_entries", "spp_signature_entries", "spp_max_lookahead",
    "core_pf_degree", "completions_per_step", "core_fill_entries",
    "num_nodes",
    # the cache-step implementation ("torch" / the hand-written "cuda"
    # kernel) builds a different step: bit-identical outputs, but a move
    # along it always captures a new graph
    "kernel_backend",
    # in-graph telemetry window count (repro_torch.obs): part of
    # geometry_free_shape() — turning it on (or changing the window
    # count) builds a different step function
    "telemetry",
})

#: traced cfg fields that still size the group's PADDED allocation:
#: sampling above the base config's value grows ``(pad_sets, pad_ways)``
#: and therefore the runner key (see module docstring).
GEOMETRY_CFG_FIELDS = frozenset({
    "block_bytes", "dram_cache_bytes", "cache_ways",
})


# -- targets ----------------------------------------------------------------

def policy_param(kind: str, param: str) -> Tuple[str, ...]:
    """Target a numeric-param override on the candidate PolicySet."""
    if kind not in POLICY_KINDS:
        raise ValueError(f"unknown policy kind {kind!r} "
                         f"(kinds: {POLICY_KINDS})")
    return ("policy_param", kind, param)


def policy_choice(kind: str) -> Tuple[str, ...]:
    """Target the policy *name* of one decision point (choices are
    registry names; static unless all choices share a compile tag)."""
    if kind not in POLICY_KINDS:
        raise ValueError(f"unknown policy kind {kind!r} "
                         f"(kinds: {POLICY_KINDS})")
    return ("policy", kind)


def cfg_field(field: str) -> Tuple[str, ...]:
    """Target a ``FamConfig`` field override."""
    if field not in {f.name for f in dataclasses.fields(FamConfig)}:
        raise ValueError(f"FamConfig has no field {field!r}")
    return ("cfg", field)


def flag(field: str) -> Tuple[str, ...]:
    """Target a ``SimFlags`` feature gate."""
    if field not in {f.name for f in dataclasses.fields(SimFlags)}:
        raise ValueError(f"SimFlags has no field {field!r}")
    return ("flag", field)


# -- dimensions -------------------------------------------------------------

@dataclass(frozen=True)
class Dimension:
    """One typed knob of the space. Use the :func:`continuous` /
    :func:`log_continuous` / :func:`integer` / :func:`categorical`
    constructors rather than building this directly."""

    name: str
    target: Tuple[str, ...]
    kind: str                       # continuous | int | categorical
    lo: float = 0.0
    hi: float = 0.0
    log: bool = False
    choices: Tuple[Any, ...] = ()

    def __post_init__(self):
        if self.kind in ("continuous", "int"):
            if not self.hi > self.lo:
                raise ValueError(
                    f"dimension {self.name!r}: need hi > lo, got "
                    f"[{self.lo}, {self.hi}]")
            if self.log and self.lo <= 0:
                raise ValueError(
                    f"dimension {self.name!r}: log scale needs lo > 0")
        elif self.kind == "categorical":
            if len(self.choices) < 2:
                raise ValueError(
                    f"dimension {self.name!r}: need >= 2 choices")
        else:
            raise ValueError(f"unknown dimension kind {self.kind!r}")

    # -- sampling / mutation (all randomness through the passed rng) -------

    def sample(self, rng) -> Any:
        if self.kind == "categorical":
            return self.choices[int(rng.integers(len(self.choices)))]
        if self.kind == "int":
            return int(rng.integers(int(self.lo), int(self.hi) + 1))
        if self.log:
            return float(math.exp(rng.uniform(math.log(self.lo),
                                              math.log(self.hi))))
        return float(rng.uniform(self.lo, self.hi))

    def mutate(self, value: Any, rng, scale: float = 0.2) -> Any:
        """A local move from ``value``: gaussian step at ``scale`` of the
        (log-)range for numeric dims, a fresh draw for categoricals."""
        if self.kind == "categorical":
            others = [c for c in self.choices if c != value]
            return others[int(rng.integers(len(others)))] if others \
                else value
        if self.log:
            span = math.log(self.hi) - math.log(self.lo)
            x = math.log(float(value)) + rng.normal(0.0, scale * span)
            return float(math.exp(min(max(x, math.log(self.lo)),
                                      math.log(self.hi))))
        span = self.hi - self.lo
        x = float(value) + rng.normal(0.0, scale * span)
        x = min(max(x, self.lo), self.hi)
        return int(round(x)) if self.kind == "int" else float(x)

    # -- static/traced classification --------------------------------------

    def is_static(self, base: Optional[FamConfig] = None) -> bool:
        """True when a move along this dimension changes the runner key
        (a new capture); False when it rides ``FamParams`` tensors."""
        t = self.target[0]
        if t in ("policy_param", "flag"):
            return False
        if t == "policy":
            kind = self.target[1]
            tags = {get_policy(kind, str(c)).compile_tag
                    for c in self.choices}
            return len(tags) > 1
        field = self.target[1]
        if field in STATIC_CFG_FIELDS:
            return True
        if field in GEOMETRY_CFG_FIELDS:
            # traced, but an up-sizing move grows the padded allocation
            # and changes the runner key (see module docstring)
            base = base or FamConfig()
            base_v = getattr(base, field)
            if self.kind == "categorical":
                return any(c > base_v for c in self.choices)
            return self.hi > base_v
        return False


def continuous(name: str, target: Tuple[str, ...], lo: float, hi: float,
               *, log: bool = False) -> Dimension:
    return Dimension(name=name, target=target, kind="continuous",
                     lo=float(lo), hi=float(hi), log=log)


def log_continuous(name: str, target: Tuple[str, ...], lo: float,
                   hi: float) -> Dimension:
    return continuous(name, target, lo, hi, log=True)


def integer(name: str, target: Tuple[str, ...], lo: int,
            hi: int) -> Dimension:
    return Dimension(name=name, target=target, kind="int",
                     lo=int(lo), hi=int(hi))


def categorical(name: str, target: Tuple[str, ...],
                choices) -> Dimension:
    return Dimension(name=name, target=target, kind="categorical",
                     choices=tuple(choices))


# -- the space --------------------------------------------------------------

@dataclass(frozen=True)
class SearchSpace:
    """A declarative design space: typed dimensions -> Experiment cells.

    ``base_policies`` / ``base_flags`` are the candidate defaults the
    dimensions perturb; the all-default baseline every search measures
    against uses them untouched.
    """

    dimensions: Tuple[Dimension, ...]
    base_policies: PolicySet = PolicySet()
    base_flags: SimFlags = SimFlags()

    def __post_init__(self):
        names = [d.name for d in self.dimensions]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate dimension names: {names}")
        by_target = [d.target for d in self.dimensions]
        if len(set(by_target)) != len(by_target):
            raise ValueError(f"duplicate dimension targets: {by_target}")

    def __iter__(self):
        return iter(self.dimensions)

    def __len__(self):
        return len(self.dimensions)

    def dim(self, name: str) -> Dimension:
        for d in self.dimensions:
            if d.name == name:
                return d
        raise KeyError(name)

    def sample(self, rng) -> Dict[str, Any]:
        """One candidate: ``{dimension name: JSON-primitive value}``."""
        return {d.name: d.sample(rng) for d in self.dimensions}

    def split(self, base: Optional[FamConfig] = None
              ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """``(static dimension names, traced dimension names)`` — which
        moves capture anew and which are free (see module docstring)."""
        static = tuple(d.name for d in self.dimensions if d.is_static(base))
        traced = tuple(d.name for d in self.dimensions
                       if not d.is_static(base))
        return static, traced

    def static_key(self, sample: Mapping[str, Any],
                   base: Optional[FamConfig] = None) -> Tuple:
        """The static coordinates of a sample — equal keys mean the two
        candidates share a compile group (their traced coordinates ride
        the same cached runner)."""
        return tuple((d.name, sample[d.name]) for d in self.dimensions
                     if d.is_static(base))

    def axis_fields(self, sample: Mapping[str, Any]) -> Dict[str, Any]:
        """The :class:`~repro_torch.experiments.AxisValue` field dict one sample
        maps to (consumed by ``repro_torch.experiments.grid_axis``): cfg
        overrides + the candidate PolicySet + the candidate SimFlags.

        Policy *choices* apply before policy-param overrides, so an
        override always validates against the chosen policy's schema.
        """
        missing = [d.name for d in self.dimensions if d.name not in sample]
        if missing:
            raise KeyError(f"sample is missing dimensions {missing}")
        pol = self.base_policies
        flags = self.base_flags
        cfg_over: Dict[str, Any] = {}
        ordered = sorted(self.dimensions,
                         key=lambda d: d.target[0] != "policy")
        for d in ordered:
            v = sample[d.name]
            t = d.target
            if t[0] == "policy":
                pol = dataclasses.replace(pol, **{t[1]: str(v)})
            elif t[0] == "policy_param":
                pol = pol.override(t[1], **{t[2]: v})
            elif t[0] == "cfg":
                cfg_over[t[1]] = v
            else:                                   # flag
                flags = dataclasses.replace(flags, **{t[1]: v})
        out: Dict[str, Any] = {"policies": pol, "flags": flags}
        if cfg_over:
            out["cfg"] = cfg_over
        return out

    def describe(self) -> Dict[str, Any]:
        """JSON-able space fingerprint (recorded in trajectory headers and
        checked on resume — a resumed search must use the same space)."""
        return {
            "dimensions": [
                {"name": d.name, "target": list(d.target), "kind": d.kind,
                 "lo": d.lo, "hi": d.hi, "log": d.log,
                 "choices": list(d.choices)}
                for d in self.dimensions],
            "base_policies": self.base_policies.as_dict(),
            "base_flags": dataclasses.asdict(self.base_flags),
        }
