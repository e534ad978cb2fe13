"""Declarative experiment specs — the paper's figures as named axis grids.

Counterpart of ``repro.experiments.spec`` (the same classes, fields and
axis constructors, over the port's ``FamConfig``, ``SimFlags`` and
``PolicySet``).

An :class:`Experiment` is the user-facing object: a base :class:`FamConfig`,
defaults (T, seed, node count, flags), and a tuple of named :class:`Axis`
objects. Each axis value contributes a slice of the final configuration —
``FamConfig`` overrides, a :class:`SimFlags` variant, a workload (or an
explicit per-node workload tuple), a node count, T, or a seed — and the
grid is the Cartesian product of the axes.

``Experiment.points()`` resolves every grid cell into a
:class:`ResolvedPoint` (one simulated system) tagged with its axis
coordinates, ``Experiment.plan()`` groups the points into compile groups
(see ``repro_torch.experiments.plan``), and ``Experiment.run()`` executes the
plan and returns an :class:`~repro_torch.experiments.executor.ExperimentResult`
whose ``get(axis=label, ...)`` looks metrics up by coordinates.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.base import FamConfig, fam_replace
from repro_torch.policies import PolicySet, SimFlags
from repro_torch.traces.backend import DEFAULT_BACKEND


@dataclass(frozen=True)
class AxisValue:
    """One position along an axis: the configuration slice it contributes.

    ``cfg`` is a tuple of ``(field, value)`` pairs (kept as a tuple so the
    value is hashable) applied to the experiment's base ``FamConfig``;
    whether the swept field is a static shape parameter or a dynamic
    ``FamParams`` scalar is the *planner's* concern, not the spec's —
    and since the dynamic-geometry refactor even ``block_bytes`` /
    ``dram_cache_bytes`` / ``cache_ways`` sweeps plan into one padded
    compile group. ``policies`` selects a full
    :class:`~repro_torch.policies.PolicySet`; whether a policy combination
    shares a compile group is likewise the planner's concern (same
    compile tags share; a different traced program splits).
    """

    label: str
    cfg: Tuple[Tuple[str, Any], ...] = ()
    flags: Optional[SimFlags] = None
    workload: Optional[str] = None          # replicated over the node count
    workloads: Optional[Tuple[str, ...]] = None  # explicit per-node tuple
    nodes: Optional[int] = None
    T: Optional[int] = None
    seed: Optional[int] = None
    policies: Optional[PolicySet] = None
    #: live step count <= T: the point simulates only its first ``t_live``
    #: events through the masked runner's traced ``t_true`` input (the
    #: remaining steps are exact no-ops). Planner membership still keys on
    #: ``T`` — gating a point's lifetime never moves it between compile
    #: groups, which is what lets an admission controller throttle
    #: tenants without recompiling. None = fully live (t_live == T).
    t_live: Optional[int] = None


@dataclass(frozen=True)
class Axis:
    name: str
    values: Tuple[AxisValue, ...]

    def __post_init__(self):
        labels = [v.label for v in self.values]
        if len(set(labels)) != len(labels):
            raise ValueError(f"axis {self.name!r} has duplicate labels: "
                             f"{labels}")


# -- axis constructors for the common sweep kinds ---------------------------

def config_axis(name: str, values: Sequence[Any], param: Optional[str] = None,
                labels: Optional[Sequence[str]] = None) -> Axis:
    """Sweep one ``FamConfig`` field (static or dynamic — the planner sorts
    points into compile groups either way)."""
    param = param or name
    labels = [str(v) for v in values] if labels is None else list(labels)
    return Axis(name, tuple(AxisValue(label=lb, cfg=((param, v),))
                            for lb, v in zip(labels, values)))


def flag_axis(name: str, variants: Mapping[str, SimFlags]) -> Axis:
    """Sweep prefetcher/scheduler feature variants (always dynamic: every
    variant shares its group's compile)."""
    return Axis(name, tuple(AxisValue(label=k, flags=v)
                            for k, v in variants.items()))


def workload_axis(workloads: Sequence[str], name: str = "workload") -> Axis:
    """One single-application system per workload; the node count (from a
    ``nodes_axis`` or the experiment default) replicates it per node."""
    return Axis(name, tuple(AxisValue(label=w, workload=w)
                            for w in workloads))


def mix_axis(mixes: Mapping[str, Sequence[str]], name: str = "mix") -> Axis:
    """Explicit per-node workload tuples (paper Fig. 14 style mixes)."""
    return Axis(name, tuple(AxisValue(label=k, workloads=tuple(v))
                            for k, v in mixes.items()))


def nodes_axis(counts: Sequence[int], name: str = "nodes") -> Axis:
    return Axis(name, tuple(AxisValue(label=str(n), nodes=n)
                            for n in counts))


def seed_axis(seeds: Sequence[int], name: str = "seed") -> Axis:
    return Axis(name, tuple(AxisValue(label=str(s), seed=s) for s in seeds))


def grid_axis(name: str, values: Mapping[str, Mapping[str, Any]]) -> Axis:
    """Programmatic axis construction from plain dicts — one axis value
    per ``{label: fields}`` entry, where ``fields`` holds any subset of
    the :class:`AxisValue` fields (``cfg`` as a ``{field: value}`` dict,
    converted to the hashable sorted-tuple form; ``flags`` / ``policies``
    / ``workload`` / ``workloads`` / ``nodes`` / ``T`` / ``seed``
    verbatim). This is the bridge a programmatic driver (a search loop
    mapping sampled candidates onto grid cells) uses to build an
    Experiment without hand-rolling AxisValue tuples.
    """
    allowed = {"cfg", "flags", "workload", "workloads", "nodes", "T",
               "seed", "policies", "t_live"}
    out = []
    for label, fields in values.items():
        unknown = set(fields) - allowed
        if unknown:
            raise ValueError(
                f"grid_axis {name!r}, value {label!r}: unknown AxisValue "
                f"fields {sorted(unknown)} (allowed: {sorted(allowed)})")
        kw = dict(fields)
        cfg = kw.pop("cfg", None)
        if cfg:
            valid = {f.name for f in dataclasses.fields(FamConfig)}
            bad = set(cfg) - valid
            if bad:
                raise ValueError(
                    f"grid_axis {name!r}, value {label!r}: FamConfig has "
                    f"no field(s) {sorted(bad)}")
            kw["cfg"] = tuple(sorted(cfg.items()))
        if "workloads" in kw and kw["workloads"] is not None:
            kw["workloads"] = tuple(kw["workloads"])
        out.append(AxisValue(label=str(label), **kw))
    return Axis(name, tuple(out))


def policy_axis(variants: Mapping[str, PolicySet],
                name: str = "policy") -> Axis:
    """Sweep full policy combinations (``repro_torch.policies.PolicySet``).

    Policy *choice* is a compile-key input: combinations whose compile
    tags differ plan into separate groups (their traced programs differ),
    while same-tag combinations — ``fifo`` vs ``wfq``, or any
    numeric-param override — share one compile like a ``flag_axis``. An
    explicit PolicySet is authoritative for scheduler choice: the legacy
    ``SimFlags.wfq`` boolean is ignored wherever this axis applies.
    """
    return Axis(name, tuple(AxisValue(label=k, policies=v)
                            for k, v in variants.items()))


# -- resolved grid cells ----------------------------------------------------

@dataclass(frozen=True)
class ResolvedPoint:
    """One fully-resolved simulated system of an experiment grid.

    ``policies=None`` means "derive the PolicySet from the flags" — the
    SimFlags deprecation mapping (``wfq=True`` -> the ``wfq`` scheduler
    policy); an explicit set (from a ``policy_axis``) is authoritative.
    :meth:`policy_set` resolves either way and is what the planner and
    executor consume.
    """

    cfg: FamConfig
    flags: SimFlags
    workloads: Tuple[str, ...]
    T: int
    seed: int = 0
    coords: Tuple[Tuple[str, str], ...] = ()
    policies: Optional[PolicySet] = None
    #: live step count (see :class:`AxisValue`); None = fully live
    t_live: Optional[int] = None

    @property
    def num_nodes(self) -> int:
        return len(self.workloads)

    @property
    def t_true(self) -> int:
        """The step count this point actually simulates — what the
        executor feeds the masked runner's traced ``t_true`` input and
        what the true-events accounting charges. ``T`` stays the
        allocation/planning length (``t_live is None`` means fully
        live)."""
        return self.T if self.t_live is None else self.t_live

    def policy_set(self) -> PolicySet:
        if self.policies is not None:
            return self.policies
        return PolicySet.from_flags(self.flags)


@dataclass(frozen=True)
class Experiment:
    """A named grid of simulated systems over the FAM simulator."""

    name: str
    axes: Tuple[Axis, ...]
    base: FamConfig = field(default_factory=FamConfig)
    flags: SimFlags = field(default_factory=SimFlags)
    #: default PolicySet when no policy_axis sets one (None: derive from
    #: the flags — the SimFlags deprecation mapping)
    policies: Optional[PolicySet] = None
    workloads: Optional[Tuple[str, ...]] = None   # default when no axis sets one
    nodes: int = 1
    T: int = 10_000
    seed: int = 0
    #: Trace synthesis backend (see repro_torch.traces.backend): "device"
    #: generates each group's traces on the executing device (the default
    #: — zero host-side generation); "numpy" stages the host reference
    #: generators. An execution choice, never a compile key.
    trace_backend: str = DEFAULT_BACKEND

    def __post_init__(self):
        names = [a.name for a in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names: {names}")

    def points(self) -> Tuple[ResolvedPoint, ...]:
        """Resolve the Cartesian product of the axes, in axis-major order.

        Later axes' contributions override earlier ones where they collide
        (e.g. a per-value T over the experiment default).
        """
        out = []
        for combo in itertools.product(*(a.values for a in self.axes)):
            cfg, flags, pol = self.base, self.flags, self.policies
            # one workload source, overridden in axis order: ("single", w)
            # replicates over the node count, ("tuple", ws) is explicit
            wl = ("tuple", tuple(self.workloads)) if self.workloads else None
            nodes, T, seed = self.nodes, self.T, self.seed
            t_live = None
            for av in combo:
                if av.cfg:
                    cfg = fam_replace(cfg, **dict(av.cfg))
                if av.flags is not None:
                    flags = av.flags
                if av.policies is not None:
                    pol = av.policies
                if av.workload is not None:
                    wl = ("single", av.workload)
                if av.workloads is not None:
                    wl = ("tuple", tuple(av.workloads))
                if av.nodes is not None:
                    nodes = av.nodes
                if av.T is not None:
                    T = av.T
                if av.seed is not None:
                    seed = av.seed
                if av.t_live is not None:
                    t_live = av.t_live
            workloads = None
            if wl is not None:
                workloads = (wl[1],) * nodes if wl[0] == "single" else wl[1]
            if not workloads:
                raise ValueError(
                    f"experiment {self.name!r}: no workload for cell "
                    f"{[av.label for av in combo]} — add a workload/mix "
                    "axis or set Experiment.workloads")
            if t_live is not None and not 0 <= t_live <= T:
                raise ValueError(
                    f"experiment {self.name!r}: t_live={t_live} out of "
                    f"range for T={T} at cell "
                    f"{[av.label for av in combo]} (need 0 <= t_live <= T)")
            coords = tuple((ax.name, av.label)
                           for ax, av in zip(self.axes, combo))
            out.append(ResolvedPoint(cfg=cfg, flags=flags,
                                     workloads=workloads, T=T, seed=seed,
                                     coords=coords, policies=pol,
                                     t_live=t_live))
        return tuple(out)

    def plan(self, **kw):
        from repro_torch.experiments.plan import plan_points
        kw.setdefault("trace_backend", self.trace_backend)
        return plan_points(self.points(), name=self.name, **kw)

    def run(self, *, plan_kw: Optional[dict] = None, **execute_kw):
        """Plan and execute; ``execute_kw`` goes to
        :func:`~repro_torch.experiments.executor.execute` (``device``
        among them, ``"cuda"`` by default)."""
        from repro_torch.experiments.executor import execute
        from repro_torch.obs.spans import maybe_span
        with maybe_span("plan", experiment=self.name):
            plan = self.plan(**(plan_kw or {}))
        return execute(plan, **execute_kw)
