"""Compile-key planner: resolve a point list into compile groups.

Counterpart of ``repro.experiments.plan``: the same keys, buckets, groups
and ``describe()``. A compile group is one batched runner of
:mod:`repro_torch.core.famsim` (on the card one CUDA graph capture of its
step, replayed over the events), where the reference has one AOT-compiled
XLA executable. Group *membership* keys on

* ``cfg.geometry_free_shape()`` — table/queue sizes and degrees, the part
  no padding can unify (``kernel_backend`` among them: ``"cuda"`` or
  ``"torch"`` here, where the reference's says ``"xla"`` or ``"pallas"``);
* the ``PolicySet`` compile tags — policy *choice* is a different program
  and splits the group, except where policies share one (``fifo``/``wfq``
  both tag ``scheduler:chain``); policy numeric params never key anything;
* ``num_nodes`` — the per-system node width;
* ``T_bucket`` — true lengths round UP to a geometric grid (1024, 1536,
  2048, 3072, ...) so mixed-T experiments share a group; the group then
  runs at ``t_pad``, the max true T of its members, and the runner masks
  any padded tail out exactly (``famsim.GroupRunner``).

Each group's final ``CompileKey.static_shape`` re-adds the PADDED geometry
``(pad_sets, pad_ways)``: the cache state is allocated at the group's
largest swept geometry and each system's effective geometry rides in its
``FamParams``, bit-exactly. The system axis S pads to a canonical width
(``s_bucket``: quarter-geometric grid, <= 25 % pad) by repeating the last
member; systems share no state, so padded ones are inert and dropped.
Group membership and order are deterministic functions of the point list
(first-appearance order).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.experiments.spec import ResolvedPoint
from repro_torch.traces.backend import DEFAULT_BACKEND, validate_backend


class CompileKey(NamedTuple):
    """Everything that decides one group runner (one compiled program).

    ``static_shape`` is ``(pad_sets, pad_ways) + geometry_free_shape`` for
    a group key; :func:`point_key` returns the *membership* key, whose
    ``static_shape`` is the geometry-free shape alone (padding is a group
    property, computed after membership is known).
    """

    static_shape: Tuple
    num_nodes: int
    t_bucket: int


def t_bucket(T: int) -> int:
    """Smallest canonical trace length >= T (NEVER truncates).

    Canonical lengths are the geometric grid {1024, 1536} * 2^k — the
    worst-case pad overhead is 50 % and any two lengths within ~1.5x of
    each other share a bucket (and therefore a group runner).
    """
    if T <= 0:
        raise ValueError(f"trace length must be positive, got {T}")
    b = 1024
    while True:
        if T <= b:
            return b
        if T <= b + b // 2:
            return b + b // 2
        b *= 2


def s_bucket(S: int) -> int:
    """Smallest canonical system-axis width >= S (never shrinks).

    Canonical widths are the quarter-geometric grid {4, 5, 6, 7} * 2^k
    (plus 1, 2, 3): worst-case pad overhead is 25 %, and any two point
    counts within ~1.25x share a width. Padded systems repeat the group's
    last member and their results are dropped (systems share no state, so
    the padding is inert by construction).
    """
    if S <= 0:
        raise ValueError(f"system count must be positive, got {S}")
    if S <= 4:
        return S
    b = 4
    while True:
        for m in (4, 5, 6, 7):
            c = b * m // 4
            if S <= c:
                return c
        b *= 2


@dataclass(frozen=True)
class CompileGroup:
    """All points sharing one group runner.

    ``key.t_bucket`` is the canonical bucket that decided *membership*;
    ``t_pad`` is the length actually executed — the group's max true T —
    so a uniform-T group pays ZERO time padding. ``s_pad`` is the
    canonical system-axis width the group executes at (>= ``size``), and
    ``pad_sets``/``pad_ways`` the shared cache allocation (the max
    effective geometry over the members, echoed in
    ``key.static_shape[:2]``).
    """

    key: CompileKey
    indices: Tuple[int, ...]        # into Plan.points, first-appearance order
    t_pad: int = 0
    s_pad: int = 0
    pad_sets: int = 0
    pad_ways: int = 0

    @property
    def size(self) -> int:
        return len(self.indices)


@dataclass(frozen=True)
class Plan:
    """A resolved execution plan: points + their compile grouping.

    ``trace_backend`` (``"device"`` or ``"numpy"``, see
    :mod:`repro_torch.traces.backend`) is carried on the plan — an *execution*
    choice the spec selects — but deliberately NOT part of any
    :class:`CompileKey`: group membership, order, and padding are
    identical for both backends, so switching backend never changes the
    plan shape (only which generator feeds the group runner).
    """

    points: Tuple[ResolvedPoint, ...]
    groups: Tuple[CompileGroup, ...]
    name: str = ""
    trace_backend: str = DEFAULT_BACKEND

    @property
    def num_points(self) -> int:
        return len(self.points)

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def events(self) -> int:
        """Total true simulated events (sum over points of N * T)."""
        return sum(len(p.workloads) * p.T for p in self.points)

    def padded_events(self) -> int:
        """Extra events paid to T-bucketing AND S-padding:
        sum over groups of s_pad * N * t_pad minus the true events."""
        total = 0
        for g in self.groups:
            true = sum(len(self.points[i].workloads) * self.points[i].T
                       for i in g.indices)
            total += g.s_pad * g.key.num_nodes * g.t_pad - true
        return total

    def padded_systems(self) -> int:
        """Inert systems added to reach canonical S widths."""
        return sum(g.s_pad - g.size for g in self.groups)

    def describe(self) -> List[dict]:
        """JSON-able per-group summary (deterministic)."""
        out = []
        for g in self.groups:
            true = sum(len(self.points[i].workloads) * self.points[i].T
                       for i in g.indices)
            exec_events = g.s_pad * g.key.num_nodes * g.t_pad
            out.append({
                "static_shape": str(g.key.static_shape),
                "N": g.key.num_nodes, "T_pad": g.t_pad,
                "S": g.size, "S_pad": g.s_pad,
                "pad_sets": g.pad_sets, "pad_ways": g.pad_ways,
                "pad_overhead": round(exec_events / max(true, 1) - 1.0, 3),
            })
        return out


def point_key(pt: ResolvedPoint,
              bucket=t_bucket) -> CompileKey:
    """The *membership* key of one point: geometry-free static shape +
    the policy compile tags + node count + T bucket. The group's final
    key re-adds the padded geometry once membership is known (see
    :func:`plan_points`).

    Policy *choice* is static — a different prefetcher/scheduler/
    replacement/adaptation program splits the group — but policies
    engineered to fuse share a compile tag (``fifo``/``wfq`` both tag
    ``scheduler:chain``), and policy *numeric params* (weights,
    thresholds, rates) are ``FamParams.policy`` tensors that never appear
    here, so a FIFO baseline plus every WFQ weight still shares one
    group.
    """
    tags = pt.policy_set().compile_tags()
    return CompileKey(pt.cfg.geometry_free_shape() + tags,
                      len(pt.workloads), bucket(pt.T))


def plan_points(points: Sequence[ResolvedPoint], *, name: str = "",
                bucket: Optional[object] = t_bucket,
                s_bucket: Optional[object] = s_bucket,
                trace_backend: str = DEFAULT_BACKEND) -> Plan:
    """Group ``points`` by membership key, preserving first-appearance
    order, then pad each group's cache allocation to its max effective
    geometry and its system axis to the canonical width.

    ``bucket=None`` disables T-bucketing (each true T keys its own group);
    ``s_bucket=None`` disables S-padding (groups execute at their exact
    size) — both useful for exactness tests and tiny one-off runs.
    ``trace_backend`` rides on the plan (never in a compile key — see
    :class:`Plan`).
    """
    bucket_fn = bucket if bucket is not None else (lambda T: T)
    s_fn = s_bucket if s_bucket is not None else (lambda S: S)
    groups: Dict[CompileKey, List[int]] = {}
    order: List[CompileKey] = []
    for i, pt in enumerate(points):
        key = point_key(pt, bucket_fn)
        if key.t_bucket < pt.T:
            raise ValueError(
                f"bucket {key.t_bucket} would truncate T={pt.T}")
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(i)

    built = []
    for k in order:
        idxs = groups[k]
        pad_sets = max(points[i].cfg.num_sets for i in idxs)
        pad_ways = max(points[i].cfg.cache_ways for i in idxs)
        built.append(CompileGroup(
            key=CompileKey((pad_sets, pad_ways) + k.static_shape,
                           k.num_nodes, k.t_bucket),
            indices=tuple(idxs),
            t_pad=max(points[i].T for i in idxs),
            s_pad=s_fn(len(idxs)),
            pad_sets=pad_sets, pad_ways=pad_ways))
    return Plan(points=tuple(points), groups=tuple(built), name=name,
                trace_backend=validate_backend(trace_backend))
