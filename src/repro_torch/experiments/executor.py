"""Plan executor: one batched simulator call per compile group.

Counterpart of ``repro.experiments.executor``. One
:class:`~repro_torch.experiments.plan.CompileGroup` is one call of a
:class:`repro_torch.core.famsim.GroupRunner` over the group's systems: the
cache allocated at the group's padded ``(pad_sets, pad_ways)`` geometry
with each system's own geometry masking it down (bit-exact), the system
axis padded to the group's canonical ``s_pad`` width by repeating the last
member (inert: systems share no state, and the padded systems' results are
dropped), every system run at the group's ``t_pad`` with its padded tail
masked out. On the card the runner captures one window of steps in a CUDA
graph and replays it over the events: that capture stands in for the
reference's AOT-compiled executable, and its seconds are the group's
compile seconds.

Runners are cached for the life of the process by the group's runner key
(:func:`_exec_key`) and device, as the reference caches its executables:
a later group with an equal key, in the same ``execute`` or a later one,
refills the cached runner's buffers and replays its graph, with no
capture. ``RunInfo`` counts the lookups (``exec_cache_hits`` /
``exec_cache_misses``), the groups whose runner predated the call
(``groups_reused``) and the captures (``compiles``).

Traces come from the plan's backend (:mod:`repro_torch.traces.backend`):

* ``device`` (default) — each group's traces are generated on the group's
  device at ``t_pad`` by :mod:`repro_torch.traces.device` and fed straight
  to the runner; no trace is generated on the host
  (``RunInfo.host_trace_events == 0``);
* ``numpy`` — the host generators; generation for group i+1 overlaps the
  simulation of group i (one worker thread), and trace arrays are memoized
  per ``(workload, T, node_seed)``.

Either way ``ResolvedPoint.seed`` threads into ``node_seed(seed, node)``.

With a :mod:`repro_torch.obs.spans` tracer installed, ``execute`` wraps
its phases in the reference's spans: ``execute`` around the call,
``trace_stage`` per group (on the staging thread's own lane when it
overlaps), ``run`` per group and inside it ``device_call`` (the runner,
which on the card holds the ``compile`` span of its graph capture and
closes after the replays' synchronize) and ``fetch`` (the copy of the
metrics to the host); ``RunInfo.spans`` summarizes them.

With ``assert_compiles=True`` ``execute`` runs its groups under
:mod:`repro_torch.analysis.runtime`'s ``CompileWatcher`` and sync guard,
as the reference's does: every runner is named
``famsim_group__<key digest>``, the capture site reports each capture of
it, and ``RunInfo.xla_compiles`` (the reference's name) is the watcher's
count, asserted equal to ``compiles`` and at most ``planned_groups``;
any host sync inside the groups raises on the card but for the
executor's fetch of results and the runner's synchronize after its
replays (``explicit_fetch``), so uploads are asynchronous.

Sharding (``execute(devices=D)``, the reference's ``("shard", D)``
mode): each group's system axis is padded up the canonical grid until D
divides it (:func:`_pad_systems`) and split into D contiguous shards. On
``cuda`` shard i runs its own ``GroupRunner`` on ``cuda:i`` (its own
captured graph); on the CPU the D shards are virtual devices, as XLA's
host device count gives them, and run one after another. Shards run one
after another on the cards too, and their outputs are joined in order.
``devices`` defaults to the visible count of the device type
(``torch.cuda.device_count()`` on ``cuda``, 1 on the CPU); 1 runs the
plain batched mode (``"vmap"``). The mode is part of the runner key, and
the cache holds one runner per (key, shard device). ``cross_check_shard``
re-runs the first group through the other mode (``"vmap"`` against
``("shard", 1)``) and records the reference's ``shard_check``;
``cross_check_eager`` re-runs it step by step from the host and records
``eager_check``.
"""
from __future__ import annotations

import hashlib
import time
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import ExitStack
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.runtime import (GROUP_RUNNER_NAME, CompileWatcher,
                                          explicit_fetch, no_implicit_transfers)
from repro_torch.core import famsim
from repro_torch.core.fam_params import FamParams, stack_params, tree_map
from repro_torch.device import resolve_device
from repro_torch.experiments.plan import Plan, s_bucket
from repro_torch.experiments.spec import ResolvedPoint
from repro_torch.kernels.famsim_step import fused_cache_step
from repro_torch.obs.spans import current_tracer, maybe_span
from repro_torch.policies import DEFAULT_POLICY_SET
from repro_torch.traces import generate, node_seed
from repro_torch.traces.backend import DEFAULT_BACKEND, validate_backend


def _key_digest(key: Tuple) -> str:
    """Short stable digest of a group's runner key (tags its
    ``info.groups`` row)."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:8]


@dataclass
class RunInfo:
    """Wall-clock / capture accounting for one executed plan."""

    #: CUDA graph captures of group runners in this execute: one per runner
    #: cache miss on the card, none on a hit, none on the CPU
    compiles: int = 0
    planned_groups: int = 0        # deterministic, unlike ``compiles``
    #: captures of group runners the CompileWatcher saw under
    #: ``assert_compiles`` (the reference's count of XLA compiles of group
    #: executables); -1 without it
    xla_compiles: int = -1
    compile_s: float = 0.0         # seconds of those captures
    run_s: float = 0.0             # runner wall, captures and trace generation excluded
    #: runner-cache lookups of this execute, one per group: was the
    #: group's runner already cached (hit, its graph replayed) or new (miss)
    exec_cache_hits: int = 0
    exec_cache_misses: int = 0
    #: groups of this plan whose runner was cached before this execute
    groups_reused: int = 0
    #: wall of the whole execute (staging, generation, captures, runs;
    #: the cross-check excluded)
    wall_s: float = 0.0
    systems: int = 0
    events: int = 0                # true simulated events (sum N*t_true)
    padded_events: int = 0         # extra events paid to T/S padding
    padded_systems: int = 0        # inert systems added for canonical S
    devices: int = 1
    trace_backend: str = DEFAULT_BACKEND
    #: events actually generated on the host (memoized reuse is free,
    #: padded systems repeat real ones): 0 for the device backend
    host_trace_events: int = 0
    trace_gen_s: float = 0.0       # host trace/param staging wall-clock
    #: device trace generation seconds (synchronized; device backend)
    trace_device_s: float = 0.0
    groups: List[dict] = field(default_factory=list)
    #: ``cross_check_shard``'s record, with the reference's keys
    shard_check: Optional[dict] = None
    #: seconds of the shard cross-check's re-run (captures apart)
    shard_check_run_s: float = 0.0
    #: ``cross_check_eager``'s record: graph (or CPU steps) vs eager steps
    eager_check: Optional[dict] = None
    #: span summary ``{name: {count, total_s}}`` from the installed
    #: :mod:`repro_torch.obs.spans` tracer, covering this execute call
    #: only; None when no tracer is installed (the default)
    spans: Optional[dict] = None

    def us_per_call(self) -> float:
        if self.events <= 0:
            return 0.0
        return self.run_s / self.events * 1e6

    def as_dict(self) -> dict:
        d = {"compiles": self.compiles,
             "planned_groups": self.planned_groups,
             "compile_s": round(self.compile_s, 3),
             "run_s": round(self.run_s, 3),
             "exec_cache_hits": self.exec_cache_hits,
             "exec_cache_misses": self.exec_cache_misses,
             "groups_reused": self.groups_reused,
             "wall_s": round(self.wall_s, 3),
             "systems": self.systems, "events": self.events,
             "padded_events": self.padded_events,
             "padded_systems": self.padded_systems,
             "devices": self.devices,
             "trace_backend": self.trace_backend,
             "host_trace_events": self.host_trace_events,
             "trace_gen_s": round(self.trace_gen_s, 4),
             "trace_device_s": round(self.trace_device_s, 4),
             "us_per_event": round(self.us_per_call(), 4),
             "groups": self.groups}
        if self.xla_compiles >= 0:
            d["xla_compiles"] = self.xla_compiles
        if self.shard_check is not None:
            d["shard_check"] = self.shard_check
        if self.eager_check is not None:
            d["eager_check"] = self.eager_check
        if self.spans is not None:
            d["spans"] = self.spans
        return d


class ExperimentResult:
    """Per-point metrics + accounting, addressable by axis coordinates."""

    def __init__(self, points: Sequence[ResolvedPoint],
                 metrics: Sequence[Dict[str, np.ndarray]], info: RunInfo,
                 t_pads: Optional[Sequence[int]] = None):
        self.points = tuple(points)
        self.metrics = list(metrics)
        self.info = info
        #: per-point executed trace length (the group's t_pad) — what the
        #: device backend generated at; == pt.T unless the point rode a
        #: mixed-T group
        self.t_pads = tuple(t_pads) if t_pads is not None \
            else tuple(p.T for p in self.points)
        self._by_coords = {frozenset(p.coords): i
                           for i, p in enumerate(self.points)}
        self._by_point = {p: i for i, p in enumerate(self.points)}

    def metrics_for(self, pt: ResolvedPoint) -> Dict[str, np.ndarray]:
        """The point's metrics: (N,) per-node arrays and, when its config
        has telemetry on, its ``(n_windows, N_COUNTERS)`` ``"telemetry"``
        matrix."""
        return self.metrics[self._by_point[pt]]

    def t_pad_for(self, pt: ResolvedPoint) -> int:
        return self.t_pads[self._by_point[pt]]

    def get(self, **coords) -> Dict[str, np.ndarray]:
        """Metrics for the point at the given axis coordinates, e.g.
        ``result.get(block=256, workload="LU", variant="dram")``. Every
        axis must be specified; values are coerced to their string labels.
        """
        key = frozenset((k, str(v)) for k, v in coords.items())
        try:
            return self.metrics[self._by_coords[key]]
        except KeyError:
            raise KeyError(
                f"no point at {dict(coords)!r}; axes present: "
                f"{sorted({k for p in self.points for k, _ in p.coords})}"
            ) from None


# ---------------------------------------------------------------------------
# Trace assembly (host side, overlappable)
# ---------------------------------------------------------------------------

_TRACE_CACHE: Dict = {}


def store_traces(traces: Mapping[Tuple[str, int, int],
                                 Tuple[np.ndarray, np.ndarray]]) -> None:
    """Put node traces made elsewhere (inputs stored beside a golden file)
    into the numpy backend's memo, keyed ``(workload, T, node_seed)``:
    :func:`trace_arrays` and :func:`execute` then read them and generate
    nothing for those keys (``host_trace_events`` counts none of them)."""
    for (w, T, seed), (a, g) in traces.items():
        _TRACE_CACHE[(w, int(T), int(seed))] = (a, g)


def trace_arrays(workloads: Sequence[str], T: int, seed: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, T) numpy-backend node traces for one system; per-node seeds
    derive through ``node_seed`` (shared with ``famsim.simulate``),
    memoized."""
    pairs = []
    for i, w in enumerate(workloads):
        k = (w, T, node_seed(seed, i))
        if k not in _TRACE_CACHE:
            _TRACE_CACHE[k] = generate(w, T, node_seed(seed, i))
        pairs.append(_TRACE_CACHE[k])
    return (np.stack([a for a, _ in pairs]),
            np.stack([g for _, g in pairs]))


@dataclass
class _GroupData:
    """Host-side inputs of one compile group (S systems, padded).

    ``inputs`` is ``(addrs (S, N, T_pad) int32, gaps (S, N, T_pad)
    float32)`` for host-staged traces, or ``(TraceParams,)`` with leaves
    ``(S, N, ...)`` for traces generated on the device."""

    params: FamParams
    inputs: Tuple
    t_true: np.ndarray         # (S,) int32
    warm_start: np.ndarray     # (S,) int32
    host_trace_events: int = 0
    prep_s: float = 0.0


def _prepare(points: Sequence[ResolvedPoint], idxs: Sequence[int],
             t_pad: int, warmup_frac: float,
             trace_backend: str = "numpy") -> _GroupData:
    t0 = time.perf_counter()
    pts = [points[i] for i in idxs]
    N = len(pts[0].workloads)
    S = len(pts)
    host_events = 0
    if trace_backend == "device":
        from repro_torch.traces.device import stack_system_params, system_params
        inputs = (stack_system_params(
            [system_params(pt.workloads, pt.seed) for pt in pts]),)
    else:
        addrs = np.zeros((S, N, t_pad), np.int32)
        gaps = np.zeros((S, N, t_pad), np.float32)
        for j, pt in enumerate(pts):
            # count events actually GENERATED host-side (memoized reuse
            # is free — repeated points and inert padded lanes cost 0)
            host_events += sum(
                pt.T for i, w in enumerate(pt.workloads)
                if (w, pt.T, node_seed(pt.seed, i)) not in _TRACE_CACHE)
            a, g = trace_arrays(pt.workloads, pt.T, pt.seed)
            addrs[j, :, :pt.T] = a
            gaps[j, :, :pt.T] = g
        inputs = (addrs, gaps)
    params = stack_params([FamParams.of(pt.cfg, pt.flags, pt.policy_set(),
                                        device="cpu") for pt in pts])
    # pt.t_true == pt.T unless the point is lifetime-gated (t_live)
    t_true = np.array([pt.t_true for pt in pts], np.int32)
    # host-side int arithmetic, matching famsim._make_run's
    # ``int(T * warmup_frac)`` exactly
    warm_start = np.array([int(pt.t_true * warmup_frac) for pt in pts],
                          np.int32)
    return _GroupData(params, inputs, t_true, warm_start,
                      host_trace_events=host_events,
                      prep_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Group runners
# ---------------------------------------------------------------------------

def _mode(dev: torch.device) -> str:
    """How a group runs: a replayed CUDA graph on the card, steps on the CPU."""
    return "graph" if dev.type == "cuda" else "steps"


#: the batched execution mode: one device, the group's systems on the
#: leading axis (the reference's name); the sharded one is ``("shard", D)``
_BATCHED = "vmap"

#: ``(runner key, shard device, shard index) -> GroupRunner``, for the life
#: of the process
_EXEC_CACHE: Dict[Tuple, famsim.GroupRunner] = {}


def _exec_key(cfg, S: int, N: int, t_pad: int, mode, *,
              pad_sets: Optional[int] = None, pad_ways: Optional[int] = None,
              trace_backend: str = "numpy", policies=None) -> Tuple:
    """The runner key one group resolves to: a pure function of the plan
    (geometry-free shape + padded allocation + widths + execution mode +
    policy tags), the same on every device. Groups with equal keys run one
    program, so :func:`execute` caches one runner (and on the card its
    captured graph) per key and shard device, and every later group with
    that key replays it."""
    policies = policies or DEFAULT_POLICY_SET
    return (cfg.geometry_free_shape(), pad_sets or cfg.num_sets,
            pad_ways or cfg.cache_ways, S, N, t_pad, mode,
            trace_backend == "device", policies.compile_tags())


def _exec_mode(D: int):
    return ("shard", D) if D > 1 else _BATCHED


def _visible_devices(device) -> int:
    """The reference's ``len(jax.devices())``: the cards on ``cuda`` (1
    where there is none: planning touches no device), one device on the
    CPU."""
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def group_cache_keys(plan: Plan, *, devices: Optional[int] = None,
                     trace_backend: Optional[str] = None,
                     device="cuda") -> Tuple[Tuple, ...]:
    """The runner key each group of ``plan`` would resolve to under
    :func:`execute` on ``devices`` devices (default: those visible on
    ``device``; an explicit count needs no device), without running
    anything: two groups with equal keys share one cached runner, so a
    caller batching repeated sweeps (:mod:`repro_torch.search`) can tell
    beforehand which groups replay a cached graph and which capture one."""
    backend = validate_backend(trace_backend or plan.trace_backend)
    D = _visible_devices(device) if devices is None else devices
    keys = []
    for g in plan.groups:
        rep = plan.points[g.indices[0]]
        keys.append(_exec_key(
            rep.cfg, len(_pad_systems(g.indices, g.s_pad, D)),
            g.key.num_nodes, g.t_pad, _exec_mode(D), pad_sets=g.pad_sets,
            pad_ways=g.pad_ways, trace_backend=backend,
            policies=rep.policy_set()))
    return tuple(keys)


def cached_runners(plan: Plan, *, device="cuda") -> List[famsim.GroupRunner]:
    """The cached runner of each group of ``plan`` (its first shard's) once
    :func:`execute` has run the plan on ``device`` (raises KeyError for a
    group it has not run)."""
    dev = resolve_device(device)
    keys = group_cache_keys(plan, device=dev)
    return [_EXEC_CACHE[(key, _shard_devices(dev, key[6])[0], 0)] for key in keys]


def _clear_exec_cache() -> None:
    """Drop every cached runner (and its graph and buffers)."""
    _EXEC_CACHE.clear()


def exec_cache_bytes() -> int:
    """Device bytes the cached runners keep alive: buffers and graph pools."""
    return sum(r.nbytes() for r in _EXEC_CACHE.values())


def _sync(dev: torch.device):
    """An explicit synchronize, for the device trace generation's seconds."""
    if dev.type == "cuda":
        with explicit_fetch():
            torch.cuda.synchronize(dev)


def _upload(x, dev: torch.device) -> torch.Tensor:
    """A host array or tensor on ``dev``, copied without making the host
    wait for the device (from pageable memory the copy is staged before
    this returns, so the source may change afterwards)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(dev, non_blocking=True)


def _run_group(data: _GroupData, run, dev: torch.device, t_pad: int,
               trace_backend: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """One runner call on ``dev``. Returns (metrics of the S systems as
    numpy, accounting: capture seconds, run seconds, device trace
    generation seconds, cache-step kernel launches)."""
    p = tree_map(lambda t: _upload(t, dev), data.params)
    gen_s = 0.0
    if trace_backend == "device":
        from repro_torch.traces.device import node_generator, to_tensors
        _sync(dev)
        t0 = time.perf_counter()
        addrs, gaps = node_generator(t_pad)(to_tensors(data.inputs[0], dev))
        _sync(dev)
        gen_s = time.perf_counter() - t0
    else:
        addrs = _upload(data.inputs[0], dev)
        gaps = _upload(data.inputs[1], dev)
    t_true = _upload(data.t_true, dev)
    warm_start = _upload(data.warm_start, dev)
    famsim.last_graph.clear()
    launches = fused_cache_step.launches
    t0 = time.perf_counter()
    # on the card the runner synchronizes after its replays, so the span
    # closes on the device's work, not on its launches
    with maybe_span("device_call"):
        out = run(p, addrs, gaps, t_true, warm_start)
    with maybe_span("fetch"), explicit_fetch():
        out = {k: v.cpu().numpy() for k, v in out.items()}
    wall = time.perf_counter() - t0
    capture_s = famsim.last_graph.get("capture_s")
    return out, {"captured": capture_s is not None,
                 "capture_s": capture_s or 0.0,
                 "run_s": wall - (capture_s or 0.0), "trace_device_s": gen_s,
                 "launches": fused_cache_step.launches - launches}


def _shard_data(data: _GroupData, D: int) -> List[_GroupData]:
    """The group's inputs split into D contiguous lane shards."""
    S = len(data.t_true)
    w = S // D
    cut = lambda x, i: x[i * w:(i + 1) * w]
    out = []
    for i in range(D):
        inputs = tuple(type(x)(*(cut(f, i) for f in x)) if isinstance(x, tuple)
                       else cut(x, i) for x in data.inputs)
        out.append(_GroupData(tree_map(lambda t: cut(t, i), data.params), inputs,
                              cut(data.t_true, i), cut(data.warm_start, i)))
    return out


def _shard_devices(dev: torch.device, mode) -> List[torch.device]:
    """The device of each shard: ``dev`` for one shard, ``cuda:i`` for
    shard i of several on the cards, the CPU for every virtual shard on
    the CPU."""
    D = 1 if mode == _BATCHED else mode[1]
    if D == 1 or dev.type != "cuda":
        return [dev] * D
    if D > torch.cuda.device_count():
        raise ValueError(f"devices={D}: only {torch.cuda.device_count()} CUDA "
                         "device(s) visible")
    return [torch.device("cuda", i) for i in range(D)]


def _run_mode(data: _GroupData, key, mode, rep, g, dev: torch.device,
              trace_backend: str):
    """One group through ``mode``: the batched runner, or one runner a
    shard (cached per shard device), outputs joined in lane order.
    Returns (metrics, accounting summed over the shards, whether every
    runner came from the cache)."""
    devs = _shard_devices(dev, mode)
    shards = [data] if len(devs) == 1 else _shard_data(data, len(devs))
    outs, accts, hits = [], [], []
    for i, (shard, sdev) in enumerate(zip(shards, devs)):
        ckey = (key, sdev, i)
        run = _EXEC_CACHE.get(ckey)
        hits.append(run is not None)
        if run is None:
            # a sharded group's captures (one a card) report once, by its
            # first shard's runner: the reference's one SPMD executable
            run = famsim.GroupRunner(rep.cfg, g.key.num_nodes, g.pad_sets, g.pad_ways,
                                     policies=rep.policy_set(),
                                     name=_runner_name(key) if i == 0 else None)
        out, acct = _run_group(shard, run, sdev, g.t_pad, trace_backend)
        # cached once it has run, so a failed first run leaves nothing
        _EXEC_CACHE[ckey] = run
        outs.append(out)
        accts.append(acct)
    out = outs[0] if len(outs) == 1 else \
        {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    acct = {"captured": any(a["captured"] for a in accts)}
    for k in ("capture_s", "run_s", "trace_device_s", "launches"):
        acct[k] = sum(a[k] for a in accts)
    return out, acct, all(hits)


def _runner_name(key) -> str:
    """The name a group's runner reports its capture under."""
    return f"{GROUP_RUNNER_NAME}__{_key_digest(key)}"


def _pad_systems(idxs: Sequence[int], s_pad: int, D: int = 1) -> List[int]:
    """Pad the group's point-index list to the canonical S width, then,
    when sharding, further up the canonical grid until the device count
    divides it (bounded; else the plain next multiple of D). Padded lanes
    repeat the last member (inert; dropped on the way out)."""
    idxs = list(idxs)
    target = max(s_pad, len(idxs))
    D = max(D, 1)
    if target % D:
        cand = target
        for _ in range(8):                    # bounded: <= ~16x growth
            cand = s_bucket(cand + 1)
            if cand % D == 0:
                break
        else:
            cand = -(-target // D) * D        # no canonical width fits D
        target = cand
    return idxs + [idxs[-1]] * (target - len(idxs))


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

def execute(plan: Plan, *, devices: Optional[int] = None,
            overlap: bool = True, warmup_frac: float = 0.2,
            cross_check_shard: bool = False,
            trace_backend: Optional[str] = None,
            assert_compiles: bool = False,
            device="cuda", cross_check_eager: bool = False) -> ExperimentResult:
    """Run every point of ``plan`` on ``device``; one runner call per
    compile group (one a shard when sharded).

    devices: shard each group's systems over this many devices (default:
        all visible on ``device``); 1 runs the plain batched mode. On
        ``cuda`` more than the visible cards raises.
    overlap: overlap host trace generation for group i+1 with the
        simulation of group i (numpy backend only).
    cross_check_shard: re-run the first group through the other mode
        (``("shard", 1)`` against ``"vmap"``, ``"vmap"`` against a sharded
        run) and record whether the metrics are bit-exact in
        ``info.shard_check``, with the reference's keys.
    cross_check_eager: re-run the first group step by step from the host
        (``GroupRunner(eager=True)``, never cached) and record whether the
        metrics equal the primary run's (a replayed CUDA graph on the card)
        bit for bit in ``info.eager_check``.
    trace_backend: override ``plan.trace_backend`` ("device"/"numpy").
    assert_compiles: assert the capture accounting: one lookup of the
        runner cache a group (``exec_cache_hits + exec_cache_misses ==
        planned_groups``), and one capture a miss on the card
        (``compiles == exec_cache_misses``), none on the CPU; run the
        groups under the ``CompileWatcher`` and the sync guard
        (:mod:`repro_torch.analysis.runtime`) and assert the captures it
        saw: ``xla_compiles == compiles <= planned_groups``.
    """
    t_start = time.perf_counter()
    backend = validate_backend(trace_backend or plan.trace_backend)
    dev = resolve_device(device)
    D = _visible_devices(dev) if devices is None else devices
    if D < 1:
        raise ValueError(f"devices={devices}: at least one")
    mode = _exec_mode(D)
    info = RunInfo(planned_groups=plan.num_groups, devices=D,
                   trace_backend=backend)
    tracer = current_tracer()
    span_mark = tracer.mark() if tracer is not None else 0
    exec_idxs = [_pad_systems(g.indices, g.s_pad, D) for g in plan.groups]

    keys = group_cache_keys(plan, devices=D, trace_backend=backend)
    # the groups whose runners an earlier execute left in the cache
    devs = _shard_devices(dev, mode)
    info.groups_reused = sum(all((k, d, i) in _EXEC_CACHE for i, d in enumerate(devs))
                             for k in keys)

    def staged_prepare(gi_):
        with maybe_span("trace_stage", group=gi_):
            return _prepare(plan.points, exec_idxs[gi_], plan.groups[gi_].t_pad,
                            warmup_frac, backend)

    results: List[Optional[Dict[str, np.ndarray]]] = [None] * plan.num_points
    pool = ThreadPoolExecutor(max_workers=1) if overlap and \
        backend == "numpy" and len(plan.groups) > 1 else None
    group0 = None
    # the whole-execute span closes before the cross-check, as the
    # reference's does; so do the watcher and the guard (the cross-checks'
    # captures are not group runs)
    sentry = ExitStack()
    watcher = None
    sentry.enter_context(maybe_span("execute", groups=plan.num_groups,
                                    points=plan.num_points, backend=backend,
                                    devices=D))
    if assert_compiles:
        watcher = sentry.enter_context(CompileWatcher())
        sentry.enter_context(no_implicit_transfers())
    try:
        pending: Optional[Future] = None
        if pool is not None:
            pending = pool.submit(staged_prepare, 0)
        for gi, g in enumerate(plan.groups):
            if pool is not None:
                data = pending.result()
                if gi + 1 < len(plan.groups):
                    pending = pool.submit(staged_prepare, gi + 1)
            else:
                data = staged_prepare(gi)
            S_exec = len(exec_idxs[gi])
            N, t_pad = g.key.num_nodes, g.t_pad
            rep = plan.points[g.indices[0]]
            seen = watcher.by_name if watcher is not None else {}
            with maybe_span("run", group=gi, key_digest=_key_digest(keys[gi]),
                            S=S_exec, N=N, T_pad=t_pad):
                out, acct, hit = _run_mode(data, keys[gi], mode, rep, g, dev, backend)
            info.exec_cache_hits += hit
            info.exec_cache_misses += not hit
            if gi == 0 and (cross_check_shard or cross_check_eager):
                group0 = (data, out)

            true_events = sum(len(plan.points[i].workloads) *
                              plan.points[i].t_true for i in g.indices)
            info.compiles += acct["captured"]
            info.compile_s += acct["capture_s"]
            info.run_s += acct["run_s"]
            info.trace_device_s += acct["trace_device_s"]
            info.systems += g.size
            info.events += true_events
            info.padded_events += S_exec * N * t_pad - true_events
            info.padded_systems += S_exec - g.size
            info.host_trace_events += data.host_trace_events
            info.trace_gen_s += data.prep_s
            entry = {
                "static_shape": str(g.key.static_shape),
                "S": g.size, "S_exec": S_exec, "N": N, "T_pad": t_pad,
                "pad_sets": g.pad_sets, "pad_ways": g.pad_ways,
                "compile_s": round(acct["capture_s"], 3),
                "run_s": round(acct["run_s"], 3),
                "trace_device_s": round(acct["trace_device_s"], 4),
                "fresh_compile": acct["captured"],
                "exec_cache_hit": hit,
                "launches": acct["launches"],
                "key_digest": _key_digest(keys[gi])}
            if watcher is not None:
                # captures attributed to THIS group by its digest-suffixed
                # runner name (CompileWatcher.by_name delta)
                name = _runner_name(keys[gi])
                entry["xla_compiles"] = watcher.by_name.get(name, 0) - seen.get(name, 0)
            info.groups.append(entry)
            for j, i in enumerate(g.indices):
                results[i] = {k: v[j] for k, v in out.items()}
    finally:
        sentry.close()
        if pool is not None:
            pool.shutdown(wait=False)

    info.wall_s = time.perf_counter() - t_start
    if assert_compiles:
        want = info.exec_cache_misses if dev.type == "cuda" else 0
        assert info.compiles == want and info.exec_cache_hits + \
            info.exec_cache_misses == plan.num_groups, (
                f"{info.compiles} graph capture(s), {info.exec_cache_hits} runner "
                f"cache hit(s) and {info.exec_cache_misses} miss(es) for "
                f"{plan.num_groups} planned group(s) on {dev}; expected {want} "
                "capture(s) and one lookup a group", info.groups)
        info.xla_compiles = watcher.count
        assert info.xla_compiles == info.compiles <= info.planned_groups, (
            "runtime compile-count assertion failed: observed "
            f"{info.xla_compiles} capture(s) of group runners, "
            f"accounted {info.compiles} fresh capture(s), planned "
            f"{info.planned_groups} group(s) — an unplanned recapture "
            "means something traced leaked into a runner key (run "
            "python -m repro_torch.analysis)", info.groups)

    if cross_check_shard and plan.groups:
        info.shard_check, info.shard_check_run_s = _shard_cross_check(
            plan, *group0, exec_idxs[0], mode, dev, backend)
    if cross_check_eager and plan.groups:
        info.eager_check = _eager_cross_check(plan, *group0, exec_idxs[0],
                                              dev, backend)
    if tracer is not None:
        # summarized after the cross-check, so its spans are included
        info.spans = tracer.summary(since=span_mark)
    t_pads = [0] * plan.num_points
    for g in plan.groups:
        for i in g.indices:
            t_pads[i] = g.t_pad
    return ExperimentResult(plan.points, results, info,  # type: ignore[arg-type]
                            t_pads=t_pads)


def _shard_cross_check(plan: Plan, data: _GroupData,
                       primary_out: Dict[str, np.ndarray], idxs: Sequence[int],
                       primary_mode, dev: torch.device, trace_backend: str):
    """Compare the first group's primary output with a run through the
    other mode (``("shard", 1)`` against ``"vmap"``, ``"vmap"`` against a
    sharded primary), bit for bit. Returns (the reference's record, the
    re-run's seconds without captures)."""
    g = plan.groups[0]
    rep = plan.points[g.indices[0]]
    S_exec = len(idxs)
    alt_mode = _BATCHED if primary_mode != _BATCHED else ("shard", 1)
    key = _exec_key(rep.cfg, S_exec, g.key.num_nodes, g.t_pad, alt_mode,
                    pad_sets=g.pad_sets, pad_ways=g.pad_ways,
                    trace_backend=trace_backend, policies=rep.policy_set())
    alt, acct, _ = _run_mode(data, key, alt_mode, rep, g, dev, trace_backend)
    bit_exact = all(np.array_equal(primary_out[k], alt[k]) for k in primary_out)
    return ({"group": 0, "primary": str(primary_mode), "alt": str(alt_mode),
             "systems": S_exec, "bit_exact": bool(bit_exact)}, acct["run_s"])


def _eager_cross_check(plan: Plan, data: _GroupData,
                       primary_out: Dict[str, np.ndarray],
                       idxs: Sequence[int], dev: torch.device,
                       trace_backend: str) -> dict:
    """Re-run the first group step by step from the host with a fresh
    ``GroupRunner(eager=True)`` (never cached) and compare it with the
    primary run, bit for bit."""
    g = plan.groups[0]
    rep = plan.points[g.indices[0]]
    run = famsim.GroupRunner(rep.cfg, g.key.num_nodes, g.pad_sets, g.pad_ways,
                             policies=rep.policy_set(), eager=True)
    alt, _ = _run_group(data, run, dev, g.t_pad, trace_backend)
    bit_exact = all(np.array_equal(primary_out[k], alt[k])
                    for k in primary_out)
    return {"group": 0, "primary": _mode(dev), "alt": "eager",
            "systems": len(idxs), "bit_exact": bool(bit_exact)}
