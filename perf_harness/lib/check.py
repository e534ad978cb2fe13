"""Whether the timed sweeps produced the right statistics.

After the window closes, one of its sweeps and a sample of that sweep's
simulated systems are drawn from the run's seed. For each, the plain
reference (``perf_harness/reference``) regenerates the node traces from
the workload names and the sweep's seed and simulates the system from the
benchmark's own configuration and traffic files; the program's statistics
for that system, as the timed sweep returned them, are compared with the
reference's: every metric of every node (IPC, FAM latency, the two hit
fractions, prefetches issued, the issue rate, cache occupancy), which
together cover phase A (cache, SPP, queue, probes), phase B (the FAM
controller's FIFO or WFQ timing) and phase C (latency and IPC accounting,
adaptation). The number compared is the widest relative gap,
``|program - reference| / max(|reference|, FLOOR)``.

The sample is spread over one axis of the sweep (``check.spread`` in the
cell's file): its values are visited in a random order, a random system of
each, until ``check.systems`` systems are drawn.
"""
from __future__ import annotations

import itertools
import math
import random
import time
from typing import Callable, Dict, List, Sequence, Tuple

from perf_harness.reference import famsim as ref
from perf_harness.reference import traces as ref_traces

FLOOR = 1e-6
#: SimFlags' defaults, which a traffic variant overrides
FLAG_DEFAULTS = {"core_prefetch": True, "dram_prefetch": True, "bw_adapt": False,
                 "wfq": False, "wfq_weight": 2, "all_local": False}

System = Tuple[Tuple[Tuple[str, str], ...], Tuple[str, ...], Dict, Dict]


def resolve(config: Dict, traffic: Dict) -> List[System]:
    """(coordinates, node workloads, configuration, flags) of every system
    of the sweep, in the order of the axes' product, from the benchmark's
    own files."""
    nodes = config["num_nodes"]

    def values(ax):
        v = ax["values"]
        return list(v.items()) if isinstance(v, dict) else [(str(x), x) for x in v]

    out = []
    for combo in itertools.product(*(values(ax) for ax in traffic["axes"])):
        cfg, flags, workloads, coords = dict(config), dict(FLAG_DEFAULTS), None, []
        for ax, (label, value) in zip(traffic["axes"], combo):
            coords.append((ax["name"], label))
            if ax["axis"] == "config":
                cfg[ax["param"]] = value
            elif ax["axis"] == "workload":
                workloads = (value,) * nodes
            elif ax["axis"] == "mix":
                workloads = tuple(value)
            elif ax["axis"] == "flag":
                flags.update(value)
        if workloads is None or len(workloads) != nodes:
            raise ValueError(f"system {coords} has workloads {workloads} for {nodes} node(s)")
        out.append((tuple(coords), workloads, cfg, flags))
    return out


def sample(systems: Sequence[System], spread: str, count: int,
           rng: random.Random) -> List[int]:
    """Indices of ``count`` systems, spread over the values of axis ``spread``."""
    groups: Dict[str, List[int]] = {}
    for i, (coords, *_rest) in enumerate(systems):
        groups.setdefault(dict(coords)[spread], []).append(i)
    order = sorted(groups)
    rng.shuffle(order)
    for members in groups.values():
        rng.shuffle(members)
    picked: List[int] = []
    while len(picked) < min(count, len(systems)):
        for key in order:
            if groups[key] and len(picked) < count:
                picked.append(groups[key].pop())
    return picked


def rel_gap(got: Dict, want: Dict) -> float:
    """Widest relative gap over every metric and node (inf for a missing
    or non-finite value)."""
    worst = 0.0
    for k in ref.METRICS:
        g, w = list(map(float, got[k])), list(map(float, want[k]))
        if len(g) != len(w):
            return math.inf
        for a, b in zip(g, w):
            gap = abs(a - b) / max(abs(b), FLOOR)
            if not math.isfinite(gap):
                return math.inf
            worst = max(worst, gap)
    return worst


def reference(system: System, T: int, seed: int, warmup_frac: float,
              rnd: Callable[[float], float] = ref.round_f32) -> Dict:
    """The reference's statistics of one system of a sweep seeded ``seed``."""
    _coords, workloads, cfg, flags = system
    addrs, gaps = ref_traces.system_traces(workloads, T, seed)
    return ref.simulate(cfg, flags, addrs.tolist(), gaps.tolist(), warmup_frac, rnd=rnd)


def compare(systems: Sequence[System], traffic: Dict, sweeps: Sequence[Tuple[int, List[Dict]]],
            spec: Dict, seed: int, control: bool = False) -> Dict:
    """Draw a sweep and its systems from ``seed`` and compare the program's
    statistics of each with the reference's. ``sweeps`` holds each timed
    sweep's trace seed and per-system metrics. With ``control`` the
    reference computed in bfloat16 takes the program's place. Returns the
    widest gap, the systems checked, each one's gap and the reference's
    seconds."""
    rng = random.Random(f"check:{seed}")
    which = rng.randrange(len(sweeps))
    sweep_seed, metrics = sweeps[which]
    picked = sample(systems, spec["spread"], spec["systems"], rng)
    t0 = time.perf_counter()
    gaps = {}
    for i in picked:
        args = (systems[i], traffic["T"], sweep_seed, traffic["warmup_frac"])
        got = reference(*args, rnd=ref.round_bf16) if control else metrics[i]
        gaps[i] = rel_gap(got, reference(*args))
    return {"max_rel_gap": max(gaps.values()), "sweep": which, "sweep_seed": sweep_seed,
            "gaps": {"/".join(v for _, v in systems[i][0]): g for i, g in gaps.items()},
            "reference_s": time.perf_counter() - t0}
