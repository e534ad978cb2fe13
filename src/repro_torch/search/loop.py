"""The ask/tell search driver over the batched simulator.

Counterpart of ``repro.search.loop``. One generation is ONE
:class:`~repro_torch.experiments.Experiment`: the proposer's candidates
become a ``grid_axis`` (via :meth:`SearchSpace.axis_fields`) crossed with
the objective's mix axis, planned and executed through
``repro_torch.experiments.execute`` like a paper figure. The executor's
compile groups (policy params as tensors, fifo/wfq one program, geometry
padded) and its runner cache price a candidate: a generation that moves
only traced dimensions lands on the runner keys of generation 1 and
replays their cached CUDA graphs, with ZERO new captures.

The loop computes, per candidate:

* the **objective** — geomean-over-mixes of geomean-over-nodes IPC
  uplift vs the all-default baseline row evaluated in the SAME grid
  (the formula of ``benchmarks/fig14_mixes.py``; baseline = 1.0 by
  construction);
* a **penalized fitness** — objective minus ``compile_penalty`` per
  *cold* runner key (a key no earlier generation of this search used,
  predicted from the plan via
  ``repro_torch.experiments.group_cache_keys``, never from runtime
  state), so proposers maximizing fitness learn to stay inside warm groups.

Everything deterministic lands in ``trajectory.jsonl`` (byte-identical
across processes under a fixed seed; on the CPU the reference's on the
same numpy traces but for the kernel backend's name); wall clock and the
executor's cache accounting land in the ``timings.jsonl`` sidecar (see
:mod:`repro_torch.search.trajectory`). ``best.json`` records the winner
with enough to replay it as a plain two-candidate Experiment:
:func:`replay_best` re-derives the metric string and compares it byte for
byte. The entry points take ``device`` and default to ``"cuda"``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import FamConfig
from repro_torch.core.ipc_model import geomean
from repro_torch.experiments import Experiment, grid_axis, mix_axis
from repro_torch.experiments.executor import execute, group_cache_keys
from repro_torch.obs.spans import SpanTracer, maybe_span, set_tracer
from repro_torch.policies import PolicySet, SimFlags
from repro_torch.search.proposers import get_proposer
from repro_torch.search.space import SearchSpace
from repro_torch.search.trajectory import (TrajectoryWriter, resume_state,
                                           write_best)

#: default per-cold-group fitness penalty: ~2% objective — enough that a
#: traced move beating a capturing move by <2pp wins, small enough
#: that a genuinely better static configuration still surfaces
DEFAULT_COMPILE_PENALTY = 0.02


# -- objective --------------------------------------------------------------

def candidate_objective(result, label: str, mixes: Mapping[str, Sequence[str]],
                        baseline: str = "baseline"
                        ) -> Tuple[Dict[str, float], float]:
    """fig14's figure of merit for one candidate row: per-mix geomean IPC
    uplift vs the baseline row of the same mix, then geomean over mixes."""
    per_mix = {}
    for mix in mixes:
        b_ipc = np.maximum(result.get(candidate=baseline, mix=mix)["ipc"],
                           1e-9)
        c_ipc = result.get(candidate=label, mix=mix)["ipc"]
        per_mix[mix] = float(geomean(c_ipc / b_ipc))
    return per_mix, float(geomean(np.array(list(per_mix.values()))))


def derived_string(per_mix: Mapping[str, float], objective: float) -> str:
    """The canonical derived-metric string (same shape as the figure
    rows' ``derived`` field) — the replay byte-identity contract is over
    exactly this encoding."""
    body = ";".join(f"{k}={v:.6f}" for k, v in sorted(per_mix.items()))
    return f"{body};objective={objective:.6f}"


# -- generation grid --------------------------------------------------------

def _baseline_fields(space: SearchSpace) -> Dict[str, Any]:
    return {"policies": space.base_policies, "flags": space.base_flags}


def generation_experiment(space: SearchSpace, samples: Sequence[Mapping],
                          labels: Sequence[str],
                          mixes: Mapping[str, Sequence[str]], *,
                          base: FamConfig, T: int, seed: int,
                          trace_backend: str, name: str) -> Experiment:
    """One generation as a plain Experiment: (baseline + candidates) x
    mixes. The baseline row rides along in every generation so the
    objective is self-contained (and free: it shares the candidates'
    compile group)."""
    values = {"baseline": _baseline_fields(space)}
    for lb, s in zip(labels, samples):
        values[lb] = space.axis_fields(s)
    return Experiment(name=name, base=base, T=T, seed=seed,
                      trace_backend=trace_backend,
                      axes=(grid_axis("candidate", values),
                            mix_axis(dict(mixes))))


def _candidate_keys(plan, key_strs: Sequence[str]) -> Dict[str, Tuple[str, ...]]:
    """candidate label -> the sorted compile-group key strings its points
    land in (usually exactly one)."""
    by_label: Dict[str, set] = {}
    for g, ks in zip(plan.groups, key_strs):
        for i in g.indices:
            label = dict(plan.points[i].coords)["candidate"]
            by_label.setdefault(label, set()).add(ks)
    return {lb: tuple(sorted(s)) for lb, s in by_label.items()}


# -- the driver -------------------------------------------------------------

def run_search(space: SearchSpace,
               mixes: Optional[Mapping[str, Sequence[str]]] = None, *,
               objective=None,
               proposer: str = "evolutionary", generations: int = 3,
               population: int = 8, T: int = 10_000, seed: int = 0,
               base: Optional[FamConfig] = None,
               out_dir, resume: bool = False,
               compile_penalty: float = DEFAULT_COMPILE_PENALTY,
               assert_compiles: bool = True,
               trace_backend: str = "device",
               proposer_opts: Optional[dict] = None,
               device="cuda") -> dict:
    """Run (or resume) a search; returns a summary dict with the winner.
    Its files (``trajectory.jsonl``, ``timings.jsonl``, ``trace.json``,
    ``best.json``) go under ``out_dir``, which the caller names.

    ``mixes`` selects the classic fig14 IPC objective; ``objective``
    (an :class:`~repro_torch.search.objectives.Objective` instance or a
    registered name, e.g. ``"pond_tail"`` from ``repro_torch.tenants.search``)
    swaps in a different evaluation scenario — it owns both the
    per-generation grid and the per-candidate score.

    ``assert_compiles`` has each generation's ``execute`` assert its
    capture accounting: one runner-cache lookup a group, one capture a
    miss on the card. A generation whose keys an earlier generation used
    (``new_group_keys == 0``) thus captures nothing and hits the cache for
    every group.

    ``resume=True`` continues an existing ``out_dir/trajectory.jsonl``
    from its last completed generation up to ``generations`` total: the
    RNG bit-generator state and proposer state round-trip through the
    trajectory, and the plan-level warm-key set is rebuilt from the
    recorded candidate exec keys, so the remaining generations are
    byte-identical to an uninterrupted run.
    """
    from repro_torch.search.objectives import MixObjective, resolve_objective

    obj_impl = resolve_objective(objective, mixes)
    base = base or FamConfig()
    out = Path(out_dir)
    traj_path = out / "trajectory.jsonl"
    header = {
        "type": "header", "space": space.describe(), "proposer": proposer,
        "seed": seed, "generations": generations, "population": population,
        "T": T, "mixes": obj_impl.header_mixes(),
        "base_cfg": dataclasses.asdict(base),
        "compile_penalty": compile_penalty,
    }
    if obj_impl.name != MixObjective.name:
        # the default objective keeps pre-objective trajectories
        # byte-identical; anything else records its identity
        header["objective"] = obj_impl.name
    rng = np.random.default_rng(seed)
    prop = get_proposer(proposer)(space, rng, population,
                                  **(proposer_opts or {}))
    warm_keys: set = set()
    best: Optional[dict] = None
    start_gen = 1

    def consider(cand: dict) -> None:
        nonlocal best
        if cand["T"] != T:            # only full-budget evaluations compete
            return
        if best is None or cand["objective"] > best["objective"]:
            best = dict(cand)

    if resume:
        st = resume_state(traj_path)
        recorded = dict(st["header"])
        for k in ("space", "proposer", "seed", "population", "T", "mixes",
                  "base_cfg", "compile_penalty"):
            if recorded.get(k) != header[k]:
                raise ValueError(
                    f"resume mismatch on {k!r}: trajectory has "
                    f"{recorded.get(k)!r}, caller passed {header[k]!r}")
        rng.bit_generator.state = st["rng_state"]
        prop.load_state(st["proposer_state"])
        warm_keys = set(st["warm_keys"])
        start_gen = st["next_gen"]
        for c in st["candidates"]:
            consider(c)

    writer = TrajectoryWriter(traj_path, append=resume)
    timings = TrajectoryWriter(out / "timings.jsonl", append=resume)
    timing_rows: List[dict] = []
    gens_run = 0
    # one host-span timeline for the whole search (repro.obs.spans):
    # generation / plan / executor spans nest into out/trace.json, and
    # each timings row carries its generation's span summary (via
    # RunInfo.spans — same emitter schema as every other trace in the
    # repo). Restore any caller-installed tracer on the way out.
    tracer = SpanTracer(process_name=f"repro_torch.search:{proposer}")
    prev_tracer = set_tracer(tracer)
    try:
        if not resume:
            writer.write(header)
        for gen in range(start_gen, generations + 1):
            with maybe_span("generation", gen=gen):
                samples = prop.ask()
                gen_T = int(prop.round_T(T))
                labels = [f"g{gen}c{i}" for i in range(len(samples))]
                exp = obj_impl.build(
                    space, samples, labels, base=base, T=gen_T,
                    seed=seed, trace_backend=trace_backend,
                    name=f"search_gen{gen}")
                with maybe_span("plan", gen=gen):
                    plan = exp.plan()
                key_strs = [str(k) for k in
                            group_cache_keys(plan,
                                             trace_backend=trace_backend,
                                             device=device)]
                cand_keys = _candidate_keys(plan, key_strs)
                new_keys = sorted(set(key_strs) - warm_keys)

                result = execute(plan, assert_compiles=assert_compiles,
                                 device=device)
                info = result.info

                fitnesses = []
                for lb, s in zip(labels, samples):
                    per_mix, obj = obj_impl.score(result, lb)
                    keys = cand_keys[lb]
                    cold = sum(k not in warm_keys for k in keys)
                    fit = obj - compile_penalty * cold
                    fitnesses.append(fit)
                    cand = {"type": "candidate", "gen": gen, "label": lb,
                            "sample": dict(s), "objective": obj,
                            "fitness": fit, "per_mix": per_mix,
                            "exec_key": "|".join(keys),
                            "warm": cold == 0, "T": gen_T}
                    writer.write(cand)
                    consider(cand)
                warm_keys.update(key_strs)

                prop.tell(samples, fitnesses)
                writer.write({"type": "generation", "gen": gen,
                              "candidates": len(samples), "T": gen_T,
                              "new_group_keys": len(new_keys),
                              "proposer_state": prop.state(),
                              "rng_state": rng.bit_generator.state})
                trow = {"type": "generation_timing", "gen": gen,
                        "new_group_keys": len(new_keys), **info.as_dict()}
                trow.pop("groups", None)
                timings.write(trow)
                timing_rows.append(trow)
                gens_run += 1
    finally:
        writer.close()
        timings.close()
        set_tracer(prev_tracer)
        tracer.save(out / "trace.json")

    if best is None:
        raise RuntimeError("search produced no full-budget candidate "
                           "(generations too small for this proposer?)")
    best_record = {
        "sample": best["sample"], "objective": best["objective"],
        "per_mix": best["per_mix"], "gen": best["gen"],
        "label": best["label"], "T": T, "seed": seed,
        "mixes": header["mixes"], "base_cfg": header["base_cfg"],
        "space": header["space"], "proposer": proposer,
        "axis_fields": _serialize_fields(space.axis_fields(best["sample"])),
        "baseline_fields": _serialize_fields(_baseline_fields(space)),
        "derived": derived_string(best["per_mix"], best["objective"]),
    }
    write_best(out / "best.json", best_record)
    return {"best": best_record, "trajectory": str(traj_path),
            "best_path": str(out / "best.json"),
            "trace": str(out / "trace.json"),
            "generations_run": gens_run, "timings": timing_rows}


# -- winner replay ----------------------------------------------------------

def _serialize_fields(fields: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if "policies" in fields:
        out["policies"] = fields["policies"].as_dict()
    if "flags" in fields:
        out["flags"] = dataclasses.asdict(fields["flags"])
    if "cfg" in fields:
        out["cfg"] = dict(fields["cfg"])
    return out


def _deserialize_fields(d: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if "policies" in d:
        out["policies"] = PolicySet.from_dict(d["policies"])
    if "flags" in d:
        out["flags"] = SimFlags(**d["flags"])
    if "cfg" in d:
        out["cfg"] = dict(d["cfg"])
    return out


def best_experiment(best: Mapping[str, Any], *,
                    trace_backend: str = "device") -> Experiment:
    """The winner as a PLAIN two-candidate Experiment (baseline + best)
    over the recorded mixes — nothing search-specific left."""
    return Experiment(
        name="search_best_replay",
        base=FamConfig(**best["base_cfg"]),
        T=int(best["T"]), seed=int(best["seed"]),
        trace_backend=trace_backend,
        axes=(grid_axis("candidate", {
                  "baseline": _deserialize_fields(best["baseline_fields"]),
                  "best": _deserialize_fields(best["axis_fields"])}),
              mix_axis({k: tuple(v) for k, v in best["mixes"].items()})))


def replay_best(best: Mapping[str, Any], *,
                trace_backend: str = "device", device="cuda") -> dict:
    """Re-evaluate a ``best.json`` record through plain
    ``repro_torch.experiments`` on ``device`` and byte-compare the
    derived-metric string (systems share no state, so the batch — the
    search grid vs this two-candidate replay — must not change a single
    bit of any per-system metric)."""
    exp = best_experiment(best, trace_backend=trace_backend)
    result = exp.run(device=device)
    per_mix, obj = candidate_objective(result, "best", best["mixes"])
    derived = derived_string(per_mix, obj)
    return {"derived": derived, "objective": obj, "per_mix": per_mix,
            "matches": derived == best["derived"],
            "recorded": best["derived"]}
