"""Design-space search over the fig14 mix suite (``python -m repro_torch.benchmarks.run search``).

Counterpart of the reference's ``benchmarks/fig_search.py``: a
:class:`repro_torch.search.SearchSpace` over the prefetch / scheduler /
adaptation knobs, evaluated on the fig14 mixes through the executor, with
the all-default PolicySet (the paper's non-adaptive FIFO prefetcher,
fig14's ``fifo`` variant) as the baseline row every objective is measured
against.

The default space is traced-only — the scheduler choice (``fifo`` / ``wfq``
are one program), WFQ weight, backlog cap, SPP confidence, the
token-bucket knobs and the ``bw_adapt`` gate all ride ``FamParams`` — so
every generation after the first lands on generation 1's runner key and
replays its cached CUDA graph: the run asserts that each such generation
captures nothing and hits the runner cache for every group.
``--space full`` adds dimensions that change the key (prefetcher choice,
prefetch degree, the cache-step backend ``torch`` / ``cuda``) to exercise
the static/traced split and the capture-penalized fitness.

Artifacts, only under ``--out DIR``: ``trajectory.jsonl``, ``timings.jsonl``,
``trace.json`` and ``best.json`` (replayed and compared byte for byte
before the driver returns), the rows ``fig_search.json`` and the winner's
summary ``BENCH_search.json``. Without ``--out`` the search runs in a
temporary directory that is removed on return::

    python -m repro_torch.benchmarks.run search                    # quick, on the card
    python -m repro_torch.benchmarks.run search --out /tmp/search --trace-backend numpy
    python -m repro_torch.benchmarks.run search --replay /tmp/search/best.json
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from contextlib import ExitStack
from pathlib import Path

from repro_torch.benchmarks.common import save_rows
from repro_torch.benchmarks.fig14_mixes import T, _mixes
from repro_torch.search import (SearchSpace, categorical, cfg_field, continuous,
                                integer, load_best, log_continuous, policy_choice,
                                policy_param, read_trajectory, replay_best,
                                run_search, split_records)

NAME = "fig_search"


def default_space() -> SearchSpace:
    """Traced-only knobs: every dimension rides ``FamParams``, so one
    capture (generation 1) prices the whole search."""
    return SearchSpace((
        categorical("scheduler", policy_choice("scheduler"),
                    ["fifo", "wfq"]),
        continuous("wfq_weight", policy_param("scheduler", "weight"),
                   0.5, 4.0),
        log_continuous("backlog_cap", policy_param("scheduler",
                                                   "backlog_cap"),
                       500.0, 4000.0),
        categorical("bw_adapt", ("flag", "bw_adapt"), [False, True]),
        continuous("spp_confidence", policy_param("prefetch",
                                                  "confidence_threshold"),
                   0.05, 0.6),
        continuous("ema_alpha", policy_param("adaptation", "ema_alpha"),
                   0.05, 0.6),
        continuous("mimd_increase", policy_param("adaptation",
                                                 "mimd_increase"),
                   1.02, 1.4),
    ))


def full_space() -> SearchSpace:
    """The default space plus dimensions that change the runner key:
    prefetcher choice (``spp`` and ``nextline`` are different programs),
    the prefetch degree (a geometry-free shape field) and the cache-step
    backend (the plain ``torch`` step or the hand-written ``cuda`` kernel:
    the same metrics bit for bit, a different captured program)."""
    return SearchSpace(default_space().dimensions + (
        categorical("prefetcher", policy_choice("prefetch"),
                    ["spp", "nextline"]),
        integer("prefetch_degree", cfg_field("prefetch_degree"), 1, 4),
        categorical("kernel_backend", cfg_field("kernel_backend"),
                    ["torch", "cuda"]),
    ))


SPACES = {"default": default_space, "full": full_space}


def run_result(quick: bool = True, trace_backend: str = "device", *,
               proposer: str = "evolutionary", generations: int = 3,
               population: int = 6, seed: int = 0, space: str = "default",
               T_events: int = T, out=None, resume: bool = False,
               device="cuda"):
    """(rows, the ``run_search`` summary, the replay): the search, its
    acceptance asserts, the winner's replay and the rows. Files go under
    ``out`` only (a removed temporary directory without it)."""
    if resume and out is None:
        raise ValueError("resume needs the directory of the trajectory (out)")
    mixes = _mixes(quick)
    with ExitStack() as stack:
        out_dir = Path(out) if out is not None else \
            Path(stack.enter_context(tempfile.TemporaryDirectory()))
        summary = run_search(
            SPACES[space](), mixes, proposer=proposer, generations=generations,
            population=population, T=T_events, seed=seed, out_dir=out_dir,
            resume=resume, trace_backend=trace_backend, device=device)
        best = summary["best"]

        # -- acceptance asserts ---------------------------------------------
        warm_gens = [t["gen"] for t in summary["timings"]
                     if t["new_group_keys"] == 0]
        for t in summary["timings"]:
            if t["new_group_keys"] == 0:
                # every group's runner key was used by an earlier generation
                # of this search: all cache hits, no capture
                assert t["compiles"] == 0 and \
                    t["exec_cache_hits"] == t["planned_groups"], t
        if space == "default" and generations >= 2 and proposer != "halving":
            # traced-only space + constant population: every generation
            # after the first lands on generation 1's runner key
            assert warm_gens, summary["timings"]
        if proposer == "evolutionary":
            assert best["objective"] > 1.0, (
                "evolutionary search failed to beat the all-default baseline",
                best)

        replay = replay_best(load_best(summary["best_path"]),
                             trace_backend=trace_backend, device=device)
        assert replay["matches"], replay

        # -- rows ---------------------------------------------------------------
        _, cands, _ = split_records(read_trajectory(summary["trajectory"]))
        rows = []
        for t in summary["timings"]:
            gen = t["gen"]
            gen_best = max(c["objective"] for c in cands if c["gen"] == gen)
            rows.append({
                "name": f"search_gen{gen}",
                "us_per_call": t["us_per_event"],
                "derived": (f"best={gen_best:.6f};"
                            f"new_keys={t['new_group_keys']}"),
                "engine": t,
            })
        rows.append({
            "name": "search_best", "us_per_call": 0.0,
            "derived": best["derived"],
            "sample": best["sample"], "gen": best["gen"],
            "replay_matches": replay["matches"],
        })
        rows.append({
            "name": "search_engine", "us_per_call": 0.0,
            "derived": (f"generations={summary['generations_run']};"
                        f"warm_gens={len(warm_gens)}"),
            "proposer": proposer, "space": space, "seed": seed,
        })
        if out is not None:
            save_rows(NAME, rows, out_dir)
            (out_dir / "BENCH_search.json").write_text(json.dumps({
                "objective": best["objective"], "derived": best["derived"],
                "proposer": proposer, "space": space, "seed": seed,
                "generations": summary["generations_run"],
                "population": population, "T": T_events,
                "mixes": sorted(mixes),
            }, indent=2, sort_keys=True) + "\n")
    return rows, summary, replay


def run(quick: bool = True, trace_backend: str = "device", **kw):
    return run_result(quick, trace_backend, **kw)[0]


def main(argv=None) -> list:
    """Run the search (or ``--replay`` a ``best.json``) and print the
    ``name,us_per_call,derived`` CSV; returns the rows."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.benchmarks.run search",
        description="Design-space search on the fig14 mix suite "
                    "(repro_torch.search)")
    ap.add_argument("--proposer", default="evolutionary",
                    help="proposer registry name (random / evolutionary / "
                         "halving)")
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--population", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--space", choices=sorted(SPACES), default="default",
                    help="'default' = traced-only knobs (no capture after "
                         "generation 1); 'full' adds the prefetcher choice, "
                         "prefetch degree and cache-step backend")
    ap.add_argument("--full", action="store_true",
                    help="all 7 fig14 mixes (default: quick 4-mix subset)")
    ap.add_argument("--T", type=int, default=T, dest="T_events",
                    help=f"events per node per evaluation (default {T})")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="artifact directory (default: a temporary one, removed)")
    ap.add_argument("--resume", action="store_true",
                    help="continue the trajectory in --out up to "
                         "--generations in all")
    ap.add_argument("--device", default="cuda",
                    help="torch device to simulate on (default: cuda)")
    ap.add_argument("--trace-backend", choices=("device", "numpy"),
                    default="device")
    ap.add_argument("--replay", metavar="BEST_JSON", default=None,
                    help="replay a best.json as a plain Experiment, compare "
                         "its derived string byte for byte, and exit")
    args = ap.parse_args(argv)

    if args.replay:
        r = replay_best(load_best(args.replay),
                        trace_backend=args.trace_backend, device=args.device)
        print(f"recorded: {r['recorded']}")
        print(f"replayed: {r['derived']}")
        print(f"matches:  {r['matches']}")
        if not r["matches"]:
            sys.exit(1)
        return []

    rows = run(quick=not args.full, trace_backend=args.trace_backend,
               proposer=args.proposer, generations=args.generations,
               population=args.population, seed=args.seed,
               space=args.space, T_events=args.T_events,
               out=args.out, resume=args.resume, device=args.device)
    print("name,us_per_call,derived")
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.3f},\"{r['derived']}\"",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
