"""Steady-state throughput of the simulator, per cache-step backend.

Counterpart of the reference's ``benchmarks/bench_famsim.py``: simulated
events/s/device at fig08 scale (the block-size sweep) for each
``FamConfig.kernel_backend`` (``cuda``, the hand-written cache-step kernel,
and ``torch``, its plain version), through the same planner and executor
the figures use, so the number tracked is the one the figures pay.

Every time comes from the executor's own accounting: ``RunInfo.run_s``
(the replays, graph captures excluded) and ``compile_s`` (the captures;
each execution captures its graphs anew). ``repeats`` executions per
backend, the best ``run_s`` reported. ``derived`` carries only the metric
digest (SHA-256 over every metric array of every point) and the event
count; ``main`` asserts that the backends' digests are equal: on the card
the graphed ``cuda`` and ``torch`` runs are bit-identical, on the CPU both
run the plain version.

Rows (``bench_famsim.json``) and the throughput trajectory
(``bench_famsim_trajectory.json``, one entry per backend per invocation,
appended) are written only under ``--out``; so is, with ``--telemetry``,
the host span timeline of the measurement (``trace/bench_famsim.json``:
plan and repeat spans a backend, the executor's inside them), and, unless
``--no-roofline``, the roofline record (``roofline/famsim_step.json``):
per backend and compile group, the counted work of the group's events
(:meth:`repro_torch.core.famsim.GroupRunner.count_event` times the
group's padded events, as the reference's loop-aware count of its compiled
group multiplies the loop body by its trip count), its terms against the
H100's peaks (:mod:`repro_torch.roofline.analysis`), bytes and flops an
event, joined with the measured ``run_s_best`` and events/s/device.

Usage::

    python -m repro_torch.benchmarks.run bench                  # both backends
    python -m repro_torch.benchmarks.run bench --quick          # CI scale
    python -m repro_torch.benchmarks.run bench --kernel-backend torch --repeats 5
    python -m repro_torch.benchmarks.run bench --quick --telemetry --out /tmp/rows
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np

from repro_torch.benchmarks import fig08_blocksize
from repro_torch.benchmarks.common import (BASELINE, DRAM, obs_tracer, save_rows,
                                           workloads)
from repro_torch.configs.base import KERNEL_BACKENDS
from repro_torch.experiments import config_axis, execute, executor, flag_axis, workload_axis
from repro_torch.obs.spans import maybe_span
from repro_torch.roofline.analysis import analyze
from repro_torch.roofline.op_cost import OpCost

NAME = "bench_famsim"
TRAJECTORY = "bench_famsim_trajectory.json"
ROOFLINE = "roofline/famsim_step.json"
SCHEMA = "bench_famsim_torch/v1"

#: The quick grid: a subsample of fig08 (same axes, fewer values) at a
#: short T; the full grid is fig08's ``quick=False`` experiment.
QUICK_T = 400
QUICK_BLOCKS = [256, 1024]
QUICK_WORKLOADS = 2


def _experiment(backend: str, quick: bool):
    """fig08's experiment (device traces), subsampled to the quick grid
    when ``quick`` (the same grid on every backend: the digest contract)."""
    exp = fig08_blocksize.experiment(quick=quick, kernel_backend=backend)
    if not quick:
        return exp
    return dataclasses.replace(
        exp, T=QUICK_T,
        axes=(config_axis("block", QUICK_BLOCKS, param="block_bytes"),
              workload_axis(workloads(True)[:QUICK_WORKLOADS]),
              flag_axis("variant", {"base": BASELINE, "dram": DRAM})))


def _digest(result) -> str:
    """Order-stable digest over every point's every metric array."""
    h = hashlib.sha256()
    for m in result.metrics:
        for k in sorted(m):
            h.update(k.encode())
            h.update(np.ascontiguousarray(m[k]).tobytes())
    return h.hexdigest()[:16]


def measure(backend: str, quick: bool, repeats: int, device="cuda") -> dict:
    """Execute the experiment ``repeats`` times on ``backend``; best-of
    ``run_s`` and the summed capture seconds."""
    exp = _experiment(backend, quick)
    with maybe_span("plan", experiment=exp.name, backend=backend):
        plan = exp.plan()
    runs, result, compile_s = [], None, 0.0
    for rep in range(max(repeats, 1)):
        with maybe_span("repeat", backend=backend, repeat=rep):
            result = execute(plan, assert_compiles=True, device=device)
        runs.append(result.info.run_s)
        compile_s += result.info.compile_s
    info = result.info
    best = min(runs)
    return {
        "plan": plan,             # for the roofline record; not serialized
        "backend": backend,
        "digest": _digest(result),
        "events": info.events,
        "points": len(result.points),
        "devices": info.devices,
        "planned_groups": info.planned_groups,
        "run_s_best": round(best, 4),
        "run_s_all": [round(r, 4) for r in runs],
        "compile_s": round(compile_s, 3),
        "wall_s_last": round(info.wall_s, 4),
        "us_per_event": info.events and best / info.events * 1e6,
        "events_per_sec_per_device": round(
            info.events / max(best, 1e-12) / max(info.devices, 1), 1),
        "engine": info.as_dict(),
    }


def roofline_record(measured: dict, device="cuda") -> dict:
    """The counted work of each compile group of ``measured``'s plan (its
    runners are in the executor's cache after :func:`measure`), joined
    with the measured steady-state throughput."""
    plan = measured["plan"]
    devices = measured["devices"]
    recs = []
    for g, runner in zip(plan.groups, executor.cached_runners(plan, device=device)):
        one = runner.count_event()
        cost = OpCost()
        cost.add(one.cost, g.t_pad)
        terms = analyze(cost, chips=devices, model_flops=0.0)
        terms.xla_flops_once, terms.xla_bytes_once = one.flops_once, one.bytes_once
        recs.append({"static_shape": str(g.key.static_shape), "events": g.t_pad,
                     "bytes_per_event": one.cost.bytes, "flops_per_event": one.cost.flops,
                     "charges_per_event": one.charges, **terms.to_dict()})
    events = measured["events"]
    return {
        "backend": measured["backend"],
        "events": events,
        "run_s_best": measured["run_s_best"],
        "events_per_sec_per_device": measured["events_per_sec_per_device"],
        "us_per_event": measured["us_per_event"],
        "memory_s": sum(r["memory_s"] for r in recs),
        "groups": recs,
    }


def _append_trajectory(path: Path, entries: list) -> None:
    doc = {"schema": SCHEMA, "unit": "events_per_sec_per_device", "runs": []}
    if path.exists():
        old = json.loads(path.read_text())
        if old.get("schema") == SCHEMA:
            doc = old
    doc["runs"].extend(entries)
    path.write_text(json.dumps(doc, indent=2) + "\n")


def main(argv=None) -> list:
    """Measure, assert the digests equal, print the CSV; returns the rows."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.benchmarks.run bench",
        description="Steady-state simulator throughput (events/s/device) per "
                    "cache-step backend, at fig08 scale")
    ap.add_argument("--kernel-backend", default="both",
                    choices=("both",) + KERNEL_BACKENDS,
                    help="which backend(s) to measure (default: both, "
                         "asserting that their metric digests are equal)")
    ap.add_argument("--quick", action="store_true",
                    help=f"fig08's grid subsampled to {len(QUICK_BLOCKS)} block "
                         f"sizes x {QUICK_WORKLOADS} workloads, T={QUICK_T}")
    ap.add_argument("--repeats", type=int, default=3,
                    help="executions per backend; the best run_s is reported")
    ap.add_argument("--device", default="cuda",
                    help="torch device to simulate on (default: cuda)")
    ap.add_argument("--telemetry", action="store_true",
                    help="record a host span timeline (plan / repeat / the "
                         "executor's spans a backend) to DIR/trace/bench_famsim.json "
                         "under --out")
    ap.add_argument("--no-roofline", action="store_true",
                    help="skip the roofline record (DIR/roofline/famsim_step.json)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help=f"write the rows to DIR/{NAME}.json and append the "
                         f"trajectory entries to DIR/{TRAJECTORY}")
    args = ap.parse_args(argv)

    backends = KERNEL_BACKENDS if args.kernel_backend == "both" \
        else (args.kernel_backend,)
    with obs_tracer(NAME, int(args.telemetry), args.out):
        measured = [measure(b, args.quick, args.repeats, args.device)
                    for b in backends]
    roofline = [] if args.no_roofline else \
        [roofline_record(m, args.device) for m in measured]
    for m in measured:
        m.pop("plan")
    digests = {m["backend"]: m["digest"] for m in measured}
    assert len(set(digests.values())) == 1, (
        "kernel backends disagree on the metrics: the CUDA cache step must "
        "be bit-identical to its plain version", digests)

    rows = [{"name": f"{NAME}_{m['backend']}", "us_per_call": m["us_per_event"],
             # deterministic: the digest and the true event count only
             "derived": f"digest={m['digest']};events={m['events']}",
             **{k: v for k, v in m.items() if k != "us_per_event"}}
            for m in measured]
    if args.out is not None:
        save_rows(NAME, rows, args.out)
        if roofline:
            path = Path(args.out) / ROOFLINE
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(roofline, indent=2) + "\n")
        _append_trajectory(Path(args.out) / TRAJECTORY, [
            {k: v for k, v in r.items() if k not in ("engine", "us_per_call")}
            | {"quick": bool(args.quick)} for r in rows])

    print("name,us_per_call,derived")
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.3f},\"{r['derived']}\"", flush=True)
    for m in measured:
        print(f"# {m['backend']}: {m['events_per_sec_per_device']} events/s/device "
              f"(best run_s {m['run_s_best']} s of {m['run_s_all']}, captures "
              f"{m['compile_s']} s)", flush=True)
    for r in roofline:
        per_event = sum(g["bytes_per_event"] * g["events"] for g in r["groups"]) / r["events"]
        print(f"# roofline {r['backend']}: {per_event:.6g} counted bytes an event, memory "
              f"bound {r['memory_s'] / r['events'] * 1e6:.6g} us an event (H100 peak) against "
              f"{r['us_per_event']:.6g} us measured", flush=True)
    if len(measured) > 1:
        base, other = measured[0], measured[1]
        print(f"# {other['backend']} vs {base['backend']}: "
              f"{base['run_s_best'] / max(other['run_s_best'], 1e-12):.2f}x, "
              "digests match", flush=True)
    return rows


if __name__ == "__main__":
    main()
