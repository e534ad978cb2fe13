"""Multi-tenant fleet scenario driver (``python -m repro_torch.benchmarks.run pond``).

Counterpart of the reference's ``benchmarks/fig_pond.py``: sweeps tenant
count x weight skew x admission policy as ONE compile group. Every tenant
of every fleet (plus the deduplicated isolated baselines) is a system lane
of a single ``grid_axis("tenant", ...)`` Experiment over
:mod:`repro_torch.tenants`: per-tenant QoS knobs (WFQ weight, issue-rate
entitlement) ride per-system policy params, contention-derated
bandwidth/latency per-system config values, and admission gates lifetimes
through the masked runner's ``t_live``, so fleet size only widens the
system axis: one CUDA graph capture on the card, its cache-step kernel
launched once an event for all lanes.

Rows: one per fleet with the tail/fairness aggregates (p50/p95/p99 from
the in-run latency histogram, slowdown-vs-isolated geomean, Jain index,
SLO-violation counts) and the per-tenant records under ``tenants_detail``
(schema: :data:`repro_torch.tenants.metrics.TENANT_SCHEMA`), plus the
``pond_engine`` accounting row. Written to ``<out>/fig_pond.json`` only
under ``--out`` (with the telemetry windows and the span trace when
``--telemetry`` is given)::

    python -m repro_torch.benchmarks.run pond              # {16, 64, 256} tenants, on the card
    python -m repro_torch.benchmarks.run pond --full       # adds 1024-tenant fleets and "cap"
    python -m repro_torch.benchmarks.run pond --plan       # the fleet grid's compile group
    python -m repro_torch.benchmarks.run pond --device cpu --out /tmp/rows
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from repro_torch.benchmarks.common import (QUICK_WORKLOADS, info_row, obs_tracer,
                                           plan_lines, save_outputs)
from repro_torch.configs.base import FamConfig
from repro_torch.tenants import (FleetSpec, fleet_report, lower_fleets,
                                 make_tenants)

NAME = "fig_pond"
T = 4096
T_QUICK = 1024
N_WINDOWS = 8

#: the sweep: tenant count x weight skew x admission policy
COUNTS = (16, 64, 256, 1024)
COUNTS_QUICK = (16, 64, 256)
SKEWS = ("uniform", "zipf")
ADMISSIONS = ("none", "cap", "load_shed")
ADMISSIONS_QUICK = ("none", "load_shed")
#: the default sweep's largest fleet must reach this many tenants
MIN_LARGEST = 256


def default_fleets(quick: bool = True) -> List[FleetSpec]:
    counts = COUNTS_QUICK if quick else COUNTS
    admissions = ADMISSIONS_QUICK if quick else ADMISSIONS
    pool = QUICK_WORKLOADS if quick else None
    fleets = []
    for count in counts:
        for skew in SKEWS:
            for adm in admissions:
                fleets.append(FleetSpec(
                    name=f"c{count}_{skew}_{adm}",
                    tenants=make_tenants(count, skew=skew, workloads=pool),
                    admission=adm, max_tenants=count // 2))
    return fleets


def lowered(quick: bool = True, kernel_backend: str = "cuda",
            telemetry: int = 0, trace_backend: str = "device",
            fleets: Optional[Sequence[FleetSpec]] = None):
    """The fleets lowered onto one Experiment (telemetry always on: the
    tail metrics read the in-run histogram; ``telemetry`` picks the
    window count, default N_WINDOWS)."""
    base = FamConfig(kernel_backend=kernel_backend,
                     telemetry=telemetry or N_WINDOWS)
    return lower_fleets(fleets if fleets is not None else default_fleets(quick),
                        base=base, T=T_QUICK if quick else T,
                        trace_backend=trace_backend, name=NAME)


def experiment(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", telemetry: int = 0):
    """The ``--plan`` hook (same shape as every figure module's)."""
    return lowered(quick, kernel_backend, telemetry, trace_backend).experiment


def run_result(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", out=None,
               telemetry: int = 0, fleets: Optional[Sequence[FleetSpec]] = None):
    """(rows, ExperimentResult, Lowered): the whole fleet sweep in one
    executor call, asserted to be one planned group (and one capture on
    the card); then the per-fleet rows and the engine row."""
    low = lowered(quick, kernel_backend, telemetry, trace_backend, fleets)
    biggest = max(f.size for f in low.fleets)
    assert biggest >= MIN_LARGEST or fleets is not None, \
        f"fleet sweep tops out at {biggest} tenants (acceptance: >= {MIN_LARGEST})"
    plan = low.experiment.plan()
    assert plan.num_groups == 1, (
        f"fleet sweep planned {plan.num_groups} compile groups; the whole "
        "population must fold into one", [str(g.key) for g in plan.groups])
    with obs_tracer(NAME, telemetry, out):
        result = low.experiment.run(assert_compiles=True, device=device)
    info = result.info
    # one group: one runner-cache lookup, a capture only on a miss
    assert info.exec_cache_hits + info.exec_cache_misses == 1 and \
        info.compiles <= info.exec_cache_misses, info.groups
    summaries, records = fleet_report(result, low)
    by_fleet = {}
    for r in records:
        by_fleet.setdefault(r["fleet"], []).append(r)
    rows = [{"name": f"pond_{s['fleet']}", "us_per_call": info.us_per_call(),
             **s, "tenants_detail": by_fleet[s["fleet"]]} for s in summaries]
    rows.append(info_row("pond_engine", info, fleets=len(low.fleets),
                         tenant_lanes=len(low.cells),
                         isolated_lanes=len(low.iso_labels),
                         largest_fleet=biggest))
    save_outputs(NAME, rows, result, telemetry, out)
    return rows, result, low


def run(quick: bool = True, trace_backend: str = "device",
        kernel_backend: str = "cuda", device="cuda", out=None,
        telemetry: int = 0, fleets: Optional[Sequence[FleetSpec]] = None):
    return run_result(quick, trace_backend, kernel_backend, device, out,
                      telemetry, fleets)[0]


def main(argv=None) -> list:
    """Run the sweep and print the ``name,us_per_call,derived`` CSV;
    returns the rows (none with ``--plan``)."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.benchmarks.run pond",
        description="Multi-tenant fleet scenario (repro_torch.tenants)")
    ap.add_argument("--quick", action="store_true", default=True,
                    help="fleets of {16, 64, 256} tenants at T=1024 over the "
                         "quick workloads (the default; --full overrides)")
    ap.add_argument("--full", action="store_true",
                    help="adds 1024-tenant fleets and the 'cap' admission, "
                         "T=4096, all 19 workloads")
    ap.add_argument("--plan", action="store_true",
                    help="print the fleet grid's compile group(s) and axis "
                         "sizes; run nothing")
    ap.add_argument("--device", default="cuda",
                    help="torch device to simulate on (default: cuda)")
    ap.add_argument("--trace-backend", choices=("device", "numpy"), default="device")
    ap.add_argument("--kernel-backend", choices=("cuda", "torch"), default="cuda")
    ap.add_argument("--telemetry", type=int, default=0, metavar="N_WINDOWS",
                    help=f"histogram windows a run (default {N_WINDOWS}; always "
                         "on: the tail metrics need the in-run histogram); a "
                         "non-zero value also records the span timeline")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help=f"write the rows to DIR/{NAME}.json")
    args = ap.parse_args(argv)
    quick = not args.full

    if args.plan:
        exp = experiment(quick, args.trace_backend, args.kernel_backend, args.telemetry)
        for line in plan_lines(exp.plan(), exp.axes):
            print(line)
        return []

    rows = run(quick=quick, trace_backend=args.trace_backend,
               kernel_backend=args.kernel_backend, device=args.device,
               out=args.out, telemetry=args.telemetry)
    print("name,us_per_call,derived")
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.3f},\"{r['derived']}\"", flush=True)
    return rows


if __name__ == "__main__":
    main()
