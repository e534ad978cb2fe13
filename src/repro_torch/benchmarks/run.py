"""Run the port's paper-figure drivers and print ``name,us_per_call,derived``.

Counterpart of the reference's ``benchmarks/run.py`` (fig08, fig10, fig12,
fig14, fig15, fig16 and the ``bench``, ``pond`` and ``search`` subcommands)::

    python -m repro_torch.benchmarks.run                       # all, quick, on the card
    python -m repro_torch.benchmarks.run fig10 fig12 fig15
    python -m repro_torch.benchmarks.run --only fig14 --device cpu
    python -m repro_torch.benchmarks.run fig08 --trace-backend numpy
    python -m repro_torch.benchmarks.run --full --out /tmp/rows   # JSON rows there
    python -m repro_torch.benchmarks.run --plan                # compile groups only

``--policies`` sweeps the policy zoo as a policy matrix on the figures
that support it (fig12); ``random`` replacement needs
``--kernel-backend torch``::

    python -m repro_torch.benchmarks.run --policies scheduler=fifo,wfq,strict \\
        --policies prefetch=spp,nextline,bestoffset fig12

``--telemetry [N]`` turns on the observability layer (:mod:`repro_torch.obs`):
N in-run telemetry windows a run (bare flag: 32), a host span timeline, and
with ``--out DIR`` the files ``DIR/telemetry/<figure>.json`` (render them
with ``python -m repro_torch.obs report``) and ``DIR/trace/<figure>.json``::

    python -m repro_torch.benchmarks.run fig12 --telemetry --out /tmp/rows
    python -m repro_torch.obs report /tmp/rows/telemetry/fig12_wfq.json

``bench`` hands the remaining arguments to the throughput benchmark
(:mod:`repro_torch.benchmarks.bench_famsim`), ``pond`` to the multi-tenant
fleet scenario (:mod:`repro_torch.benchmarks.fig_pond`), ``search`` to the
design-space search over the fig14 mixes
(:mod:`repro_torch.benchmarks.fig_search`)::

    python -m repro_torch.benchmarks.run bench --quick
    python -m repro_torch.benchmarks.run pond             # quick fleets, on the card
    python -m repro_torch.benchmarks.run search --out /tmp/search

``--check`` runs the port's static analyzer (:mod:`repro_torch.analysis`,
strict, over the port's tree) first and aborts on any finding it reports,
the pre-flight that catches a runner-key leak or a host sync in the
captured step before paying for the run::

    python -m repro_torch.benchmarks.run --check fig08

``--device`` defaults to ``cuda`` (the run fails without a card rather
than fall back to the CPU). JSON rows are written only under ``--out``.
"""
from __future__ import annotations

import argparse
import inspect
import itertools
import sys
import time
from pathlib import Path

FIGURE_NAMES = ("fig08", "fig10", "fig12", "fig14", "fig15", "fig16")


def _figures():
    from repro_torch.benchmarks import (fig08_blocksize, fig10_bw_adaptation,
                                        fig12_wfq, fig14_mixes, fig15_allocation,
                                        fig16_cachesize)
    return {"fig08": fig08_blocksize, "fig10": fig10_bw_adaptation,
            "fig12": fig12_wfq, "fig14": fig14_mixes,
            "fig15": fig15_allocation, "fig16": fig16_cachesize}


def main(argv=None):
    """Run the figures (None), or the ``bench`` / ``pond`` / ``search``
    subcommand (returning its rows)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "bench":
        # the throughput benchmark owns its whole argument tail
        from repro_torch.benchmarks import bench_famsim
        return bench_famsim.main(argv[1:])
    if argv and argv[0] == "pond":
        # so does the multi-tenant fleet scenario
        from repro_torch.benchmarks import fig_pond
        return fig_pond.main(argv[1:])
    if argv and argv[0] == "search":
        # and the design-space search
        from repro_torch.benchmarks import fig_search
        return fig_search.main(argv[1:])
    ap = argparse.ArgumentParser(
        description="Run the port's paper-figure drivers through "
                    "repro_torch.experiments")
    ap.add_argument("figures", nargs="*", metavar="figure",
                    help=f"figures to run (default: all of {', '.join(FIGURE_NAMES)})")
    ap.add_argument("--only", default=None,
                    help="comma list of figures (alternative to positional names)")
    ap.add_argument("--full", action="store_true",
                    help="all 19 workloads per figure (default: quick subset)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to simulate on (default: cuda)")
    ap.add_argument("--trace-backend", choices=("device", "numpy"),
                    default="device",
                    help="'device' generates each group's traces on --device "
                         "(default); 'numpy' stages the host generators")
    ap.add_argument("--kernel-backend", choices=("cuda", "torch"),
                    default="cuda",
                    help="cache step: the hand-written kernel (its plain "
                         "version on CPU tensors) or the plain version")
    ap.add_argument("--policies", action="append", default=None,
                    metavar="KIND=NAME[,NAME...]",
                    help="policy-matrix mode (repeatable): the cross-product of "
                         "the named policies per kind (prefetch / scheduler / "
                         "replacement / adaptation) as PolicySet combos, on "
                         "figures that support it (fig12); unlisted kinds keep "
                         "their defaults, and the all-default combo is the "
                         "baseline")
    ap.add_argument("--telemetry", nargs="?", const=32, default=0, type=int,
                    metavar="N_WINDOWS",
                    help="observability (repro_torch.obs): N_WINDOWS in-run "
                         "telemetry windows a run (bare flag: 32) and a host span "
                         "timeline; with --out written to DIR/telemetry/<figure>.json "
                         "and DIR/trace/<figure>.json. A static tag: 0 (default) "
                         "runs the step without it")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write each figure's JSON rows to DIR/<figure>.json")
    ap.add_argument("--plan", action="store_true",
                    help="print each figure's compile groups and run nothing")
    ap.add_argument("--check", action="store_true",
                    help="run the repro_torch.analysis static gate first (the "
                         "port's tree, strict mode) and abort on any "
                         "non-allowlisted finding")
    args = ap.parse_args(argv)

    if args.check:
        from repro_torch.analysis import run_analysis
        code = run_analysis([str(Path(__file__).resolve().parents[1])], strict=True)
        if code:
            sys.exit(code)
        print("# repro_torch.analysis: clean", file=sys.stderr)

    figures = _figures()
    keep = set(args.figures)
    if args.only:
        keep |= set(args.only.split(","))
    if keep:
        unknown = keep - set(figures)
        if unknown:
            ap.error(f"unknown figures: {sorted(unknown)} (choose from {list(figures)})")
        figures = {k: v for k, v in figures.items() if k in keep}

    combos = None
    if args.policies:
        combos = policy_combos(args.policies, ap.error)
        unsupported = [k for k, mod in figures.items()
                       if "policies" not in inspect.signature(mod.run).parameters]
        if unsupported:
            ap.error(f"--policies is not supported by {unsupported} "
                     "(supported: fig12); select supported figures explicitly")

    if args.plan:
        from repro_torch.benchmarks.common import plan_lines
        for mod in figures.values():
            kw = dict(quick=not args.full, trace_backend=args.trace_backend,
                      kernel_backend=args.kernel_backend, telemetry=args.telemetry)
            exp = mod.experiment(**kw) if combos is None else \
                mod.policy_experiment(combos, **kw)
            for line in plan_lines(exp.plan(), exp.axes):
                print(line)
        return

    print("name,us_per_call,derived")
    for key, mod in figures.items():
        t0 = time.time()
        kw = {} if combos is None else {"policies": combos}
        rows = mod.run(quick=not args.full, trace_backend=args.trace_backend,
                       kernel_backend=args.kernel_backend, device=args.device,
                       out=args.out, telemetry=args.telemetry, **kw)
        for r in rows:
            print(f"{r['name']},{r['us_per_call']:.3f},\"{r['derived']}\"",
                  flush=True)
        print(f"# {key} wall={time.time() - t0:.1f}s", file=sys.stderr)


def policy_combos(specs, error):
    """Parse repeated ``KIND=NAME[,NAME...]`` arguments into the
    cross-product of labelled PolicySets. A label joins the swept kinds'
    policy names in kind order (``spp+fifo``), so the all-default combo,
    the baseline, is labelled by its default names."""
    from repro_torch.policies import POLICY_KINDS, PolicySet, available

    swept = {}
    for spec in specs:
        kind, eq, names = spec.partition("=")
        if not eq or not names:
            error(f"--policies expects KIND=NAME[,NAME...], got {spec!r}")
        if kind not in POLICY_KINDS:
            error(f"unknown policy kind {kind!r} (kinds: {POLICY_KINDS})")
        for n in names.split(","):
            if n not in available(kind):
                error(f"unknown {kind} policy {n!r} (available: {available(kind)})")
        swept[kind] = names.split(",")
    kinds = [k for k in POLICY_KINDS if k in swept]
    return {"+".join(values): PolicySet(**dict(zip(kinds, values)))
            for values in itertools.product(*(swept[k] for k in kinds))}


if __name__ == "__main__":
    main()
