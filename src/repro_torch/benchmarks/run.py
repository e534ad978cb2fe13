"""Run the port's paper-figure drivers and print ``name,us_per_call,derived``.

Counterpart of the reference's ``benchmarks/run.py`` for the figures the
port has (fig08, fig14, fig16)::

    python -m repro_torch.benchmarks.run                       # all, quick, on the card
    python -m repro_torch.benchmarks.run --only fig14 --device cpu
    python -m repro_torch.benchmarks.run fig08 --trace-backend numpy
    python -m repro_torch.benchmarks.run --full --out /tmp/rows   # JSON rows there
    python -m repro_torch.benchmarks.run --plan                # compile groups only

``--device`` defaults to ``cuda`` (the run fails without a card rather
than fall back to the CPU). JSON rows are written only under ``--out``.
"""
from __future__ import annotations

import argparse
import sys
import time

FIGURE_NAMES = ("fig08", "fig14", "fig16")


def _figures():
    from repro_torch.benchmarks import fig08_blocksize, fig14_mixes, fig16_cachesize
    return {"fig08": fig08_blocksize, "fig14": fig14_mixes,
            "fig16": fig16_cachesize}


def main(argv=None) -> None:
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
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write each figure's JSON rows to DIR/<figure>.json")
    ap.add_argument("--plan", action="store_true",
                    help="print each figure's compile groups and run nothing")
    args = ap.parse_args(argv)

    figures = _figures()
    keep = set(args.figures)
    if args.only:
        keep |= set(args.only.split(","))
    if keep:
        unknown = keep - set(figures)
        if unknown:
            ap.error(f"unknown figures: {sorted(unknown)} (choose from {list(figures)})")
        figures = {k: v for k, v in figures.items() if k in keep}

    if args.plan:
        from repro_torch.benchmarks.common import plan_lines
        for mod in figures.values():
            exp = mod.experiment(quick=not args.full,
                                 trace_backend=args.trace_backend,
                                 kernel_backend=args.kernel_backend)
            for line in plan_lines(exp.plan(), exp.axes):
                print(line)
        return

    print("name,us_per_call,derived")
    for key, mod in figures.items():
        t0 = time.time()
        rows = mod.run(quick=not args.full, trace_backend=args.trace_backend,
                       kernel_backend=args.kernel_backend, device=args.device,
                       out=args.out)
        for r in rows:
            print(f"{r['name']},{r['us_per_call']:.3f},\"{r['derived']}\"",
                  flush=True)
        print(f"# {key} wall={time.time() - t0:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
