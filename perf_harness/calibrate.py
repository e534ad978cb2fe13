"""The readings the correctness check's limit is set from.

    python perf_harness/calibrate.py --workload <cell> --seeds 12 --control-seeds 3

from the root of a checkout, on a card. After the cell's set-up, for each
of ``--seeds`` run seeds it runs one sweep of the cell at its full size
through the timed path and compares the systems a run with that seed would
check with the plain reference, as ``run.py`` does: the largest of these
gaps is the lower reading. For the first ``--control-seeds`` seeds it also
runs the control, the reference computed in bfloat16 in the program's
place, on the same systems: the smallest of its gaps is the upper reading.
Prints one JSON line a seed and a summary line. The benchmark's own runs
never run the control.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, control_seeds: int, device: str, out=print):
    """Program and control readings of ``cell`` on ``seeds``; returns the
    summary (the largest program gap, the smallest control gap)."""
    from perf_harness.lib import check, experiment
    from perf_harness.lib.runner import _sweep
    systems = check.resolve(cell.config, cell.traffic)
    spec = cell.spec["check"]
    _sweep(cell, experiment.sweep_seed(seeds[0], "warm"), device)
    lower, upper = [], []
    for n, seed in enumerate(seeds):
        s = experiment.sweep_seed(seed, 0)
        _, result = _sweep(cell, s, device)
        sweeps = [(s, result.metrics)]
        program = check.compare(systems, cell.traffic, sweeps, spec, seed)
        lower.append(program["max_rel_gap"])
        line = {"seed": seed, "program": program["max_rel_gap"], "systems": program["gaps"]}
        if n < control_seeds:
            control = check.compare(systems, cell.traffic, sweeps, spec, seed, control=True)
            upper.append(control["max_rel_gap"])
            line.update(control=control["max_rel_gap"], control_systems=control["gaps"])
        out(json.dumps(line))
    summary = {"cell": cell.name, "seeds": len(seeds), "lower": max(lower),
               "control_seeds": len(upper), "upper": min(upper) if upper else None}
    out(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perf_harness.lib.manifest import load_cell
    import torch
    if not torch.cuda.is_available():
        print("calibrate.py reads the program on a card; none is visible", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    readings(cell, seeds, args.control_seeds, "cuda",
             out=lambda line: print(line, flush=True))
    print(f"{time.perf_counter() - STARTED:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
