"""Run one cell of ``BENCHMARK.json`` once.

    python perf_harness/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the run's progress and, as its last
lines on standard error, each number the correctness check compared with
its limit; the last line of standard output is the result, one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and ``checked`` last). With ``--trace 0``
the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones.

Exits non-zero and prints no result when no CUDA device is visible or fewer
than the cell asks for, when the program cannot be imported, and when the
JAX package or JAX itself was loaded by the time the window closed.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that must not be loaded in a run: JAX, and the JAX
#: package the program was ported from (compared by the whole name:
#: ``repro_torch`` is the program)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # every build and kernel cache of the program inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    from perf_harness.lib.manifest import load_cell
    from perf_harness.lib.runner import log, run_cell

    cell = load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    log(f"{cell.name}: seed {args.seed}, {args.seconds} s, trace {args.trace}; "
        f"{power_limit()}; torch {torch.__version__}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark measures the port alone")
        return 3
    for name, c in result["checked"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
