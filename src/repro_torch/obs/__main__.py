"""CLI: ``python -m repro_torch.obs {report,validate} <file.json>``.

Counterpart of ``python -m repro.obs``. ``report`` renders a saved
telemetry payload (``<out>/telemetry/<figure>.json``, written by
``python -m repro_torch.benchmarks.run --telemetry --out <out>``) as a
text/markdown dashboard; ``validate`` checks a saved Chrome trace
(``<out>/trace/<figure>.json``) parses and its spans nest correctly,
exiting non-zero on any problem. Both read JSON only: no card needed.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.report import load_telemetry, render_report, validate_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="render a telemetry payload as a "
                                       "windowed-stream dashboard")
    rp.add_argument("path", help="<out>/telemetry/<figure>.json")
    rp.add_argument("--point", type=int, default=None,
                    help="render only this point index (default: first "
                         "few points)")
    rp.add_argument("--all", action="store_true",
                    help="render every point (default caps at 4)")
    rp.add_argument("--format", choices=("text", "md"), default="text")
    vp = sub.add_parser("validate", help="validate a Chrome trace-event "
                                         "JSON (parse + span nesting)")
    vp.add_argument("path", help="<out>/trace/<figure>.json")
    args = ap.parse_args(argv)

    if args.cmd == "report":
        payload = load_telemetry(args.path)
        print(render_report(payload, point=args.point, fmt=args.format,
                            limit=0 if args.all else 4))
        return 0
    problems = validate_trace(args.path)
    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    print(f"{args.path}: valid Chrome trace-event JSON, spans nest "
          f"correctly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
