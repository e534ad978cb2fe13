"""``python -m repro_torch.analysis [paths...] [--strict]`` — the CI gate.

Counterpart of ``repro.analysis.cli``. Collects ``.py`` files under the
given paths (default: ``src/repro_torch`` relative to the repo root, the
port's whole tree, its benchmark drivers included), builds the introspected
registry, runs the four check families, filters through the allowlist,
and prints one block per finding::

    src/repro_torch/core/foo.py:42:8: TC201 [step] Python `if` on a traced ...
        hint: use torch.where masking ...

Exit status: 0 when every finding is allowlisted, 1 otherwise.
``--strict`` (CI) additionally fails on allowlist hygiene: entries
without a ``reason`` and *stale* entries that no longer match anything —
the allowlist can only ever shrink to fit the tree.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.checks import analyze_source
from repro_torch.analysis.findings import (CHECKS, Allowlist, Finding,
                                           load_allowlist, sort_findings)
from repro_torch.analysis.registry import Registry, build_registry

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "results"}


def _collect_files(paths: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_file() and path.suffix == ".py":
            files.append(path)
        elif path.is_dir():
            files.extend(
                f for f in sorted(path.rglob("*.py"))
                if not (_SKIP_DIRS & set(part.name for part in f.parents)))
    return files


def _repo_relative(path: Path) -> str:
    """Findings print repo-relative paths when possible (stable across
    machines — what the allowlist suffix-matches against)."""
    try:
        return str(path.resolve().relative_to(Path.cwd().resolve()))
    except ValueError:
        return str(path)


def analyze_paths(paths: Sequence[str],
                  registry: Optional[Registry] = None,
                  ) -> Tuple[List[Finding], List[Finding]]:
    """Run the analyzer; returns (static findings, registry findings)."""
    if registry is None:
        registry, reg_findings = build_registry()
    else:
        reg_findings = []
    findings: List[Finding] = []
    for f in _collect_files(paths):
        findings.extend(
            analyze_source(f.read_text(), _repo_relative(f), registry))
    return sort_findings(findings), reg_findings


def run_analysis(paths: Sequence[str], *, strict: bool = False,
                 allowlist: Optional[Allowlist] = None,
                 out=None) -> int:
    """The CLI body, importable (``repro_torch.benchmarks.run --check``
    uses it); prints to ``out`` (default: the current ``sys.stdout``).
    Returns the process exit code."""
    out = sys.stdout if out is None else out
    allow = load_allowlist() if allowlist is None else allowlist
    static, runtime = analyze_paths(paths)
    everything = runtime + static

    reported = [f for f in everything if not allow.allows(f)]
    allowed = len(everything) - len(reported)

    for f in reported:
        print(f.format(), file=out)

    problems = len(reported)
    if strict:
        for e in allow.unjustified_entries():
            print(f"allowlist: entry ({e.check}, {e.path}, {e.symbol}) has "
                  "no reason= justification", file=out)
            problems += 1
        for e in allow.stale_entries():
            print(f"allowlist: stale entry ({e.check}, {e.path}, "
                  f"{e.symbol}) matches no finding — remove it", file=out)
            problems += 1

    print(f"repro_torch.analysis: {len(everything)} finding(s), "
          f"{allowed} allowlisted, {len(reported)} reported"
          + (" [strict]" if strict else ""), file=out)
    return 1 if problems else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Capture-safety & compile-key hygiene analyzer of the "
                    "PyTorch port")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to scan (default: "
                         "src/repro_torch relative to the repo root)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on allowlist hygiene (entries missing "
                         "a reason, stale entries) — the CI mode")
    ap.add_argument("--allowlist", default=None, metavar="PATH",
                    help="alternative allowlist.toml (default: the one "
                         "packaged with repro_torch.analysis)")
    ap.add_argument("--list-checks", action="store_true",
                    help="print the check catalog and exit")
    args = ap.parse_args(argv)

    if args.list_checks:
        for cid in sorted(CHECKS):
            print(f"{cid}  {CHECKS[cid]}")
        return 0

    paths = args.paths
    if not paths:
        paths = [str(Path(__file__).resolve().parents[1])]
    allow = load_allowlist(Path(args.allowlist)) if args.allowlist else None
    return run_analysis(paths, strict=args.strict, allowlist=allow)
