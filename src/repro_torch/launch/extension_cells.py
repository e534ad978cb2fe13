"""Cells beyond the assigned grid.

Counterpart of ``repro.launch.extension_cells``. The grid skips
``long_500k`` for pure full-attention archs (prefill and train are
quadratic), but *decode* against a 500k-token KV cache is linear per
token, and with the cache sharded along its sequence it fits. This
script runs yi-9b's ``long_500k`` decode on the dry run's fake mesh with
``run_long_context`` set in the config it passes, and writes the record
under ``--out``/extensions (not in the grid's records).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.extension_cells --device cpu --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as DR


def long_context_decode(out: Optional[Path], *, cfg=None,
                        mesh_shape: Optional[Sequence[int]] = None, device="cuda") -> dict:
    """yi-9b ``long_500k`` decode (``cfg`` defaults to the registry's
    yi-9b with ``run_long_context``); the record goes to
    ``out``/extensions when ``out`` is given."""
    cfg = cfg or dataclasses.replace(get_config("yi-9b"), run_long_context=True)
    out_dir = Path(out) / "extensions" if out is not None else None
    return DR.run_cell("yi-9b", "long_500k", False, out_dir, cfg=cfg,
                       mesh_shape=mesh_shape, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.extension_cells")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (default: cuda; cpu needs no card)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write the record to DIR/extensions/")
    args = ap.parse_args(argv)
    info = long_context_decode(args.out, device=args.device)
    raise SystemExit(0 if info["status"] == "ok" else 1)


if __name__ == "__main__":
    main()
