"""Roofline report: reads a dry run's records (``<dir>/*.json``, as
:mod:`repro_torch.launch.dryrun` writes them under ``--out``) and prints
the roofline table (per-cell three terms, bottleneck, MODEL_FLOPS ratio,
improvement note) and the bottleneck counts.

Counterpart of ``repro.roofline.report``, which reads the reference's
fixed results directory; the port reads the directory it is given.

Usage: PYTHONPATH=src python -m repro_torch.roofline.report --dir DIR
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

NOTES = {
    ("train", "memory"): ("cut activation traffic: bf16 stash/cotangents, "
                          "seq-shard activations, fuse norm chains"),
    ("train", "compute"): ("collapse chunked-attention rectangle waste "
                           "(2x causal flops) / pad heads to the TP axis"),
    ("train", "collective"): ("reduce-scatter grads once per step (not per "
                              "microbatch); int8-compress pod-axis reduce"),
    ("prefill", "memory"): ("flash-attention kernel (no score "
                            "materialization); KV emission in bf16"),
    ("prefill", "compute"): ("triangular block schedule for causal "
                             "attention (halves attention flops)"),
    ("prefill", "collective"): "shard KV seq instead of replicating heads",
    ("decode", "memory"): ("KV reads dominate: int8 KV blocks (2x), "
                           "tiered-KV hot set in HBM (paper mechanism)"),
    ("decode", "compute"): "batch decode steps / speculative decoding",
    ("decode", "collective"): ("move batch sharding off the KV-seq axis; "
                               "all-gather one partial softmax instead of "
                               "per-layer collectives"),
}


def load(directory):
    """The ``ok`` records of ``directory`` (``*.json``), by file name."""
    rows = []
    for f in sorted(Path(directory).glob("*.json")):
        d = json.loads(f.read_text())
        if d.get("status") == "ok":
            rows.append(d)
    return rows


def fmt(x, digits=3):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x:.2e}"
    return f"{x:.{digits}f}"


def table(rows, hillclimb=()):
    out = ["| arch | shape | compute s | memory s | collective s | "
           "bottleneck | useful flops | MFU bound | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        r = d["roofline"]
        kind = d.get("kind", "?")
        note = NOTES.get((kind, r["bottleneck"]), "")
        mark = " **(hillclimb)**" if (d["arch"], d["shape"]) in hillclimb else ""
        out.append(
            f"| {d['arch']}{mark} | {d['shape']} | {fmt(r['compute_s'])} | "
            f"{fmt(r['memory_s'])} | {fmt(r['collective_s'])} | "
            f"{r['bottleneck']} | {fmt(min(r['useful_flops_ratio'], 99))} | "
            f"{fmt(r['mfu_bound'], 4)} | {note} |")
    return "\n".join(out)


HILLCLIMB = (("xlstm-350m", "train_4k"), ("arctic-480b", "train_4k"),
             ("qwen2-vl-72b", "decode_32k"))


def bottlenecks(rows) -> dict:
    """{bottleneck: cells}."""
    bn = {}
    for d in rows:
        bn[d["roofline"]["bottleneck"]] = bn.get(d["roofline"]["bottleneck"], 0) + 1
    return bn


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.roofline.report")
    ap.add_argument("--dir", "--out", dest="dir", required=True, metavar="DIR",
                    help="a dry run's --out directory (its *.json records)")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    print(table(rows, hillclimb=HILLCLIMB))
    print(f"\ncells={len(rows)} bottlenecks={bottlenecks(rows)}")


if __name__ == "__main__":
    main()
