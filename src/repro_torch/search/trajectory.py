"""Search trajectory artifacts: deterministic JSONL and the winner record.

Counterpart of ``repro.search.trajectory`` (a copy). Two files, with a
deliberate determinism split:

* ``trajectory.jsonl`` — the canonical search record, **byte-identical
  across processes under a fixed seed**. One JSON object per line,
  canonical encoding (sorted keys, no whitespace), record types:

  - ``header``     — the search's fingerprint: space, proposer, seed,
    generations, population, T, mixes;
  - ``candidate``  — one evaluated sample: generation, label, sample,
    objective, penalized fitness, its group's runner key, and the
    deterministic *plan-level* ``warm`` flag (was this key already used
    by an earlier generation of this search — computed from the planner's
    keys, so a resumed process reproduces it exactly);
  - ``generation`` — the proposer state after ``tell`` and the RNG
    bit-generator state: the exact resume point.

  Nothing nondeterministic (wall clock, runtime capture counters) goes
  into this file.

* ``timings.jsonl`` — the runtime sidecar: per-generation wall clock and
  the executor's runtime cache accounting (``RunInfo.exec_cache_hits`` /
  ``compiles``, the graph captures). Not part of the byte-identity
  contract.

``best.json`` records the reproducible winner: the full sample, the
serialized PolicySet (policy names and param overrides), cfg overrides,
flags, seed, T and mixes — all that is needed to replay it as a plain
:class:`~repro_torch.experiments.Experiment` — plus the canonical
derived-metric string the replay must reproduce byte for byte.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple


def canonical_json(record: dict) -> str:
    """Canonical one-line encoding: sorted keys, no whitespace — the
    byte-identity contract is over exactly this encoding."""
    return json.dumps(record, sort_keys=True, separators=(",", ":"))


class TrajectoryWriter:
    """Append-only JSONL writer (one canonical line per record)."""

    def __init__(self, path, append: bool = False):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a" if append else "w")

    def write(self, record: dict) -> None:
        self._fh.write(canonical_json(record) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "TrajectoryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_trajectory(path) -> List[dict]:
    """Parse every record of a trajectory JSONL file."""
    out = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}: line {i + 1} is not valid JSON: {e}") from None
    return out


def split_records(records: Iterable[dict]
                  ) -> Tuple[Optional[dict], List[dict], List[dict]]:
    """``(header, candidate records, generation records)``."""
    header = None
    cands, gens = [], []
    for r in records:
        t = r.get("type")
        if t == "header":
            header = r
        elif t == "candidate":
            cands.append(r)
        elif t == "generation":
            gens.append(r)
    return header, cands, gens


def resume_state(path) -> Dict[str, Any]:
    """Everything a resumed search needs from an existing trajectory:
    the header, the last completed generation's proposer/RNG state, the
    exec keys already warmed, and the running best candidate.

    Raises ``ValueError`` when the file holds no completed generation
    (nothing to resume from — rerun from scratch instead).
    """
    records = read_trajectory(path)
    header, cands, gens = split_records(records)
    if header is None:
        raise ValueError(f"{path}: no header record")
    if not gens:
        raise ValueError(f"{path}: no completed generation to resume from")
    last = gens[-1]
    done = int(last["gen"])
    kept = [c for c in cands if int(c["gen"]) <= done]
    return {
        "header": header,
        "next_gen": done + 1,
        "proposer_state": last["proposer_state"],
        "rng_state": last["rng_state"],
        "warm_keys": {c["exec_key"] for c in kept},
        "candidates": kept,
    }


def write_best(path, record: dict) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(record, sort_keys=True, indent=2) + "\n")


def load_best(path) -> dict:
    return json.loads(Path(path).read_text())
