"""The simulated work of an event step, counted from the configuration's
sizes, and the card's peaks.

The count is of what the simulated hardware's model has to move, not of
what the program's ops move, so it reads the same whatever implements the
step. Per lane (one simulated node) and event, with W ways, C fills, D
prefetch candidates, P = D + core prefetches, Q queue entries, E fill
buffer entries, 4-byte tags, stamps, deltas, weights, times and counters:

* the demand's set row, tags and recency, read once and written once:
  2 x 8 W;
* the C fill rows, likewise: 2 x 8 W C;
* the P redundancy-probe rows, tags only, read (the step writes none):
  4 W P;
* SPP: the signature entry (tag, last block, signature) read and written
  (2 x 12), the trained pattern row (4 deltas, 4 weights, the signature
  weight) read and written (2 x 36) and the D lookahead rows read (36 D);
* the prefetch queue (block, finish) read and written: 2 x 8 Q;
* the core fill buffer (line, finish) read, and its written entries:
  8 E + 8 (P - D);
* the carry's 25 scalars (clock, rate controller, stride prefetcher,
  stamp, accumulators) read and written: 2 x 100;
* the event's address and gap: 8;
* per system, the FAM controller's two busy times read and written: 16,
  shared by its N nodes.
"""
from __future__ import annotations

from typing import Dict, Optional

#: NVIDIA H100 SXM (data sheet, dense, 700 W): HBM3 bytes/s
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12}}
CARRY_SCALARS = 25


def peak(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    None for a card the table lacks."""
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None


def _shape(config: Dict):
    W, C, D = config["cache_ways"], config["completions_per_step"], config["prefetch_degree"]
    P = D + config["core_pf_degree"]
    return W, C, D, P, config["prefetch_queue"], config["core_fill_entries"]


def cache_step_lane_bytes(config: Dict) -> int:
    """One lane's bytes in the cache-step kernel: the set rows it reads and
    writes, the probe rows it reads, its operands and results."""
    W, C, D, P, _, _ = _shape(config)
    rows = 2 * 8 * W + 2 * 8 * W * C + 4 * W * P
    operands = 4 * C + C + 4 + 1 + 4 * P + 4 + 4 + 2 * 4     # fills, demand, probes, geometry, stamp
    results = 1 + P                                          # hit, probe hits
    return rows + operands + results


def lane_bytes(config: Dict, nodes: int) -> float:
    """One lane's bytes of one event step (see the module's docstring)."""
    W, C, D, P, Q, E = _shape(config)
    cache = 2 * 8 * W + 2 * 8 * W * C + 4 * W * P
    spp = 2 * 12 + 2 * 36 + 36 * D
    queue = 2 * 8 * Q
    fill_buffer = 8 * E + 8 * (P - D)
    carry = 2 * 4 * CARRY_SCALARS
    return cache + spp + queue + fill_buffer + carry + 8 + 16 / nodes


def step_bytes(config: Dict, lanes: int, nodes: int) -> float:
    """Bytes of one event step over ``lanes`` simulated nodes."""
    return lanes * lane_bytes(config, nodes)
