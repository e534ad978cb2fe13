"""Host (numpy) trace generators — the ``numpy`` trace backend.

A copy of ``repro.traces.host`` (held bit-equal by a test). A trace is
(addr_bytes int64 (T,), gap_cycles float32 (T,)): LLC-miss byte addresses
and compute gaps between consecutive misses.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.traces.specs import (ADDR_HASH, GAP_SIGMA, HOT_REGION_DIV, LINE,
                                TILE_JITTER, WORKLOADS, WorkloadSpec, _lines,
                                mean_gap_cycles, node_seed,
                                      trace_seed)


def _per_stream_occurrence(pick: np.ndarray, streams: int) -> np.ndarray:
    """occ[i] = how many earlier events chose the same stream as event i.

    Vectorized replacement for the per-event python loop: each stream's
    events get 0,1,2,... in order, so position_i = start_i + occ_i * stride."""
    occ = np.empty(pick.shape[0], np.int64)
    for s in range(streams):
        m = pick == s
        occ[m] = np.arange(int(m.sum()), dtype=np.int64)
    return occ


def _stream(spec, rng, T):
    n = _lines(spec)
    starts = rng.integers(0, n, spec.streams).astype(np.int64)
    pick = rng.integers(0, spec.streams, T)
    occ = _per_stream_occurrence(pick, spec.streams)
    return (starts[pick] + occ) % n


def _strided(spec, rng, T):
    n = _lines(spec)
    starts = rng.integers(0, n, spec.streams).astype(np.int64)
    pick = rng.integers(0, spec.streams, T)
    occ = _per_stream_occurrence(pick, spec.streams)
    return (starts[pick] + occ * spec.stride) % n


def _tiled(spec, rng, T):
    n = _lines(spec)
    tile = spec.tile_lines
    out = np.empty(T, np.int64)
    i = 0
    while i < T:
        base = rng.integers(0, max(n - tile, 1))
        span = min(int(rng.integers(tile // 2, tile)), T - i)
        # row-major sweep of the tile with small jitter (stencil reuse)
        idx = base + (np.arange(span) % tile)
        jitter = rng.integers(-TILE_JITTER, TILE_JITTER + 1, span)
        out[i:i + span] = np.clip(idx + jitter, 0, n - 1)
        i += span
    return out


def _zipf(spec, rng, T):
    n = _lines(spec)
    if spec.zipf_a > 1.0:
        ranks = rng.zipf(spec.zipf_a, T).astype(np.int64)
    else:
        # a <= 1: weak skew — mixture of uniform and a hot region; the
        # hot probability is spec.hot_fraction (= zipf_a / 2, documented
        # on WorkloadSpec so the parameter reads as a probability)
        hot = rng.integers(0, max(n // HOT_REGION_DIV, 1), T)
        cold = rng.integers(0, n, T)
        ranks = np.where(rng.random(T) < spec.hot_fraction, hot, cold)
    # Reduce ranks mod n BEFORE the hash multiply: (r % n) * M % n ==
    # r * M % n mathematically, but rng.zipf's heavy tails (a close to 1)
    # return ranks up to 2**63 - 1, and r * ADDR_HASH would silently wrap
    # int64 for r > ~3.4e9 — for small footprints a third of the samples.
    # The explicit modulo keeps the multiply exact (n < 2**25, so
    # (n-1) * ADDR_HASH < 2**57) and is a no-op for in-range ranks.
    ranks = ranks % n
    # hash ranks over the footprint so hot lines are scattered
    return (ranks * ADDR_HASH) % n


def _graph(spec, rng, T):
    n = _lines(spec)
    seq = _stream(spec, rng, T)
    rnd = _zipf(spec, rng, T)
    take_seq = rng.random(T) < spec.seq_frac
    return np.where(take_seq, seq, rnd)


def _mixed(spec, rng, T):
    seq = _stream(spec, rng, T)
    rnd = _zipf(spec, rng, T)
    take_seq = rng.random(T) < spec.seq_frac
    return np.where(take_seq, seq, rnd)


_PATTERNS = {"stream": _stream, "strided": _strided, "tiled": _tiled,
             "zipf": _zipf, "graph": _graph, "mixed": _mixed}


def generate(name: str, T: int, seed: int = 0, base_ipc: float = 2.0
             ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (addr_bytes (T,) int64, gap_cycles (T,) float32)."""
    spec = WORKLOADS[name]
    rng = np.random.default_rng(trace_seed(name, seed))
    lines = _PATTERNS[spec.pattern](spec, rng, T)
    addrs = lines * LINE
    # compute gap between misses: 1000/mpki instructions at base_ipc,
    # log-normal jitter (bursty miss clusters)
    gaps = rng.lognormal(mean=0.0, sigma=GAP_SIGMA, size=T) * \
        mean_gap_cycles(spec, base_ipc)
    return addrs.astype(np.int64), gaps.astype(np.float32)


def system_traces(workloads: Sequence[str], T: int, seed: int,
                  backend: str = "numpy") -> Tuple[np.ndarray, np.ndarray]:
    """(N, T) node traces for one system, per-node seeds via ``node_seed``.
    Only the ``numpy`` backend is ported; the ``device`` backend waits for
    the threefry port."""
    if backend != "numpy":
        raise ValueError(f"trace backend {backend!r} is not ported; use 'numpy'")
    pairs = [generate(w, T, node_seed(seed, i)) for i, w in enumerate(workloads)]
    return (np.stack([a for a, _ in pairs]), np.stack([g for _, g in pairs]))
