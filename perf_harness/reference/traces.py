"""The benchmark's own copy of the host trace generator.

A frozen copy of the synthetic LLC-miss trace model the simulator's numpy
trace backend uses: the workload table of the paper's Table III (each
workload's access-pattern class, footprint and miss intensity), the seed
derivation and the per-pattern generators. The reference regenerates every
checked system's node traces from the workload names and the sweep's seed
with this module, so it takes no trace from the program under test.

A trace is (addr_bytes int64 (T,), gap_cycles float32 (T,)): LLC-miss byte
addresses and compute gaps between consecutive misses.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

LINE = 64
GAP_SIGMA = 0.6          # log-normal jitter on compute gaps (bursty misses)
HOT_REGION_DIV = 20      # weak-skew hot region = footprint / 20
TILE_JITTER = 2          # +-2 line stencil jitter inside a tile
MIN_TILE_LINES = 64      # floor on the tile size (lines)
ADDR_HASH = 2654435761   # Knuth multiplicative hash scattering zipf ranks


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    suite: str
    footprint_mb: float
    mpki: float
    pattern: str
    zipf_a: float = 1.2
    streams: int = 4
    stride: int = 1       # in lines
    tile_kb: int = 256
    seq_frac: float = 0.8

    @property
    def hot_fraction(self) -> float:
        """Weak skew (``zipf_a <= 1``): probability of the hot region."""
        return min(max(self.zipf_a * 0.5, 0.0), 1.0)

    @property
    def tile_lines(self) -> int:
        return max(self.tile_kb * 1024 // LINE, MIN_TILE_LINES)


WORKLOADS: Dict[str, WorkloadSpec] = {s.name: s for s in [
    WorkloadSpec("603.bwaves_s", "SPEC17", 824, 22, "stream", streams=3),
    WorkloadSpec("607.cactuBSSN_s", "SPEC17", 257, 15, "strided", streams=6, stride=4),
    WorkloadSpec("619.lbm_s", "SPEC17", 1550, 28, "stream", streams=2),
    WorkloadSpec("628.pop2_s", "SPEC17", 590, 12, "tiled", tile_kb=512),
    WorkloadSpec("649.fotonik3d_s", "SPEC17", 587, 20, "strided", streams=8, stride=8),
    WorkloadSpec("654.roms_s", "SPEC17", 245, 18, "stream", streams=4),
    WorkloadSpec("657.xz_s", "SPEC17", 561, 9, "zipf", zipf_a=1.1),
    WorkloadSpec("LU", "Splash3", 515, 14, "tiled", tile_kb=128),
    WorkloadSpec("FFT", "Splash3", 625, 16, "strided", streams=2, stride=16),
    WorkloadSpec("bfs", "GAP", 864, 25, "graph", zipf_a=1.3, seq_frac=0.35),
    WorkloadSpec("cc", "GAP", 802, 27, "graph", zipf_a=1.2, seq_frac=0.25),
    WorkloadSpec("bc", "GAP", 593, 24, "graph", zipf_a=1.4, seq_frac=0.3),
    WorkloadSpec("sssp", "GAP", 545, 23, "graph", zipf_a=1.3, seq_frac=0.3),
    WorkloadSpec("dedup", "PARSEC", 868, 11, "mixed", zipf_a=1.0, seq_frac=0.6),
    WorkloadSpec("facesim", "PARSEC", 188, 8, "tiled", tile_kb=64),
    WorkloadSpec("canneal", "PARSEC", 849, 30, "zipf", zipf_a=0.9),
    WorkloadSpec("mg", "NPB", 431, 19, "strided", streams=4, stride=2),
    WorkloadSpec("is", "NPB", 1000, 26, "mixed", zipf_a=0.8, seq_frac=0.5),
    WorkloadSpec("XSBench", "XSBench", 611, 21, "zipf", zipf_a=1.05),
]}

WORKLOAD_NAMES = tuple(WORKLOADS)


def _lines(spec: WorkloadSpec) -> int:
    return max(int(spec.footprint_mb * (1 << 20) // LINE), 1 << 12)


def trace_seed(name: str, seed: int) -> int:
    return zlib.crc32(f"{name}:{seed}".encode())


def node_seed(seed: int, node_index: int) -> int:
    return seed + 1_000_003 * node_index


def mean_gap_cycles(spec: WorkloadSpec, base_ipc: float = 2.0) -> float:
    return (1000.0 / spec.mpki) / base_ipc


def _occurrence(pick: np.ndarray, streams: int) -> np.ndarray:
    """How many earlier events chose the same stream as each event."""
    occ = np.empty(pick.shape[0], np.int64)
    for s in range(streams):
        m = pick == s
        occ[m] = np.arange(int(m.sum()), dtype=np.int64)
    return occ


def _stream(spec, rng, T):
    n = _lines(spec)
    starts = rng.integers(0, n, spec.streams).astype(np.int64)
    pick = rng.integers(0, spec.streams, T)
    return (starts[pick] + _occurrence(pick, spec.streams)) % n


def _strided(spec, rng, T):
    n = _lines(spec)
    starts = rng.integers(0, n, spec.streams).astype(np.int64)
    pick = rng.integers(0, spec.streams, T)
    return (starts[pick] + _occurrence(pick, spec.streams) * spec.stride) % n


def _tiled(spec, rng, T):
    n = _lines(spec)
    tile = spec.tile_lines
    out = np.empty(T, np.int64)
    i = 0
    while i < T:
        base = rng.integers(0, max(n - tile, 1))
        span = min(int(rng.integers(tile // 2, tile)), T - i)
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
        hot = rng.integers(0, max(n // HOT_REGION_DIV, 1), T)
        cold = rng.integers(0, n, T)
        ranks = np.where(rng.random(T) < spec.hot_fraction, hot, cold)
    ranks = ranks % n                   # keeps the hash multiply inside int64
    return (ranks * ADDR_HASH) % n


def _graph(spec, rng, T):
    seq = _stream(spec, rng, T)
    rnd = _zipf(spec, rng, T)
    return np.where(rng.random(T) < spec.seq_frac, seq, rnd)


_PATTERNS = {"stream": _stream, "strided": _strided, "tiled": _tiled,
             "zipf": _zipf, "graph": _graph, "mixed": _graph}


def generate(name: str, T: int, seed: int = 0, base_ipc: float = 2.0
             ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (addr_bytes (T,) int64, gap_cycles (T,) float32)."""
    spec = WORKLOADS[name]
    rng = np.random.default_rng(trace_seed(name, seed))
    lines = _PATTERNS[spec.pattern](spec, rng, T)
    gaps = rng.lognormal(mean=0.0, sigma=GAP_SIGMA, size=T) * \
        mean_gap_cycles(spec, base_ipc)
    return (lines * LINE).astype(np.int64), gaps.astype(np.float32)


def system_traces(workloads: Sequence[str], T: int, seed: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, T) node traces of one system, node i seeded ``node_seed(seed, i)``."""
    pairs = [generate(w, T, node_seed(seed, i)) for i, w in enumerate(workloads)]
    return np.stack([a for a, _ in pairs]), np.stack([g for _, g in pairs])
