"""Workload specifications + seed derivation for synthetic LLC-miss traces.

A copy of ``repro.traces.specs`` (the port imports nothing of the JAX
package, so the tables live here too and a test holds them equal).

The 19 evaluated workloads (paper Table III) cannot be executed under a
pin-tool here, so each is modeled by its dominant access-pattern class +
footprint + miss intensity; EXPERIMENTS.md therefore validates
*trends/magnitudes* against the paper, not per-benchmark numbers.

The spec table, the footprint arithmetic, and the seed-derivation scheme
used by the ``numpy`` generators in :mod:`repro_torch.traces.host`.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict

LINE = 64

#: Generator-wide constants shared by both backends (statistical
#: equivalence requires the same model parameters, not the same RNG).
GAP_SIGMA = 0.6          # log-normal jitter on compute gaps (bursty misses)
HOT_REGION_DIV = 20      # weak-skew hot region = footprint / 20
TILE_JITTER = 2          # +-2 line stencil jitter inside a tile
MIN_TILE_LINES = 64      # floor on the tile size (lines) — the device
                         # backend's segment bound relies on it
ADDR_HASH = 2654435761   # Knuth multiplicative hash scattering zipf ranks

#: Pattern-class ids, the numeric encoding the device backend traces.
PATTERN_IDS = {"stream": 0, "strided": 1, "tiled": 2,
               "zipf": 3, "graph": 4, "mixed": 5}


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    suite: str
    footprint_mb: float   # paper Table III
    mpki: float           # miss intensity (model parameter)
    pattern: str
    zipf_a: float = 1.2
    streams: int = 4
    stride: int = 1       # in lines
    tile_kb: int = 256
    seq_frac: float = 0.8

    @property
    def hot_fraction(self) -> float:
        """Weak-skew (``zipf_a <= 1.0``) hot-region probability.

        For weak skew the spec's ``zipf_a`` doubles as a *probability
        parameter*: each access lands in the hot region (footprint /
        ``HOT_REGION_DIV``) with probability ``zipf_a / 2`` — so
        ``zipf_a=1.0`` means 50 % hot traffic, ``0.8`` means 40 %.
        Normalized here (clamped to [0, 1]) so spec parameters read as
        probabilities instead of a bare ``* 0.5`` buried in the
        generator."""
        return min(max(self.zipf_a * 0.5, 0.0), 1.0)

    @property
    def tile_lines(self) -> int:
        return max(self.tile_kb * 1024 // LINE, MIN_TILE_LINES)

    @property
    def pattern_id(self) -> int:
        return PATTERN_IDS[self.pattern]


WORKLOADS: Dict[str, WorkloadSpec] = {s.name: s for s in [
    # SPEC17 (memory-intensive fp mostly streaming/stencil)
    WorkloadSpec("603.bwaves_s", "SPEC17", 824, 22, "stream", streams=3),
    WorkloadSpec("607.cactuBSSN_s", "SPEC17", 257, 15, "strided", streams=6, stride=4),
    WorkloadSpec("619.lbm_s", "SPEC17", 1550, 28, "stream", streams=2),
    WorkloadSpec("628.pop2_s", "SPEC17", 590, 12, "tiled", tile_kb=512),
    WorkloadSpec("649.fotonik3d_s", "SPEC17", 587, 20, "strided", streams=8, stride=8),
    WorkloadSpec("654.roms_s", "SPEC17", 245, 18, "stream", streams=4),
    WorkloadSpec("657.xz_s", "SPEC17", 561, 9, "zipf", zipf_a=1.1),
    # Splash3
    WorkloadSpec("LU", "Splash3", 515, 14, "tiled", tile_kb=128),
    WorkloadSpec("FFT", "Splash3", 625, 16, "strided", streams=2, stride=16),
    # GAP (graph: power-law destinations + frontier streaming)
    WorkloadSpec("bfs", "GAP", 864, 25, "graph", zipf_a=1.3, seq_frac=0.35),
    WorkloadSpec("cc", "GAP", 802, 27, "graph", zipf_a=1.2, seq_frac=0.25),
    WorkloadSpec("bc", "GAP", 593, 24, "graph", zipf_a=1.4, seq_frac=0.3),
    WorkloadSpec("sssp", "GAP", 545, 23, "graph", zipf_a=1.3, seq_frac=0.3),
    # PARSEC
    WorkloadSpec("dedup", "PARSEC", 868, 11, "mixed", zipf_a=1.0, seq_frac=0.6),
    WorkloadSpec("facesim", "PARSEC", 188, 8, "tiled", tile_kb=64),
    WorkloadSpec("canneal", "PARSEC", 849, 30, "zipf", zipf_a=0.9),
    # NPB
    WorkloadSpec("mg", "NPB", 431, 19, "strided", streams=4, stride=2),
    WorkloadSpec("is", "NPB", 1000, 26, "mixed", zipf_a=0.8, seq_frac=0.5),
    # XSBench
    WorkloadSpec("XSBench", "XSBench", 611, 21, "zipf", zipf_a=1.05),
]}

WORKLOAD_NAMES = tuple(WORKLOADS)

#: Max ``streams`` over the spec table — the device backend's one-hot
#: occurrence counter is sized to this static width.
STREAMS_MAX = max(s.streams for s in WORKLOADS.values())


def _lines(spec: WorkloadSpec) -> int:
    return max(int(spec.footprint_mb * (1 << 20) // LINE), 1 << 12)


def trace_seed(name: str, seed: int) -> int:
    """Stable RNG seed for (workload, seed) — NOT the salted builtin
    ``hash()``, which changes per process with PYTHONHASHSEED and made no
    two runs reproduce the same trace."""
    return zlib.crc32(f"{name}:{seed}".encode())


def node_seed(seed: int, node_index: int) -> int:
    """Per-node trace seed derivation, shared by ``famsim.simulate`` and the
    benchmark harness so both generate identical node traces. The large odd
    multiplier decorrelates node streams even for adjacent base seeds."""
    return seed + 1_000_003 * node_index


def mean_gap_cycles(spec: WorkloadSpec, base_ipc: float = 2.0) -> float:
    """Mean compute gap between misses: 1000/mpki instructions at
    ``base_ipc`` — the scale both backends apply to the log-normal
    jitter."""
    return (1000.0 / spec.mpki) / base_ipc


def footprint_bytes(name: str) -> int:
    return _lines(WORKLOADS[name]) * LINE
