"""Device trace synthesis: the ``device`` trace backend, in PyTorch.

Counterpart of ``repro.traces.device``. One :class:`TraceParams` encodes a
(workload, seed) pair as a few numbers; :func:`node_generator` turns a
batch of them into ``(addr_bytes, gap_cycles)`` traces on the device the
tensors live on, batched over any leading dimensions (the executor passes
``(S, N)``: systems x nodes, where JAX vmaps). The draws come from
threefry keys exactly as ``jax.random`` makes them
(:mod:`repro_torch.traces.threefry`), in the reference's order and shapes:

* ``raw`` (stream pick, tile jitter, seq/random choice), ``u`` (zipf CDF
  draw and hot/cold selector), ``uni`` (uniform line, hot offset),
  ``starts`` (stream starts), ``bases`` / ``spans`` (the tiled pattern's
  ``K = T // (MIN_TILE_LINES // 2) + 2`` segments) and the normal that
  jitters the gaps;
* the stream pattern's occurrence counts as a one-hot cumulative sum over
  ``STREAMS_MAX`` streams, the tiled pattern's segment of each position by
  ``searchsorted`` over the span prefix sum;
* zipf ranks: the exact head CDF by ``searchsorted``, the tail by inverting
  the continuous power law in log space, ranks hashed over the footprint
  with the uint32 ``rank * ADDR_HASH % n``.

Every integer draw, and every address the zipf tail does not set, equals
JAX's bit for bit on any device. The tail's ``log``/``exp`` and the gaps'
``erfinv``/``exp`` are the device's own float32 functions, not XLA's, so
tail addresses (the rank's floor lands on the other integer) and gaps
(last bits) agree with JAX only within a tolerance, and differ between
the CPU and the card as they do between XLA's backends.

The draws are counter-based: element i of a draw hashes counter i whatever
the draw's length, so a trace generated at a padded length begins with the
trace at the true length (as JAX 0.9.0's partitionable threefry does; the
reference's docstring, which says otherwise, predates that default). The
executor still generates each group's traces at its ``t_pad``, as the
reference does.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.traces import threefry
from repro_torch.traces.specs import (ADDR_HASH, GAP_SIGMA, HOT_REGION_DIV, LINE,
                                      MIN_TILE_LINES, STREAMS_MAX, TILE_JITTER,
                                      WORKLOADS,
                                      _lines, mean_gap_cycles, node_seed,
                                      trace_seed)

#: Ranks resolved exactly from the zeta-normalized head CDF; beyond this
#: the tail is sampled by continuous power-law inversion.
ZIPF_HEAD = 32

# float32 constants of the reference's generator, as XLA folds them
# (bits taken from JAX 0.9.0 on the CPU): log(ZIPF_HEAD + 0.5) and
# log(float32(2**31 - 1)) (= log(2**31))
_LOG_HEAD = float(np.array(0x405ECCA3, np.uint32).view(np.float32))
_LOG_INT32_MAX = float(np.array(0x41ABE687, np.uint32).view(np.float32))
_INT32_MAX = 2 ** 31 - 1


class TraceParams(NamedTuple):
    """Numeric encoding of one node's (workload, seed): scalars and a small
    table, numpy on the host (:func:`trace_params`) or tensors with leading
    batch dimensions (:func:`to_tensors`)."""

    pattern: np.ndarray        # i32 PATTERN_IDS value
    n_lines: np.ndarray        # i32 footprint in cache lines
    streams: np.ndarray        # i32 concurrent streams (<= STREAMS_MAX)
    stride: np.ndarray         # i32 stream stride in lines
    tile: np.ndarray           # i32 tile size in lines (>= MIN_TILE_LINES)
    zipf_a: np.ndarray         # f32 skew exponent
    hot_p: np.ndarray          # f32 weak-skew hot probability (spec.hot_fraction)
    seq_frac: np.ndarray       # f32 sequential fraction (graph/mixed)
    mean_gap: np.ndarray       # f32 mean compute gap, cycles
    zipf_head_cdf: np.ndarray  # f32 (ZIPF_HEAD,) exact head CDF (a > 1)
    key: np.ndarray            # u32 (2,) raw threefry key [0, trace_seed]


def _zeta(a: float, n_terms: int = 100_000) -> float:
    """Riemann zeta via partial sum + integral tail (plenty for a CDF)."""
    k = np.arange(1, n_terms + 1, dtype=np.float64)
    return float(np.sum(k ** -a) + n_terms ** (1.0 - a) / (a - 1.0))


@lru_cache(maxsize=None)
def _head_cdf(a: float) -> Tuple[float, ...]:
    """Exact CDF of the first ZIPF_HEAD zipf(a) ranks (a > 1)."""
    k = np.arange(1, ZIPF_HEAD + 1, dtype=np.float64)
    return tuple(np.cumsum(k ** -a) / _zeta(a))


@lru_cache(maxsize=None)
def trace_params(name: str, seed: int, base_ipc: float = 2.0) -> TraceParams:
    """Host-side numeric encoding of one node trace (no events are made
    here: this is all the host does for the device backend)."""
    spec = WORKLOADS[name]
    head = _head_cdf(spec.zipf_a) if spec.zipf_a > 1.0 else (1.0,) * ZIPF_HEAD
    return TraceParams(
        pattern=np.int32(spec.pattern_id),
        n_lines=np.int32(_lines(spec)),
        streams=np.int32(spec.streams),
        stride=np.int32(spec.stride),
        tile=np.int32(spec.tile_lines),
        zipf_a=np.float32(spec.zipf_a),
        hot_p=np.float32(spec.hot_fraction),
        seq_frac=np.float32(spec.seq_frac),
        mean_gap=np.float32(mean_gap_cycles(spec, base_ipc)),
        zipf_head_cdf=np.asarray(head, np.float32),
        key=np.array([0, trace_seed(name, seed)], np.uint32))


def system_params(workloads: Sequence[str], seed: int,
                  base_ipc: float = 2.0) -> TraceParams:
    """One system's N node encodings stacked (leading axis N); per-node
    seeds derive through ``node_seed`` as in the numpy backend."""
    pts = [trace_params(w, node_seed(seed, i), base_ipc)
           for i, w in enumerate(workloads)]
    return TraceParams(*(np.stack([getattr(p, f) for p in pts])
                         for f in TraceParams._fields))


def stack_system_params(systems: Sequence[TraceParams]) -> TraceParams:
    """S system encodings stacked into the (S, N, ...) batch of one group."""
    return TraceParams(*(np.stack([getattr(s, f) for s in systems])
                         for f in TraceParams._fields))


def to_tensors(tp: TraceParams, device) -> TraceParams:
    """The numpy encoding as tensors on ``device`` (the key as int64 holding
    its uint32 words), copied without making the host wait for the device
    (from pageable memory a copy is staged before it returns)."""
    def conv(x):
        x = np.asarray(x)
        x = np.ascontiguousarray(x.astype(np.int64) if x.dtype == np.uint32 else x)
        return torch.from_numpy(x).to(device, non_blocking=True)
    return TraceParams(*(conv(x) for x in tp))


def _sat_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 rounding toward zero and saturating, as XLA's
    convert does (torch's cast of an out-of-range value is undefined)."""
    big = x >= 2.0 ** 31
    return torch.where(big, _INT32_MAX, torch.where(big, 0.0, x).to(torch.int32))


def draws(tp: TraceParams, T: int) -> Dict[str, torch.Tensor]:
    """The threefry draws of a batch of node encodings (tensors with leading
    dims B), in the reference's order: raw, u, uni (B, T); starts
    (B, STREAMS_MAX); bases, spans (B, K); normal (B, T)."""
    K = T // (MIN_TILE_LINES // 2) + 2
    sub = lambda i: threefry.fold_in(tp.key, i)
    n, tile = tp.n_lines[..., None], tp.tile[..., None]
    return dict(
        raw=threefry.randint(sub(0), (T,), 0, 1 << 30),
        u=threefry.uniform(sub(1), (T,)),
        uni=threefry.randint(sub(2), (T,), 0, n),
        starts=threefry.randint(sub(3), (STREAMS_MAX,), 0, n),
        bases=threefry.randint(sub(4), (K,), 0, torch.clamp(n - tile, min=1)),
        spans=threefry.randint(sub(5), (K,), tile // 2, tile),
        normal=threefry.normal(sub(6), (T,)))


def generate(tp: TraceParams, T: int, parts: bool = False):
    """(addrs int32 (B, T), gaps float32 (B, T)) for a batch of node
    encodings ``tp`` (tensors with leading dims B). With ``parts`` also the
    draws and, as ``"tail"``, the mask of addresses the zipf tail set."""
    d = draws(tp, T)
    raw, u, uni = d["raw"], d["u"], d["uni"]
    dev = raw.device
    # filled on the device: torch.tensor would copy each from the host
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
    col = lambda t: t[..., None]
    n = col(tp.n_lines)

    # stream / strided (and the sequential half of graph/mixed): one-hot
    # cumulative-sum occurrence counts
    pick = raw % col(tp.streams)
    oh = pick[..., None] == torch.arange(STREAMS_MAX, device=dev, dtype=torch.int32)
    ohi = oh.to(torch.int32)
    cum = torch.cumsum(ohi, dim=-2, dtype=torch.int32) - ohi
    occ = torch.where(oh, cum, 0).sum(-1, dtype=torch.int32)
    s_lines = (d["starts"].gather(-1, pick.long()) + occ * col(tp.stride)) % n

    # tiled: segmented row-major sweeps with stencil jitter
    tile, spans = col(tp.tile), d["spans"]
    seg_start = torch.cat([torch.zeros_like(spans[..., :1]),
                           torch.cumsum(spans, -1, dtype=torch.int32)[..., :-1]], -1)
    pos = torch.arange(T, device=dev, dtype=torch.int32).expand_as(raw).contiguous()
    seg = torch.searchsorted(seg_start.contiguous(), pos, right=True) - 1
    off = pos - seg_start.gather(-1, seg)
    jitter = (raw >> 3) % (2 * TILE_JITTER + 1) - TILE_JITTER
    t_lines = torch.minimum(torch.clamp(d["bases"].gather(-1, seg) + off % tile
                                        + jitter, min=0), n - 1)

    # zipf: exact head CDF + continuous power-law tail (a > 1); hot/cold
    # mixture for weak skew (a <= 1)
    cdf = tp.zipf_head_cdf
    head_rank = (torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
                 + 1).to(torch.int32)
    head_mass = cdf[..., -1:]
    a1 = torch.maximum(col(tp.zipf_a), f32(1.01)) - 1.0
    v = torch.clamp((u - head_mass) / torch.maximum(1.0 - head_mass, f32(1e-9)),
                    min=f32(1e-9), max=f32(1.0))
    log_tail = _LOG_HEAD - torch.log(v) / a1
    tail_rank = torch.exp(torch.minimum(log_tail, f32(_LOG_INT32_MAX)))
    in_head = u <= head_mass
    overflow = ~in_head & (log_tail >= _LOG_INT32_MAX)
    strong = torch.where(in_head, head_rank, _sat_int32(torch.floor(tail_rank)))
    hot = uni % torch.clamp(n // HOT_REGION_DIV, min=1)
    weak = torch.where(u < col(tp.hot_p), hot, uni)
    is_strong = col(tp.zipf_a) > 1.0
    rank = torch.where(is_strong, strong, weak) % n
    hashed = ((rank.long() * ADDR_HASH) & threefry.M32) % n
    z_lines = torch.where(is_strong & overflow, uni, hashed.to(torch.int32))

    # graph / mixed: sequential-vs-random mixture
    take_seq = ((raw >> 6) & 1023).to(torch.float32) * (1.0 / 1024.0) < col(tp.seq_frac)
    m_lines = torch.where(take_seq, s_lines, z_lines)

    pat = col(tp.pattern)
    lines = torch.where(pat <= 1, s_lines, torch.where(
        pat == 2, t_lines, torch.where(pat == 3, z_lines, m_lines)))
    addrs = (lines * LINE).to(torch.int32)            # < 2**31 for every spec
    gaps = torch.exp(d["normal"] * GAP_SIGMA) * col(tp.mean_gap)
    if not parts:
        return addrs, gaps
    zipf_used = (pat == 3) | ((pat >= 4) & ~take_seq)
    d["tail"] = zipf_used & is_strong & ~in_head
    return addrs, gaps, d


def node_generator(T: int):
    """fn(tp) -> (addrs int32 (B, T), gaps float32 (B, T)) for a batch of
    node encodings on one device."""
    return lambda tp: generate(tp, T)


def system_traces(workloads: Sequence[str], T: int, seed: int,
                  base_ipc: float = 2.0, device="cuda"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, T) node traces of one system, generated on ``device`` and pulled
    to the host (addrs int64, gaps float32)."""
    dev = resolve_device(device)
    tp = to_tensors(system_params(tuple(workloads), seed, base_ipc), dev)
    addrs, gaps = node_generator(T)(tp)
    return addrs.cpu().numpy().astype(np.int64), gaps.cpu().numpy()


def generate_device(name: str, T: int, seed: int = 0, base_ipc: float = 2.0,
                    device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """One node trace, API-compatible with ``host.generate``; node 0 of a
    one-node system carries exactly its seeding (``node_seed(seed, 0) ==
    seed``)."""
    a, g = system_traces([name], T, seed, base_ipc, device=device)
    return a[0], g[0]
