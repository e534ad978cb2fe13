"""In-run windowed telemetry counters for the FAM simulator.

Counterpart of ``repro.obs.telemetry``. The simulator reports end-of-run
scalars; this module adds the time-resolved half: a fixed-shape
``(S, n_windows, N_COUNTERS)`` float32 accumulator that rides the carry
of ``famsim._make_step`` (one ``(n_windows, N_COUNTERS)`` matrix per
simulated system, where the reference vmaps) and adds one row of
per-system (node-summed) counter increments per live step into the
step's window.

Gating is static: ``FamConfig.telemetry`` (= ``n_windows``; 0 = off) is
part of ``geometry_free_shape()``. With 0 the step is built without any
of this and launches exactly the kernels it launched before; with
telemetry on, accumulation only reads the step's signals, so every other
metric stays bit-identical.

On the card the accumulator is one of the fixed carry buffers of the
simulator's CUDA graph (``famsim.GroupRunner``): :func:`accumulate` adds
each step's row in place with one ``scatter_add_``, and the window index
arrives as one more per-event input stream. The constant tensors it reads
(:func:`constants`) are made once per device before any capture.

Window semantics (as the reference's):

* the step at trace index ``i`` lands in window
  ``clip(i * n_windows // max(t_true, 1), 0, n_windows - 1)``;
* counters accumulate on every live step, warm-up included, so window
  sums equal the end-of-run totals exactly when ``warmup_frac=0``;
* a padded tail step (not live) adds an exact zero row: event counters
  are gated through masks that already include ``live``, and the
  per-step gauges are multiplied by ``live`` here.

Counter catalog (the reference's):

========================  =================================================
``events``                live node-events (``N`` per live step)
``demand_fam``            FAM-bound demand events
``demand_hit``            ... that hit the DRAM cache
``demand_late``           ... that matched a still-in-flight prefetch
``pf_issued``             DRAM-cache prefetches issued to FAM
``pf_redundant``          prefetch candidates dropped because the block
                          was already cached or in flight
``queue_occupancy``       gauge-sum: occupied prefetch-queue slots,
                          summed over nodes once per live step
``wfq_demand_backlog``    gauge-sum: demand-chain busy-until minus mean
                          node clock (cycles), once per live step
``wfq_prefetch_backlog``  same for the prefetch chain
``token_rate``            gauge-sum: adaptation issue rate, summed over
                          nodes once per live step
``lat_sum``               total demand latency over FAM-bound demands
``lat_le_<edge>``...      latency histogram: FAM-bound demand count per
                          geometric bucket (upper edges ``LAT_EDGES``,
                          final bucket ``lat_gt_<last>``)
========================  =================================================

Float order: the node sums of the float gauges (``wfq_*_backlog`` through
the node-mean clock, ``token_rate``, ``lat_sum``) are taken node by node
in index order, as XLA reduces the reference's few nodes, so the windows
equal the reference's bit for bit.
"""
from __future__ import annotations

from functools import lru_cache

import torch

#: latency histogram upper edges (cycles), half-octave geometric
LAT_EDGES = (128.0, 181.0, 256.0, 362.0, 512.0, 724.0, 1024.0, 1448.0,
             2048.0, 2896.0, 4096.0)

BASE_COUNTERS = (
    "events", "demand_fam", "demand_hit", "demand_late",
    "pf_issued", "pf_redundant", "queue_occupancy",
    "wfq_demand_backlog", "wfq_prefetch_backlog", "token_rate", "lat_sum",
)

#: full counter-name tuple; index into the last telemetry-array axis
COUNTERS = BASE_COUNTERS + tuple(
    f"lat_le_{int(e)}" for e in LAT_EDGES) + (f"lat_gt_{int(LAT_EDGES[-1])}",)

N_COUNTERS = len(COUNTERS)

#: first histogram-bucket index into COUNTERS
HIST_OFFSET = len(BASE_COUNTERS)
N_BUCKETS = len(LAT_EDGES) + 1

F32 = torch.float32


def counter_index(name: str) -> int:
    return COUNTERS.index(name)


def init_windows(n_windows: int, S: int, device) -> torch.Tensor:
    """The zero telemetry accumulator: ``(S, n_windows, N_COUNTERS)`` f32."""
    return torch.zeros((S, n_windows, N_COUNTERS), dtype=F32, device=device)


def window_index(i, t_true, n_windows: int) -> torch.Tensor:
    """Window of trace step ``i`` for a run of true length ``t_true``
    (tensors that broadcast, e.g. ``i`` (T, 1) against ``t_true`` (S,)),
    in int32 as the reference computes it. Padded steps (``i >=
    t_true``) clip into the last window; they are not live and add zero
    there."""
    t = torch.clamp(torch.as_tensor(t_true).to(torch.int32), min=1)
    w = torch.div(torch.as_tensor(i).to(torch.int32) * n_windows, t,
                  rounding_mode="floor")
    return torch.clamp(w, 0, n_windows - 1).to(torch.int32)


@lru_cache(maxsize=None)
def constants(device: torch.device):
    """(``LAT_EDGES`` as f32, the bucket indices ``arange(N_BUCKETS)``) on
    ``device``: made once per device, before the first capture, so a
    captured step copies nothing from the host."""
    return (torch.tensor(LAT_EDGES, dtype=F32, device=device),
            torch.arange(N_BUCKETS, dtype=torch.int64, device=device))


def _node_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the node axis (last) in node order: ((x0 + x1) + x2) + ..."""
    s = x[..., 0]
    for n in range(1, x.shape[-1]):
        s = s + x[..., n]
    return s


def accumulate(windows: torch.Tensor, win: torch.Tensor, *, live, req, lat,
               nodes, new_busy) -> torch.Tensor:
    """Add one step's counter row into each system's window ``win``, in
    place: ``windows`` (S, n_windows, C), ``win`` (S,) int32, ``live``
    (S, 1) bool, ``lat`` (S, N) the nodes' demand latency, ``nodes`` the
    updated (S, N) node state, ``new_busy`` (S, 2) the scheduler's
    per-class busy-until times. Returns ``windows``."""
    S, N = lat.shape
    live_f = live[:, 0].to(F32)
    is_fam = req["is_fam"]                               # (S, N), includes live
    fam_f = is_fam.to(F32)
    lat_fam = torch.where(is_fam, lat, 0.0)
    clock_mean = _node_sum(nodes.clock) / N
    base = torch.stack([
        live_f * float(N),                                      # events
        fam_f.sum(-1),                                          # demand_fam
        req["hit"].to(F32).sum(-1),                             # demand_hit
        req["inflight"].to(F32).sum(-1),                        # demand_late
        req["pf_valid"].to(F32).sum((-2, -1)),                  # pf_issued
        req["pf_redundant"].sum(-1),                            # pf_redundant
        (nodes.queue.block > 0).to(F32).sum((-2, -1)) * live_f,
        torch.clamp(new_busy[:, 0] - clock_mean, min=0.0) * live_f,
        torch.clamp(new_busy[:, 1] - clock_mean, min=0.0) * live_f,
        _node_sum(nodes.throttle.issue_rate) * live_f,          # token_rate
        _node_sum(lat_fam),                                     # lat_sum
    ], -1)                                                      # (S, 11)
    edges, buckets = constants(windows.device)
    bucket = (lat[..., None] > edges).sum(-1)                   # (S, N)
    onehot = (bucket[..., None] == buckets).to(F32)             # (S, N, B)
    hist = (onehot * fam_f[..., None]).sum(1)                   # (S, B)
    row = torch.cat([base, hist], -1)                           # (S, C)
    idx = win.to(torch.int64)[:, None, None].expand(S, 1, N_COUNTERS)
    return windows.scatter_add_(1, idx, row[:, None, :])
