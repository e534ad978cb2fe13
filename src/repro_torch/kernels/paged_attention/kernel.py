"""CUDA wrapper for paged decode attention.

:func:`paged_attention` launches ``csrc/paged_attention.cu`` on CUDA
tensors and runs the plain version (:func:`ref.paged_attention_ref`) on CPU
tensors. It replaces the TPU kernel ``paged_attention`` of
``repro.kernels.paged_attention.kernel``. A call is one kernel launch: one
thread block cluster per (sequence, kv head) splits the live KV blocks over
its CTAs, each CTA streams its chunk through a ring of shared-memory stages
(TMA, or cp.async / element copies for views TMA cannot take) and the
cluster merges its partials through distributed shared memory. The K and
V pools may be strided views (D contiguous): their strides go to the
kernel, nothing is copied. The source is built at first use by
:mod:`repro_torch.kernels.nvcc`.

The helpers below mirror the source's plan, so the CPU tests can check it:
:func:`warps` (rows a warp, row blocks), :func:`layout` and
:func:`shared_bytes` (the ring, its block walkers and the rest of a CTA's
shared memory), :func:`cluster_size` and :func:`cluster_plan` (the chunks
of a cluster) and :func:`copy_path` (TMA, cp.async or element copies, from
the views' layout, which the wrapper hands the kernel). :func:`plan` asks
the card for the plan the source takes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SOURCE = Path(__file__).with_name("csrc") / "paged_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SHARED_BYTES = 227 * 1024   # kMaxSharedBytes in the source
MAX_WARPS = 8                   # kMaxWarps: consumer warps of a CTA
MIN_CLUSTER, MAX_CLUSTER = 8, 16   # kMinCluster, kMaxCluster
RING_BYTES = 128 * 1024         # kRingBytes: the ring's budget
MIN_SHARED_BYTES = 116 * 1024   # kMinSharedBytes: one CTA an SM
MAX_D = 1024                    # kMaxD
MAX_TMA_BOX = 256               # kMaxTmaBox: a TMA box's limit in each dimension
MIN_STAGES, MAX_STAGES = 3, 16  # kMinStages, kMaxStages
PATHS = {"tma": 0, "cp_async": 1, "element": 2}   # enum Path in the source

_entry = nvcc.CudaEntry(SOURCE, "paged_attention",
                        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                        + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_plan_entry = nvcc.CudaEntry(SOURCE, "paged_attention_plan",
                             [ctypes.c_int] * 5 + [ctypes.c_void_p])
build = _entry.build


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def max_rows(dw: int) -> int:
    """Query rows every warp holds at ``dw`` columns a lane (``max_rows``)."""
    return 4 if dw <= 16 else 64 // dw


def warps(G: int, D: int) -> dict:
    """The source's ``Warps``: ``dw`` columns of a lane (a power of two,
    D <= 32 dw); ``rows`` query rows a warp; the G rows of a kv head in
    ``row_blocks`` blocks of at most ``block_rows`` (one cluster each); a
    CTA's ``gc`` rows in ``rg`` row groups."""
    dw = 1
    while 32 * dw < D:
        dw *= 2
    rows = max_rows(dw)
    block_rows = MAX_WARPS * rows
    gc = min(G, block_rows)
    return dict(dw=dw, rows=rows, block_rows=block_rows, row_blocks=_cdiv(G, block_rows),
                gc=gc, rg=_cdiv(gc, rows))


def layout(G: int, D: int, T: int, itemsize: int) -> dict:
    """The source's ``Layout`` of a CTA, sizes in bytes: the ring
    (``stages`` of a K and a V tile of T rows of ``rs`` bytes), which the
    warps' states reuse once drained; the queries in f32; the CTA's (M, L);
    the walkers' and ranks' scales of each row; each warp's probabilities
    of a pass; what the cluster's ranks send the CTA; two mbarriers a
    stage; 128 bytes of alignment slack; at least MIN_SHARED_BYTES in all,
    so no two CTAs share an SM. ``walkers`` block walkers per row group
    divide ``stages`` (a multiple of them where that leaves at least
    MIN_STAGES), ``warps`` = rg * walkers consumer warps."""
    w = warps(G, D)
    rs = _round_up(D * itemsize, 16)
    dq = rs // 16 * (16 // itemsize)
    tile = _round_up(T * rs, 128)
    stage = 2 * tile
    s0 = min(max(RING_BYTES // stage, MIN_STAGES), MAX_STAGES)
    bw0 = MAX_WARPS // w["rg"]
    if s0 - s0 % bw0 >= MIN_STAGES:
        stages, walkers = s0 - s0 % bw0, bw0
    else:
        stages = s0
        walkers = next(b for b in range(min(bw0, s0), 0, -1) if s0 % b == 0)
    nwarps = w["rg"] * walkers
    ring = stages * stage
    warp_state = nwarps * w["rows"] * (D + 2) * 4
    q = _round_up(max(ring, warp_state), 16)
    ml = q + _round_up(w["rg"] * w["rows"] * dq * 4, 16)
    scale = ml + w["gc"] * 2 * 4
    probs = _round_up(scale + w["gc"] * (MAX_CLUSTER + 1) * 4, 16)
    recv = probs + nwarps * 32 * w["rows"] * 4
    bars = _round_up(recv + (w["gc"] * (2 * MAX_CLUSTER + D) + MAX_CLUSTER) * 4, 8)
    return dict(rs=rs, stages=stages, walkers=walkers, warps=nwarps, stage=stage, ring=ring,
                threads=32 * (nwarps + 1),
                total=max(bars + 2 * stages * 8 + 128, MIN_SHARED_BYTES))


def shared_bytes(G: int, D: int, T: int, itemsize: int) -> int:
    return layout(G, D, T, itemsize)["total"]


def cluster_size(pairs: int, held: dict) -> int:
    """CTAs of a (sequence, kv head) cluster: the largest size from 16 down
    to 9 of which the card holds all ``pairs`` clusters at once (``held``:
    size -> clusters, from cudaOccupancyMaxActiveClusters), else the
    portable 8."""
    return next((c for c in range(MAX_CLUSTER, MIN_CLUSTER, -1) if held.get(c, 0) >= pairs),
                MIN_CLUSTER)


def cluster_plan(live: int, cluster: int) -> list:
    """(first block, blocks) of each CTA rank of a cluster over a pair's
    ``live`` KV blocks: contiguous chunks of ceil(live / cluster)."""
    chunk = _cdiv(live, cluster)
    return [(r * chunk, max(0, min(chunk, live - r * chunk))) for r in range(cluster)]


def copy_path(k_pool: torch.Tensor, v_pool: torch.Tensor) -> tuple:
    """(path, bytes a copy) the kernel takes for these views: ``"tma"`` when
    the bases, the strides of the dimensions larger than 1 and D * itemsize
    are multiples of 16 bytes and D and T are at most 256 (a box's limit); else
    ``"cp_async"`` in copies of the largest of 16, 8 or 4 bytes that
    divides them all; else ``"element"``."""
    isz = k_pool.element_size()
    P, T, Hkv, D = k_pool.shape
    values = [D * isz, k_pool.data_ptr(), v_pool.data_ptr()]
    for t in (k_pool, v_pool):
        values += [s * isz for s, n in zip(t.stride()[:3], (P, T, Hkv)) if n > 1]
    width = next((w for w in (16, 8, 4) if all(x % w == 0 for x in values)), 0)
    if width == 16 and D <= MAX_TMA_BOX and T <= MAX_TMA_BOX:
        return "tma", 16
    return ("cp_async", width) if width else ("element", 0)


def plan(G: int, D: int, T: int, pairs: int, dtype: torch.dtype) -> dict:
    """The launch plan the source takes for this shape on the current card
    (builds the kernel): cluster, stages, threads, shared bytes and
    ``held``, the clusters of each size from 8 to 16 the card holds at
    once."""
    n = MAX_CLUSTER - MIN_CLUSTER + 1
    out = (ctypes.c_int * (4 + n))()
    _plan_entry(G, D, T, pairs, DTYPES[dtype], ctypes.addressof(out))
    return dict(cluster=out[0], stages=out[1], threads=out[2], shared_bytes=out[3],
                held={MIN_CLUSTER + i: out[4 + i] for i in range(n)})


def paged_attention(q, k_pool, v_pool, block_table, lengths):
    """q: (B, Hq, D) float32 or bfloat16; k/v_pool: (P, T, Hkv, D) of the
    same type, any strides with D contiguous; block_table: (B, NB) int32;
    lengths: (B,) int32 -> (B, Hq, D) of q's type. A sequence of length 0
    gives zeros, as the TPU kernel does.

    CUDA tensors launch the kernel (counted in ``paged_attention.launches``);
    CPU tensors run the plain version. The kernel has no backward: under
    grad mode, inputs that require grad raise on any device."""
    nvcc.refuse_grad("paged_attention", q, k_pool, v_pool)
    nvcc.check_tensor("q", q, tuple(DTYPES), (None, None, None), None)
    dev = q.device
    B, Hq, D = q.shape
    nvcc.check_tensor("k_pool", k_pool, q.dtype, (None, None, None, D), dev,
                      contiguous=False)
    nvcc.check_tensor("v_pool", v_pool, q.dtype, tuple(k_pool.shape), dev,
                      contiguous=False)
    P, T, Hkv, _ = k_pool.shape
    nvcc.check_tensor("block_table", block_table, torch.int32, (B, None), dev)
    nvcc.check_tensor("lengths", lengths, torch.int32, (B,), dev)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"query heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    if P == 0 or T == 0:
        raise ValueError(f"k_pool must hold at least one block of one token, got {tuple(k_pool.shape)}")
    if dev.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, lengths)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, not {dev}")
    G, NB = Hq // Hkv, block_table.shape[1]
    if D > MAX_D:
        raise ValueError(f"head dim {D} is above the kernel's {MAX_D}")
    smem = shared_bytes(G, D, T, q.element_size())
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"G={G}, D={D}, T={T} need {smem} B of shared memory, "
                         f"more than {MAX_SHARED_BYTES}")
    out = torch.empty_like(q)
    if out.numel():
        path, width = copy_path(k_pool, v_pool)
        _entry(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
               block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
               B, Hkv, G, D, T, NB, P, *k_pool.stride()[:3], *v_pool.stride()[:3],
               DTYPES[q.dtype], PATHS[path], width, nvcc.stream(dev))
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
