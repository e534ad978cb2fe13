"""CUDA wrapper for the fused per-event DRAM-cache step.

:func:`fused_cache_step` launches ``csrc/famsim_step.cu`` — one launch per
event for every lane (system x node), one warp per lane that stages the
event's set rows in shared memory — on CUDA tensors, and runs the plain
version (:func:`ref.cache_step_ref`) on CPU tensors.
It replaces the TPU kernel ``fused_cache_step`` of
``repro.kernels.famsim_step.kernel``.

The source is built at first use by :mod:`repro_torch.kernels.nvcc`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
import torch

from repro_torch.core import dram_cache as dc
from repro_torch.kernels import nvcc
from repro_torch.kernels.famsim_step.ref import cache_step_ref
from repro_torch.policies.replacement import _SrripBound
from repro_torch.roofline import op_cost

SOURCE = Path(__file__).with_name("csrc") / "famsim_step.cu"
MODES = {"lru": 0, "srrip": 1}

_entry = nvcc.CudaEntry(SOURCE, "famsim_cache_step",
                        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_shared_entry = nvcc.CudaEntry(SOURCE, "famsim_cache_step_shared",
                               [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)] * 2)
build = _entry.build
_shared_ok = set()


def _check_shared(dev, C, P, w_pad):
    """Raise if a launch with these shapes needs more shared memory than
    a block may opt in to on ``dev`` (checked once per shape)."""
    key = (dev.index, C, P, w_pad)
    if key not in _shared_ok:
        need, limit = ctypes.c_longlong(), ctypes.c_longlong()
        with torch.cuda.device(dev):
            _shared_entry(C, P, w_pad, ctypes.byref(need), ctypes.byref(limit))
        if need.value > limit.value:
            raise ValueError(
                f"fused_cache_step needs {need.value} B of shared memory per "
                f"lane (C={C}, P={P}, ways_pad={w_pad}); the device allows "
                f"{limit.value} B")
        _shared_ok.add(key)


def fused_cache_step(tags, lru, stamp, fill_blocks, fill_enable,
                     demand_block, demand_enable, probe_blocks,
                     num_sets, ways, *, mode: str = "lru", max_rrpv: int = 0):
    """One event's cache work for every lane, IN PLACE.

    tags/lru: (*B, S_pad, W_pad) int32 and stamp (*B,) int32 are updated in
    place (the JAX kernel returns new arrays); fill_blocks (*B, C) int32
    with fill_enable (*B, C) bool; demand_block (*B,) int32 with
    demand_enable (*B,) bool; probe_blocks (*B, P) int32; num_sets/ways
    (*B,) int32 effective geometry, num_sets <= S_pad. ``mode`` is
    ``"lru"`` or ``"srrip"`` (with ``max_rrpv``).

    Returns (hit (*B,) bool, probe_hits (*B, P) bool), the same values as
    :func:`ref.cache_step_ref`. CUDA tensors launch the kernel (counted in
    ``fused_cache_step.launches``); CPU tensors run the plain version.
    Under an active op counter the call is charged its operands and
    results once, and its plain version is not counted.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if tags.dim() < 2:
        raise ValueError("tags must be (*lanes, sets, ways)")
    lanes = tuple(tags.shape[:-2])
    C, P = fill_blocks.shape[-1], probe_blocks.shape[-1]
    dev = tags.device
    i32, b8 = torch.int32, torch.bool
    for name, t, dtype, shape in (
            ("tags", tags, i32, tags.shape), ("lru", lru, i32, tags.shape),
            ("stamp", stamp, i32, lanes),
            ("fill_blocks", fill_blocks, i32, lanes + (C,)),
            ("fill_enable", fill_enable, b8, lanes + (C,)),
            ("demand_block", demand_block, i32, lanes),
            ("demand_enable", demand_enable, b8, lanes),
            ("probe_blocks", probe_blocks, i32, lanes + (P,)),
            ("num_sets", num_sets, i32, lanes), ("ways", ways, i32, lanes)):
        nvcc.check_tensor(name, t, dtype, shape, dev)

    if op_cost.active():
        # the reference's custom-call rule: operands + results once (tags,
        # lru and stamp are written in place, hit and probe_hits are new)
        results = tags.numel() * 4 + lru.numel() * 4 + stamp.numel() * 4
        results += stamp.numel() * (1 + P)
        op_cost.charge("fused_cache_step", 0.0, float(op_cost.tensor_bytes(
            tags, lru, stamp, fill_blocks, fill_enable, demand_block, demand_enable,
            probe_blocks, num_sets, ways) + results))
    if dev.type == "cpu":
        policy = _SrripBound(max_rrpv) if mode == "srrip" else None
        with op_cost.uncounted():
            _, hit, probe_hits = cache_step_ref(
                dc.CacheState(tags, lru, stamp), fill_blocks, fill_enable,
                demand_block, demand_enable, probe_blocks, num_sets, ways,
                policy=policy)
        return hit, probe_hits
    if dev.type != "cuda":
        raise ValueError(f"fused_cache_step runs on cuda or cpu tensors, not {dev}")

    hit = torch.empty(lanes, dtype=b8, device=dev)
    probe_hits = torch.empty(lanes + (P,), dtype=b8, device=dev)
    n_lanes = stamp.numel()
    if n_lanes == 0:
        return hit, probe_hits
    s_pad, w_pad = tags.shape[-2:]
    _check_shared(dev, C, P, w_pad)
    _entry(tags.data_ptr(), lru.data_ptr(), stamp.data_ptr(),
           fill_blocks.data_ptr(), fill_enable.data_ptr(),
           demand_block.data_ptr(), demand_enable.data_ptr(),
           probe_blocks.data_ptr(), num_sets.data_ptr(), ways.data_ptr(),
           hit.data_ptr(), probe_hits.data_ptr(),
           n_lanes, s_pad, w_pad, C, P, MODES[mode], int(max_rrpv),
           nvcc.stream(dev))
    fused_cache_step.launches += 1
    return hit, probe_hits


fused_cache_step.launches = 0
