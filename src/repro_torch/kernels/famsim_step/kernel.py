"""CUDA wrapper for the fused per-event DRAM-cache step.

:func:`fused_cache_step` launches ``csrc/famsim_step.cu`` — one launch per
event for every lane (system x node), one warp per lane — on CUDA tensors,
and runs the plain version (:func:`ref.cache_step_ref`) on CPU tensors.
It replaces the TPU kernel ``fused_cache_step`` of
``repro.kernels.famsim_step.kernel``.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/`` beside this file
(named by a hash of the source), and bound with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core import dram_cache as dc
from repro_torch.kernels.famsim_step.ref import cache_step_ref
from repro_torch.policies.replacement import _SrripBound

SOURCE = Path(__file__).with_name("csrc") / "famsim_step.cu"
BUILD_DIR = Path(__file__).with_name("build")
MODES = {"lru": 0, "srrip": 1}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernel needs the CUDA toolkit")


def build() -> Tuple[Path, str]:
    """Compile the kernel if this source has not been built yet.

    Returns (library path, compiler log; empty when already built)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libfamsim_step_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        fn = lib.famsim_cache_step
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
        _check(name, t, dtype, shape, dev)

    if dev.type == "cpu":
        policy = _SrripBound(max_rrpv) if mode == "srrip" else None
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
    err = _library().famsim_cache_step(
        tags.data_ptr(), lru.data_ptr(), stamp.data_ptr(),
        fill_blocks.data_ptr(), fill_enable.data_ptr(),
        demand_block.data_ptr(), demand_enable.data_ptr(),
        probe_blocks.data_ptr(), num_sets.data_ptr(), ways.data_ptr(),
        hit.data_ptr(), probe_hits.data_ptr(),
        n_lanes, s_pad, w_pad, C, P, MODES[mode], int(max_rrpv),
        torch.cuda.current_stream(dev).cuda_stream)
    fused_cache_step.launches += 1
    if err != 0:
        raise RuntimeError(f"famsim_cache_step launch failed: CUDA error {err}")
    return hit, probe_hits


fused_cache_step.launches = 0
