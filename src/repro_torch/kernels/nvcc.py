"""Building and binding the port's CUDA kernels.

Every kernel is one ``csrc/<name>.cu`` file with a plain C entry point that
takes the current stream and returns the launch's ``cudaGetLastError()``.
At first use the source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/`` beside its package, named by a hash of the
source, with nvcc's log (``-Xptxas -v``: registers and spills) beside it,
and loaded with ``ctypes``. :func:`build_all` starts one ``nvcc``
per source at once and waits for all of them; a failed build raises with
nvcc's stderr. Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(source: Path) -> Path:
    """``<package>/build/lib<stem>_<hash>.so`` for ``<package>/csrc/<stem>.cu``."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return source.parent.parent / "build" / f"lib{source.stem}_{digest}.so"


def log_path(library: Path) -> Path:
    """Where the compiler log of ``library`` is kept: ``lib<stem>_<hash>.log``."""
    return library.with_suffix(".log")


def build_all(sources: Sequence[Path]) -> List[Tuple[Path, str]]:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together. Returns (library path, compiler log) per source, in order; a
    library built before gives the log kept beside it (empty if none was)."""
    jobs = []
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            jobs.append((src, lib, None, None))
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((src, lib, tmp, proc))
    out, failed = [], []
    for src, lib, tmp, proc in jobs:
        if proc is None:
            log = log_path(lib)
            out.append((lib, log.read_text() if log.exists() else ""))
            continue
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
            continue
        log_path(tmp).write_text(err)
        os.replace(log_path(tmp), log_path(lib))
        os.replace(tmp, lib)
        out.append((lib, err))
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(source: Path) -> Tuple[Path, str]:
    return build_all([source])[0]


class CudaEntry:
    """The C entry point ``symbol`` of ``source``, built and loaded at its
    first call. Pointers and the stream go as ``ctypes.c_void_p``, ints as
    ``ctypes.c_int`` or ``ctypes.c_longlong``, floats as ``ctypes.c_float``.
    A call raises if the entry point returns a CUDA error."""

    def __init__(self, source: Path, symbol: str, argtypes):
        self.source, self.symbol, self.argtypes = source, symbol, list(argtypes)
        self._fn: Optional[ctypes._CFuncPtr] = None

    def build(self) -> Tuple[Path, str]:
        """Compile the source if it has not been built yet. Returns (library
        path, compiler log)."""
        return build(self.source)

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(self.build()[0])), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {err}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def refuse_grad(kernel, *tensors):
    """Raise when grad mode is on and any of ``tensors`` requires grad: the
    hand-written kernels launch on raw pointers, so their outputs carry no
    ``grad_fn`` and a backward would drop those gradients without a word."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{kernel} has no backward: call it under torch.no_grad() "
                           f"or on inputs that do not require grad (training runs "
                           f"the plain torch attention)")


def check_tensor(name, t, dtype, shape, device, contiguous=True):
    """Raise unless ``t`` is a tensor of ``dtype`` and ``shape`` (a tuple;
    ``None`` entries match any size) on ``device`` (``None``: any);
    contiguous unless told otherwise. ``dtype`` may be a tuple of allowed
    types, or ``None`` for any type."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if dtype is not None and t.dtype not in allowed:
        want = " or ".join(str(d) for d in allowed)
        raise TypeError(f"{name} must be {want}, got {t.dtype}")
    shape = tuple(shape)
    if t.dim() != len(shape) or any(w is not None and s != w
                                    for s, w in zip(t.shape, shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
