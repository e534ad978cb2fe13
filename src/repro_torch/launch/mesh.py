"""Production mesh construction.

Counterpart of ``repro.launch.mesh``. ``make_production_mesh`` is a
function, so importing this module touches no process group. Single pod
= 256 ranks (16 x 16, data x model); multi-pod = 2 pods x 256 ranks with a
leading "pod" axis (data-parallel by default; pipeline over the pod axis
through :mod:`repro_torch.parallel.pipeline`). The ranks are those of the
``torch.distributed`` job this process belongs to.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from repro_torch.parallel.compat import make_mesh


def _ranks() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    found = _ranks()
    if found < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, found {found}. "
            "Run one rank a device under torch.distributed (e.g. torchrun "
            f"--nproc-per-node ... with {need} ranks in all).")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A small mesh over the ranks of the current job (tests/examples)."""
    return make_mesh((data, model), ("data", "model"))
