"""Trace backends: ``numpy`` (the host generators) and ``device`` (torch).

Counterpart of ``repro.traces.backend``. A backend turns (workload, T,
seed) into node traces:

* ``numpy`` — :mod:`repro_torch.traces.host`, a copy of the reference's
  host generators (bit-identical to them);
* ``device`` — :mod:`repro_torch.traces.device`, the threefry generator on
  the device of the caller's choice. The experiments executor generates a
  whole group's traces there at the group's padded length and never stages
  them through the host; ``system_traces`` here pulls them to the host for
  reference and cross-check paths.

The two backends are statistically equivalent, not bit-equal (threefry is
not PCG64).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.traces import host
from repro_torch.traces.specs import node_seed

BACKEND_NAMES = ("device", "numpy")
DEFAULT_BACKEND = "device"


class NumpyBackend:
    name = "numpy"

    def generate(self, workload, T, seed, base_ipc=2.0, device=None):
        return host.generate(workload, T, seed, base_ipc)

    def system_traces(self, workloads, T, seed, device=None):
        pairs = [self.generate(w, T, node_seed(seed, i))
                 for i, w in enumerate(workloads)]
        return (np.stack([a for a, _ in pairs]),
                np.stack([g for _, g in pairs]))


class DeviceBackend:
    name = "device"

    def generate(self, workload, T, seed, base_ipc=2.0, device="cuda"):
        from repro_torch.traces import device as dev
        return dev.generate_device(workload, T, seed, base_ipc, device=device)

    def system_traces(self, workloads, T, seed, device="cuda"):
        from repro_torch.traces import device as dev
        return dev.system_traces(workloads, T, seed, device=device)


_BACKENDS: Dict[str, object] = {}


def validate_backend(name: str) -> str:
    """The one place a backend name is checked (planner, executor and
    registry all call it)."""
    if name not in BACKEND_NAMES:
        raise ValueError(f"unknown trace backend {name!r}; "
                         f"choose from {BACKEND_NAMES}")
    return name


def get_backend(name: str):
    validate_backend(name)
    if name not in _BACKENDS:
        _BACKENDS[name] = DeviceBackend() if name == "device" else NumpyBackend()
    return _BACKENDS[name]


def system_traces(workloads: Sequence[str], T: int, seed: int,
                  backend: str = "numpy", device="cuda"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, T) node traces of one system from ``backend`` (addrs int64, gaps
    float32, on the host); ``device`` is where the ``device`` backend
    generates them (the ``numpy`` backend runs on the host)."""
    return get_backend(backend).system_traces(workloads, T, seed, device=device)
