"""Analytic core model used by the simulator (a numpy copy of
``repro.core.ipc_model``).

cycles = sum(gap_i) + sum(stall_i),  stall_i = demand_latency_i / MLP
instr  = sum(gap_i) * IPC_base
IPC    = instr / cycles
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.annotations import host_metric


def ipc(instr: np.ndarray, cycles: np.ndarray) -> np.ndarray:
    return instr / np.maximum(cycles, 1.0)


def ipc_gain(ipc_config: np.ndarray, ipc_baseline: np.ndarray) -> np.ndarray:
    """Paper §V-A def. 5 (higher is better)."""
    return ipc_config / np.maximum(ipc_baseline, 1e-9)


def relative_fam_latency(lat_config: np.ndarray, lat_baseline: np.ndarray
                         ) -> np.ndarray:
    """Paper §V-A def. 6 (lower is better)."""
    return lat_config / np.maximum(lat_baseline, 1e-9)


@host_metric
def geomean(x) -> float:
    """Geometric mean of metric values already on the host (fetched after
    the runner's replays; never a device tensor in the captured window:
    the ``float()`` / ``np.asarray`` here would be a host sync there)."""
    x = np.asarray(x, np.float64)
    return float(np.exp(np.mean(np.log(np.maximum(x, 1e-12)))))
