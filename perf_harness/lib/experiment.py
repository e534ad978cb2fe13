"""The cell's sweep as the program's public experiment API states it.

One general generator for every ``"kind": "sweep"`` traffic file: the
configuration file gives the base ``FamConfig`` and the node count, the
traffic file the axes (``config``: one ``FamConfig`` field swept,
``workload``: one workload per system replicated over its nodes, ``mix``:
an explicit workload per node, ``flag``: ``SimFlags`` variants), the trace
length and the trace backend. The experiment goes through
``repro_torch.experiments``' ``Experiment`` and axis constructors, never
through the port's figure drivers.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict


def sweep_seed(seed: int, index) -> int:
    """The trace seed of sweep ``index`` (a number, or the name of a set-up
    sweep) of a run seeded ``seed``: 31 bits, so every node's derived seed
    stays a small integer."""
    digest = hashlib.sha256(f"{seed}:{index}".encode()).digest()
    return int.from_bytes(digest[:4], "little") >> 1


def fam_fields(config: Dict) -> Dict:
    """The configuration file's ``FamConfig`` values; raises if one is
    missing, so the file always holds the configuration as it is run."""
    from repro_torch.configs.base import FamConfig
    names = [f.name for f in dataclasses.fields(FamConfig)]
    missing = [n for n in names if n not in config]
    if missing:
        raise KeyError(f"configuration {config.get('name')!r} lacks {missing}")
    return {n: config[n] for n in names}


def axes_of(traffic: Dict):
    from repro_torch.experiments import config_axis, flag_axis, mix_axis, workload_axis
    from repro_torch.policies import SimFlags
    axes = []
    for ax in traffic["axes"]:
        kind, name, values = ax["axis"], ax["name"], ax["values"]
        if kind == "config":
            axes.append(config_axis(name, values, param=ax["param"]))
        elif kind == "workload":
            axes.append(workload_axis(values, name=name))
        elif kind == "mix":
            axes.append(mix_axis(values, name=name))
        elif kind == "flag":
            axes.append(flag_axis(name, {k: SimFlags(**v) for k, v in values.items()}))
        else:
            raise ValueError(f"unknown axis kind {kind!r}")
    return tuple(axes)


def experiment(config: Dict, traffic: Dict, seed: int, T: int = 0, name: str = "cell"):
    """The cell's ``Experiment`` with trace seed ``seed`` (and trace length
    ``T`` instead of the traffic's, for the profiled sweep)."""
    from repro_torch.configs.base import FamConfig
    from repro_torch.experiments import Experiment
    if traffic["kind"] != "sweep":
        raise ValueError(f"traffic kind {traffic['kind']!r} is not a sweep")
    return Experiment(name=name, base=FamConfig(**fam_fields(config)),
                      axes=axes_of(traffic), nodes=config["num_nodes"],
                      T=T or traffic["T"], seed=seed,
                      trace_backend=traffic["trace_backend"])
