"""One run of one sweep cell: set-up, the timed window, the traced sweep,
the check, and the metrics.

Set-up builds the cache-step kernel (kept in the checkout's
``src/repro_torch/kernels/famsim_step/build/``, so only a checkout's first
run compiles it) and runs one whole sweep of the cell, which captures the
cell's compile groups into the executor's runner cache; a traced run also
captures the short profiled sweep. The window then runs whole sweeps back
to back through ``repro_torch.experiments.execute``, each with its own
trace seed, starting sweeps until ``seconds`` have passed and closing when
the last one ends. No capture happens inside it: its runner-cache misses
are reported.
"""
from __future__ import annotations

import importlib.util
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from perf_harness.lib import check, experiment, profile, work
from perf_harness.lib.manifest import Cell, metric_path


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclass
class Run:
    """What the metric readers read."""

    config: Dict
    setup_s: float = 0.0
    window_s: float = 0.0
    events: int = 0                    # simulated events of the window's sweeps
    lanes: int = 0                     # simulated nodes of a sweep
    sweeps: List[Dict] = field(default_factory=list)
    trace: Optional[profile.Trace] = None
    peak: Optional[Dict[str, float]] = None

    def steps_and_replay_s(self):
        """(event steps, runner seconds) summed over the window's sweeps."""
        return (sum(s["steps"] for s in self.sweeps), sum(s["run_s"] for s in self.sweeps))

    def step_bytes(self) -> float:
        return work.step_bytes(self.config, self.lanes, self.config["num_nodes"])

    def cache_step_bytes(self) -> float:
        """Bytes of one cache-step launch over the simulated lanes."""
        return self.lanes * work.cache_step_lane_bytes(self.config)


def read_metric(name: str, run: Run) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(run)``: a number, or None when the
    run holds nothing for it to read."""
    spec = importlib.util.spec_from_file_location("perf_harness_metric_" + name.replace(".", "_"),
                                                  metric_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(run)
    return None if value is None else float(value)


def _sweep(cell: Cell, seed: int, device, T: int = 0):
    from repro_torch.experiments import execute
    exp = experiment.experiment(cell.config, cell.traffic, seed, T=T, name=cell.name)
    plan = exp.plan()
    return plan, execute(plan, device=device, devices=cell.chips,
                         warmup_frac=cell.traffic["warmup_frac"])


def _record(seed: int, result) -> Dict:
    info = result.info
    return {"seed": seed, "metrics": result.metrics, "wall_s": info.wall_s,
            "run_s": info.run_s, "compile_s": info.compile_s,
            "misses": info.exec_cache_misses, "hits": info.exec_cache_hits,
            "steps": sum(g["T_pad"] for g in info.groups),
            "coords": [p.coords for p in result.points]}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             started: float) -> Dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checked``)."""
    import torch
    systems = check.resolve(cell.config, cell.traffic)
    spec = cell.spec
    T = cell.traffic["T"]
    lanes = len(systems) * cell.config["num_nodes"]
    if (lanes, T) != (spec["lanes"], spec["T"]):
        raise ValueError(f"{cell.name}: the traffic gives {lanes} lanes at T {T}, "
                         f"the cell's file says {spec['lanes']} at T {spec['T']}")
    on_card = torch.device(device).type == "cuda"

    # ---- set-up: the kernel, one warm sweep, the traced sweep's capture
    if on_card:
        from repro_torch.kernels.famsim_step import build
        build()
    _sweep(cell, experiment.sweep_seed(seed, "warm"), device)
    if trace:
        _sweep(cell, experiment.sweep_seed(seed, "traced-warm"), device, T=spec["profile_T"])
    if on_card:
        torch.cuda.synchronize()
    run = Run(config=cell.config, lanes=lanes)
    run.setup_s = time.perf_counter() - started

    # ---- the window: whole sweeps until `seconds` have passed
    w0 = time.perf_counter()
    while True:
        s = experiment.sweep_seed(seed, len(run.sweeps))
        _, result = _sweep(cell, s, device)
        run.sweeps.append(_record(s, result))
        if time.perf_counter() - w0 >= seconds:
            break
    run.window_s = time.perf_counter() - w0
    run.events = len(run.sweeps) * lanes * T
    want = [c for c, *_ in systems]
    if any([tuple(c) for c in sw["coords"]] != want for sw in run.sweeps):
        raise RuntimeError("the program's points are not the cell's systems in order")
    misses = sum(sw["misses"] for sw in run.sweeps)
    runners = ", ".join(f"{sw['run_s']:.3f}" for sw in run.sweeps)
    log(f"window: {len(run.sweeps)} sweeps of {len(systems)} systems x "
        f"{cell.config['num_nodes']} nodes x {T} events in {run.window_s:.3f} s "
        f"(runners {runners} s); runner-cache misses {misses}, "
        f"hits {sum(sw['hits'] for sw in run.sweeps)}")
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    run.peak = work.peak(kind)

    breakdown = None
    dev_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if trace:
        _, run.trace = profile.traced(torch, lambda: _sweep(
            cell, experiment.sweep_seed(seed, "traced"), device, T=spec["profile_T"]))
        breakdown = run.trace.breakdown()
        dev_info.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)

    # ---- the check against the plain reference
    verdict = check.compare(systems, cell.traffic,
                            [(sw["seed"], sw["metrics"]) for sw in run.sweeps],
                            spec["check"], seed)
    limits = spec["check"]["limits"]
    checked = {name: {"value": verdict[name], "limit": limit} for name, limit in limits.items()}
    failed = sum(1 for g in verdict["gaps"].values() if not g <= limits["max_rel_gap"])
    correct = all(c["value"] <= c["limit"] for c in checked.values())
    log(f"check: sweep {verdict['sweep']} (seed {verdict['sweep_seed']}), "
        f"{len(verdict['gaps'])} systems against the reference in "
        f"{verdict['reference_s']:.1f} s: " +
        ", ".join(f"{k} {v:.3g}" for k, v in verdict["gaps"].items()))

    metrics = {}
    for m in cell.metrics(trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(run.sweeps) * len(systems),
           "failed": failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = checked
    return out
