"""Fig. 8 — sub-page block size vs IPC gain and relative FAM latency.

Counterpart of the reference's ``benchmarks/fig08_blocksize.py``: the same
axes (block size x workload x {base, dram}), T, rows and ``derived``
format. Paper claim: IPC gain flat for 64-512 B (slight peak at 128-256 B),
falling beyond; 4096 B (page-on-touch) blows FAM latency up ~17x and IPC
collapses.

Block size is a per-system ``FamParams`` value: the planner pads the cache
to the largest swept geometry (64 B blocks -> 16384 sets), so the whole
figure is ONE compile group, one batched runner call (one CUDA graph
capture on the card). The ``fig08_engine`` row holds the per-point
cross-check and, on a short run of the grid, the reference's
``shard_check`` (the batched mode against ``("shard", 1)``) and the
graph-vs-eager ``eager_check``.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (BASELINE, DRAM, FamConfig, eager_check,
                                           engine_row, fam_replace, geomean,
                                           obs_tracer, save_outputs, workloads)
from repro_torch.experiments import (Experiment, config_axis, flag_axis,
                                     workload_axis)

NAME = "fig08_blocksize"
BLOCK_SIZES = [64, 128, 256, 512, 1024, 4096]
T = 12_000


def experiment(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", telemetry: int = 0) -> Experiment:
    return Experiment(
        name=NAME, T=T,
        base=fam_replace(FamConfig(), num_nodes=1,
                         kernel_backend=kernel_backend, telemetry=telemetry),
        trace_backend=trace_backend,
        axes=(config_axis("block", BLOCK_SIZES, param="block_bytes"),
              workload_axis(workloads(quick)),
              flag_axis("variant", {"base": BASELINE, "dram": DRAM})))


def figure_rows(get, wls, us_per_call: float):
    """The per-block-size rows from ``get(block=, workload=, variant=)``."""
    rows = []
    for bs in BLOCK_SIZES:
        gains, rels = [], []
        for w in wls:
            base = get(block=bs, workload=w, variant="base")
            out = get(block=bs, workload=w, variant="dram")
            gains.append(float(out["ipc"][0] / max(base["ipc"][0], 1e-9)))
            rels.append(float(out["fam_latency"][0] /
                              max(base["fam_latency"][0], 1e-9)))
        rows.append({
            "name": f"fig08_block{bs}",
            "us_per_call": us_per_call,
            "derived": f"ipc_gain={geomean(gains):.3f};"
                       f"rel_fam_latency={geomean(rels):.3f}",
            "block_bytes": bs,
            "ipc_gain_geomean": geomean(gains),
            "rel_fam_latency_geomean": geomean(rels),
        })
    return rows


def run_figure(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", telemetry: int = 0):
    """(figure rows, ExperimentResult): the whole grid in one executor
    call, as one compile group."""
    res = experiment(quick, trace_backend, kernel_backend, telemetry).run(
        assert_compiles=True, device=device)
    info = res.info
    assert info.planned_groups == 1, info.groups  # dynamic geometry: 1 group
    return figure_rows(res.get, workloads(quick), info.us_per_call()), res


def engine(res, device="cuda", check_points=None, eager: bool = True) -> dict:
    """The ``fig08_engine`` row: the per-point engine check over the first
    ``check_points`` block-64 points (default: all of them, as the
    reference) and the shard and graph-vs-eager checks at ``XCHECK_T``
    events (left out with ``eager`` False)."""
    check_pts = [p for p in res.points
                 if p.cfg.block_bytes == BLOCK_SIZES[0]][:check_points]
    row = engine_row("fig08_engine", res, check_pts, device)
    if eager:
        row.update(eager_check(res, device, shard=True))
    return row


def run_result(quick: bool = True, trace_backend: str = "device",
               kernel_backend: str = "cuda", device="cuda", out=None,
               check_points=None,
               telemetry: int = 0):
    """(rows, ExperimentResult): :func:`run_figure` (under the span tracer
    when ``telemetry``), then :func:`engine`."""
    with obs_tracer(NAME, telemetry, out):
        rows, res = run_figure(quick, trace_backend, kernel_backend, device,
                               telemetry)
    rows.append(engine(res, device, check_points))
    save_outputs(NAME, rows, res, telemetry, out)
    return rows, res


def run(quick: bool = True, trace_backend: str = "device",
        kernel_backend: str = "cuda", device="cuda", out=None, telemetry: int = 0):
    return run_result(quick, trace_backend, kernel_backend, device, out,
                      telemetry=telemetry)[0]
