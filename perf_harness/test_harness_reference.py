"""The plain reference against the program on the CPU, and the control:
the reference in bfloat16 in the program's place has to fail the check."""
import dataclasses
import math

import numpy as np

from perf_harness.lib import check
from perf_harness.reference import famsim as ref
from perf_harness.reference import traces as ref_traces


def test_rounding():
    assert ref.round_f32(0.1) == float(np.float32(0.1))
    assert ref.round_f32(1 / 3) == float(np.float32(1) / np.float32(3))
    assert ref.round_bf16(1.0 + 2 ** -9) == 1.0          # below half an ulp
    assert ref.round_bf16(1.0 + 3 * 2 ** -9) == 1.0 + 2 ** -7
    assert ref.round_bf16(257.0) == 256.0 and ref.round_bf16(259.0) == 260.0
    assert ref.round_bf16(math.inf) == math.inf


def test_traces_equal_the_programs_generator():
    from repro_torch.traces import host, specs
    assert set(ref_traces.WORKLOADS) == set(specs.WORKLOADS)
    for name, spec in specs.WORKLOADS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref_traces.WORKLOADS[name])
    for name in ref_traces.WORKLOAD_NAMES:
        a, g = ref_traces.generate(name, 300, 12345)
        b, h = host.generate(name, 300, 12345)
        assert np.array_equal(a, b) and np.array_equal(g, h), name


def test_reference_equals_the_program_on_the_cpu(cell_name, small_cell):
    """Every system of a small sweep through the program's executor equals
    the reference bit for bit (the check's lower reading at this size)."""
    from perf_harness.lib import experiment
    from perf_harness.lib.runner import _sweep
    c = small_cell(cell_name, T=600)          # past one adaptation cycle (512 events)
    systems = check.resolve(c.config, c.traffic)
    seed = experiment.sweep_seed(2 ** 31 + 77, 0)
    _, result = _sweep(c, seed, "cpu")
    assert [p.coords for p in result.points] == [s[0] for s in systems]
    for system, got in zip(systems, result.metrics):
        want = check.reference(system, 600, seed, c.traffic["warmup_frac"])
        assert check.rel_gap(got, want) == 0.0, system[0]


def test_control_fails_and_program_holds(cell_name, small_cell):
    """The calibration's readings at a small size: the program reads 0,
    the bfloat16 control reads far above the limit on three seeds."""
    from perf_harness.calibrate import readings
    c = small_cell(cell_name, T=300)
    lines = []
    summary = readings(c, [3, 2 ** 31 + 5, 10 ** 9 + 7], 3, "cpu", out=lines.append)
    limit = c.spec["check"]["limits"]["max_rel_gap"]
    assert summary["lower"] <= limit
    assert summary["upper"] > max(limit, 1e-3)
    assert len(lines) == 4
