"""The count behind ``sim_step_roofline_pct`` and
``fused_cache_step_roofline``, against hand arithmetic, and the profiler
window's arithmetic on made-up records."""
import pytest

from perf_harness.lib import manifest, profile, work


@pytest.mark.parametrize("cell,nodes,lanes", [
    ("fam-1node-table2.fig08-suite", 1, 228),
    ("fam-4node-pooled.fig14-mixes", 4, 168)])
def test_step_bytes_by_hand(cell, nodes, lanes, cells):
    config = cells(cell).config
    # W 16, C 8, D 4, P 6, Q 256 (Table II), E 64
    cache = 2 * 8 * 16 + 2 * 8 * 16 * 8 + 4 * 16 * 6          # 256 + 2048 + 384
    spp = 24 + 72 + 36 * 4                                    # 240
    queue = 2 * 8 * 256                                       # 4096
    fill_buffer = 8 * 64 + 8 * 2                              # 528
    carry = 200
    per_lane = cache + spp + queue + fill_buffer + carry + 8 + 16 / nodes
    assert per_lane == 7760 + 16 / nodes
    assert work.lane_bytes(config, nodes) == per_lane
    assert work.step_bytes(config, lanes, nodes) == pytest.approx(lanes * per_lane)


def test_cache_step_bytes_by_hand():
    config = manifest.load_cell("fam-1node-table2.fig08-suite").config
    rows = 256 + 2048 + 384
    operands = 4 * 8 + 8 + 4 + 1 + 4 * 6 + 4 + 4 + 8
    assert work.cache_step_lane_bytes(config) == rows + operands + 1 + 6


def test_peak_table():
    assert work.peak("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert work.peak("cpu") is None


def _trace():
    k = profile.CACHE_STEP_KERNEL
    kernels = [("a", 100, 110), (k, 110, 115), ("b", 115, 130),      # step 1
               ("a", 200, 210), (k, 210, 216), ("b", 216, 230),      # step 2
               ("a", 300, 310), (k, 310, 314), ("b", 314, 330)]      # step 3
    copies = [("Memcpy DtoD (Device -> Device)", 150, 160)]
    spans = [("execute", 0, 400), ("run", 90, 340), ("fetch", 335, 400)]
    return profile.Trace(kernels, copies, (0, 400), spans)


def test_trace_busy_gaps_and_breakdown():
    t = _trace()
    assert t.window_s == 400e-9
    assert t.busy_s() == pytest.approx((30 + 10 + 30 + 30) * 1e-9)
    gaps = t.gaps()
    assert gaps[0] == (0, 100) and gaps[-1] == (330, 400)
    assert sum(e - s for s, e in gaps) == 400 - 100
    b = t.breakdown()
    assert b["idle_gaps"][0] == ["execute", 100e-9]
    assert [name for name, _ in b["idle_gaps"]][:3] == ["execute", "run", "fetch"]
    assert b["device_ops"][0] == ["b", 45e-9] and len(b["device_ops"]) == 4


def test_replay_kernels():
    per_event, cache_s, launches, step_s = profile.replay_kernels(_trace())
    assert launches == 3
    assert per_event == 6 / 2      # kernels starting in [110, 310), two steps
    assert cache_s == pytest.approx(15 / 3 * 1e-9)
    # busy in [110, 310): 110-130, 150-160 (the copy), 200-230, 300-310
    assert step_s == pytest.approx((20 + 10 + 30 + 10) / 2 * 1e-9)
    assert profile.replay_kernels(profile.Trace([], [], (0, 1))) is None


def test_readers_take_the_trace_and_the_simulated_lanes(cells):
    """The device-trace readers: the whole step's share over the traced time
    a step, the kernel's share over the cell's simulated lanes."""
    from perf_harness.lib.runner import Run, read_metric
    config = cells("fam-1node-table2.fig08-suite").config
    run = Run(config=config, lanes=228, trace=_trace(), peak={"hbm_bytes_per_s": 1e12})
    step_s, cache_s = 35e-9, 5e-9
    assert read_metric("sim_step_roofline_pct", run) == pytest.approx(
        228 * work.lane_bytes(config, 1) / 1e12 / step_s * 100)
    assert read_metric("fused_cache_step_roofline", run) == pytest.approx(
        228 * work.cache_step_lane_bytes(config) / 1e12 / cache_s * 100)
    assert read_metric("kernels_per_event", run) == 3
    assert read_metric("cache_step_us", run) == pytest.approx(cache_s * 1e6)
    run.trace = None
    for name in ("sim_step_roofline_pct", "fused_cache_step_roofline",
                 "kernels_per_event", "cache_step_us", "device_idle_pct"):
        assert read_metric(name, run) is None
