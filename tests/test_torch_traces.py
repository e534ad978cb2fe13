"""The port's copies of the numpy trace generators equal the JAX
package's bit for bit (the port imports nothing of ``repro``, so it keeps
its own copy of these JAX-free modules)."""
import dataclasses

import numpy as np
import pytest

from repro.traces import host as jhost
from repro.traces import specs as jspecs
from repro.traces import system_traces as j_system_traces
from repro_torch.traces import host as thost
from repro_torch.traces import specs as tspecs
from repro_torch.traces import system_traces


def test_spec_tables_equal():
    assert list(jspecs.WORKLOADS) == list(tspecs.WORKLOADS)
    for name in jspecs.WORKLOADS:
        assert dataclasses.asdict(jspecs.WORKLOADS[name]) == \
            dataclasses.asdict(tspecs.WORKLOADS[name])
    for const in ("LINE", "GAP_SIGMA", "HOT_REGION_DIV", "TILE_JITTER",
                  "MIN_TILE_LINES", "ADDR_HASH", "PATTERN_IDS", "STREAMS_MAX"):
        assert getattr(jspecs, const) == getattr(tspecs, const), const
    assert jspecs.trace_seed("LU", 3) == tspecs.trace_seed("LU", 3)
    assert jspecs.node_seed(5, 2) == tspecs.node_seed(5, 2)
    assert jspecs.footprint_bytes("bfs") == tspecs.footprint_bytes("bfs")


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_bit_identical(seed):
    for name in jspecs.WORKLOAD_NAMES:
        ja, jg = jhost.generate(name, 2000, seed)
        ta, tg = thost.generate(name, 2000, seed)
        assert ja.dtype == ta.dtype and jg.dtype == tg.dtype
        np.testing.assert_array_equal(ja, ta, err_msg=name)
        np.testing.assert_array_equal(jg, tg, err_msg=name)


def test_system_traces_bit_identical():
    wl = ["LU", "bfs", "canneal"]
    for a, b in zip(j_system_traces(wl, 1500, 4, backend="numpy"),
                    system_traces(wl, 1500, 4)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown trace backend"):
        system_traces(wl, 10, 0, backend="pcg")
    # the device backend dispatches to the threefry generator
    from repro_torch.traces import device as tdevice
    got = system_traces(wl, 1500, 4, backend="device", device="cpu")
    for a, b in zip(got, tdevice.system_traces(wl, 1500, 4, device="cpu")):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (3, 1500) and got[1].dtype == np.float32
