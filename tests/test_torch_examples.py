"""The port's examples (``examples/torch_*.py``), each driven through its
functions at a cut size on the CPU, one test a file.

* ``torch_quickstart``: the simulator demo's metrics equal the
  reference's ``simulate`` on the same numpy traces (counters exact, IPC
  and latency within RTOL); the tiering walk reads back every block it
  accesses; the model demo's loss is finite and near ln(vocab);
* ``torch_multinode_fam``: the five configurations plan into one group,
  the sharded re-run is bit-exact, and DRAM-cache prefetching beats the
  baseline;
* ``torch_serve_tiered``: the Engine's greedy tokens have the asked shape
  and the tiered-KV decode matches full attention within the example's
  own bound;
* ``torch_train_lm``: the demo LM's loss falls over its steps, with a
  checkpoint written under the test's directory.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _example(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart():
    from repro.configs.base import FamConfig as JFamConfig
    from repro.core.famsim import SimFlags as JSimFlags, simulate as j_simulate
    qs = _example("torch_quickstart")
    T = 500
    base, pf = qs.demo_simulator("cpu", T=T)
    for got, flags in ((base, JSimFlags(core_prefetch=False, dram_prefetch=False)),
                       (pf, JSimFlags())):
        want = j_simulate(JFamConfig(), flags, ["603.bwaves_s"], T=T)
        for k in ("demand_hit_fraction", "prefetches_issued"):
            np.testing.assert_array_equal(np.asarray(want[k]), got[k], err_msg=k)
        for k in ("ipc", "fam_latency"):
            np.testing.assert_allclose(np.asarray(want[k]), got[k], rtol=RTOL, err_msg=k)
    assert pf["ipc"][0] > base["ipc"][0]
    assert 0.0 < qs.demo_tiering("cpu", walk=48) <= 1.0
    loss = qs.demo_model("cpu", seq=16)
    assert np.isfinite(loss) and abs(loss - np.log(256)) < 2.0


def test_multinode_fam():
    mn = _example("torch_multinode_fam")
    res, gms = mn.run("cpu", T=300)
    info = res.info
    assert info.planned_groups == 1 and info.systems == len(mn.CONFIGS)
    assert info.shard_check["bit_exact"]
    assert list(gms) == list(mn.CONFIGS)
    assert gms["+ DRAM-cache prefetch (FIFO)"] > gms["baseline (no prefetch)"]


def test_serve_tiered():
    st = _example("torch_serve_tiered")
    gen = st.demo_engine("cpu", batch=2, prompt=8, new_tokens=4)
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    err, hit_rate = st.demo_tiered_kv("cpu", context=128)
    assert err < 5e-4 and 0.0 <= hit_rate <= 1.0


def test_train_lm(tmp_path):
    tl = _example("torch_train_lm")
    report = tl.train(steps=10, dmodel=64, layers=2, vocab=256, batch=4, seq=32,
                      ckpt_dir=str(tmp_path), device="cpu", checkpoint_every=5)
    assert report.steps == 10 and len(report.losses) == 10
    assert np.mean(report.losses[-5:]) < np.mean(report.losses[:5])
    assert any(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_multinode_fam",
                                  "torch_serve_tiered", "torch_train_lm"])
def test_examples_default_to_the_card(name):
    """Each example's entry point runs on the card unless told otherwise,
    and its sizes default to the original's."""
    import inspect
    mod = _example(name)
    fns = [f for f in vars(mod).values() if inspect.isfunction(f)
           and f.__module__ == name and "device" in inspect.signature(f).parameters]
    assert fns and all(inspect.signature(f).parameters["device"].default == "cuda"
                       for f in fns)
