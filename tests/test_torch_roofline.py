"""The port's op counter and roofline terms against the reference's
loop-aware HLO analysis.

* the six cases of ``tests/test_roofline.py``, each on the same numpy
  inputs through ``repro.roofline.hlo_parse.analyze_hlo`` (on the jitted
  jnp program) and through :class:`repro_torch.roofline.op_cost.OpCounter`
  (on the torch program): a matmul's flops equal XLA's exactly; a loop of
  n matmuls counts n times one and nested loops multiply, against the
  reference's loop-aware count within the reference's own 5 %; an
  elementwise chain's bytes within the reference's stated bound (one read
  and one write, 3x slack: the port counts every op's operands and result,
  XLA fuses the chain); a batched einsum's flops; an all-reduce on a
  4-rank fake group counts its operand bytes (the reference's case skips
  without devices);
* ``RooflineTerms.to_dict()`` equal to the reference's, key for key and
  value for value, given the same counts and the reference's constants;
  ``report.table`` equal to the reference's for the same rows;
* a ``Replicate @ Shard(0)`` matmul on a 4-rank fake mesh counts the
  local flops only (hand-counted), the same on a sharding-propagation
  cache hit;
* the ``flash_attention`` charge equal to the ``"torch"`` backend's
  counted dots at three shapes, causal and not, with GQA, and the
  ``"cuda"`` route (the wrapper's plain version on CPU tensors) counting
  the charge alone; ``fused_cache_step`` charged its operands and results
  once;
* the cost model's rules (gathers, scatters, views, collectives) on
  single ops.

The fake process group runs in a subprocess: it becomes its process's
default group.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel.compat import cost_analysis_dict
from repro.roofline import analysis as j_analysis
from repro.roofline import report as j_report
from repro.roofline.hlo_parse import analyze_hlo
from repro_torch.configs.registry import get_config
from repro_torch.models import attention as t_attention
from repro_torch.roofline import analysis, op_cost, report
from repro_torch.roofline.op_cost import OpCounter

REPO = Path(__file__).resolve().parents[1]
LOOP_TOL = 0.05          # the reference's tolerance on its loop-aware counts


def _compile(f, *args):
    return jax.jit(f).lower(*args).compile()


def _count(fn, *args):
    with OpCounter() as c:
        fn(*args)
    return c


def _rng_arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_matmul_flops_match_xla():
    M, K, N = 128, 256, 64
    a, b = _rng_arrays((M, K), (K, N))
    comp = _compile(lambda a, b: a @ b, a, b)
    xla_flops = cost_analysis_dict(comp)["flops"]
    ref = analyze_hlo(comp.as_text()).flops
    got = _count(torch.matmul, torch.tensor(a), torch.tensor(b))
    assert got.cost.flops == ref == xla_flops == 2 * M * K * N
    assert got.flops_once == xla_flops           # FlopCounterMode's cross-check


def test_loop_flops_scale_with_trip_count():
    M, L = 64, 12
    x, ws = _rng_arrays((M, M), (L, M, M))

    def jf(x, ws):
        def body(x, w):
            return jnp.tanh(x @ w), None
        return jax.lax.scan(body, x, ws)[0]

    def tf(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    ref = analyze_hlo(_compile(jf, x, ws).as_text()).flops
    one = _count(lambda x, w: torch.tanh(x @ w), torch.tensor(x), torch.tensor(ws[0]))
    got = _count(tf, torch.tensor(x), torch.tensor(ws))
    assert got.cost.flops == L * one.cost.flops == L * 2 * M ** 3
    assert abs(got.cost.flops - ref) / ref < LOOP_TOL, (got.cost.flops, ref)


def test_nested_loops_multiply():
    M, L1, L2 = 32, 4, 6
    x, ws = _rng_arrays((M, M), (L1, L2, M, M))

    def jf(x, ws):
        def outer(x, wrow):
            def inner(x, w):
                return x @ w, None
            return jax.lax.scan(inner, x, wrow)[0], None
        return jax.lax.scan(outer, x, ws)[0]

    def tf(x, ws):
        for wrow in ws:
            for w in wrow:
                x = x @ w
        return x

    ref = analyze_hlo(_compile(jf, x, ws).as_text()).flops
    got = _count(tf, torch.tensor(x), torch.tensor(ws))
    assert got.cost.flops == L1 * L2 * 2 * M ** 3
    assert abs(got.cost.flops - ref) / ref < LOOP_TOL, (got.cost.flops, ref)


def test_bytes_reasonable_for_elementwise():
    N = 1 << 16
    (x,) = _rng_arrays((N,))
    ref = analyze_hlo(_compile(lambda x: jnp.tanh(x) * 2 + 1, x).as_text()).bytes
    got = _count(lambda x: torch.tanh(x) * 2 + 1, torch.tensor(x))
    # the reference's bound: one read + one write of the buffer, 3x slack
    lo, hi = 2 * 4 * N * 0.5, 2 * 4 * N * 3
    assert lo <= ref <= hi
    assert lo <= got.cost.bytes <= hi, got.cost.bytes
    # three unfused ops, each reading and writing the buffer once
    assert got.cost.bytes == 3 * 2 * 4 * N


def test_dot_general_batched():
    B, M, K, N = 8, 32, 64, 16
    a, b = _rng_arrays((B, M, K), (B, K, N))
    comp = _compile(lambda a, b: jnp.einsum("bmk,bkn->bmn", a, b), a, b)
    ref = analyze_hlo(comp.as_text()).flops
    got = _count(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                 torch.tensor(a), torch.tensor(b))
    assert got.cost.flops == B * 2 * M * K * N
    assert abs(got.cost.flops - ref) / ref < LOOP_TOL


FAKE_GROUP = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.roofline.op_cost import OpCounter
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    out = {}
    x = torch.ones(256, 32)
    with OpCounter() as c:
        dist.all_reduce(x)
    out["all_reduce"] = [c.cost.coll_bytes, c.cost.coll_count, c.cost.bytes]
    mesh = init_device_mesh("cpu", (4,))
    M, K, N = 128, 128, 128
    a = distribute_tensor(torch.randn(M, K), mesh, (Replicate(),))
    b = distribute_tensor(torch.randn(K, N), mesh, (Shard(0),))
    runs = []
    for _ in range(2):                  # a propagation miss, then a hit
        with OpCounter() as c:
            y = a @ b
        runs.append([c.cost.flops, c.flops_once, str(y.placements)])
    with FlopCounterMode(display=False) as f:
        a @ b
    out["dtensor"] = runs
    out["flop_counter_alone"] = f.get_total_flops()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_group():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", FAKE_GROUP], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_collective_bytes_counted(fake_group):
    coll_bytes, coll_count, nbytes = fake_group["all_reduce"]
    assert coll_bytes == {"all-reduce": 256 * 32 * 4}
    assert coll_count == {"all-reduce": 1}
    assert nbytes == 2 * 256 * 32 * 4          # operands + result


def test_dtensor_counts_local_flops_only(fake_group):
    M, K, N, ranks = 128, 128, 128, 4
    local = 2 * M * (K // ranks) * N            # each rank's slice of the contraction
    for flops, once, placements in fake_group["dtensor"]:
        assert flops == local and once == local, (flops, once)
        assert placements == "(Partial(sum),)"
    print(f"local {local} flops; FlopCounterMode alone reads "
          f"{fake_group['flop_counter_alone']} (the global op)")


def _ref_terms(**kw):
    t = j_analysis.RooflineTerms(**kw)
    t.coll_bytes = {"all-reduce": 7.0e9, "all-gather": 1.5e9}
    t.coll_count = {"all-reduce": 12, "all-gather": 3}
    t.xla_flops_once, t.xla_bytes_once = 1.25e13, 3.5e11
    return t


REF_CHIP = analysis.ChipSpec("reference constants", j_analysis.PEAK_FLOPS, j_analysis.HBM_BW,
                             j_analysis.ICI_BW, j_analysis.ICI_LINKS)


@pytest.mark.parametrize("counts", [
    dict(flops_per_device=3.2e14, bytes_per_device=2.1e12,
         collective_bytes_per_device=8.5e9, chips=256, model_flops=5.0e16),
    dict(flops_per_device=1.0e9, bytes_per_device=7.0e11,
         collective_bytes_per_device=0.0, chips=512, model_flops=0.0),
    dict(flops_per_device=0.0, bytes_per_device=0.0,
         collective_bytes_per_device=0.0, chips=8),
])
def test_terms_to_dict_equal_reference(counts):
    ref = _ref_terms(**counts).to_dict()
    got = analysis.RooflineTerms(**counts, chip=REF_CHIP,
                                 coll_bytes={"all-reduce": 7.0e9, "all-gather": 1.5e9},
                                 coll_count={"all-reduce": 12, "all-gather": 3},
                                 xla_flops_once=1.25e13, xla_bytes_once=3.5e11).to_dict()
    assert list(got) == list(ref)
    assert got == ref


def test_analyze_reads_a_counter():
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    c = _count(torch.matmul, a, b)
    t = analysis.analyze(c, chips=4, model_flops=1e6)
    assert t.flops_per_device == 2 * 64 * 32 * 16 and t.chip is analysis.H100_SXM
    assert t.bytes_per_device == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert t.xla_flops_once == t.flops_per_device
    assert t.compute_s == t.flops_per_device / 989e12


def _rows():
    rows = []
    for i, (arch, shape, kind) in enumerate([("xlstm-350m", "train_4k", "train"),
                                             ("yi-9b", "prefill_32k", "prefill"),
                                             ("qwen2-vl-72b", "decode_32k", "decode"),
                                             ("gemma-2b", "decode_32k", "decode")]):
        terms = analysis.RooflineTerms(
            flops_per_device=10.0 ** (10 + i), bytes_per_device=3.0 ** (20 + i),
            collective_bytes_per_device=(0.0, 5e8, 2e11, 1e3)[i], chips=256,
            model_flops=4.0 ** (20 + i))
        rows.append({"arch": arch, "shape": shape, "kind": kind, "status": "ok",
                     "roofline": terms.to_dict()})
    return rows


def test_report_table_equals_reference(tmp_path):
    rows = _rows()
    assert report.table(rows, hillclimb=report.HILLCLIMB) == \
        j_report.table(rows, hillclimb=j_report.HILLCLIMB)
    assert report.NOTES == j_report.NOTES and report.HILLCLIMB == j_report.HILLCLIMB
    for x in (0, 5e-4, 0.123456, 12.5):
        assert report.fmt(x) == j_report.fmt(x)
    for d in rows + [{"arch": "a", "shape": "s", "status": "error"}]:
        (tmp_path / f"{d['arch']}__{d['shape']}.json").write_text(json.dumps(d))
    assert report.load(tmp_path) == sorted(rows, key=lambda d: f"{d['arch']}__{d['shape']}")
    assert report.bottlenecks(rows) == dict(
        collections.Counter(d["roofline"]["bottleneck"] for d in rows))


def _attn_cfg(Hq, Hkv, D):
    return dataclasses.replace(get_config("granite-3-2b-smoke"), num_heads=Hq,
                                             num_kv_heads=Hkv, head_dim=D)


# (B, S, Hq, Hkv, D): one chunk, a whole number of chunks, a padded tail
ATTN_SHAPES = [(2, 200, 4, 2, 16), (1, 1024, 4, 1, 8), (1, 1100, 6, 2, 8)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_flash_attention_charge_equals_torch_count(shape, causal):
    B, S, Hq, Hkv, D = shape
    cfg = _attn_cfg(Hq, Hkv, D)
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.standard_normal((B, S, H, D)).astype(np.float32))
               for H in (Hq, Hkv, Hkv))
    torch_count = _count(lambda: t_attention.attend(cfg, q, k, v, causal=causal,
                                                    backend="torch"))
    flops, nbytes = op_cost.attention_cost(q.shape, k.shape, q.element_size())
    assert torch_count.cost.flops == flops
    kernel = _count(lambda: t_attention.attend(cfg, q, k, v, causal=causal, backend="cuda"))
    assert kernel.charges == {"flash_attention": [flops, nbytes, 1]}
    assert kernel.cost.flops == flops and kernel.cost.bytes == nbytes
    assert not kernel.ops                       # the plain version ran uncounted


def test_fused_cache_step_charge():
    from repro_torch.kernels.famsim_step.kernel import fused_cache_step
    lanes, S, W, C, P = (3, 2), 8, 4, 2, 3
    i32 = torch.int32
    tags = torch.full(lanes + (S, W), -1, dtype=i32)
    lru = torch.zeros(lanes + (S, W), dtype=i32)
    stamp = torch.zeros(lanes, dtype=i32)
    args = (tags, lru, stamp, torch.zeros(lanes + (C,), dtype=i32),
            torch.ones(lanes + (C,), dtype=torch.bool), torch.zeros(lanes, dtype=i32),
            torch.ones(lanes, dtype=torch.bool), torch.zeros(lanes + (P,), dtype=i32),
            torch.full(lanes, S, dtype=i32), torch.full(lanes, W, dtype=i32))
    c = _count(lambda: fused_cache_step(*args))
    n = 6
    operands = 4 * (2 * n * S * W + n + n * C + n + n * P + 2 * n) + n * C + n
    results = 4 * (2 * n * S * W + n) + n + n * P
    assert c.charges == {"fused_cache_step": [0.0, float(operands + results), 1]}
    assert not c.ops
    op_cost.charge("nobody", 1.0, 1.0)          # no counter: nothing to charge


def _one(fn):
    return _count(fn).cost


@pytest.mark.parametrize("case", ["gather", "index_select", "index", "embedding",
                                  "index_put", "scatter_add", "view", "transpose",
                                  "addmm", "bmm"])
def test_cost_rules(case):
    x = torch.ones(64, 32)
    idx = torch.arange(8)
    f32, i64 = 4, 8
    if case == "gather":
        c = _one(lambda: torch.gather(x, 0, idx[:, None].expand(8, 32)))
        assert c.bytes == 2 * 8 * 32 * f32 + 8 * 32 * i64
    elif case == "index_select":
        c = _one(lambda: torch.index_select(x, 0, idx))
        assert c.bytes == 2 * 8 * 32 * f32 + 8 * i64
    elif case == "index":
        c = _one(lambda: x[idx])
        assert c.bytes == 2 * 8 * 32 * f32 + 8 * i64
    elif case == "embedding":
        c = _one(lambda: torch.nn.functional.embedding(idx, x))
        assert c.bytes == 2 * 8 * 32 * f32 + 8 * i64
    elif case == "index_put":
        y = x.clone()
        upd = torch.ones(8, 32)
        c = _one(lambda: y.index_put_((idx,), upd))
        assert c.bytes == 2 * 8 * 32 * f32 + 8 * i64 + 64 * 32 * f32
    elif case == "scatter_add":
        src = torch.ones(8, 32)
        index = idx[:, None].expand(8, 32)
        c = _one(lambda: x.clone().scatter_add_(0, index, src))
        # the clone, then the scatter: 2 * updates + indices + result
        assert c.bytes == 2 * 64 * 32 * f32 + (2 * 8 * 32 * f32 + 8 * 32 * i64 + 64 * 32 * f32)
    elif case in ("view", "transpose"):
        c = _one(lambda: x.view(32, 64) if case == "view" else x.t())
        assert c.bytes == 0 and c.flops == 0
    elif case == "addmm":
        w, bias = torch.ones(32, 16), torch.ones(16)
        c = _one(lambda: torch.addmm(bias, x, w))
        assert c.flops == 2 * 64 * 32 * 16
        assert c.bytes == (16 + 64 * 32 + 32 * 16 + 64 * 16) * f32
    else:
        a, b = torch.ones(4, 8, 16), torch.ones(4, 16, 2)
        c = _one(lambda: torch.bmm(a, b))
        assert c.flops == 2 * 4 * 8 * 2 * 16


def test_uncounted_pauses_every_counter():
    x = torch.ones(16, 16)
    with OpCounter() as outer, OpCounter() as inner:
        x @ x
        with op_cost.uncounted():
            x @ x
        op_cost.charge("k", 10.0, 20.0)
    for c in (outer, inner):
        assert c.cost.flops == 2 * 16 ** 3 + 10.0
        assert c.charges == {"k": [10.0, 20.0, 1]}


def test_bench_roofline_record(tmp_path):
    """``bench --quick`` writes its roofline record under ``--out`` only:
    the reference's keys (``benchmarks/bench_famsim.py:128-149``) and each
    group's counted bytes an event; the ``cuda`` step charges the cache
    step once an event (its plain version on CPU tensors uncounted), so
    the two backends count different bytes for the same digest."""
    from repro_torch.benchmarks import bench_famsim as bench
    rows = bench.main(["--quick", "--repeats", "1", "--device", "cpu", "--out", str(tmp_path)])
    recs = json.loads((tmp_path / bench.ROOFLINE).read_text())
    assert [r["backend"] for r in recs] == [r["backend"] for r in rows] == ["cuda", "torch"]
    terms_keys = set(analysis.RooflineTerms(0.0, 0.0, 0.0, 1).to_dict())
    for r, row in zip(recs, rows):
        assert {"backend", "events", "run_s_best", "events_per_sec_per_device",
                "groups"} <= set(r)
        assert r["events"] == row["events"] == 8 * bench.QUICK_T
        assert r["run_s_best"] == row["run_s_best"]
        (g,) = r["groups"]
        assert {"static_shape"} | terms_keys <= set(g)
        assert g["events"] == bench.QUICK_T and g["bytes_per_event"] > 0
        assert g["bytes_per_device"] == g["bytes_per_event"] * g["events"]
        assert g["chips"] == 1 and g["model_flops"] == 0.0
        assert g["bottleneck"] == "memory"
    cuda, plain = (r["groups"][0] for r in recs)
    assert list(cuda["charges_per_event"]) == ["fused_cache_step"]
    assert cuda["charges_per_event"]["fused_cache_step"][2] == 1
    assert plain["charges_per_event"] == {}
    assert cuda["bytes_per_event"] != plain["bytes_per_event"]
    # --no-roofline: rows only
    bench.main(["--quick", "--repeats", "1", "--device", "cpu", "--kernel-backend", "torch",
                "--no-roofline", "--out", str(tmp_path / "bare")])
    assert not (tmp_path / "bare" / bench.ROOFLINE).exists()
