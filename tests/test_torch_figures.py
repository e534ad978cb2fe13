"""The port's figure drivers (fig08, fig10, fig12, fig14, fig15, fig16)
against the JAX reference.

* The golden file ``src/repro_torch/testdata/figures_golden.json`` holds,
  for both trace backends, JAX's ``derived`` rows of each figure at its
  quick size and full T and every point's metrics with its workloads and
  seed; JAX's rows and points of fig12's policy matrix (MATRIX) and
  the points of one random-replacement combo (RANDOM), at MATRIX_T on
  numpy traces (``chip_smoke.py`` holds the card's runs against them). Regenerate it with
  ``python tests/test_torch_figures.py``: it runs ``repro.experiments``
  directly (never the reference drivers' ``run()``, which rewrites
  ``results/benchmarks/``) and builds the rows with a transcription of the
  reference drivers' row code (:func:`_jax_rows`).
* ``figures_numpy_traces.npz`` beside it holds the numpy traces the
  golden ran on for the workloads whose draws go through numpy's
  ``Generator.zipf`` (zipf_a > 1), which numpy releases sample
  differently (2.0.2, which made the golden, and 2.3.5 disagree); the
  golden lists the SHA-256 of every numpy trace the figures use, so
  ``chip_smoke.py`` runs the card on exactly JAX's inputs.
* The port's row code rebuilds every golden ``derived`` string from the
  golden per-point metrics, and the golden's points are the port's.
* Each driver run on the CPU at a short T with numpy traces gives the same
  ``derived`` strings as the reference's experiment at that T; the
  matrix's ``spp+wfq`` rows equal the plain fig12 run's ``w2`` rows; the
  matrix's baseline is the all-default PolicySet and nothing like it.

``python tests/test_torch_figures.py --compare-committed on|off`` prints
how many of JAX's device-trace rows equal the committed
``results/benchmarks/`` rows with ``jax_threefry_partitionable`` on (JAX
0.9.0's default) or off; ``--compare-device T`` prints, per figure at
length T with device traces on the CPU, how many rows of the port equal
JAX's and the largest |log| ratio between them.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from repro_torch.benchmarks import fig08_blocksize as t08  # noqa: E402
from repro_torch.benchmarks import fig10_bw_adaptation as t10  # noqa: E402
from repro_torch.benchmarks import fig12_wfq as t12  # noqa: E402
from repro_torch.benchmarks import fig14_mixes as t14  # noqa: E402
from repro_torch.benchmarks import fig15_allocation as t15  # noqa: E402
from repro_torch.benchmarks import fig16_cachesize as t16  # noqa: E402
from repro_torch.benchmarks.run import policy_combos  # noqa: E402
from repro_torch.configs.base import fam_replace  # noqa: E402

GOLDEN = REPO / "src" / "repro_torch" / "testdata" / "figures_golden.json"
TRACES = GOLDEN.with_name("figures_numpy_traces.npz")
FIGURES = {"fig08_blocksize": t08, "fig14_mixes": t14, "fig16_cachesize": t16,
           "fig10_bw_adaptation": t10, "fig12_wfq": t12, "fig15_allocation": t15}
#: compile groups of each figure's quick grid (the reference's)
GROUPS = {"fig08_blocksize": 1, "fig14_mixes": 1, "fig16_cachesize": 1,
          "fig10_bw_adaptation": 3, "fig12_wfq": 2, "fig15_allocation": 1}
#: figures whose engine row is the reference's ``info_row`` (groups=N);
#: fig08 / fig16 carry the per-point check in theirs
INFO_ENGINE = ("fig14_mixes", "fig10_bw_adaptation", "fig12_wfq", "fig15_allocation")
METRICS = ("ipc", "fam_latency", "cache_occupancy")
RTOL = 1e-5            # float metrics card vs JAX (tests/test_torch_famsim.py)
ENGINE_POINTS = 2      # per-point cross-check points in the golden's engine rows
T_SHORT = 160          # driver runs on the CPU in this file
#: fig12's policy matrix (``--policies`` arguments), numpy traces at
#: MATRIX_T, on the CUDA cache step
MATRIX_T = 2_000
MATRIX = ["scheduler=fifo,wfq,strict", "prefetch=spp,nextline,bestoffset"]
#: one random-replacement combo on the plain cache step (random has no
#: kernel mode): the quick workloads on 4 nodes at MATRIX_T, numpy traces,
#: prefetching on, the cache cut to 64 KB (16 sets of 16 ways) so sets
#: fill and victims are drawn
RANDOM = {"T": MATRIX_T, "nodes": 4, "kernel_backend": "torch",
          "dram_cache_bytes": 64 << 10}


def _reference(name):
    import importlib
    return importlib.import_module(f"benchmarks.{name}")


def _jax_rows(name, get, quick=True):
    """The reference drivers' row code (``benchmarks/fig*.py`` ``run()``,
    the figure rows only), over ``get(**coords)``."""
    from repro.core.ipc_model import geomean
    ref = _reference(name)
    if name == "fig08_blocksize":
        from benchmarks.common import workloads
        rows = []
        for bs in ref.BLOCK_SIZES:
            gains, rels = [], []
            for w in workloads(quick):
                base = get(block=bs, workload=w, variant="base")
                out = get(block=bs, workload=w, variant="dram")
                gains.append(float(out["ipc"][0] / max(base["ipc"][0], 1e-9)))
                rels.append(float(out["fam_latency"][0] /
                                  max(base["fam_latency"][0], 1e-9)))
            rows.append((f"fig08_block{bs}", f"ipc_gain={geomean(gains):.3f};"
                         f"rel_fam_latency={geomean(rels):.3f}"))
        return rows
    if name == "fig14_mixes":
        rows, adapt_over_fifo, wfq_over_fifo = [], [], []
        for mix in ref._mixes(quick):
            b_ipc = np.maximum(get(mix=mix, variant="base")["ipc"], 1e-9)
            r = {c: geomean(get(mix=mix, variant=c)["ipc"] / b_ipc)
                 for c in ref.CONFIGS}
            adapt_over_fifo.append(r["adapt"] / r["fifo"])
            wfq_over_fifo.append(r["wfq2"] / r["fifo"])
            rows.append((f"fig14_{mix}",
                         ";".join(f"{k}={v:.3f}" for k, v in r.items())))
        rows.append(("fig14_summary",
                     f"adapt_vs_fifo={np.mean(adapt_over_fifo):.3f};"
                     f"wfq2_vs_fifo={np.mean(wfq_over_fifo):.3f}"))
        return rows
    if name == "fig10_bw_adaptation":
        return _jax_fig10_rows(ref, get, quick)
    if name == "fig12_wfq":
        from benchmarks.common import workloads

        class _Res:
            pass
        res = _Res()
        res.get = get
        variants = {f"w{w_}": ({"variant": f"w{w_}"}, {"variant": "fifo"})
                    for w_ in ref.WEIGHTS}
        rows = ref._rows_for(res, workloads(quick), variants,
                             lambda n, label: f"fig12_nodes{n}_{label}", _NoInfo())
        return [(r["name"], r["derived"]) for r in rows]
    if name == "fig15_allocation":
        rows = []
        for ratio in ref.RATIOS:
            agg = {k: [] for k, _ in ref.VARIANTS}
            for w in ref._wls(quick):
                l_ipc = np.maximum(get(ratio=ratio, workload=w, variant="local")
                                   ["ipc"].mean(), 1e-9)
                for key, _ in ref.VARIANTS:
                    agg[key].append(get(ratio=ratio, workload=w, variant=key)
                                    ["ipc"].mean() / l_ipc)
            rows.append((f"fig15_ratio{ratio}",
                         ";".join(f"{k}={geomean(v):.3f}" for k, v in agg.items())))
        return rows
    from benchmarks.common import workloads
    rows = []
    for kb in ref.SIZES_KB:
        gains, occ = [], []
        for w in workloads(quick):
            base = get(cache=kb, workload=w, variant="base")
            out = get(cache=kb, workload=w, variant="wfq2")
            gains.append(out["ipc"].mean() / max(base["ipc"].mean(), 1e-9))
            occ.append(out["cache_occupancy"].mean())
        rows.append((f"fig16_cache{kb}KB", f"ipc_gain={geomean(gains):.3f};"
                     f"occupancy={np.mean(occ):.2f}"))
    return rows


class _NoInfo:
    """The ``info`` the reference's ``fig12_wfq._rows_for`` reads."""

    def us_per_call(self):
        return 0.0


def _jax_fig10_rows(ref, get, quick):
    """The reference's fig10 row code (``derived`` of each row)."""
    from benchmarks.common import workloads
    from repro.core.ipc_model import geomean
    rows = []
    for n in ref.NODE_COUNTS:
        agg = {k: [] for k in ("core", "dram", "adapt")}
        rel_pf = []
        for w in workloads(quick):
            out = {k: get(nodes=n, workload=w, variant=k) for k in ref.VARIANTS}
            b_ipc = np.maximum(out["base"]["ipc"].mean(), 1e-9)
            for k in ("core", "dram", "adapt"):
                agg[k].append(out[k]["ipc"].mean() / b_ipc)
            rel_pf.append(out["adapt"]["prefetches_issued"].sum() /
                          max(out["dram"]["prefetches_issued"].sum(), 1.0))
        rows.append((f"fig10_nodes{n}",
                     f"core={geomean(agg['core']):.3f};"
                     f"dram={geomean(agg['dram']):.3f};"
                     f"adapt={geomean(agg['adapt']):.3f};"
                     f"rel_pf={np.mean(rel_pf):.3f}"))
    rows.append(("fig11_per_workload_4node", "see per_workload field"))
    return rows


def _jax_engine_row(name, res):
    """The reference's ``*_engine`` derived string, its per-point check cut
    to ENGINE_POINTS points (as ``chip_smoke.py`` cuts the port's)."""
    if name in INFO_ENGINE:
        return (f"{name[:5]}_engine", f"groups={res.info.planned_groups}")
    from benchmarks.common import engine_check
    first = res.points[0].cfg
    pts = [p for p in res.points if p.cfg == first][:ENGINE_POINTS]
    check = engine_check(pts, [res.metrics_for(p) for p in pts],
                         trace_backend=res.info.trace_backend)
    return (f"{name[:5]}_engine", f"max_rel_diff={check['max_rel_diff']:.2e};"
            f"matches_1e-5={check['matches_1e-5']}")


def _trace_key(w, T, seed):
    return f"{w}:{T}:{seed}"


def _trace_digest(addrs, gaps):
    import hashlib
    h = hashlib.sha256(np.asarray(addrs, np.int64).tobytes())
    h.update(np.asarray(gaps, np.float32).tobytes())
    return h.hexdigest()


def _numpy_traces(points):
    """{key: (workload, T, node seed)} of every numpy trace the points use."""
    from repro.traces.specs import node_seed
    return {_trace_key(w, p.T, node_seed(p.seed, i)): (w, p.T, node_seed(p.seed, i))
            for p in points for i, w in enumerate(p.workloads)}


def _zipf_drawn(workload):
    from repro.traces.specs import WORKLOADS
    return WORKLOADS[workload].zipf_a > 1.0 and \
        WORKLOADS[workload].pattern in ("zipf", "graph", "mixed")


def _matrix_experiment(mod, combos):
    """fig12's ``policy_experiment`` of ``mod`` (the reference's or the
    port's, each on its default cache step) over ``combos`` at MATRIX_T,
    numpy traces."""
    exp = mod.policy_experiment(combos, quick=True, trace_backend="numpy")
    return dataclasses.replace(exp, T=MATRIX_T)


def _random_experiment(xmod, cfg_cls, ps_cls, flags_cls, kernel_backend):
    """The RANDOM combo as an experiment of ``xmod`` (``repro.experiments``
    or ``repro_torch.experiments``)."""
    from repro_torch.benchmarks.common import QUICK_WORKLOADS
    base = dataclasses.replace(cfg_cls(), kernel_backend=kernel_backend,
                               dram_cache_bytes=RANDOM["dram_cache_bytes"])
    return xmod.Experiment(
        name="random_replacement", T=RANDOM["T"], base=base, flags=flags_cls(),
        nodes=RANDOM["nodes"], trace_backend="numpy",
        axes=(xmod.workload_axis(QUICK_WORKLOADS),
              xmod.policy_axis({"random": ps_cls(replacement="random")})))


def _port_random_experiment():
    from repro_torch import experiments as tx
    from repro_torch.configs.base import FamConfig
    from repro_torch.policies import PolicySet, SimFlags
    return _random_experiment(tx, FamConfig, PolicySet, SimFlags, RANDOM["kernel_backend"])


def _jax_combos(specs):
    from benchmarks.run import policy_combos as jax_policy_combos

    def error(msg):
        raise ValueError(msg)
    return jax_policy_combos(specs, error)


def _points(res):
    return [{"coords": [list(c) for c in p.coords],
             "workloads": list(p.workloads), "seed": p.seed,
             **{k: [float(v) for v in np.asarray(res.metrics_for(p)[k])]
                for k in sorted(res.metrics_for(p))}}
            for p in res.points]


def golden_from_jax():
    """JAX's rows and per-point metrics (every metric) of each figure at
    its quick size and full T on both trace backends, of fig12's policy
    matrix and the points of the random combo at MATRIX_T on numpy traces;
    with the numpy traces' digests and the zipf-drawn traces themselves."""
    from repro.traces import host
    out = {"jax": __import__("jax").__version__, "numpy": np.__version__,
           "rtol": RTOL, "engine_points": ENGINE_POINTS, "figures": {},
           "numpy_traces": {}}
    used = {}
    for name in FIGURES:
        ref = _reference(name)
        out["figures"][name] = {"T": ref.T}
        for backend in ("numpy", "device"):
            res = ref.experiment(quick=True, trace_backend=backend).run()
            assert res.info.planned_groups == GROUPS[name]
            rows = _jax_rows(name, res.get) + [_jax_engine_row(name, res)]
            out["figures"][name][backend] = {"derived": dict(rows),
                                             "points": _points(res)}
            print(f"{name} {backend}: {dict(rows)}", file=sys.stderr)
        used.update(_numpy_traces(res.points))
    ref12 = _reference("fig12_wfq")
    from benchmarks.common import workloads
    combos = _jax_combos(MATRIX)
    res = _matrix_experiment(ref12, combos).run()
    baseline = ref12._baseline_label(combos)
    variants = {label: ({"policy": label}, {"policy": baseline})
                for label in combos if label != baseline}
    rows = [(r["name"], r["derived"]) for r in ref12._rows_for(
        res, workloads(True), variants,
        lambda n, label: f"fig12_nodes{n}_{label}", _NoInfo())]
    rows.append(("fig12_policies_engine", f"groups={res.info.planned_groups}"))
    out["matrix"] = dict(specs=MATRIX, T=MATRIX_T,
                         combos={k: v.describe() for k, v in combos.items()},
                         derived=dict(rows), points=_points(res))
    print(f"policy matrix: {dict(rows)}", file=sys.stderr)
    used.update(_numpy_traces(res.points))
    from repro import experiments as jx
    from repro.configs.base import FamConfig as JFamConfig
    from repro.policies import PolicySet as JPolicySet
    from repro.policies import SimFlags as JSimFlags
    res = _random_experiment(jx, JFamConfig, JPolicySet, JSimFlags, "xla").run()
    out["random"] = dict(RANDOM, groups=res.info.planned_groups, points=_points(res))
    used.update(_numpy_traces(res.points))
    stored = {}
    for key, (w, T, seed) in sorted(used.items()):
        a, g = host.generate(w, T, seed)
        out["numpy_traces"][key] = _trace_digest(a, g)
        if _zipf_drawn(w):
            stored[key + ":lines"] = (a // 64).astype(np.int32)
            stored[key + ":gaps"] = g
    return out, stored


def _golden():
    return json.loads(GOLDEN.read_text())


class _Golden:
    """``get(**coords)`` over a golden figure's stored points."""

    def __init__(self, points):
        self._by = {frozenset((k, v) for k, v in p["coords"]):
                    {m: np.asarray(v, np.float32) for m, v in p.items()
                     if m not in ("coords", "workloads", "seed")}
                    for p in points}

    def get(self, **coords):
        return self._by[frozenset((k, str(v)) for k, v in coords.items())]


def _port_rows(name, get, quick=True):
    mod = FIGURES[name]
    if name == "fig14_mixes":
        return mod.figure_rows(get, mod._mixes(quick), 0.0)
    if name == "fig15_allocation":
        return mod.figure_rows(get, mod._wls(quick), 0.0)
    from repro_torch.benchmarks.common import workloads
    return mod.figure_rows(get, workloads(quick), 0.0)


def _engine_derived(name):
    """The engine row's ``derived`` every run of ``name`` gives."""
    if name in INFO_ENGINE:
        return f"groups={GROUPS[name]}"
    return "max_rel_diff=0.00e+00;matches_1e-5=True"


@pytest.mark.parametrize("backend", ["numpy", "device"])
@pytest.mark.parametrize("name", list(FIGURES))
def test_port_rows_rebuild_golden_derived(name, backend):
    """The port's row code turns the golden per-point metrics back into
    the golden (JAX) derived strings, and the golden's points are the
    port's experiment's points in order (coords, workloads, seed)."""
    fig = _golden()["figures"][name]
    g = fig[backend]
    rows = _port_rows(name, _Golden(g["points"]).get)
    want = {k: v for k, v in g["derived"].items() if not k.endswith("_engine")}
    assert {r["name"]: r["derived"] for r in rows} == want
    pts = FIGURES[name].experiment(quick=True, trace_backend=backend).points()
    assert fig["T"] == FIGURES[name].T == pts[0].T
    assert [[list(c) for c in p.coords] for p in pts] == \
        [p["coords"] for p in g["points"]]
    assert [list(p.workloads) for p in pts] == [p["workloads"] for p in g["points"]]
    assert [p.seed for p in pts] == [p["seed"] for p in g["points"]]
    for p in g["points"]:
        assert all(np.isfinite(p[m]).all() and len(p[m]) == len(p["workloads"])
                   for m in METRICS)


def test_golden_numpy_traces():
    """Every numpy trace the figures use is listed by digest; the stored
    ones are exactly the zipf-drawn ones and hash to their digests; the
    others are this machine's host generator's."""
    from repro_torch.traces import host
    gold = _golden()["numpy_traces"]
    stored = np.load(TRACES)
    keys = {k.rsplit(":", 1)[0] for k in stored.files}
    want = set()
    for name, mod in FIGURES.items():
        want |= set(_numpy_traces(mod.experiment(quick=True).points()))
    want |= set(_numpy_traces(_matrix_experiment(t12, _combos(MATRIX)).points()))
    want |= set(_numpy_traces(_port_random_experiment().points()))
    assert set(gold) == want
    assert keys == {k for k in gold if _zipf_drawn(k.split(":")[0])}
    for key, digest in gold.items():
        w, T, seed = key.split(":")
        if key in keys:
            a = stored[key + ":lines"].astype(np.int64) * 64
            g = stored[key + ":gaps"]
        else:
            a, g = host.generate(w, int(T), int(seed))
        assert _trace_digest(a, g) == digest, key


def test_golden_consistent():
    """The committed golden: both backends of every figure, the engine rows
    exact, the metadata the card's checks read."""
    gold = _golden()
    assert gold["rtol"] == RTOL and gold["engine_points"] == ENGINE_POINTS
    assert sorted(gold["figures"]) == sorted(FIGURES)
    for name, fig in gold["figures"].items():
        for backend in ("numpy", "device"):
            d = fig[backend]["derived"]
            engine = [v for k, v in d.items() if k.endswith("_engine")]
            assert engine == [_engine_derived(name)]
        # the two backends draw different traces: some row differs
        assert fig["numpy"]["derived"] != fig["device"]["derived"]
    m = gold["matrix"]
    combos = _combos(MATRIX)
    assert m["T"] == MATRIX_T and m["specs"] == MATRIX
    assert m["combos"] == {k: v.describe() for k, v in combos.items()}
    groups = len({(p.num_nodes, p.policy_set().compile_tags())
                  for p in _matrix_experiment(t12, combos).points()})
    assert m["derived"]["fig12_policies_engine"] == f"groups={groups}" == "groups=12"
    # random replacement: the port's points, one group, most of them on
    # full caches (victims were drawn)
    rnd = gold["random"]
    assert {k: rnd[k] for k in RANDOM} == RANDOM and rnd["groups"] == 1
    pts = _port_random_experiment().points()
    assert [[list(c) for c in p.coords] for p in pts] == [p["coords"] for p in rnd["points"]]
    assert [list(p.workloads) for p in pts] == [p["workloads"] for p in rnd["points"]]
    full = [min(p["cache_occupancy"]) == 1.0 for p in rnd["points"]]
    assert sum(full) > len(full) // 2, full


@pytest.mark.parametrize("name", list(FIGURES))
def test_driver_matches_reference_at_short_T(name, monkeypatch, tmp_path):
    """The port's driver on the CPU (numpy traces, T = T_SHORT) prints the
    same derived strings as the reference's experiment at that T; its
    engine row is exact (the reference's groups, the per-point check
    exact), its graph-vs-eager check is bit-exact, and its rows went to
    the directory it was given as JSON."""
    ref = _reference(name)
    monkeypatch.setattr(ref, "T", T_SHORT)
    monkeypatch.setattr(FIGURES[name], "T", T_SHORT)
    jres = ref.experiment(quick=True, trace_backend="numpy").run()
    want = dict(_jax_rows(name, jres.get))
    # the per-point check: the reference's points on fig08 / fig16 (cut),
    # one point on fig10 / fig12 / fig15 (none in the reference)
    kw = {} if name == "fig14_mixes" else \
        {"check_points": 1 if name in INFO_ENGINE else ENGINE_POINTS}
    rows, res = FIGURES[name].run_result(quick=True, trace_backend="numpy",
                                         device="cpu", out=tmp_path, **kw)
    assert json.loads((tmp_path / f"{name}.json").read_text()) == \
        json.loads(json.dumps(rows))
    got = {r["name"]: r["derived"] for r in rows}
    engine = got.pop(f"{name[:5]}_engine")
    assert got == want
    assert engine == _engine_derived(name)
    assert res.info.planned_groups == GROUPS[name] and res.info.compiles == 0
    if kw:
        assert rows[-1]["check"]["max_rel_diff"] == 0.0
        assert rows[-1]["check"]["points_checked"] == kw["check_points"]
    check = rows[-1]["eager_check"]
    assert check["bit_exact"] and check["alt"] == "eager"
    assert check["T"] == T_SHORT and check["launches"] == 0    # CPU tensors
    # fig08 / fig16 also carry the reference's shard check, as its rows do
    if name in ("fig08_blocksize", "fig16_cachesize"):
        assert rows[-1]["shard_check"] == {
            "group": 0, "primary": "vmap", "alt": "('shard', 1)",
            "systems": res.info.groups[0]["S_exec"], "bit_exact": True}
    else:
        assert "shard_check" not in rows[-1]


def _combos(specs):
    def error(msg):
        raise ValueError(msg)
    return policy_combos(specs, error)


def test_port_rows_rebuild_golden_matrix():
    """fig12's policy rows over the golden matrix points give the golden
    (JAX) derived strings; the golden's points are the port's matrix
    experiment's, in order."""
    m = _golden()["matrix"]
    combos = _combos(m["specs"])
    from repro_torch.benchmarks.common import workloads
    rows = t12.policy_rows(_Golden(m["points"]).get, workloads(True), combos, 0.0)
    want = {k: v for k, v in m["derived"].items() if not k.endswith("_engine")}
    assert {r["name"]: r["derived"] for r in rows} == want
    pts = _matrix_experiment(t12, combos).points()
    assert [[list(c) for c in p.coords] for p in pts] == [p["coords"] for p in m["points"]]
    assert [list(p.workloads) for p in pts] == [p["workloads"] for p in m["points"]]


def test_policy_matrix_wfq_rows_equal_plain_w2(monkeypatch):
    """The matrix's ``spp+wfq`` rows equal the plain run's ``w2`` rows byte
    for byte (same traces, same program, default weight 2), on the CPU at
    T_SHORT; with the JAX reference's matrix rows equal too."""
    monkeypatch.setattr(t12, "T", T_SHORT)
    combos = _combos(["scheduler=fifo,wfq"])
    mrows, mres = t12.run_figure(quick=True, trace_backend="numpy", device="cpu",
                                 policies=combos)
    prows, _ = t12.run_figure(quick=True, trace_backend="numpy", device="cpu")
    assert mres.info.planned_groups == 2      # fifo and wfq share a group per N
    matrix = {r["name"].replace("_wfq", "_w2"): r["derived"] for r in mrows}
    plain = {r["name"]: r["derived"] for r in prows if r["name"].endswith("_w2")}
    assert matrix == plain and len(plain) == len(t12.NODE_COUNTS)
    ref12 = _reference("fig12_wfq")
    monkeypatch.setattr(ref12, "T", T_SHORT)
    jcombos = _jax_combos(["scheduler=fifo,wfq"])
    jres = ref12.policy_experiment(jcombos, quick=True, trace_backend="numpy").run()
    from benchmarks.common import workloads
    jrows = ref12._rows_for(jres, workloads(True), {"wfq": ({"policy": "wfq"},
                                                            {"policy": "fifo"})},
                            lambda n, label: f"fig12_nodes{n}_{label}", _NoInfo())
    assert {r["name"]: r["derived"] for r in jrows} == \
        {r["name"]: r["derived"] for r in mrows}


def test_baseline_label_rejects_an_overridden_look_alike():
    """The matrix's baseline is the all-default PolicySet by full equality:
    an overridden look-alike (spp + fifo with another weight) is refused,
    before anything runs (``tests/test_policies.py`` holds the same for
    the reference)."""
    from repro_torch.policies import PolicySet
    good = {"base": PolicySet(), "wfq": PolicySet(scheduler="wfq")}
    assert t12._baseline_label(good) == "base"
    look_alike = {"fifo": PolicySet().override("scheduler", weight=3.0),
                  "wfq": PolicySet(scheduler="wfq")}
    with pytest.raises(ValueError, match="all-default baseline"):
        t12._baseline_label(look_alike)
    with pytest.raises(ValueError, match="all-default baseline"):
        t12.run_figure(quick=True, trace_backend="numpy", device="cpu",
                       policies=look_alike)


def compare_committed(partitionable: bool):
    """How many of JAX's device-trace rows equal the committed
    ``results/benchmarks/<figure>.json`` rows, under the given
    ``jax_threefry_partitionable`` setting (JAX 0.9.0's default is True)."""
    import jax
    jax.config.update("jax_threefry_partitionable", partitionable)
    for name in FIGURES:
        res = _reference(name).experiment(quick=True, trace_backend="device").run()
        rows = dict(_jax_rows(name, res.get))
        path = REPO / "results" / "benchmarks" / f"{name}.json"
        committed = {r["name"]: r["derived"] for r in json.loads(path.read_text())}
        same = sum(committed.get(k) == v for k, v in rows.items())
        print(f"jax {jax.__version__}, jax_threefry_partitionable={partitionable}, "
              f"{name}: {same} of {len(rows)} rows equal {path.relative_to(REPO)}")


def compare_device(T: int):
    """The largest |log(port / JAX)| over every printed ratio of each
    figure at its quick size and length ``T``, device traces, both on the
    CPU (the port's tail addresses and gaps differ from JAX's within the
    bounds of tests/test_torch_trace_device.py)."""
    for name, mod in FIGURES.items():
        ref = _reference(name)
        jexp = dataclasses.replace(ref.experiment(quick=True, trace_backend="device"), T=T)
        texp = dataclasses.replace(mod.experiment(quick=True, trace_backend="device"), T=T)
        want = dict(_jax_rows(name, jexp.run().get))
        got = {r["name"]: r["derived"] for r in
               _port_rows(name, texp.run(device="cpu").get)}
        ratios = lambda d: [float(v.split("=")[1]) for v in d.split(";")]
        worst = max(abs(np.log(a / b)) for k in want
                    for a, b in zip(ratios(got[k]), ratios(want[k])))
        same = sum(got[k] == v for k, v in want.items())
        print(f"{name} at T {T}, device traces on the CPU: {same} of {len(want)} "
              f"rows equal JAX's, largest |log(port / JAX)| {worst:.4f}")


if __name__ == "__main__":
    # python tests/test_torch_figures.py [--compare-committed on|off]
    #                                    [--compare-device T]
    if sys.argv[1:2] == ["--compare-committed"]:
        compare_committed(sys.argv[2] == "on")
        sys.exit()
    if sys.argv[1:2] == ["--compare-device"]:
        compare_device(int(sys.argv[2]))
        sys.exit()
    golden, traces = golden_from_jax()
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    np.savez_compressed(TRACES, **traces)
    print(f"wrote {GOLDEN} and {TRACES}", file=sys.stderr)
