"""The port's search (``repro_torch.search``), its ``pond_tail`` objective
(``repro_torch.tenants.search``) and driver
(``repro_torch.benchmarks.fig_search``) against ``repro.search`` on the CPU,
and the golden values the card is held to.

* ``PolicySet.param_schema`` / ``as_dict`` / ``from_dict``, the space's
  sampling, mutation, validation, ``split``, ``static_key``,
  ``axis_fields`` and ``describe``, the proposers' asks, ``round_T`` and
  states for fixed fitnesses, and ``canonical_json`` equal JAX's.
* ``run_search`` (the fig14 objective over this file's space and MIXES, T
  900, seed 5, 3 candidates over 2 generations, numpy traces) writes JAX's
  ``trajectory.jsonl`` line for line and JAX's ``best.json`` byte for byte,
  derived string included, but for the kernel backend's name: ``"cuda"``,
  the port's default, where JAX's default says ``"xla"``, in the header's
  ``base_cfg`` and in each candidate's runner key (:func:`_as_jax`). The
  second generation replays the first one's cached runner. A resume from 2
  to 3 generations gives JAX's uninterrupted 3-generation run; two
  processes with different hash seeds write identical files.
* ``pond_tail`` at a 4-tenant fleet writes JAX's trajectory likewise
  (header, per-tenant p99 scores, fitnesses).
* The golden file ``src/repro_torch/testdata/search_golden.json`` holds
  JAX's quick ``fig_search`` run (the default space, evolutionary,
  population 6, 3 generations, seed 0, fig14's 4 quick mixes at T 10,000)
  on numpy traces — every ``trajectory.jsonl`` line and ``best.json`` —
  and generation 1's candidates on device traces. ``chip_smoke.py`` holds
  the card against it. Regenerate it with ``python tests/test_torch_search.py``
  (through ``repro.search.run_search``, never the reference driver's
  ``run()``, which rewrites ``results/`` and ``BENCH_search.json``; ~3 min).
  Tier-1 checks its structure and rebuilds its derived strings.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import repro.search as js  # noqa: E402
import repro.tenants.search as jts  # noqa: E402
from repro.configs.base import FamConfig as JFamConfig  # noqa: E402
from repro.policies import PolicySet as JPolicySet  # noqa: E402
from repro.policies import POLICY_KINDS  # noqa: E402
from repro.policies import available as javailable  # noqa: E402
from repro.tenants import FleetSpec as JFleetSpec  # noqa: E402
from repro.tenants import make_tenants as jmake_tenants  # noqa: E402
import repro_torch.search as ts  # noqa: E402
import repro_torch.tenants.search as tts  # noqa: E402
from repro_torch.benchmarks import fig_search  # noqa: E402
from repro_torch.benchmarks.fig14_mixes import T as FIG14_T  # noqa: E402
from repro_torch.benchmarks.fig14_mixes import _mixes  # noqa: E402
from repro_torch.configs.base import FamConfig  # noqa: E402
from repro_torch.core.ipc_model import geomean  # noqa: E402
from repro_torch.experiments import executor as tex  # noqa: E402
from repro_torch.policies import PolicySet, available  # noqa: E402
from repro_torch.tenants import FleetSpec, make_tenants  # noqa: E402

GOLDEN = REPO / "src" / "repro_torch" / "testdata" / "search_golden.json"
MIXES = {"m1": ["LU", "bfs"], "m2": ["mg", "cc"]}
T = 900
SEED = 5
#: the golden's search: fig_search's quick defaults on numpy traces
GOLDEN_RUN = dict(proposer="evolutionary", generations=3, population=6, seed=0,
                  T=FIG14_T)
#: its generation 1 on device traces (the card's device-trace search is cut
#: to 2 generations, never in T: at T 10,000 its generation 1 measured
#: |log| 0.00886 of JAX's against the 0.01 bar, and shorter traces average
#: less)
GOLDEN_DEVICE_T = FIG14_T

#: the one known difference in the files: the kernel backend's name, the
#: port's default against JAX's
_KERNEL_NAMES = (('"kernel_backend":"cuda"', '"kernel_backend":"xla"'),
                 ('"kernel_backend": "cuda"', '"kernel_backend": "xla"'),
                 ("'cuda', ", "'xla', "))


def _as_jax(text: str) -> str:
    """A trajectory line or ``best.json`` of the port with the kernel
    backend named as JAX's default names it (``base_cfg`` and the runner
    keys' geometry-free shape)."""
    for port, ref in _KERNEL_NAMES:
        text = text.replace(port, ref)
    return text


def _space(mod):
    return mod.SearchSpace((
        mod.categorical("sched", mod.policy_choice("scheduler"), ["fifo", "wfq"]),
        mod.continuous("weight", mod.policy_param("scheduler", "weight"), 0.5, 4.0),
        mod.categorical("adapt", mod.flag("bw_adapt"), [False, True]),
    ))


def _lines(out):
    return (Path(out) / "trajectory.jsonl").read_text().splitlines()


def _best(out):
    return (Path(out) / "best.json").read_text()


def _jrun(out, **kw):
    return js.run_search(_space(js), MIXES, T=T, seed=SEED, out_dir=out,
                         trace_backend="numpy", proposer="evolutionary",
                         population=3, **kw)


def _trun(out, **kw):
    return ts.run_search(_space(ts), MIXES, T=T, seed=SEED, out_dir=out,
                         trace_backend="numpy", proposer="evolutionary",
                         population=3, device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's search at 2 and 3 generations, and the port's at 2, run once
    for the module."""
    root = tmp_path_factory.mktemp("search")
    tex._clear_exec_cache()
    out = {"root": root,
           "jax2": _jrun(root / "jax2", generations=2),
           "jax3": _jrun(root / "jax3", generations=3),
           "port2": _trun(root / "port2", generations=2)}
    return out


# ---------------------------------------------------------------------------
# PolicySet serialisation
# ---------------------------------------------------------------------------

def _policy_sets(mod):
    return [mod(), mod(scheduler="wfq").override("scheduler", weight=3.0, backlog_cap=900.0),
            mod(prefetch="nextline", scheduler="strict", replacement="srrip",
                adaptation="static").override("adaptation", rate=0.5),
            mod().override("adaptation", ema_alpha=0.3, mimd_increase=1.1)
                 .override("prefetch", confidence_threshold=0.2)]


def test_policy_set_round_trip_and_schema():
    for jps, tps in zip(_policy_sets(JPolicySet), _policy_sets(PolicySet)):
        assert tps.as_dict() == jps.as_dict()
        assert json.loads(json.dumps(tps.as_dict())) == tps.as_dict()
        assert PolicySet.from_dict(tps.as_dict()) == tps
        assert PolicySet.from_dict(jps.as_dict()) == tps
    for kind in POLICY_KINDS:
        assert available(kind) == javailable(kind)
        for name in available(kind):
            assert PolicySet(**{kind: name}).param_schema(kind) == \
                JPolicySet(**{kind: name}).param_schema(kind)


@pytest.mark.parametrize("call", [
    lambda m: m.from_dict({"prefetch": "spp", "bogus": 1}),
    lambda m: m().override("scheduler", wieght=1.0),
    lambda m: m().param_schema("queueing"),
    lambda m: m.from_dict({"overrides": {"scheduler": {"nope": 1.0}}}),
], ids=["unknown_key", "bad_param", "bad_kind", "bad_override"])
def test_policy_set_errors_equal(call):
    with pytest.raises(ValueError) as jerr:
        call(JPolicySet)
    with pytest.raises(ValueError) as terr:
        call(PolicySet)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# space
# ---------------------------------------------------------------------------

def _dims(mod):
    return [mod.continuous("c", mod.policy_param("scheduler", "weight"), 0.5, 4.0),
            mod.log_continuous("l", mod.policy_param("scheduler", "backlog_cap"), 500, 4000),
            mod.integer("i", mod.cfg_field("prefetch_degree"), 1, 4),
            mod.categorical("k", mod.flag("bw_adapt"), [False, True]),
            mod.categorical("s", mod.policy_choice("scheduler"), ["fifo", "wfq", "strict"])]


def test_space_sampling_and_mutation_equal():
    """The same generator draws the same samples and moves."""
    draws = {}
    for name, mod in (("jax", js), ("port", ts)):
        rng = np.random.default_rng(0)
        seq = []
        for _ in range(40):
            for d in _dims(mod):
                v = d.sample(rng)
                seq.append((d.name, v, d.mutate(v, rng), d.mutate(v, rng, 0.5)))
            seq.append(_space(mod).sample(rng))
        draws[name] = seq
    assert draws["port"] == draws["jax"]
    assert json.loads(json.dumps(draws["port"][-1])) == draws["port"][-1]


@pytest.mark.parametrize("build", [
    lambda m: m.continuous("x", m.policy_param("scheduler", "weight"), 2.0, 1.0),
    lambda m: m.log_continuous("x", m.policy_param("scheduler", "weight"), 0.0, 1.0),
    lambda m: m.categorical("x", m.flag("bw_adapt"), [True]),
    lambda m: m.policy_param("queueing", "weight"),
    lambda m: m.cfg_field("nope"),
    lambda m: m.flag("nope"),
    lambda m: m.SearchSpace((m.categorical("a", m.flag("bw_adapt"), [False, True]),
                             m.categorical("a", m.flag("all_local"), [False, True]))),
    lambda m: m.SearchSpace((m.integer("a", m.cfg_field("prefetch_degree"), 1, 4),
                             m.integer("b", m.cfg_field("prefetch_degree"), 2, 8))),
    lambda m: m.SearchSpace((m.continuous("w", m.policy_param("scheduler", "wieght"),
                                          0.5, 4.0),)).axis_fields({"w": 1.0}),
], ids=["hi_lo", "log_lo", "choices", "kind", "cfg", "flag", "dup_name", "dup_target",
        "bad_param"])
def test_space_validation_equal(build):
    with pytest.raises(ValueError) as jerr:
        build(js)
    with pytest.raises(ValueError) as terr:
        build(ts)
    assert str(terr.value) == str(jerr.value)


def _split_space(mod, base):
    return mod.SearchSpace((
        mod.categorical("chain", mod.policy_choice("scheduler"), ["fifo", "wfq"]),
        mod.continuous("w", mod.policy_param("scheduler", "weight"), 0.5, 4.0),
        mod.categorical("adapt", mod.flag("bw_adapt"), [False, True]),
        mod.integer("deg", mod.cfg_field("prefetch_degree"), 1, 4),
        mod.categorical("geom_dn", mod.cfg_field("block_bytes"),
                        [base.block_bytes // 2, base.block_bytes]),
        mod.categorical("geom_up", mod.cfg_field("dram_cache_bytes"),
                        [base.dram_cache_bytes, 2 * base.dram_cache_bytes]),
        mod.categorical("sched3", mod.policy_choice("prefetch"), ["spp", "nextline"]),
        mod.continuous("alpha", mod.policy_param("adaptation", "ema_alpha"), 0.05, 0.6),
    ))


def _fields(f):
    return {"policies": f["policies"].as_dict(), "flags": dataclasses.asdict(f["flags"]),
            "cfg": f.get("cfg")}


def test_space_split_keys_fields_and_describe_equal():
    jsp, tsp = _split_space(js, JFamConfig()), _split_space(ts, FamConfig())
    assert tsp.split(FamConfig()) == jsp.split(JFamConfig())
    assert set(tsp.split(FamConfig())[0]) == {"deg", "geom_up", "sched3"}
    assert tsp.describe() == jsp.describe()
    rng_j, rng_t = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(6):
        sj, st = jsp.sample(rng_j), tsp.sample(rng_t)
        assert st == sj
        assert tsp.static_key(st, FamConfig()) == jsp.static_key(sj, JFamConfig())
        assert _fields(tsp.axis_fields(st)) == _fields(jsp.axis_fields(sj))
    with pytest.raises(KeyError, match="missing dimensions"):
        tsp.axis_fields({"chain": "wfq"})
    # the cache-step backend is static in both: (torch, cuda) / (xla, pallas)
    kb = ts.SearchSpace((ts.categorical("kb", ts.cfg_field("kernel_backend"),
                                        ["torch", "cuda"]),))
    assert kb.split(FamConfig()) == (("kb",), ())
    assert kb.static_key({"kb": "cuda"}) == (("kb", "cuda"),)


def test_driver_spaces_equal_reference():
    """fig_search's spaces describe as the reference driver's, the backend
    dimension's choices named for each package."""
    from benchmarks import fig_search as ref
    assert fig_search.default_space().describe() == ref.default_space().describe()
    port, want = fig_search.full_space().describe(), ref.full_space().describe()
    assert port["dimensions"][-1]["choices"] == ["torch", "cuda"]
    assert want["dimensions"][-1]["choices"] == ["xla", "pallas"]
    port["dimensions"][-1]["choices"] = want["dimensions"][-1]["choices"]
    assert port == want
    assert fig_search.full_space().split(FamConfig()) == ref.full_space().split(JFamConfig())


# ---------------------------------------------------------------------------
# proposers and encoding
# ---------------------------------------------------------------------------

def _synthetic_fitness(s):
    return (-(s["weight"] - 3.0) ** 2 - (0.0 if s["sched"] == "wfq" else 0.5)
            - (0.0 if s["adapt"] else 0.25))


@pytest.mark.parametrize("name,population,opts", [
    ("random", 4, {}), ("evolutionary", 8, {}),
    ("evolutionary", 5, {"elite": 1, "tournament": 3, "static_mutation": 0.5}),
    ("halving", 2, {"rungs": 3, "eta": 2, "min_T": 512})])
def test_proposers_equal_reference(name, population, opts):
    """Asks, budgets and states for the same seed and fitnesses; the state
    round-trips through JSON into a fresh proposer that continues alike."""
    props = [mod.get_proposer(name)(_space(mod), np.random.default_rng(3), population,
                                    **opts) for mod in (js, ts)]
    assert ts.available() == js.proposers.available()
    for _ in range(5):
        asks = [p.ask() for p in props]
        assert asks[1] == asks[0]
        assert props[1].round_T(8000) == props[0].round_T(8000)
        for p, a in zip(props, asks):
            p.tell(a, [_synthetic_fitness(s) for s in a])
        assert props[1].state() == props[0].state()
    state = json.loads(json.dumps(props[1].state()))
    fresh = ts.get_proposer(name)(_space(ts), np.random.default_rng(0), population, **opts)
    fresh.load_state(state)
    fresh.rng.bit_generator.state = props[1].rng.bit_generator.state
    assert fresh.ask() == props[0].ask()
    with pytest.raises(KeyError, match="no proposer named"):
        ts.get_proposer("annealing")


def test_canonical_json_equal():
    recs = [{"b": 1, "a": [1.5, True, None], "c": {"z": 0.1, "y": "s"}},
            {"type": "candidate", "objective": 1.0000000000000002, "per_mix": {"m2": 0.3, "m1": 2}}]
    for r in recs:
        assert ts.canonical_json(r) == js.canonical_json(r)


# ---------------------------------------------------------------------------
# the loop against JAX
# ---------------------------------------------------------------------------

def test_run_search_trajectory_and_best_equal_jax(runs):
    """Line for line and byte for byte but for the kernel backend's name;
    generation 2 replays generation 1's cached runner."""
    root = runs["root"]
    port, want = _lines(root / "port2"), _lines(root / "jax2")
    assert len(port) == len(want) == 1 + 2 * 3 + 2
    assert json.loads(port[0])["base_cfg"]["kernel_backend"] == "cuda"
    assert [_as_jax(line) for line in port] == want
    assert _as_jax(_best(root / "port2")) == _best(root / "jax2")
    t1, t2 = runs["port2"]["timings"]
    assert (t1["new_group_keys"], t1["exec_cache_misses"], t1["exec_cache_hits"]) == (1, 1, 0)
    assert (t2["new_group_keys"], t2["compiles"], t2["exec_cache_hits"],
            t2["groups_reused"]) == (0, 0, t2["planned_groups"], t2["planned_groups"])
    best = ts.load_best(root / "port2" / "best.json")
    assert best["derived"] == ts.derived_string(best["per_mix"], best["objective"])
    replay = ts.replay_best(best, trace_backend="numpy", device="cpu")
    assert replay["matches"], replay


def test_resume_gives_jax_uninterrupted_run(runs):
    """The port's 2 generations resumed to 3 equal JAX's 3 in one run, but
    for the header's generation count; a resume over another space
    refuses."""
    root = runs["root"]
    shutil.copytree(root / "port2", root / "resumed")
    out = _trun(root / "resumed", generations=3, resume=True)
    assert out["generations_run"] == 1
    port, want = _lines(root / "resumed"), _lines(root / "jax3")
    h_port, h_want = json.loads(_as_jax(port[0])), json.loads(want[0])
    assert h_port.pop("generations") == 2 and h_want.pop("generations") == 3
    assert h_port == h_want
    assert [_as_jax(line) for line in port[1:]] == want[1:]
    assert _as_jax(_best(root / "resumed")) == _best(root / "jax3")
    other = ts.SearchSpace((ts.categorical("sched", ts.policy_choice("scheduler"),
                                           ["fifo", "wfq"]),))
    with pytest.raises(ValueError, match="resume mismatch"):
        ts.run_search(other, MIXES, T=T, seed=SEED, generations=4, device="cpu",
                      out_dir=root / "resumed", resume=True, trace_backend="numpy")


def test_run_search_needs_its_directory():
    """The port's run_search writes only where its caller says: it has no
    default directory."""
    with pytest.raises(TypeError, match="out_dir"):
        ts.run_search(_space(ts), MIXES, T=T, seed=SEED, device="cpu",
                      trace_backend="numpy")


def test_trajectory_byte_identical_across_processes(tmp_path):
    """Two interpreters with different hash seeds write the same
    trajectory and best.json."""
    snippet = (
        "import sys; sys.path[:0] = [{src!r}]\n"
        "from repro_torch.search import run_search, SearchSpace, categorical, "
        "continuous, policy_choice, policy_param, flag\n"
        "sp = SearchSpace(("
        "categorical('sched', policy_choice('scheduler'), ['fifo','wfq']),"
        "continuous('weight', policy_param('scheduler','weight'), .5, 4.),"
        "categorical('adapt', flag('bw_adapt'), [False, True])))\n"
        "run_search(sp, {{'m1': ['LU', 'bfs']}}, proposer='random', generations=2, "
        "population=2, T=300, seed=11, out_dir={out!r}, trace_backend='numpy', "
        "device='cpu')\n")
    procs = {}
    for hashseed in ("0", "1"):
        out = tmp_path / f"h{hashseed}"
        env = dict(os.environ, PYTHONHASHSEED=hashseed)
        procs[hashseed] = (out, subprocess.Popen(
            [sys.executable, "-c", snippet.format(src=str(REPO / "src"), out=str(out))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    blobs = {}
    for hashseed, (out, proc) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log
        blobs[hashseed] = ((out / "trajectory.jsonl").read_bytes(),
                           (out / "best.json").read_bytes())
    assert blobs["0"] == blobs["1"]


def test_pond_tail_equals_jax(tmp_path):
    """``pond_tail`` over ``qos_space()`` at a 4-tenant zipf fleet: JAX's
    trajectory (header, per-tenant scores, fitnesses) but for the kernel
    backend's name; the objective registers on first lookup."""
    assert "pond_tail" in ts.available_objectives()
    runs = {}
    for name, mod, search, fleet, kw in (
            ("jax", js, jts, JFleetSpec(name="pond4", tenants=jmake_tenants(4, skew="zipf"),
                                        admission="none"), {}),
            ("port", ts, tts, FleetSpec(name="pond4", tenants=make_tenants(4, skew="zipf"),
                                        admission="none"), {"device": "cpu"})):
        out = tmp_path / name
        runs[name] = mod.run_search(search.qos_space(), objective=search.PondObjective(fleet),
                                    generations=2, population=2, T=256, seed=3,
                                    out_dir=out, trace_backend="numpy", **kw)
        runs[name]["lines"] = _lines(out)
    port, want = runs["port"]["lines"], runs["jax"]["lines"]
    header = json.loads(port[0])
    assert header["objective"] == "pond_tail" and header["mixes"]["tenants"] == 4
    assert [_as_jax(line) for line in port] == want
    cands = [json.loads(line) for line in port if '"type":"candidate"' in line]
    assert len(cands) == 4 and all(len(c["per_mix"]) == 4 for c in cands)
    assert runs["port"]["timings"][1]["exec_cache_hits"] == \
        runs["port"]["timings"][1]["planned_groups"]
    assert tts.qos_space().split() == ((), ("wfq_weight", "backlog_cap", "issue_rate"))
    assert tts.default_search_fleet().size == jts.default_search_fleet().size == 16


def test_driver_runs_under_out_only(tmp_path, capsys):
    """``run.py search`` at a small size: rows, the artifacts and
    BENCH_search.json under ``--out``, the replay of its best.json."""
    from repro_torch.benchmarks import run as bench_run
    out = tmp_path / "search"
    rows = bench_run.main(["search", "--device", "cpu", "--T", "200", "--population", "2",
                           "--generations", "2", "--trace-backend", "numpy",
                           "--out", str(out)])
    assert [r["name"] for r in rows] == ["search_gen1", "search_gen2", "search_best",
                                         "search_engine"]
    assert sorted(p.name for p in out.iterdir()) == [
        "BENCH_search.json", "best.json", "fig_search.json", "timings.jsonl",
        "trace.json", "trajectory.jsonl"]
    assert rows[1]["engine"]["compiles"] == 0
    assert rows[1]["engine"]["exec_cache_hits"] == rows[1]["engine"]["planned_groups"]
    capsys.readouterr()
    assert bench_run.main(["search", "--device", "cpu", "--trace-backend", "numpy",
                           "--replay", str(out / "best.json")]) == []
    assert "matches:  True" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the golden file
# ---------------------------------------------------------------------------

def _golden():
    return json.loads(GOLDEN.read_text())


def test_golden_matches_the_driver_and_rebuilds_its_derived_strings():
    """The golden is fig_search's quick run (space, proposer, seed, sizes,
    mixes), and its derived strings rebuild from its per-mix values."""
    g = _golden()
    header, cands, gens = ts.split_records(json.loads(line) for line in g["numpy"]["trajectory"])
    assert header["space"] == fig_search.default_space().describe()
    assert {k: header[k] for k in ("proposer", "generations", "population", "seed", "T")} \
        == GOLDEN_RUN
    assert header["mixes"] == {k: list(v) for k, v in _mixes(True).items()}
    port_cfg = dataclasses.asdict(FamConfig())
    assert port_cfg.pop("kernel_backend") == "cuda"
    assert header["base_cfg"].pop("kernel_backend") == "xla" and header["base_cfg"] == port_cfg
    assert len(gens) == 3 and len(cands) == 18
    for c in cands:
        assert c["objective"] == geomean(np.array(list(c["per_mix"].values())))
    best = json.loads(g["numpy"]["best"])
    assert best["derived"] == ts.derived_string(best["per_mix"], best["objective"])
    assert best["objective"] > 1.0
    assert g["numpy"]["new_group_keys"] == [1, 0, 0]
    dev = g["device_gen1"]
    assert dev["T"] == GOLDEN_DEVICE_T
    assert [c["sample"] for c in dev["candidates"]] == [c["sample"] for c in cands[:6]]
    for c in dev["candidates"]:
        assert c["objective"] == geomean(np.array(list(c["per_mix"].values())))


def golden_from_jax():
    """JAX's quick fig_search run on numpy traces (every trajectory line,
    best.json) and generation 1 on device traces at GOLDEN_DEVICE_T."""
    import tempfile

    import jax

    from benchmarks import fig_search as ref
    from benchmarks.fig14_mixes import _mixes as ref_mixes
    out = {"jax": jax.__version__, "numpy": np.__version__, "run": GOLDEN_RUN}
    kw = dict(GOLDEN_RUN)
    with tempfile.TemporaryDirectory() as tmp:
        js.run_search(ref.default_space(), ref_mixes(True), out_dir=Path(tmp) / "numpy",
                      trace_backend="numpy", **kw)
        timings = (Path(tmp) / "numpy" / "timings.jsonl").read_text().splitlines()
        out["numpy"] = {
            "trajectory": _lines(Path(tmp) / "numpy"), "best": _best(Path(tmp) / "numpy"),
            "new_group_keys": [json.loads(t)["new_group_keys"] for t in timings]}
        kw.update(generations=1, T=GOLDEN_DEVICE_T)
        js.run_search(ref.default_space(), ref_mixes(True), out_dir=Path(tmp) / "device",
                      trace_backend="device", **kw)
        _, cands, _ = js.split_records(js.read_trajectory(Path(tmp) / "device" /
                                                          "trajectory.jsonl"))
        out["device_gen1"] = {"T": GOLDEN_DEVICE_T, "candidates": [{k: c[k] for k in ("label", "sample",
                                                                "objective", "per_mix")}
                                             for c in cands]}
    return out


if __name__ == "__main__":
    # python tests/test_torch_search.py: rewrite the golden file from JAX
    GOLDEN.write_text(json.dumps(golden_from_jax(), indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
