"""``repro_torch.analysis`` against ``repro.analysis``.

* on every file of the reference's fixture corpus
  (``tests/fixtures/analysis/*.py``, read only) the port's analyzer gives
  the reference's findings one for one: check, line, column and symbol;
* the port's registry, introspected from its own ``FamParams`` /
  ``FamConfig`` / ``PolicySet``, has the reference's field sets, overlap
  and compile tags, and no class finding;
* each torch-specific rule fires on a torch snippet (with the corpus's
  scope markers), and a clean torch snippet gives nothing;
* the port's real tree under the packaged allowlist and ``--strict``
  reports nothing (the CLI's exit code, in a subprocess too);
* the allowlist, its TOML subset and the CLI surface, ported from
  ``tests/test_analysis.py``;
* the runtime half: the ``CompileWatcher`` counts the captures reported
  under the group runners' name prefix, per name; the sync guard and the
  explicit fetch are no-ops without CUDA (the executor's capture count
  under ``assert_compiles`` is held in ``test_torch_experiments.py``).
"""
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import build_registry as j_build_registry
from repro.analysis.checks import analyze_source as j_analyze_source
from repro_torch.analysis import build_registry, load_allowlist, main, run_analysis
from repro_torch.analysis import runtime
from repro_torch.analysis.annotations import host_metric
from repro_torch.analysis.checks import analyze_source
from repro_torch.analysis.findings import (CHECKS, AllowEntry, Allowlist, Finding,
                                           _parse_toml_subset)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
PORT = REPO / "src" / "repro_torch"
CORPUS = sorted(p.name for p in FIXTURES.glob("*.py"))

FIXTURE_EXPECTED = {
    "ck101_traced_key.py": "CK101",
    "ck102_unhashable_tag.py": "CK102",
    "ck103_nonfrozen.py": "CK103",
    "tc201_traced_branch.py": "TC201",
    "tc202_bool_assert.py": "TC202",
    "hs301_host_sync.py": "HS301",
    "hs302_transfer.py": "HS302",
    "dt401_wallclock.py": "DT401",
    "dt402_unseeded.py": "DT402",
    "dt403_set_iter.py": "DT403",
}


@pytest.fixture(scope="module")
def registries():
    reg, findings = build_registry()
    assert findings == []
    return reg, j_build_registry()[0]


def _key(findings):
    return [(f.check, f.line, f.col, f.symbol) for f in findings]


# ---------------------------------------------------------------------------
# the reference's corpus: the same findings, one for one
# ---------------------------------------------------------------------------

def test_corpus_covers_every_check():
    assert set(FIXTURE_EXPECTED.values()) == set(CHECKS)
    assert set(FIXTURE_EXPECTED) | {"clean_jit.py"} == set(CORPUS)


@pytest.mark.parametrize("fname", CORPUS)
def test_findings_equal_reference_on_corpus(fname, registries):
    reg, j_reg = registries
    path = FIXTURES / fname
    src = path.read_text()
    want = _key(j_analyze_source(src, str(path), j_reg))
    got = analyze_source(src, str(path), reg)
    assert _key(got) == want
    assert {f.check for f in got} == ({FIXTURE_EXPECTED[fname]} if fname in FIXTURE_EXPECTED
                                      else set())
    for f in got:
        assert f.line > 0 and f.symbol != "" and f.message


def test_registry_equals_reference(registries):
    reg, j_reg = registries
    assert reg.traced_param_fields == j_reg.traced_param_fields
    assert reg.static_config_fields == j_reg.static_config_fields
    assert reg.static_policy_fields == j_reg.static_policy_fields
    assert reg.overlap_fields == j_reg.overlap_fields
    assert reg.compile_tags == j_reg.compile_tags
    assert {"num_sets", "cache_ways", "block_bits", "policy"} <= reg.traced_param_fields
    assert {"block_bytes", "cache_ways"} <= reg.overlap_fields


def test_syntax_error_becomes_a_finding(registries):
    (f,) = analyze_source("def broken(:\n", "bad.py", registries[0])
    assert f.check == "CK102" and "syntax error" in f.message


# ---------------------------------------------------------------------------
# torch's spellings of the hazards
# ---------------------------------------------------------------------------

JIT = "# analysis-scope: jit\nimport torch\n\n\n"
DET = "# analysis-scope: deterministic\nimport torch\n\n\n"
TORCH_CASES = {
    "cpu": (JIT + "def step(p, x):\n    return x.cpu()\n", {"HS302"}),
    "numpy": (JIT + "def step(p, x):\n    return (x + 1).numpy()\n", {"HS302"}),
    "to_cpu": (JIT + 'def step(p, x):\n    return x.to("cpu")\n', {"HS302"}),
    "to_cpu_device": (JIT + 'def step(p, x):\n    return x.to(device=torch.device("cpu"))\n',
                      {"HS302"}),
    "torch_nonzero": (JIT + "def step(p, x):\n    return torch.nonzero(x > 0)\n", {"HS302"}),
    "nonzero_method": (JIT + "def step(p, x):\n    return x.nonzero()\n", {"HS302"}),
    "where_one_arg": (JIT + "def step(p, x):\n    return torch.where(x > 0)\n", {"HS302"}),
    "mask_index": (JIT + "def step(p, x):\n    return x[x > 0]\n", {"HS302"}),
    "mask_name_index": (JIT + "def step(p, x):\n    m = (x > 0) & (x < 9)\n"
                        "    return x[~m]\n", {"HS302"}),
    "mask_store": (JIT + "def step(p, x, y):\n    x[x > p] = y\n    return x\n", {"HS302"}),
    "cuda_synchronize": (JIT + "def step(p, x):\n    torch.cuda.synchronize()\n"
                         "    return x\n", {"HS302"}),
    "stream_synchronize": (JIT + "def step(p, x):\n"
                           "    torch.cuda.current_stream().synchronize()\n"
                           "    return x\n", {"HS302"}),
    "item": (JIT + "def step(p, x):\n    return x.sum().item()\n", {"HS301"}),
    "torch_assert": (JIT + "def step(p, x):\n    torch._assert(x.all(), 'bad')\n"
                     "    return x\n", {"TC202"}),
    "assert": (JIT + "def step(p, x):\n    assert (x > 0).all()\n    return x\n", {"TC202"}),
    "if_any": (JIT + "def step(p, x):\n    if x.any():\n        x = x + 1\n    return x\n",
               {"TC201"}),
    "manual_seed": (DET + "def make(seed):\n    torch.manual_seed(seed)\n", {"DT402"}),
    "cuda_manual_seed": (DET + "def make(seed):\n    torch.cuda.manual_seed_all(seed)\n",
                         {"DT402"}),
    "randint_global": (DET + "def make(n):\n    return torch.randint(0, 9, (n,))\n",
                       {"DT402"}),
    "randperm_global": (DET + "def make(n):\n    return torch.randperm(n)\n", {"DT402"}),
    "rand_like": (DET + "def make(x):\n    return torch.rand_like(x)\n", {"DT402"}),
    "multinomial_global": (DET + "def make(w):\n    return torch.multinomial(w, 4)\n",
                           {"DT402"}),
    "inplace_sampler": (DET + "def make(x):\n    return x.uniform_()\n", {"DT402"}),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_rule_fires(case, registries):
    src, want = TORCH_CASES[case]
    got = analyze_source(src, f"{case}.py", registries[0])
    assert {f.check for f in got} == want, [f.format() for f in got]
    assert len(got) == 1, [f.format() for f in got]


CLEAN = '''# analysis-scope: jit
# analysis-scope: deterministic
import torch


def step(cfg, p, x, gen: torch.Generator, device):
    n = x.size(0)                        # size() / dim() / numel(): static
    if x.dim() > 1 and x.numel() > n:
        x = x.flatten()
    mask = (x > p.threshold) & (x < 9)
    y = torch.where(mask, x, 0)          # a mask in torch.where: no sync
    y = y.masked_fill(~mask, 1)
    x[mask] = 0                          # a constant stores by masked_fill_
    if x.device.type == "cuda" and x.is_cuda:
        y = y + 1
    z = torch.randint(0, 9, (n,), generator=gen, device=device)
    w = torch.rand((n,), generator=gen).uniform_(generator=gen)
    return y, z, w, x.to(torch.float32), x.to(device)
'''


def test_clean_torch_snippet_has_zero_findings(registries):
    got = analyze_source(CLEAN, "clean_torch.py", registries[0])
    assert got == [], [f.format() for f in got]


def test_host_metric_decorator_excludes_function(registries):
    src = ('# analysis-scope: jit\n'
           'from repro_torch.analysis.annotations import host_metric\n\n'
           '@host_metric\n'
           'def summarize(x):\n'
           '    s = float(x.mean())\n'
           '    y = x.cpu()\n'
           '    return s, y\n')
    assert analyze_source(src, "fx.py", registries[0]) == []
    bad = src.replace("@host_metric\n", "")
    assert {f.check for f in analyze_source(bad, "fx.py", registries[0])} == {"HS301", "HS302"}


def test_host_metric_is_an_identity_decorator():
    def f():
        return 3
    assert host_metric(f) is f and f.__host_metric__ is True


def test_scope_table_names_port_functions():
    """Every name the jit scope table includes or excludes is a top-level
    function or class of the port's file it keys (the table cannot rot)."""
    import ast

    from repro_torch.analysis.scopes import DT_SCOPE_SUFFIXES, JIT_SCOPE
    for suffix, scope in JIT_SCOPE.items():
        path = REPO / "src" / suffix
        tree = ast.parse(path.read_text())
        names = {n.name for n in tree.body
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        methods = {m.name for n in tree.body if isinstance(n, ast.ClassDef)
                   for m in n.body if isinstance(m, ast.FunctionDef)}
        listed = (scope.include or frozenset()) | scope.exclude
        assert listed <= names | methods, (suffix, listed - names - methods)
    for suffix in DT_SCOPE_SUFFIXES:
        assert (REPO / "src" / suffix).exists(), suffix


def test_captured_step_is_in_scope(registries):
    """An ``.item()`` put into the step closure that the runner captures is
    reported where it is: the scope covers the captured step."""
    path = PORT / "core" / "famsim.py"
    src = path.read_text()
    anchor = "    def step(p, carry, inputs):\n"
    assert src.count(anchor) == 1
    bad = src.replace(anchor, anchor + "        carry[1].sum().item()\n")
    got = analyze_source(bad, str(path), registries[0])
    assert [(f.check, f.symbol) for f in got if f.check.startswith("HS")] == \
        [("HS301", "_make_step.step")]


# ---------------------------------------------------------------------------
# the real tree is clean — the gate's exact invocation
# ---------------------------------------------------------------------------

def test_real_tree_clean_under_packaged_allowlist():
    out = io.StringIO()
    code = run_analysis([str(PORT)], strict=True, out=out)
    assert code == 0, out.getvalue()
    assert ", 0 reported [strict]" in out.getvalue()


def test_cli_strict_exits_zero_on_the_port():
    """``python -m repro_torch.analysis --strict`` (default paths: the
    port's tree) from the repo root."""
    done = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--strict"],
                          cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert done.returncode == 0, done.stdout + done.stderr
    assert "0 reported [strict]" in done.stdout


# ---------------------------------------------------------------------------
# allowlist: parser, matching, strict hygiene
# ---------------------------------------------------------------------------

def test_toml_subset_parser_roundtrip():
    text = ('# header comment\n\n'
            '[[allow]]\n'
            'check = "DT401"\n'
            'path = "repro_torch/benchmarks/run.py"  # trailing comment\n'
            'symbol = "main"\n'
            'reason = "wall-clock \\"ok\\" here"\n')
    assert _parse_toml_subset(text) == [{
        "check": "DT401", "path": "repro_torch/benchmarks/run.py",
        "symbol": "main", "reason": 'wall-clock "ok" here'}]


@pytest.mark.parametrize("bad", [
    '[allow]\n',                        # not an array-of-tables header
    'check = "DT401"\n',                # key/value outside a table
    '[[deny]]\n',                       # unknown table name
    '[[allow]]\ncheck = [1, 2]\n',      # non-string value
])
def test_toml_subset_parser_rejects(bad):
    with pytest.raises(ValueError):
        _parse_toml_subset(bad)


def test_allowlist_matching_and_hygiene():
    used = AllowEntry("DT401", "benchmarks/run.py", "main", "timing print")
    stale = AllowEntry("DT401", "benchmarks/gone.py", "f", "obsolete")
    bare = AllowEntry("TC201", "x.py", "g", "")
    al = Allowlist(entries=[used, stale, bare])
    f = Finding(check="DT401", path="src/repro_torch/benchmarks/run.py", line=9, col=4,
                symbol="main", message="m")
    other = Finding(check="TC201", path="src/repro_torch/benchmarks/run.py", line=9, col=4,
                    symbol="main", message="m")
    assert al.allows(f)
    assert not al.allows(other)
    assert stale in al.stale_entries() and used not in al.stale_entries()
    assert al.unjustified_entries() == [bare]


def test_packaged_allowlist_loads_and_is_justified():
    al = load_allowlist()
    assert al.entries
    for e in al.entries:
        assert e.check in CHECKS and e.reason.strip() and e.path.startswith("repro_torch/"), e


def test_strict_refuses_stale_and_unjustified_entries(tmp_path):
    out = io.StringIO()
    al = Allowlist(entries=[AllowEntry("DT401", "repro_torch/gone.py", "f", "")])
    assert run_analysis([str(FIXTURES / "clean_jit.py")], strict=True, allowlist=al,
                        out=out) == 1
    assert "no reason=" in out.getvalue() and "stale entry" in out.getvalue()


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------

def test_cli_list_checks(capsys):
    assert main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    for cid in CHECKS:
        assert cid in out


def test_cli_reports_bad_file_and_fails():
    out = io.StringIO()
    code = run_analysis([str(FIXTURES / "tc201_traced_branch.py")],
                        allowlist=Allowlist(), out=out)
    assert code == 1
    assert "TC201" in out.getvalue() and "hint:" in out.getvalue()


def test_benchmark_cli_check_runs_the_gate(capsys):
    """``repro_torch.benchmarks.run --check --plan``: the gate first (clean
    on the port's tree), then the plan; nothing runs."""
    from repro_torch.benchmarks import run as run_cli
    run_cli.main(["--check", "--plan", "fig14"])
    captured = capsys.readouterr()
    assert "0 reported [strict]" in captured.out
    assert "repro_torch.analysis: clean" in captured.err


# ---------------------------------------------------------------------------
# runtime half
# ---------------------------------------------------------------------------

def test_compile_watcher_counts_group_captures_by_name():
    with runtime.CompileWatcher() as w:
        runtime.report_capture("famsim_group__0123abcd")
        runtime.report_capture("famsim_group__0123abcd")
        runtime.report_capture("famsim_group__ffff0000")
        runtime.report_capture("other_graph")           # not a group runner
        runtime.report_capture("famsim_grouped")        # not the prefix
        runtime.report_capture(None)                    # a runner that reports nothing
        with runtime.CompileWatcher("famsim_group__ffff0000") as inner:
            runtime.report_capture("famsim_group__ffff0000")
    runtime.report_capture("famsim_group__0123abcd")    # after the window
    assert w.count == 4 and inner.count == 1
    assert w.by_name == {"famsim_group__0123abcd": 2, "famsim_group__ffff0000": 2}
    assert runtime._ACTIVE == []


def test_guard_and_fetch_are_no_ops_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py holds the guard there")
    x = torch.ones(3)
    with runtime.no_implicit_transfers():
        assert x.sum().item() == 3.0 and x.nonzero().shape == (3, 1)
        with runtime.explicit_fetch():
            assert x.cpu().numpy().sum() == 3.0


def test_runner_reports_its_capture_name():
    """The executor names each group's runner by its key digest, and the
    runner keeps the name it reports its capture under."""
    from repro_torch.configs.base import FamConfig
    from repro_torch.core import famsim
    from repro_torch.experiments import executor
    key = ("shape", 1)
    name = executor._runner_name(key)
    assert name == f"famsim_group__{executor._key_digest(key)}"
    assert famsim.GroupRunner(FamConfig(), 1, name=name).name == name
    assert famsim.GroupRunner(FamConfig(), 1).name == runtime.GROUP_RUNNER_NAME
