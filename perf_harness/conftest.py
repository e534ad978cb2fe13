"""Test support: the cells of BENCHMARK.json, and the cells whose files
the harness keeps for later, cut to a size the CPU runs in seconds (a few
systems, short traces), for the harness's own tests. A test that takes
``cell_name`` runs once for each of them."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: cells whose files are kept but that BENCHMARK.json does not run yet
#: (PERF.md, Open questions): their configuration and traffic
PREPARED = {"fam-4node-pooled.fig14-mixes": ("fam-4node-pooled", "fig14-mixes")}


def load(cell_name: str):
    from perf_harness.lib import manifest
    if cell_name not in PREPARED:
        return manifest.load_cell(cell_name)
    config, traffic = PREPARED[cell_name]
    return manifest.assemble(cell_name, 1, manifest.HARNESS / "configs" / f"{config}.json",
                             traffic, manifest.load_manifest())


def small(cell_name: str, T: int = 200):
    """``cell_name`` with two values of its first axis (the largest blocks
    or the first two mixes), two workloads where it sweeps them, and every
    flag variant, at ``T`` events; every system is checked."""
    from perf_harness.lib import check
    cell = copy.deepcopy(load(cell_name))
    cell.traffic["T"] = T
    for ax in cell.traffic["axes"]:
        if ax["axis"] == "config":
            ax["values"] = ax["values"][-2:]
        elif ax["axis"] == "workload":
            ax["values"] = ["bfs", "canneal"]
        elif ax["axis"] == "mix":
            ax["values"] = dict(list(ax["values"].items())[:2])
    n = len(check.resolve(cell.config, cell.traffic))
    cell.spec.update(lanes=n * cell.config["num_nodes"], T=T, systems=n, profile_T=100)
    cell.spec["check"]["systems"] = n
    return cell


def pytest_generate_tests(metafunc):
    if "cell_name" in metafunc.fixturenames:
        from perf_harness.lib import manifest
        names = [w["name"] for w in manifest.load_manifest()["workloads"]]
        metafunc.parametrize("cell_name", names + list(PREPARED))


@pytest.fixture
def cells():
    """The loader of a cell by name, prepared cells included."""
    return load


@pytest.fixture
def small_cell():
    from repro_torch.experiments import executor
    executor._clear_exec_cache()
    yield small
    executor._clear_exec_cache()
