"""BENCHMARK.json and the files it names: every name resolves, and the
manifest keeps to the benchmark's contract."""
import json
import re

import pytest

from perf_harness.lib import check, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = manifest.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perf_harness"]
    assert MANIFEST["command"] == ["python3", "perf_harness/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MANIFEST[k]]
    assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_every_metric_has_its_reader_and_a_valid_entry():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert manifest.metric_path(m["name"]).exists(), m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = {x["name"]: x for x in MANIFEST["end_to_end"]}[m["moves"]]
        # every cell that reads the metric reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS)), m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = manifest.load_cell(cell)
    entry = {w["name"]: w for w in MANIFEST["workloads"]}[cell]
    config_entry = {x["name"]: x for x in MANIFEST["configs"]}[entry["config"]]
    assert c.config["name"] == entry["config"] and c.spec["name"] == cell
    assert len(entry["why"]) <= 200 and entry["chips"] in (1, 4)
    assert set(config_entry["reduced"]) == set(c.config["reduced"])
    systems = check.resolve(c.config, c.traffic)
    assert len(systems) == c.spec["systems"]
    assert len(systems) * c.config["num_nodes"] == c.spec["lanes"]
    assert c.traffic["T"] == c.spec["T"]
    assert c.spec["check"]["systems"] <= len(systems)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer


def test_config_files_hold_the_configuration_as_run():
    from perf_harness.lib.experiment import fam_fields
    for entry in MANIFEST["configs"]:
        c = json.loads((manifest.ROOT / entry["file"]).read_text())
        assert fam_fields(c)["kernel_backend"] == "cuda"
        assert c["source"] == entry["source"]
