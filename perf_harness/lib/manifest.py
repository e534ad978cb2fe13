"""``BENCHMARK.json`` and the files it names.

A cell of ``workloads`` names a configuration (``configs/<name>.json``:
the simulated system as it is run), a traffic mix (``traffic/<name>.json``:
the sweep's axes and trace length) and has a file of its own
(``workloads/<cell>.json``: why it exists, its lanes and T, and how its
outputs are checked). A metric is read by ``metrics/<name>.py``. Every file
is found by name, so a cell or a metric is added by adding files and
entries, never by editing one that is there.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

HARNESS = Path(__file__).resolve().parent.parent
ROOT = HARNESS.parent


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    spec: Dict                                 # workloads/<cell>.json
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)

    def metrics(self, trace: bool) -> List[Dict]:
        return self.per_layer if trace else self.end_to_end


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> Dict:
    return _read(root / "BENCHMARK.json")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and cell files and
    the metrics it reports; raises KeyError for an unknown cell."""
    manifest = load_manifest(root)
    entry = {w["name"]: w for w in manifest["workloads"]}[name]
    config = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    return assemble(name, entry["chips"], root / config["file"], entry["traffic"], manifest)


def assemble(name: str, chips: int, config_file: Path, traffic: str, manifest: Dict) -> Cell:
    """The cell ``name`` from its configuration file, its traffic's name and
    the manifest's metrics that it reports."""
    return Cell(
        name=name, chips=chips, config=_read(config_file),
        traffic=_read(HARNESS / "traffic" / f"{traffic}.json"),
        spec=_read(HARNESS / "workloads" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])


def metric_path(name: str) -> Path:
    return HARNESS / "metrics" / f"{name}.py"
