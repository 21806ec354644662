"""Fixtures of the benchmark's tests: a copy of the benchmark in a
temporary root to which a test adds cells as new files only."""
import json
import shutil
from pathlib import Path

import pytest
import torch

HOME = Path(__file__).resolve().parent.parent
REPO = HOME.parent


class TinyBench:
    """The repo's BENCHMARK.json and gpbench/ copied under `root`; `add`
    writes a new configuration, traffic mix and limits file for a cell
    derived from one of the repo's, and registers the cell with every
    metric of that cell."""

    def __init__(self, root: Path):
        self.root = root
        shutil.copytree(HOME, root / "gpbench",
                        ignore=shutil.ignore_patterns("tests", "__pycache__"))
        self.spec = json.loads((REPO / "BENCHMARK.json").read_text())
        self.write()

    def write(self):
        (self.root / "BENCHMARK.json").write_text(json.dumps(self.spec))

    def add(self, base: str, name: str, config: dict, traffic: dict,
            limits: dict | None = None):
        home = self.root / "gpbench"
        cell = next(w for w in self.spec["workloads"] if w["name"] == base)
        cfg = json.loads((home / "configs" / f"{cell['config']}.json").read_text())
        cfg.update(config, name=f"{name}_cfg")
        tr = json.loads((home / "traffic" / f"{cell['traffic']}.json").read_text())
        tr.update(traffic)
        (home / "configs" / f"{name}_cfg.json").write_text(json.dumps(cfg))
        (home / "traffic" / f"{name}_mix.json").write_text(json.dumps(tr))
        lim = limits if limits is not None else json.loads(
            (home / "limits" / f"{base}.json").read_text())
        (home / "limits" / f"{name}.json").write_text(json.dumps(lim))
        self.spec["configs"].append({
            "name": f"{name}_cfg", "source": "test", "reduced": sorted(config),
            "file": f"gpbench/configs/{name}_cfg.json", "why": "a test size"})
        self.spec["workloads"].append({
            "name": name, "config": f"{name}_cfg", "traffic": f"{name}_mix",
            "chips": cell["chips"], "why": "a test size"})
        for metric in self.spec["end_to_end"] + self.spec["per_layer"]:
            if base in metric.get("workloads", []):
                metric["workloads"].append(name)
        self.write()


@pytest.fixture
def tiny(tmp_path):
    torch.set_num_threads(2)
    return TinyBench(tmp_path)
