"""Every piece of a cell is found by its name, and a piece added as a new
file (a configuration, a traffic mix with an entry of its own, limits, a
per-layer metric) with a new entry in BENCHMARK.json is picked up with no
edit."""

import json
import shutil

import pytest

from nfbench import harness
from nfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_each_cell_finds_its_parts(cell):
    parts = harness.load_parts(ROOT, cell)
    assert parts.config["name"] == parts.cell["config"]
    entry = harness.load_entry(ROOT, parts.traffic["entry"])
    assert callable(entry.run_unit) and callable(entry.numbers)
    assert parts.limits


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(harness.load_reader(ROOT, metric))


def test_config_files_are_the_ones_named():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_added_files_are_picked_up_without_an_edit(tmp_path, run_tiny):
    shutil.copytree(ROOT / "nfbench", tmp_path / "nfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp_path / "nfbench"
    config = json.loads((here / "configs/dlf-watercube-bf16.json").read_text())
    config["name"] = "dummy-config"
    (here / "configs/dummy-config.json").write_text(json.dumps(config))
    (here / "entries/dummy_entry.py").write_text(
        (here / "entries/transition_train.py").read_text()
        .replace("class Entry(", "class DummyEntry(") + "\nEntry = DummyEntry\n")
    traffic = json.loads((here / "traffic/transition-train.json").read_text())
    traffic.update(pool=3, entry="dummy_entry")
    (here / "traffic/dummy-mix.json").write_text(json.dumps(traffic))
    (here / "limits/dummy-cell.json").write_text(
        (here / "limits/transition-train.json").read_text())
    (here / "metrics/dummy_units.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    bench["configs"].append({"name": "dummy-config", "source": "a test",
                             "file": "nfbench/configs/dummy-config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_units", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "step_ms",
                               "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert harness.load_entry(tmp_path, "dummy_entry").__name__ == \
        "DummyEntry"
    result, _ = run_tiny("dummy-cell", trace=True, root=tmp_path)
    assert result["metrics"]["dummy_units"]["value"] >= 1
    assert "step_mfu" not in result["metrics"]  # its list names other cells
    assert result["correct"]
