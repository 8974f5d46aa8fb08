"""The result line's schema, and the run's refusal without a card."""

import json

from nfbench import run as run_cli
from nfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_untraced_line(run_tiny):
    result, lines = run_tiny("transition-train")
    assert list(result)[:3] == ["correct", "attempted", "failed"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"setup_s", "step_ms"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
        assert any(line.startswith(f"check {name}:") for line in lines)
    json.dumps(result)


def test_traced_line(run_tiny):
    result, _ = run_tiny("eval-frame", trace=True)
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in result["metrics"]:
        assert any(p["name"] == m for p in BENCH["per_layer"])
    assert list(result)[-1] == "checks"


def test_every_cell_reports_what_the_contract_asks():
    for cell in BENCH["workloads"]:
        def listed(group):
            return [m["name"] for m in BENCH[group]
                    if cell["name"] in m.get("workloads", [cell["name"]])]
        e2e = listed("end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = [m for m in BENCH["per_layer"]
                     if cell["name"] in m.get("workloads", [cell["name"]])]
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e


def test_no_card_no_result(capsys):
    assert run_cli.main(["--workload", "transition-train", "--seed", "1",
                         "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
