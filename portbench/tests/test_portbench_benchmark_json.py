"""BENCHMARK.json keeps to the benchmark's contract, and every name it gives has its file."""

import json
import re

import pytest

from portbench.tests.common import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_and_limits():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(line(w) and not w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names), kind
        for e in BENCH[kind]:
            extra = set(e) - KEYS[kind]
            assert set(e) >= KEYS[kind] and extra <= ({"workloads"} if kind in ("end_to_end", "per_layer") else set())
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock") and line(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_name_has_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    used = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and line(w["why"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()
        used.add(w["config"])
    assert used == set(configs)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name'].split('.')[0]}.py").exists(), m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    def reports(m):
        return cell in m.get("workloads", [cell])

    e2e = {m["name"] for m in BENCH["end_to_end"] if reports(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if reports(m)]
    assert layer and all(m["moves"] in e2e for m in layer)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_bounds_and_layers_name_alike():
    """Metrics of one layer give it letter for letter; every cell's moved metric exists."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"entry", "towers", "quantizers", "LSTM", "resblock towers", "device", "whole call"}
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
