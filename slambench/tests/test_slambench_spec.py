"""BENCHMARK.json and the files it names: every cell's configuration,
mix, metric readers and limits resolve by name, and every name, unit and
entry keeps to the benchmark's contract."""
import json
import re

import pytest

from slambench import harness

BM = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BM["workloads"]]


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"}
    assert BM["paths"] == ["slambench"] and BM["command"] == ["python3", "slambench/run.py"]
    assert 1 <= BM["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c, cfg, mix, per_layer = harness.cell_spec(cell)
    assert c["chips"] == 1 and len(c["why"]) <= 200
    harness.slam_config(cfg)
    assert mix["entry"] in ("sync", "pipelined")
    assert (harness.HERE / "limits" / f"{cell}.json").exists()
    for m in per_layer:
        assert callable(harness.load_metric(m["name"]))
    reported = {e["name"] for e in BM["end_to_end"] if cell in e.get("workloads", [cell])}
    assert {"setup_s", "frames_per_s"} <= reported and per_layer


def test_names_units_and_entries():
    names = []
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("slambench/") and (harness.ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["source"]) <= 200
        names.append(c["name"])
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and NAME.match(w["traffic"])
    layers = set()
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "bound" in m:
            assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
            assert m["moves"] == "frames_per_s" and set(m["workloads"]) <= set(CELLS)
            layers.add(m["layer"])
    all_names = [m["name"] for m in BM["end_to_end"] + BM["per_layer"]] + CELLS + names
    assert len(all_names) == len(set(all_names)) and all(NAME.match(n) for n in all_names)
    assert len(json.dumps(BM)) < 64 * 1024
