"""BENCHMARK.json against the rules it keeps (names, units, bounds, cells,
the run length's budget), and every name in it against the files that the
harness finds by that name."""

import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == [BENCH.name] and SPEC["command"] == ["python3", "bench_port/run.py"]
    assert all(one_line(word) for word in SPEC["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert one_line(entry["why"]), entry["name"]
    for c in SPEC["configs"]:
        assert one_line(c["source"]) and c["reduced"] == []
    for m in SPEC["per_layer"]:
        assert one_line(m["layer"])


def test_end_to_end_bounds():
    by_name = {m["name"]: m for m in SPEC["end_to_end"]}
    assert by_name["setup_s"]["bound"] == 0.25 and "workloads" not in by_name["setup_s"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = [m for m in SPEC["per_layer"] if w["name"] in m["workloads"]]
        assert layer, w["name"]
        for m in layer:  # each per-layer metric's cells report what it moves
            assert m["moves"] in e2e, (m["name"], w["name"])


def test_cells_chips_and_budget():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_name_has_its_files(w):
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    (conf,) = [c for c in SPEC["configs"] if c["name"] == w["config"]]
    assert conf["file"].startswith(BENCH.name + "/") and (ROOT / conf["file"]).is_file()
    assert json.loads((ROOT / conf["file"]).read_text())["name"] == w["config"]


def test_every_metric_has_its_reader_and_every_config_a_cell():
    for m in METRICS:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
