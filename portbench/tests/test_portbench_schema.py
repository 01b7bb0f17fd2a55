"""BENCHMARK.json against the benchmark's contract, and every file it
names found where the harness looks for it."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")
METRIC_KEYS = {"name", "unit", "better", "source"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_one_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_check_time_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [x["name"] for x in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for x in BENCH[kind]:
        for k in TEXT_KEYS:
            if k in x:
                assert _one_line(x[k]), (x["name"], k)


def test_configs_files_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_cells():
    pairs = set()
    n4 = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        n4 += w["chips"] == 4
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = json.loads((ROOT / "portbench" / "cells" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        cfg = json.loads((ROOT / "portbench" / "configs" / f"{w['config']}.json").read_text())
        entry = cfg["entries"][cell["entry"]]
        assert (ROOT / "portbench" / "entries" / f"{entry}.py").exists()
        assert (ROOT / "portbench" / "images" / f"{cell['images']['kind']}.py").exists()
        assert set(cfg["limits"][cell["entry"]])
    assert n4 <= max(1, len(CELLS) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _cells_of(m):
    return m.get("workloads", CELLS)


def test_every_metric_lists_known_cells_and_moves_a_metric_they_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(_cells_of(m)) <= set(CELLS), m["name"]
    for m in BENCH["per_layer"]:
        assert "workloads" in m
        assert set(m["workloads"]) <= set(_cells_of(e2e[m["moves"]])), m["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if w in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w in _cells_of(m) for m in BENCH["per_layer"])


def test_layer_names_match_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"`{layer}`" in perf, layer


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or rel.startswith("portbench/.cache"):
            continue
        assert PATH.match(rel), rel
