"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import pathlib
import re

import pytest

from benchmark import metrics, runners

ROOT = pathlib.Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def one_line(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


def test_shape_and_names():
    assert set(M) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in M["paths"])
    assert len(M["command"]) <= 32 and all(one_line(w) for w in M["command"])
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer") for x in M[part]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    for c in M["configs"]:
        assert set(c) == KEYS["config"] and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
        assert c["file"].startswith(M["paths"][0] + "/") and (ROOT / c["file"]).is_file()
    for w in M["workloads"]:
        assert set(w) == KEYS["workload"] and one_line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"]) and w["config"] in {c["name"] for c in M["configs"]}
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"] and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"] and UNIT.fullmatch(m["unit"]) and one_line(m["layer"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def reported(cell):
    return {m["name"] for m in M["end_to_end"] if "workloads" not in m or cell in m["workloads"]}


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in M["workloads"]}
    assert {m["name"] for m in M["end_to_end"]} >= {"setup_s"}
    for w in cells:
        e2e = reported(w)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w in m.get("workloads", cells) for m in M["per_layer"])
    for m in M["per_layer"]:
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}
        for w in m.get("workloads", cells):
            assert w in cells and m["moves"] in reported(w)
    for m in M["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("part", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(part):
    for m in M[part]:
        assert callable(metrics.reader(m["name"]))


def test_every_mix_has_a_file_a_runner_and_a_layer_name_each():
    for w in M["workloads"]:
        mix = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        runner = runners.load(mix["runner"])
        assert callable(runner.prepare) and callable(runner.check)
    perf = (ROOT / "PERF.md").read_text()
    for m in M["per_layer"]:
        assert m["layer"] in perf


def test_the_run_fits_the_check():
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
