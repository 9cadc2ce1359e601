"""BENCHMARK.json against the benchmark's contract, and every file it
names found where the harness looks for it."""
from __future__ import annotations

import json
import re

import pytest

from bench_helpers import ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    assert (ROOT / M["command"][1]).is_file()


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_unique_and_well_formed(key):
    names = [e["name"] for e in M[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(k in body["assumed"] for k in c["reduced"])


def test_workloads_find_their_files():
    cfgs = {c["name"] for c in M["configs"]}
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((ROOT / "benchmark" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "loops"
                / f"{traffic['loop']}.py").is_file()
        limits = json.loads((ROOT / "benchmark" / "limits"
                             / f"{w['name']}.json").read_text())
        assert limits["limits"]
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(
        1, len(M["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"] for m in M["end_to_end"]}
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in e2e
    for m in M["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        got = [m for m in M["end_to_end"]
               if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert any(w in m.get("workloads", cells) for m in M["per_layer"])


def test_per_layer_metrics_report_in_cells_of_their_end_to_end_metric():
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]


def test_size():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
