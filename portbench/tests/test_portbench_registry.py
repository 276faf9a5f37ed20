"""``BENCHMARK.json`` against the benchmark's contract, and the registry:
every name in it finds its file, and a cell is added with files and
entries alone (shown with the prepared ``semantic_m.decode.b32x250``)."""

import copy
import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_sizes(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(".." not in p and not p.startswith("/") for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert bench["command"][1].startswith(bench["paths"][0] + "/")
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert len(json.dumps(bench)) <= 64 * 1024
    # the full check of 24 cells fits the driver's day
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (harness.ROOT.parent / c["file"]).exists() and len(c["reduced"]) <= 16
    cfgs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        harness.load_json("traffic", w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(pairs) // 4)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(set(names)) == len(names)
    assert all(any(w["config"] == c for w in bench["workloads"]) for c in cfgs)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moved)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert harness.load_module("metrics", m["name"], fallback=True) is not None
    for cell in cells:
        mine = harness.resolve_cell(bench, cell)["metrics"]
        kinds = [m["name"] for m in mine if m in bench["end_to_end"]]
        assert "setup_s" in kinds and len(kinds) >= 2
        assert any(m in bench["per_layer"] for m in mine)


def test_layers_are_perf_md_s(bench):
    """Each ``layer`` is one of PERF.md's list of layers, letter for letter."""
    perf = (harness.ROOT.parent / "PERF.md").read_text()
    section = perf.split("## 3. Layers", 1)[1].split("\n## ", 1)[0]
    for m in bench["per_layer"]:
        assert f"| {m['layer']} |" in section, m["layer"]


def test_registry_finds_each_file_by_name(bench):
    for w in bench["workloads"]:
        mix = harness.load_json("traffic", w["traffic"])
        for kind in ("reference", "models", "counts"):
            assert harness.load_module(kind, w["config"]) is not None
        assert harness.load_module("paths", mix["path"]) is not None
        assert harness.load_module("generators", mix["generator"]) is not None
        assert w["config"] in harness.load_json("configs", w["config"])["name"]
    assert harness.load_module("metrics", "device_idle_pct.encode", fallback=True).__name__ \
        == "portbench.metrics.device_idle_pct"
    assert harness.load_module("metrics", "no_such_metric", fallback=True) is None
    with pytest.raises(harness.CellError):
        harness.load_json("traffic", "no_such_mix")


def test_a_prepared_cell_is_added_by_entries_alone(bench):
    """The prepared cell runs from its files while it is unlisted, and once
    its workload entry and its names in the metrics' lists are added, the
    listed cell reports what the prepared one did, from the same files."""
    name = "semantic_m.decode.b32x250"
    prepared = harness.load_json("prepared", name)
    assert prepared["workload"]["name"] == name
    assert all(w["name"] != name for w in bench["workloads"])
    unlisted = harness.resolve_cell(bench, name)
    listed_bench = copy.deepcopy(bench)
    listed_bench["workloads"].append(prepared["workload"])
    for m in listed_bench["end_to_end"] + listed_bench["per_layer"]:
        if m["name"] in prepared["end_to_end"] + prepared["per_layer"] and "workloads" in m:
            m["workloads"].append(name)
    listed = harness.resolve_cell(listed_bench, name)
    assert listed["entry"] == unlisted["entry"]
    assert [m["name"] for m in listed["metrics"]] == [m["name"] for m in unlisted["metrics"]]
    assert {m["name"] for m in listed["metrics"]} == set(prepared["end_to_end"] + prepared["per_layer"])
