"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and limits, each metric's cells against the end-to-end metric it moves,
and every file the harness finds by a name."""
import importlib
import json
import re

import pytest

from h100bench.harness import HERE
from h100bench.tests.small import ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = {w["name"]: w for w in M["workloads"]}
E2E = {m["name"]: m for m in M["end_to_end"]}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = M["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in M["paths"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_unique_and_well_formed(group):
    names = [e["name"] for e in M[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        # the reference beside the configuration, and its program entries
        importlib.import_module(f"h100bench.reference.{cfg['reference']}")
        assert cfg["source"] == c["source"]


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (HERE / "workloads" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()


def _metric_cells(m):
    return m.get("workloads", list(CELLS))


def test_end_to_end_metrics():
    assert 1 <= len(M["end_to_end"]) <= 16
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(_metric_cells(m)) <= set(CELLS)
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_metrics_move_what_their_cells_report():
    assert 1 <= len(M["per_layer"]) <= 128
    layers = {}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in E2E
        assert "workloads" in m
        # every cell the metric lists reports the metric it moves
        assert set(m["workloads"]) <= set(_metric_cells(E2E[m["moves"]]))
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in M["end_to_end"] if cell in _metric_cells(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m["workloads"] for m in M["per_layer"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_limits_lie_between_their_readings(cell):
    """Each limit of `correct` is above the program's largest reading and
    below the smallest upper reading, where those are recorded."""
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    assert limits
    for name, v in limits.items():
        assert NAME.match(name) and v["limit"] > 0
        if "lower" in v:
            assert v["lower"] < v["limit"]
        if "upper" in v:
            assert v["limit"] < v["upper"]


def test_files_under_paths_are_named_from_name_characters():
    for p in M["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert PATH.match(rel), rel


def test_bounds_are_not_under_one_percent():
    assert min(m["bound"] for m in M["end_to_end"]) >= 0.01
