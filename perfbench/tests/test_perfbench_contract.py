"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file."""

import json
import re
from pathlib import Path

import pytest

from perfbench.common import CHECKOUT, ROOT, load_cell

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 2 x 90 s of compiling a cell and 1200 s spare, in 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [c["name"] for c in BENCH["configs"]]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "metrics" / f"{metric['name']}.py").is_file()
    keys = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert set(metric) <= keys | {"bound"}
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert set(metric) <= keys | {"layer", "moves"}


def reports(cell: str, metric: str) -> bool:
    m = next(m for m in BENCH["end_to_end"] if m["name"] == metric)
    return cell in m.get("workloads", [cell])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    cells = {w["name"] for w in BENCH["workloads"]}
    assert metric["workloads"] and set(metric["workloads"]) <= cells
    assert all(reports(c, metric["moves"]) for c in metric["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_found_by_name(cell):
    loaded = load_cell(cell["name"])
    assert loaded["config"] == cell["config"]
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if reports(cell["name"], m["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_found_by_name(config):
    path = CHECKOUT / config["file"]
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert config["source"] == data["source"]
    assert Path(config["file"]).parts[0] in BENCH["paths"]
