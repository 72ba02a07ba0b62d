"""BENCHMARK.json against the contract's shape, and every name it uses
found as a file."""
import json
import re

import pytest

from ._small import BENCH, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry["name"]


@pytest.mark.parametrize("group,name", list(_all_names()))
def test_names(group, name):
    assert NAME.match(name), name


def test_names_unique():
    names = [n for _, n in _all_names()]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert "\n" not in metric["layer"] and "\t" not in metric["layer"]
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert (ROOT / "h100bench" / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    moved = next(m for m in BENCH["end_to_end"]
                 if m["name"] == metric["moves"])
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        assert cell in [w["name"] for w in BENCH["workloads"]]
        assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    spec = manifest.cell_spec(BENCH, cell["name"])
    assert spec["config"]["name"] == cell["config"]
    assert spec["traffic"]["name"] == cell["traffic"]
    assert set(spec["limits"]["limits"]) == {
        "loss_gap", "grad_gap", "change_gap", "grad_entry_gap"}
    manifest.driver(spec["config"]["driver"])
    reported = {m["name"] for m in manifest.metrics_for(BENCH, cell["name"],
                                                        False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert manifest.metrics_for(BENCH, cell["name"], True)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("h100bench/")
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert config["reduced"] == []
    assert body["precision"] == "float32" and body["tf32"] is False
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_every_file_name_is_a_name():
    for path in (ROOT / "h100bench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        for part in path.relative_to(ROOT).parts:
            assert NAME.match(part), path
