"""BENCHMARK.json is complete: every cell's configuration, generator,
traffic mix, driver and limits are files found by name, the configuration
and traffic with the tiny size and the faults the shared tests read; every
metric has a reader; and the names and units keep to the characters the
contract allows."""
from __future__ import annotations

import re

import pytest

from spmvbench import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["spmvbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(c["chips"] == 1 for c in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    assert (run.HERE / "drivers" / f"{traffic['driver']}.py").exists()
    assert (run.HERE / "limits" / f"{cell['name']}.json").exists()
    assert (run.HERE / "generators" / f"{cfg['generator']}.py").is_file()
    assert set(cfg["tiny"]["params"]) == set(cfg["params"])
    assert isinstance(traffic["tiny"], dict) and set(traffic["tiny"]) <= set(traffic)
    assert traffic["faults"]
    assert len(cell["why"]) <= 200 and NAME.match(cell["name"])
    reported = run.metrics_of(BENCH, cell["name"], False)
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert run.metrics_of(BENCH, cell["name"], True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(run.metric_reader(metric["name"]))
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock",
                                                                        "device_trace")
    else:
        ends = {m["name"]: m for m in BENCH["end_to_end"]}
        moved = ends[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", metric["workloads"]))


def test_configs_named_once():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
