"""Every cell's driver at a tiny size on the host, through the port's plain
PyTorch versions: a run is correct, reports the cell's metrics, and a
traced run reads the profiled stretch."""
from __future__ import annotations

import json
import math

import pytest
from conftest import CELLS, run_tiny

from spmvbench import run


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run(cell):
    line = run_tiny(cell)
    assert line["correct"] is True, line
    assert line["attempted"] > 0 and line["failed"] == 0, line
    want = {m["name"] for m in run.metrics_of(run.load_json(run.ROOT / "BENCHMARK.json"),
                                              cell, False)}
    assert set(line["metrics"]) == want and "setup_s" in want
    assert all(v["value"] > 0 for v in line["metrics"].values()), line["metrics"]
    assert list(line)[-1] == "checks"
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell):
    line = run_tiny(cell, trace=True)
    assert line["correct"] is True
    dev = line["device"]
    assert dev["window_s"] > 0 and dev["busy_s"] == 0.0   # no device on the host
    assert line["breakdown"]["idle_gaps"]
    # on the host no kernel runs: the kernel readers stay silent, never 0
    assert all(not k.startswith("spmv_roofline") for k in line["metrics"])


def test_same_seed_same_inputs():
    a = run_tiny("hmep.spmv", seed=77, check_all=True)
    b = run_tiny("hmep.spmv", seed=77, check_all=True)
    assert a["checks"] == b["checks"]


def test_served_arrivals_same_gaps_every_seed():
    from conftest import tiny

    from spmvbench.drivers import served

    t = tiny("hmep.served")
    sides = []
    for seed in (1, 2**40 + 3):
        b = run.Bench("hmep.served", t["config"], t["traffic"], seed, 1.0, False, "cpu")
        due, idx = served.arrivals(b, 5.0, 3)
        sides.append((due, idx))
    (d1, i1), (d2, i2) = sides
    assert len(d1) == len(d2) and abs(len(d1) - 1500) < 200 and abs(d1[-1] - d2[-1]) < 1e-9
    assert not (len(i1) == len(i2) and (i1 == i2).all())


def test_check_numbers():
    ok, out = run.check_numbers({"a": 1e-12, "b": 0.0}, {"a": {"limit": 1e-9},
                                                        "b": {"limit": 0.0}})
    assert ok and out["a"] == {"value": 1e-12, "limit": 1e-9}
    assert not run.check_numbers({"a": float("nan")}, {"a": {"limit": 1.0}})[0]
    assert not run.check_numbers({"a": 2.0}, {"a": {"limit": 1.0}})[0]
    with pytest.raises(KeyError):
        run.check_numbers({"a": 1.0}, {"b": {"limit": 1.0}})


def test_worst_keeps_nan_and_reads_nothing_as_infinite():
    from spmvbench.reference import worst

    assert worst([0.0, 1e-12, 3e-16]) == 1e-12
    assert math.isnan(worst([1e-16, float("nan"), 1e-15]))
    assert math.isnan(worst([float("nan"), 1e-15]))
    assert worst([]) == float("inf")


def _sweep_window(lat_first, lat_second, late=1e-4, done_share=1.0):
    import numpy as np

    n = 1000
    due = np.linspace(0.0, 10.0, n, endpoint=False)
    lat = np.where(due < 5.0, lat_first, lat_second)
    return {"latency_s": lat, "due_s": due, "window_s": 10.0, "late_s": np.full(n, late),
            "requests": n, "completed_in_window": int(done_share * n)}


@pytest.mark.parametrize("window,sustained", [
    (_sweep_window(2.2e-3, 2.4e-3), True),
    (_sweep_window(2.2e-3, 5.9e-3), False),               # the backlog grows
    (_sweep_window(7.0e-3, 7.0e-3), False),               # p95 over 3 deadlines
    (_sweep_window(2.2e-3, 2.2e-3, late=3e-3), False),    # the generator falls behind
    (_sweep_window(2.2e-3, 2.2e-3, done_share=0.98), False),
])
def test_sweep_judges_a_rate(window, sustained):
    from spmvbench import sweep

    assert sweep.judge(window, 2e-3)["sustained"] is sustained


def test_time_to_e0_counts_completed_solves_only():
    import types

    read = run.metric_reader("time_to_e0_ms")
    ctx = types.SimpleNamespace(result={"window_s": 10.0, "solves": 40, "attempted": 50})
    assert read(ctx) == 250.0
    ctx.result.update(solves=0)
    assert read(ctx) is None
