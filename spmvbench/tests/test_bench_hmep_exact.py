"""The cell ``hmep_exact.lanczos``: its configuration is HMeP's published
size, its driver runs the program's generated electron x phonon operator
on the host at a small size (through ``run_cell``'s keyword overrides),
a broken answer or the control reads incorrect, a program without the
operator fails in set-up, and the ``operator_build_ms`` reader reads the
program's counter or stays silent.  The shared modules' tests of every
cell (drivers, faults, control) are made here for this cell, whose driver
their tables do not know (``spmvbench/conftest.py``)."""
from __future__ import annotations

import json
import math
import types

import pytest
import torch
from repro_torch.core.plan import SpMVPlan

from spmvbench import gen, run

CELL = "hmep_exact.lanczos"
#: a host-size HMeP-like operator: 5 sites, 2 + 2 electrons, <= 3 phonons in
#: total (5,600 rows).  The small omega0 packs its spectrum densely, so the
#: cell's 96 plain Lanczos steps do not converge and lose no orthogonality:
#: two f64 recurrences then agree to rounding, as at the cell's full size
TINY = {"L": 5, "n_up": 2, "n_dn": 2, "max_phonon": 3, "max_total_phonon": 3,
        "t": 1.0, "U": 4.0, "g": 1.0, "omega0": 0.01, "periodic": True}


def _files() -> dict:
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    config = run.load_json(run.HERE / "configs" / "hmep_exact.json")
    config["params"] = dict(TINY)
    traffic = run.load_json(run.HERE / "traffic" / "lanczos_operator.json")
    return {"bench": bench, "config": config, "traffic": traffic}


def _run(trace: bool = False, seed: int = 2**40 + 17, samples: int | None = None,
         seconds: float = 0.3) -> dict:
    f = _files()
    if samples:
        f["traffic"]["samples"] = samples
    return run.run_cell(CELL, seed, seconds, trace, "cpu", out=lambda s: None, **f)


def test_config_is_hmep_at_its_published_size():
    cfg = run.load_json(run.HERE / "configs" / "hmep_exact.json")
    assert cfg["format"] == "mf_product" and cfg["values"] == "generated"
    assert cfg["value_dtype"] == cfg["vector_dtype"] == "float64" and cfg["reduced"] == []
    row_ptr, col, val = gen.holstein_hubbard(**cfg["params"])
    assert len(row_ptr) - 1 == 1_201_200 and len(col) == 16_027_420


def test_untraced_run_is_correct_and_plans_the_generated_operator():
    line = _run()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in run.metrics_of(_files()["bench"], CELL, False)}
    assert set(line["metrics"]) == want == {"time_to_e0_ms", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values()), line["metrics"]
    assert list(line)[-1] == "checks"
    json.dumps(line)


def test_traced_run_reads_the_build_counter():
    line = _run(trace=True)
    assert line["correct"] is True
    assert line["device"]["busy_s"] == 0.0 and line["breakdown"]["idle_gaps"]
    assert line["metrics"]["operator_build_ms"]["value"] > 0
    assert all(not k.startswith("spmv_roofline") for k in line["metrics"])


def test_setup_plans_mf_product():
    f = _files()
    b = run.Bench(CELL, f["config"], f["traffic"], 3, 0.3, False, "cpu")
    b.build_matrix()
    st = run.load_driver(f["traffic"]).setup(b)
    assert st["plan"].report.format == "mf_product" and st["plan"].report.kernel == "torch"
    assert st["plan"].report.shape == (5600, 5600) and st["plan"].report.nnz == b.nnz


def _altered(y):
    y = y.clone()
    y[len(y) // 3] += 1e-3 * float(y.abs().max())
    return y


def _nan(y):
    y = y.clone()
    y[len(y) // 2] = float("nan")
    return y


#: the faults the shared fault table gives the ``lanczos`` driver
FAULTS = {
    "answer_altered": lambda orig: lambda self, x: _altered(orig(self, x)),
    "state_unchanged": lambda orig: lambda self, x: x.clone(),
    "nan_output": lambda orig: lambda self, x: _nan(orig(self, x)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_incorrect(monkeypatch, fault):
    monkeypatch.setattr(SpMVPlan, "spmv", FAULTS[fault](SpMVPlan.spmv))
    line = _run(seed=424242, samples=64, seconds=0.4)
    assert line["correct"] is False, line["checks"]


def test_nan_in_every_answer_reads_incorrect_and_times_nothing(monkeypatch):
    monkeypatch.setattr(SpMVPlan, "spmv", lambda self, x: torch.full_like(x, float("nan")))
    monkeypatch.setattr(SpMVPlan, "spmm", lambda self, X: torch.full_like(X, float("nan")))
    line = _run(seed=5150)
    assert line["correct"] is False, line["checks"]
    assert not any(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                   for name, c in line["checks"].items() if name.endswith("rel_err")), line
    assert "time_to_e0_ms" not in line["metrics"], line["metrics"]


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_control_fails_the_limits(seed):
    f = _files()
    b = run.Bench(CELL, f["config"], f["traffic"], seed, 1.0, False, "cpu")
    b.build_matrix()
    driver = run.load_driver(f["traffic"])
    ok, checks = run.check_numbers(driver.check(b, driver.control(b)),
                                   run.load_json(run.HERE / "limits" / f"{CELL}.json"))
    assert not ok, checks


@pytest.mark.cuda
def test_control_on_the_card(card):
    """The control at the cell's own size on the card (three seeds run by
    ``spmvbench.calibrate``; one here)."""
    config = run.load_json(run.HERE / "configs" / "hmep_exact.json")
    traffic = run.load_json(run.HERE / "traffic" / "lanczos_operator.json")
    b = run.Bench(CELL, config, traffic, 5, 1.0, False, card)
    b.build_matrix()
    driver = run.load_driver(traffic)
    ok, checks = run.check_numbers(driver.check(b, driver.control(b)),
                                   run.load_json(run.HERE / "limits" / f"{CELL}.json"))
    assert not ok, checks


def test_program_without_the_operator_fails_in_setup(monkeypatch):
    """A program without ``holstein_hubbard_operator`` (one older than this
    cell) stops the run at set-up with an ImportError, before the window."""
    from repro_torch.core import matrices

    monkeypatch.delattr(matrices, "holstein_hubbard_operator")
    with pytest.raises(ImportError):
        _run()


def _ctx():
    return types.SimpleNamespace(traced={"solves": 1}, trace={}, result={}, bench=None,
                                 setup_s=1.0)


def test_operator_build_ms_reader(monkeypatch):
    from repro_torch.core import matrices

    read = run.metric_reader("operator_build_ms")
    monkeypatch.setattr(matrices, "build_stats",
                        lambda: {"builds": 1, "build_s": 0.0625, "table_bytes": 286_616})
    assert read(_ctx()) == pytest.approx(62.5)
    monkeypatch.setattr(matrices, "build_stats",
                        lambda: {"builds": 0, "build_s": 0.0, "table_bytes": 0})
    assert read(_ctx()) is None        # nothing built: silent


def test_operator_build_ms_reader_silent_where_the_program_has_no_counter(monkeypatch):
    from repro_torch.core import matrices

    monkeypatch.delattr(matrices, "build_stats")
    assert run.metric_reader("operator_build_ms")(_ctx()) is None
