"""The cell ``hmep_exact.lanczos``, beyond what the shared modules test of
every cell at its tiny size: its configuration is HMeP's published size,
its driver plans the program's generated electron x phonon operator, the
control fails on E0, a program without the operator fails in
set-up, and the ``operator_build_ms`` reader reads the program's counter or
stays silent."""
from __future__ import annotations

import types

import pytest
from conftest import run_tiny, tiny

from spmvbench import gen, run

CELL = "hmep_exact.lanczos"


def test_config_is_hmep_at_its_published_size():
    cfg = run.load_json(run.HERE / "configs" / "hmep_exact.json")
    assert cfg["format"] == "mf_product" and cfg["values"] == "generated"
    assert cfg["value_dtype"] == cfg["vector_dtype"] == "float64" and cfg["reduced"] == []
    row_ptr, col, val = gen.holstein_hubbard(**cfg["params"])
    assert len(row_ptr) - 1 == 1_201_200 and len(col) == 16_027_420


def test_traced_run_reads_the_build_counter():
    line = run_tiny(CELL, trace=True)
    assert line["correct"] is True
    assert line["device"]["busy_s"] == 0.0 and line["breakdown"]["idle_gaps"]
    assert line["metrics"]["operator_build_ms"]["value"] > 0
    assert all(not k.startswith("spmv_roofline") for k in line["metrics"])


def test_setup_plans_mf_product():
    f = tiny(CELL)
    b = run.Bench(CELL, f["config"], f["traffic"], 3, 0.3, False, "cpu")
    b.build_matrix()
    st = run.load_driver(f["traffic"]).setup(b)
    assert st["plan"].report.format == "mf_product" and st["plan"].report.kernel == "torch"
    assert st["plan"].report.shape == (5600, 5600) and st["plan"].report.nnz == b.nnz


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_control_fails_the_limits(seed):
    """The f32 control fails on E0: at this size its coefficients (2e-5)
    stay inside their limit (1e-4, set at the cell's size)."""
    f = tiny(CELL)
    b = run.Bench(CELL, f["config"], f["traffic"], seed, 1.0, False, "cpu")
    b.build_matrix()
    driver = run.load_driver(f["traffic"])
    ok, checks = run.check_numbers(driver.check(b, driver.control(b)),
                                   run.load_json(run.HERE / "limits" / f"{CELL}.json"))
    assert not ok, checks
    assert checks["e0_rel_err"]["value"] > checks["e0_rel_err"]["limit"], checks


def test_program_without_the_operator_fails_in_setup(monkeypatch):
    """A program without ``holstein_hubbard_operator`` (one older than this
    cell) stops the run at set-up with an ImportError, before the window."""
    from repro_torch.core import matrices

    monkeypatch.delattr(matrices, "holstein_hubbard_operator")
    with pytest.raises(ImportError):
        run_tiny(CELL)


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
