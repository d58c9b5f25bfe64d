"""The control, the plain reference computed one precision below what the
configuration states and put in the program's place, fails each cell's
limits: here at a size a test run holds, on the host; on the card at the
cells' own sizes through ``python3 -m spmvbench.calibrate``."""
from __future__ import annotations

import pytest
from conftest import CELLS, tiny

from spmvbench import run


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_control_fails_the_limits(cell, seed):
    t = tiny(cell)
    b = run.Bench(cell, t["config"], t["traffic"], seed, 1.0, False, "cpu")
    b.build_matrix()
    driver = run.load_driver(t["traffic"])
    numbers = driver.check(b, driver.control(b))
    ok, checks = run.check_numbers(numbers, run.load_json(run.HERE / "limits" / f"{cell}.json"))
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    """The control at the cell's own size on the card (three seeds run by
    ``spmvbench.calibrate``; one here)."""
    b_entry = {c["name"]: c for c in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]}
    entry = b_entry[cell]
    config = run.load_json(run.HERE / "configs" / f"{entry['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{entry['traffic']}.json")
    b = run.Bench(cell, config, traffic, 5, 1.0, False, card)
    b.build_matrix()
    driver = run.load_driver(traffic)
    ok, checks = run.check_numbers(driver.check(b, driver.control(b)),
                                   run.load_json(run.HERE / "limits" / f"{cell}.json"))
    assert not ok, checks
