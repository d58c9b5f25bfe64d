"""A run with the timed path broken underneath reads ``correct`` false:
an answer altered where it is produced, a NaN in every answer, a step that
returns its state unchanged (the SpMV hands back x), and half of a served
batch left out: each cell takes the faults its traffic file's ``faults``
names.
The cells run on one chip, so no exchange between chips can be left out.
Here 64 answers are checked (``check_all``), most of a tiny run's."""
from __future__ import annotations

import math

import pytest
import torch
from conftest import CELLS, run_tiny
from repro_torch.core.plan import SpMVPlan


def _altered(y):
    y = y.clone()
    flat = y.view(-1)
    flat[len(flat) // 3] += 1e-3 * float(y.abs().max())
    return y


def _nan(y):
    y = y.clone()
    y.view(-1)[len(y.view(-1)) // 2] = float("nan")
    return y


def _halved(Y):
    Y = Y.clone()
    Y[:, 1::2] = 0
    return Y


FAULTS = {
    "answer_altered": ("spmv", lambda orig: lambda self, x: _altered(orig(self, x))),
    "state_unchanged": ("spmv", lambda orig: lambda self, x: x.clone()),
    "nan_output": ("spmv", lambda orig: lambda self, x: _nan(orig(self, x))),
    "served_nan_output": ("spmm", lambda orig: lambda self, X: _nan(orig(self, X))),
    "served_answer_altered": ("spmm", lambda orig: lambda self, X: _altered(orig(self, X))),
    # every second column of a flush left out (padding columns are zero
    # anyway): half of the requests of every batch of two or more
    "half_batch_left_out": ("spmm", lambda orig: lambda self, X: _halved(orig(self, X))),
}


def _cases():
    from conftest import tiny
    for cell in CELLS:
        for fault in tiny(cell)["traffic"]["faults"]:
            yield pytest.param(cell, fault, id=f"{cell}-{fault}")


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_fault_reads_incorrect(monkeypatch, cell, fault):
    method, patch = FAULTS[fault]
    monkeypatch.setattr(SpMVPlan, method, patch(getattr(SpMVPlan, method)))
    line = run_tiny(cell, seed=424242, check_all=True, seconds=0.4)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_nan_in_every_answer_reads_incorrect_and_times_nothing(monkeypatch, cell):
    """With every answer NaN no Lanczos solve completes and no served
    request is answered: the run is not correct, and no rate or time is
    read from work that did not complete."""
    monkeypatch.setattr(SpMVPlan, "spmv", lambda self, x: torch.full_like(x, float("nan")))
    monkeypatch.setattr(SpMVPlan, "spmm", lambda self, X: torch.full_like(X, float("nan")))
    line = run_tiny(cell, seed=5150, seconds=0.3)
    assert line["correct"] is False, line["checks"]
    assert not any(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                   for name, c in line["checks"].items() if name.endswith("rel_err")), line
    for name in ("time_to_e0_ms", "served_p95_ms"):
        assert name not in line["metrics"], line["metrics"]
