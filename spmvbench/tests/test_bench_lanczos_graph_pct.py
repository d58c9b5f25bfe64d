"""The reader of ``lanczos_graph_pct.e0`` on stand-in graph counters: the
share of completed solves replayed from CUDA graphs, and None where the
traced stretch completed no solve, the counters saw none, or the program has
no such counter."""
from __future__ import annotations

import types

import pytest

from spmvbench import run

TRACED = {"units": 2, "launches": 192, "solves": 2, "spmvs": 192}


def _ctx(traced=TRACED):
    return types.SimpleNamespace(traced=dict(traced) if traced else traced, trace={},
                                 result={}, bench=None, setup_s=1.0)


def _graphs(monkeypatch, replayed, eager):
    from repro_torch.core import eigensolver as E

    monkeypatch.setattr(E, "graph_counts", lambda: {"captured": 6, "replayed_solves": replayed,
                                                    "eager_solves": eager})


def test_lanczos_graph_pct_reader(monkeypatch):
    read = run.metric_reader("lanczos_graph_pct.e0")
    _graphs(monkeypatch, 110, 0)
    assert read(_ctx()) == pytest.approx(100.0)
    _graphs(monkeypatch, 3, 1)
    assert read(_ctx()) == pytest.approx(75.0)
    _graphs(monkeypatch, 0, 0)             # nothing completed: silent
    assert read(_ctx()) is None
    _graphs(monkeypatch, 110, 0)
    assert read(_ctx({"solves": 0})) is None and read(_ctx(None)) is None


def test_lanczos_graph_pct_reader_silent_where_the_program_has_no_counter(monkeypatch):
    from repro_torch.core import eigensolver as E

    monkeypatch.delattr(E, "graph_counts")
    assert run.metric_reader("lanczos_graph_pct.e0")(_ctx()) is None
