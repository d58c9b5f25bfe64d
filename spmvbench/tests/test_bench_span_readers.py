"""The readers of the metrics that read the program's spans and its
queue-wait counter, on a synthetic traced stretch: each gives its value,
and None where its spans recorded nothing or the program has none."""
from __future__ import annotations

import sys
import types

import pytest

from spmvbench import run

TOTALS = {
    "plan.operand": {"n": 100, "total_s": 4e-3, "self_s": 4e-3},
    "kernel.check": {"n": 200, "total_s": 2e-3, "self_s": 2e-3},
    "kernel.launch": {"n": 200, "total_s": 3e-3, "self_s": 3e-3},
    "lanczos.step": {"n": 192, "total_s": 0.05, "self_s": 0.02},
    "lanczos.sync": {"n": 192, "total_s": 0.03, "self_s": 0.03},
    "serve.submit": {"n": 800, "total_s": 0.09, "self_s": 0.04},
    "serve.flush": {"n": 50, "total_s": 0.06, "self_s": 0.06},
}
TRACED = {"units": 100, "launches": 200, "solves": 2, "spmvs": 192, "requests": 800,
          "batches": 50}
#: metric -> its value on TOTALS and TRACED, and the spans it reads
CASES = {
    "plan_check_us.spmv": (60.0, ("plan.operand", "kernel.check")),
    "launch_host_us.spmv": (15.0, ("kernel.launch",)),
    "lanczos_enqueue_ms.e0": (10.0, ("lanczos.step", "lanczos.sync")),
    "lanczos_sync_ms.e0": (15.0, ("lanczos.sync",)),
    "submit_host_us.served": (50.0, ("serve.submit",)),
    "flush_host_us.served": (1200.0, ("serve.flush",)),
}


def _ctx(traced=TRACED):
    return types.SimpleNamespace(traced=dict(traced) if traced else traced, trace={},
                                 result={}, bench=None, setup_s=1.0)


@pytest.fixture
def spans(monkeypatch):
    from repro_torch.utils import spans as S

    def use(totals):
        monkeypatch.setattr(S, "totals", lambda: {k: dict(v) for k, v in totals.items()})
    return use


@pytest.mark.parametrize("metric", CASES)
def test_span_reader_value(spans, metric):
    want, _ = CASES[metric]
    spans(TOTALS)
    assert run.metric_reader(metric)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("metric", CASES)
def test_span_reader_silent_without_its_spans(spans, metric):
    _, names = CASES[metric]
    spans({})
    assert run.metric_reader(metric)(_ctx()) is None
    spans({k: v for k, v in TOTALS.items() if k not in names})
    assert run.metric_reader(metric)(_ctx()) is None


@pytest.mark.parametrize("metric", CASES)
def test_span_reader_silent_where_the_program_has_no_spans(monkeypatch, metric):
    monkeypatch.setitem(sys.modules, "repro_torch.utils.spans", None)  # import fails
    assert run.metric_reader(metric)(_ctx()) is None


def test_plan_check_reads_either_span(spans):
    spans({"plan.operand": TOTALS["plan.operand"]})
    assert run.metric_reader("plan_check_us.spmv")(_ctx()) == pytest.approx(40.0)
    assert run.metric_reader("plan_check_us.spmv")(_ctx({"units": 0})) is None


def _hist(monkeypatch, counts):
    from repro_torch.serve import batching as B

    monkeypatch.setattr(B, "queue_wait_counts", lambda: list(counts))


def test_queue_wait_p95_reader(monkeypatch):
    read = run.metric_reader("queue_wait_p95_ms.served")
    counts = [0] * 201
    counts[3], counts[39] = 94, 6          # p95 in the bin of 1.95-2.0 ms
    _hist(monkeypatch, counts)
    assert read(_ctx()) == pytest.approx(2.0)
    counts[39], counts[200] = 0, 6         # past 10 ms: silent
    _hist(monkeypatch, counts)
    assert read(_ctx()) is None
    _hist(monkeypatch, [0] * 201)          # nothing counted
    assert read(_ctx()) is None


def test_queue_wait_p95_reader_silent_where_the_program_has_no_counter(monkeypatch):
    from repro_torch.serve import batching as B

    monkeypatch.delattr(B, "queue_wait_quantile")
    assert run.metric_reader("queue_wait_p95_ms.served")(_ctx()) is None
