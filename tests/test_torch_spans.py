"""The port's spans (``repro_torch.utils.spans``) and the serving queue's
wait counter, on the host.

A span records only under a ``torch.profiler`` session: then it is a
``record_function`` range in the profiler's events and a line of
``totals()``; otherwise it is one shared object that does nothing.  The
plan call, the Lanczos step and the server's submit and flush open theirs
once a call, a completed step, a request and a flush.  The queue-wait
histogram counts every request a flush takes, answered or shed.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core.eigensolver import lanczos
from repro_torch.core.formats import CSR
from repro_torch.core.plan import SpMVPlan
from repro_torch.core.planconfig import PlanConfig
from repro_torch.kernels import cuda_build as CB
from repro_torch.serve import BatchingSpMVServer
from repro_torch.serve import batching as B
from repro_torch.serve.resilience import ResiliencePolicy
from repro_torch.utils import spans

ROOT = Path(__file__).resolve().parents[1]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt: float) -> None:
        self.t += dt

    def __call__(self) -> float:
        return self.t


def _matrix(n: int = 120) -> CSR:
    """A small symmetric tridiagonal-plus-band matrix, f64."""
    rp, cols, vals = [0], [], []
    for i in range(n):
        for j, v in ((i - 7, 0.25), (i - 1, -1.0), (i, 2.0 + i % 5), (i + 1, -1.0),
                     (i + 7, 0.25)):
            if 0 <= j < n:
                cols.append(j)
                vals.append(v)
        rp.append(len(cols))
    return CSR(np.asarray(rp, np.int64), np.asarray(cols, np.int32), np.asarray(vals),
               (n, n))


def _plan():
    return SpMVPlan.compile(_matrix(), PlanConfig(device="cpu", format="csr"))


def _server(clock=None, **kw):
    srv = BatchingSpMVServer(device="cpu", max_batch=4, deadline_s=10.0,
                             clock=clock or FakeClock(), **kw)
    srv.register("op", _matrix())
    return srv


def _xs(k: int, n: int = 120):
    return torch.from_numpy(np.random.default_rng(k).standard_normal((k, n)))


@pytest.fixture(autouse=True)
def _fresh_totals():
    spans.reset()
    yield
    spans.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _events(prof, name: str) -> list:
    return [e for e in prof.events() if e.name == name]


def _ancestors(e) -> list:
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e.name)
    return out


def _self_within_total(tot: dict) -> None:
    for name, t in tot.items():
        assert 0.0 <= t["self_s"] <= t["total_s"] + 1e-12, (name, t)


def _work():
    """A plan call, a plan SpMM, a Lanczos solve and a served batch."""
    plan = _plan()
    x = _xs(1)[0]
    plan(x)
    plan.spmm(_xs(3).T.contiguous())
    lanczos(plan, 120, m=6, v0=x, reorthogonalize=False)
    srv = _server()
    futs = [srv.submit("op", v) for v in _xs(5)]
    srv.flush("op")
    assert all(f.error() is None for f in futs)


# --- off: one shared object, nothing recorded ------------------------------------


def test_span_without_profiler_is_one_shared_object():
    a, b = spans.span("plan.operand"), spans.span("serve.submit", 3)
    assert a is b
    with a:
        pass
    assert spans.totals() == {}


def test_no_range_and_no_totals_without_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record_function range opened with no profiler running")

    monkeypatch.setattr(spans, "_range", refuse)
    _work()
    assert spans.totals() == {}


def test_totals_only_for_the_profiled_block():
    plan = _plan()
    x = _xs(1)[0]
    for _ in range(3):
        plan(x)
    with _profiled():
        plan(x)
        plan(x)
    for _ in range(4):
        plan(x)
    tot = spans.totals()
    assert set(tot) == {"plan.operand"} and tot["plan.operand"]["n"] == 2
    _self_within_total(tot)


def test_names_are_not_the_benchmarks():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from spmvbench.trace import SPANS

    assert spans.NAMES and not spans.NAMES & SPANS
    _work()
    with _profiled():
        _work()
    assert set(spans.totals()) <= spans.NAMES


def test_self_time_is_the_duration_less_the_children():
    with _profiled():
        with spans.span("serve.submit"):
            time.sleep(0.002)
            with spans.span("serve.flush"):
                time.sleep(0.004)
            with spans.span("serve.flush"):
                time.sleep(0.001)
    tot = spans.totals()
    sub, fl = tot["serve.submit"], tot["serve.flush"]
    assert (sub["n"], fl["n"]) == (1, 2)
    assert fl["self_s"] == pytest.approx(fl["total_s"], abs=1e-12)
    assert sub["self_s"] == pytest.approx(sub["total_s"] - fl["total_s"], abs=1e-9)
    assert sub["self_s"] >= 0.002 and sub["total_s"] >= 0.007
    _self_within_total(tot)


def test_a_span_left_by_an_exception_is_recorded_and_closed():
    with _profiled():
        with pytest.raises(ValueError):
            with spans.span("plan.operand"):
                raise ValueError("bad operand")
        with spans.span("kernel.check"):
            pass
    tot = spans.totals()
    assert tot["plan.operand"]["n"] == 1 and tot["kernel.check"]["n"] == 1
    # the stack unwound: the second span is no child of the first
    assert tot["plan.operand"]["self_s"] == pytest.approx(tot["plan.operand"]["total_s"])


def test_a_span_of_n_counts_n_times_over_one_range():
    # one C call that launches two kernels: one range, two launches' counts
    with _profiled() as prof:
        with spans.span("kernel.launch", n=2):
            time.sleep(0.002)
        with spans.span("kernel.launch"):
            pass
    tot = spans.totals()["kernel.launch"]
    assert tot["n"] == 3 and tot["total_s"] >= 0.002
    assert tot["self_s"] == pytest.approx(tot["total_s"])
    assert len(_events(prof, "kernel.launch")) == 2


# --- the program's spans under the profiler ---------------------------------------


def test_plan_records_its_operand_span_once_a_call():
    plan = _plan()
    xs = _xs(4)
    with _profiled() as prof:
        with record_function("caller"):
            for x in xs[:3]:
                plan(x)
            plan.spmm(xs.T.contiguous())
    tot = spans.totals()
    assert tot["plan.operand"]["n"] == 4
    assert "kernel.check" not in tot and "kernel.launch" not in tot  # no card here
    ev = _events(prof, "plan.operand")
    assert len(ev) == 4 and all(_ancestors(e)[:1] == ["caller"] for e in ev)
    _self_within_total(tot)


def test_a_refused_operand_is_still_one_span():
    plan = _plan()
    with _profiled():
        with pytest.raises(ValueError, match="shape"):
            plan(torch.zeros(7, dtype=torch.float64))
    assert spans.totals()["plan.operand"]["n"] == 1


@pytest.mark.parametrize("reorth", (False, True), ids=("plain", "reorth"))
def test_lanczos_records_step_and_sync_once_a_completed_step(reorth):
    plan = _plan()
    with _profiled() as prof:
        r = lanczos(plan, 120, m=8, v0=_xs(1)[0], reorthogonalize=reorth)
    tot = spans.totals()
    assert r.n_iterations == 8
    assert tot["lanczos.step"]["n"] == tot["lanczos.sync"]["n"] == r.n_iterations
    # every SpMV of the solve is a plan call inside a step
    assert tot["plan.operand"]["n"] == r.n_spmv
    steps = tot["lanczos.step"]
    assert steps["self_s"] <= steps["total_s"] - tot["lanczos.sync"]["total_s"] + 1e-9
    syncs = _events(prof, "lanczos.sync")
    assert len(syncs) == 8 and all(_ancestors(e)[0] == "lanczos.step" for e in syncs)
    assert all("lanczos.step" in _ancestors(e) for e in _events(prof, "plan.operand"))
    _self_within_total(tot)


def test_lanczos_stopping_early_counts_its_completed_steps():
    # the operator's invariant subspace ends the recurrence after 3 steps
    d = torch.diag(torch.tensor([1.0, 2.0, 3.0] + [0.0] * 9, dtype=torch.float64))
    v0 = torch.tensor([1.0, 1.0, 1.0] + [0.0] * 9, dtype=torch.float64)
    with _profiled():
        r = lanczos(lambda v: d @ v, 12, m=8, v0=v0, reorthogonalize=True, device="cpu")
    tot = spans.totals()
    assert r.n_iterations == 3
    assert tot["lanczos.step"]["n"] == tot["lanczos.sync"]["n"] == 3


def test_server_records_submit_once_a_request_and_flush_once_a_flush():
    srv = _server()
    xs = _xs(10)
    with _profiled() as prof:
        futs = [srv.submit("op", x) for x in xs]   # two width flushes, 2 left
        srv.flush("op")
    tot = spans.totals()
    st = srv.stats()["op"]
    assert st["batches"] == 3
    assert tot["serve.submit"]["n"] == 10 and tot["serve.flush"]["n"] == 3
    flushes = _events(prof, "serve.flush")
    # a flush that a submit triggers is its child; the forced one is not
    assert sorted(_ancestors(e)[:1] == ["serve.submit"] for e in flushes) == [False, True, True]
    assert all("serve.flush" in _ancestors(e) for e in _events(prof, "plan.operand"))
    sub = tot["serve.submit"]
    inside = sum(e.cpu_time_total for e in flushes if _ancestors(e)[:1] == ["serve.submit"])
    assert sub["self_s"] < sub["total_s"] and inside > 0
    _self_within_total(tot)
    for f, x in zip(futs, xs):
        assert torch.allclose(f.result(), srv.spmv("op", x))


def test_server_spans_carry_the_flush_number(monkeypatch):
    srv = _server()
    queue = srv._queues["op"]
    seen = []

    def spy(name, flush=None):
        seen.append((name, flush))
        return spans.span(name, flush)

    monkeypatch.setattr(B, "span", spy)
    with _profiled():
        for x in _xs(6):
            srv.submit("op", x)
        srv.flush("op")
    assert seen == [("serve.submit", 0)] * 3 + [("serve.submit", 0), ("serve.flush", 0)] + \
        [("serve.submit", 1)] * 2 + [("serve.flush", 1)]
    assert queue._flush_seq == 2


def test_server_ranges_carry_the_flush_number_in_the_trace(tmp_path):
    srv = _server()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for x in _xs(6):
            srv.submit("op", x)
        srv.flush("op")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    got = [(e["name"], e["args"]["flush"]) for e in events
           if e.get("name") in ("serve.submit", "serve.flush")]
    assert sorted(got) == sorted([("serve.submit", 0)] * 4 + [("serve.flush", 0)]
                                 + [("serve.submit", 1)] * 2 + [("serve.flush", 1)])


# --- the queue-wait counter -------------------------------------------------------


def test_queue_wait_histogram_counts_every_flushed_and_shed_request():
    B.reset_queue_wait_counts()
    clock = FakeClock()
    srv = BatchingSpMVServer(device="cpu", max_batch=32, deadline_s=10.0, clock=clock,
                             resilience=ResiliencePolicy(request_timeout_s=0.005))
    srv.register("op", _matrix())
    for x in _xs(19):
        srv.submit("op", x)
    clock.advance(120e-6)                         # 19 waits in bin 2 (100-150 us)
    srv.flush("op")
    srv.submit("op", _xs(1)[0])
    clock.advance(3.12e-3)                        # one in bin 62
    srv.flush("op")
    counts = B.queue_wait_counts()
    assert len(counts) == B.QUEUE_WAIT_BINS + 1 == 201
    assert counts[2] == 19 and counts[62] == 1 and sum(counts) == 20
    assert B.queue_wait_quantile(0.95) == pytest.approx(150e-6)
    assert B.queue_wait_quantile(1.0) == pytest.approx(63 * 50e-6)
    futs = [srv.submit("op", x) for x in _xs(2)]
    clock.advance(0.02)                           # past the 5 ms limit: shed, overflow bin
    srv.flush("op")
    assert all(type(f.error()).__name__ == "DeadlineExceeded" for f in futs)
    st = srv.stats()["op"]
    counts = B.queue_wait_counts()
    assert counts[-1] == 2 and st["deadline_missed"] == 2
    assert sum(counts) == round(st["mean_batch_width"] * st["batches"]) + st["deadline_missed"]
    assert st["queue_wait_s"] == pytest.approx(19 * 120e-6 + 3.12e-3 + 2 * 0.02)
    assert B.queue_wait_quantile(0.95) == float("inf")
    assert B.queue_wait_quantile(0.5) == pytest.approx(150e-6)
    B.reset_queue_wait_counts()
    assert sum(B.queue_wait_counts()) == 0 and np.isnan(B.queue_wait_quantile(0.95))


def test_queue_wait_on_the_legacy_flush_path():
    B.reset_queue_wait_counts()
    clock = FakeClock()
    srv = _server(clock, resilience=ResiliencePolicy(enabled=False))
    for x in _xs(3):
        srv.submit("op", x)
    clock.advance(420e-6)
    srv.flush("op")
    counts = B.queue_wait_counts()
    assert counts[8] == 3 and sum(counts) == 3
    assert srv.stats()["op"]["queue_wait_s"] == pytest.approx(3 * 420e-6)


def test_queue_wait_skips_the_width_one_fast_path():
    B.reset_queue_wait_counts()
    srv = BatchingSpMVServer(device="cpu", max_batch=1, clock=FakeClock())
    srv.register("op", _matrix())
    srv.submit("op", _xs(1)[0]).result()
    assert sum(B.queue_wait_counts()) == 0 and srv.stats()["op"]["queue_wait_s"] == 0.0


def test_queue_wait_quantile_is_the_upper_edge_of_its_bin(monkeypatch):
    counts = [0] * 201
    counts[0], counts[10], counts[200] = 90, 5, 5
    monkeypatch.setattr(B, "queue_wait_counts", lambda: list(counts))
    assert B.queue_wait_quantile(0.9) == pytest.approx(50e-6)
    assert B.queue_wait_quantile(0.95) == pytest.approx(550e-6)
    assert B.queue_wait_quantile(0.96) == float("inf")


# --- the launch helper ------------------------------------------------------------


class _FakeCudaDevice:
    entered: list = []

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        self.entered.append(self.device)

    def __exit__(self, *exc):
        return False


def _fake_card(monkeypatch, current: int) -> list:
    """Stand-ins for the C entry points (each returns its first argument as
    its return code), the raw stream of device i (90 + i) and the current
    device; returns the lookups and calls in order."""
    calls = []

    def fake_function(name, argtypes):
        calls.append(("lookup", name, tuple(argtypes)))
        return lambda *a: calls.append(("call",) + a) or a[0]

    _FakeCudaDevice.entered = []
    monkeypatch.setattr(CB, "kernel_function", fake_function)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 90 + index,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", _FakeCudaDevice)
    return calls


def _rise(before: dict) -> dict:
    after = CB.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("profiled", (False, True), ids=("off", "profiled"))
def test_launch_calls_the_entry_point_then_counts_it(monkeypatch, profiled):
    calls = _fake_card(monkeypatch, current=1)
    dev = torch.device("cuda", 1)
    before = CB.launch_counts()
    with _profiled() if profiled else contextlib.nullcontext() as prof:
        CB.launch("dia_spmv", [1, 2], dev, 0, 3)
        CB.launch("grouped_gemm", [1], dev, 0,
                  counts=("grouped_gemm", "grouped_gemm_wgmma"))
        with pytest.raises(RuntimeError, match="dia_spmv: CUDA launch failed with cudaError 7"):
            CB.launch("dia_spmv", [1, 2], dev, 7, 4)
    # the current stream of the device goes last; the device is current
    assert calls == [("lookup", "dia_spmv", (1, 2)), ("call", 0, 3, 91),
                     ("lookup", "grouped_gemm", (1,)), ("call", 0, 91),
                     ("lookup", "dia_spmv", (1, 2)), ("call", 7, 4, 91)]
    assert _FakeCudaDevice.entered == []
    # a failed launch raises before it is counted; two names count one each
    assert _rise(before) == {"dia_spmv": 1, "grouped_gemm": 1, "grouped_gemm_wgmma": 1}
    tot = spans.totals()
    if not profiled:
        assert tot == {}
    else:
        # one range a launch, which counts once a name: 1 + 2 + 1
        assert tot["kernel.launch"]["n"] == 4 and len(_events(prof, "kernel.launch")) == 3


@pytest.mark.parametrize("current", (0, 1), ids=("current", "other"))
def test_launch_enters_the_device_only_when_it_is_not_current(monkeypatch, current):
    calls = _fake_card(monkeypatch, current=current)
    CB.launch("csr_spmv", [], torch.device("cuda", 0), 0)
    assert calls[-1] == ("call", 0, 90)
    assert _FakeCudaDevice.entered == ([] if current == 0 else [0])


@pytest.mark.parametrize("rc,message", [
    (1 << 20, "grouped_gemm: cuTensorMapEncodeTiled failed with CUresult 0$"),
    ((1 << 20) + 1, "grouped_gemm: cuTensorMapEncodeTiled failed with CUresult 1$"),
    ((1 << 20) + 999, "grouped_gemm: cuTensorMapEncodeTiled failed with CUresult 999$"),
    ((1 << 20) - 1, "grouped_gemm: CUDA launch failed with cudaError 1048575 "),
    (1, "grouped_gemm: CUDA launch failed with cudaError 1 ")], ids=str)
def test_tensor_map_error_is_named(monkeypatch, rc, message):
    """``grouped_gemm.cu`` returns ``kTensorMapError`` + the ``CUresult``
    where ``cuTensorMapEncodeTiled`` fails: ``raise_on_error`` names it, for
    every entry point, and the launch is not counted."""
    src = CB.source_path("grouped_gemm").read_text()
    assert f"constexpr int kTensorMapError = 1 << {CB.TENSOR_MAP_ERROR.bit_length() - 1};" in src
    _fake_card(monkeypatch, current=0)
    before = CB.launch_counts()
    with pytest.raises(RuntimeError, match=message):
        CB.launch("grouped_gemm", [], torch.device("cuda", 0), rc,
                  counts=("grouped_gemm", "grouped_gemm_wgmma"))
    with pytest.raises(RuntimeError, match=message):
        CB.raise_on_error("grouped_gemm", rc)
    assert _rise(before) == {}
    CB.raise_on_error("grouped_gemm", 0)


@pytest.mark.parametrize("module", ("csr_spmv", "dia_spmv", "sell_spmv", "matrix_free",
                                    "mf_product", "plan_launch", "gather_bench", "moe_gemm",
                                    "bsr_spmm"))
def test_only_cuda_build_looks_up_entry_points_and_streams(module):
    """Every module that launches a kernel launches through
    ``cuda_build.launch``: none looks up an entry point, a stream or the
    device, checks a return code or counts a launch itself."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / f"{module}.py").read_text()
    assert "CB.launch(" in src
    for own in ("kernel_function", "_cuda_getCurrentRawStream", "current_stream",
                "cuda_stream", "torch.cuda.device(", "current_device", "raise_on_error",
                "count_launch", "ctypes.CDLL"):
        assert own not in src, f"{module} uses {own}"
