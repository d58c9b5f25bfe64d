"""Chaos parity: the serving cases of ``tests/test_chaos.py`` run on the
reference's server and on the port's (on the CPU), with faults armed at the
same points of each package's ``testing.faults``.

Each scenario returns a record -- error classes per future, bitwise
self-comparisons, fault firings, ``stats()`` -- that must be the same on
both sides (futures within 2e-5, the kernel label through xla -> torch).
The contract under test (``serve.resilience``): a transient fault recovers
by retry bit for bit; a persistent one never hangs and never returns NaN
silently, each affected request failing with a structured ``RequestError``;
a backend-scoped persistent fault trips the breaker and the operator serves
on, one rung down its ladder.
"""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from _torch_parity import to_port  # noqa: E402
from _torch_serve import (  # noqa: E402
    PORT, REF, FakeClock, assert_same_record, error_names, run_both)
from repro.core.formats import COO, CSR  # noqa: E402


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for side in (REF, PORT):
        side.faults.reset()


@pytest.fixture(scope="module")
def csr():
    """The reference chaos suite's matrix: 48 x 48 at 15 % density, f32."""
    rng = np.random.default_rng(0)
    dense = (rng.random((48, 48)) < 0.15) * rng.standard_normal((48, 48))
    rows, cols = np.nonzero(dense)
    return CSR.from_coo(COO(rows.astype(np.int32), cols.astype(np.int32),
                            dense[rows, cols].astype(np.float32), (48, 48)))


def make_server(side, m, *, width=4, clock=None, resilience=None, backend="auto"):
    srv = side.server(max_batch=width, clock=clock, resilience=resilience,
                      backend=side.composite if backend == "composite" else backend)
    srv.register("A", side.mat(m))
    return srv


def policy(side, **kw):
    return side.serve.ResiliencePolicy(**kw)


def answers(side, futs) -> list:
    return [side.arr(f.result()) for f in futs]


def same_bits(a: list, b: list) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------


def _transient(side, m, point):
    srv = make_server(side, m)
    xs = side.requests(m.shape[1], 4, seed=1)
    clean = answers(side, [srv.submit("A", x) for x in xs])
    with side.faults.inject(point, error=RuntimeError("transient"), times=1) as spec:
        got = answers(side, [srv.submit("A", x) for x in xs])
    return {"fired": spec.fired, "bitwise": same_bits(clean, got), "y": got,
            "stats": srv.stats()}


@pytest.mark.parametrize("point", ["serve.flush", "plan.spmm"])
def test_transient_error_retries_bitwise(csr, point):
    ref, port = run_both(_transient, csr, point)
    assert_same_record(ref, port)
    assert port["fired"] == 1 and port["bitwise"]
    st = port["stats"]["A"]
    assert st["retried"] == 1 and st["failed"] == 0


def _persistent(side, m, point):
    # no ladder escape: loop_reference also goes through plan.spmm, so a
    # persistent fault there must end in structured per-request errors
    srv = make_server(side, m, resilience=policy(side, max_retries=1,
                                                 breaker_threshold=100))
    xs = side.requests(m.shape[1], 4, seed=1)
    with side.faults.inject(point, error=RuntimeError("persistent"), times=None):
        futs = [srv.submit("A", x) for x in xs]
        srv.flush("A")
    raised = []
    for f in futs:
        try:
            f.result()
            raised.append(None)
        except side.serve.KernelFault as e:
            raised.append((isinstance(e, side.serve.RequestError), e.op,
                           type(e.__cause__).__name__))
    return {"done": [f.done() for f in futs], "errors": error_names(futs),
            "raised": raised, "stats": srv.stats()}


@pytest.mark.parametrize("point", ["serve.flush", "plan.spmm"])
def test_persistent_error_fails_structured_no_hang(csr, point):
    ref, port = run_both(_persistent, csr, point)
    assert_same_record(ref, port)
    assert port["done"] == [True] * 4
    assert port["errors"] == ["KernelFault"] * 4
    assert port["raised"] == [(True, "spmm", "RuntimeError")] * 4
    assert port["stats"]["A"]["failed"] == 4


def _poison(side, m, column):
    srv = make_server(side, m)
    xs = side.requests(m.shape[1], 4, seed=1)
    clean = answers(side, [srv.submit("A", x) for x in xs])
    with side.faults.inject("plan.spmm", nonfinite=True, times=None, column=column):
        futs = [srv.submit("A", x) for x in xs]
        srv.flush("A")
    errs = [f.error() for f in futs]
    got = [None if e is not None else side.arr(f.result()) for f, e in zip(futs, errs)]
    return {"errors": error_names(futs), "nonfinite": [getattr(e, "nonfinite", None)
                                                       for e in errs],
            "clean_bits": [y is None or np.array_equal(y, c) for y, c in zip(got, clean)],
            "y": got, "stats": srv.stats()}


@pytest.mark.parametrize("column", [0, 2, 3])
def test_poison_request_isolated_others_answered(csr, column):
    ref, port = run_both(_poison, csr, column)
    assert_same_record(ref, port)
    want = [None] * 4
    want[column] = "KernelFault"
    assert port["errors"] == want
    assert port["nonfinite"][column] is True
    assert port["clean_bits"] == [True] * 4
    assert port["stats"]["A"]["failed"] == 1


def _no_silent_nan(side, m):
    srv = make_server(side, m)
    xs = side.requests(m.shape[1], 4, seed=1)
    finite, errors = [], []
    with side.faults.inject("plan.spmm", nonfinite=True, times=None, column=0):
        for _ in range(3):
            futs = [srv.submit("A", x) for x in xs]
            srv.flush("A")
            errors.append(error_names(futs))
            finite += [bool(np.isfinite(side.arr(f.result())).all())
                       for f in futs if f.error() is None]
    return {"errors": errors, "finite": finite, "stats": srv.stats()}


def test_no_silent_nan_ever(csr):
    """The invariant behind check_finite: a resolved value is finite."""
    ref, port = run_both(_no_silent_nan, csr)
    assert_same_record(ref, port)
    assert port["finite"] == [True] * 9
    assert port["errors"] == [["KernelFault", None, None, None]] * 3


def _breaker(side, m):
    srv = make_server(side, m, backend="composite",
                      resilience=policy(side, max_retries=0, breaker_threshold=2))
    ladder = srv.stats()["A"]["ladder"]
    xs = side.requests(m.shape[1], 4, seed=1)
    clean = answers(side, [srv.submit("A", x) for x in xs])
    # fail ONLY the composite kernel, persistently: the breaker must trip
    # and the loop_reference rung must serve the same answers
    with side.faults.inject("plan.spmm", error=RuntimeError("composite broken"),
                            times=None,
                            when=lambda ctx: ctx.get("kernel") == side.composite) as spec:
        got = answers(side, [srv.submit("A", x) for x in xs])
    return {"ladder_before": ladder, "fired": spec.fired,
            "kernel_after": srv.plan("A").report.kernel,
            "close": all(np.allclose(a, b, atol=1e-5) for a, b in zip(clean, got)),
            "y": got, "stats": srv.stats()}


def test_breaker_degrades_and_recovers(csr):
    ref, port = run_both(_breaker, csr)
    # the two halves of the split run on the loop rung, whose SpMM goes one
    # column at a time: the port streams no zero column there, the
    # reference pads each half to width 4
    pads = [rec["stats"]["A"]["padding_ratio"] for rec in (ref, port)]
    assert pads == [pytest.approx(4 / 12), 0.0]
    for rec in (ref, port):
        rec["stats"]["A"]["padding_ratio"] = None
    assert_same_record(ref, port)
    assert port["ladder_before"] == ("loop_reference",)
    assert port["fired"] == 2                      # threshold firings, then the trip
    st = port["stats"]["A"]
    assert st["degraded"] == 1 and st["breaker_trips"] == 1 and st["ladder"] == ()
    assert port["kernel_after"] == "loop" and port["close"]


def _queue_full(side, m):
    srv = make_server(side, m)
    x = side.requests(m.shape[1], 1, seed=1)[0]
    queued = srv.submit("A", x).done()
    with side.faults.inject("serve.queue_full",
                            error=side.serve.BackpressureError("injected"), times=1):
        try:
            srv.submit("A", x)
            raised = None
        except side.serve.BackpressureError as e:
            raised = type(e).__name__
    st = srv.stats()
    return {"queued_done": queued, "raised": raised, "stats_shed": st,
            "flushed": srv.flush("A"), "stats": srv.stats()}


def test_queue_full_fault_sheds(csr):
    ref, port = run_both(_queue_full, csr)
    assert_same_record(ref, port)
    assert port["queued_done"] is False and port["raised"] == "BackpressureError"
    st = port["stats_shed"]["A"]
    assert st["shed"] == 1 and st["requests"] == 1  # the shed request was not admitted
    assert port["flushed"] == 1


def _straggler(side, m):
    clock = FakeClock()
    srv = make_server(side, m, clock=clock,
                      resilience=policy(side, request_timeout_s=0.2))
    xs = side.requests(m.shape[1], 2, seed=1)
    f1 = srv.submit("A", xs[0])
    with side.faults.inject("serve.flush", delay_s=0.5, times=1) as spec:
        srv.flush("A")                             # a slow flush advances the clock
    t_after = clock.t
    y1 = side.arr(f1.result())                     # slow, not wrong
    f2 = srv.submit("A", xs[1])
    clock.advance(1.0)
    srv.flush("A")                                 # f2 out-waited its deadline
    err = f2.error()
    return {"fired": spec.fired, "t_after": t_after, "y": [y1],
            "error": type(err).__name__, "waited_s": err.waited_s,
            "timeout_s": err.timeout_s, "stats": srv.stats()}


def test_straggler_delay_then_deadline_shed(csr):
    ref, port = run_both(_straggler, csr)
    assert_same_record(ref, port)
    assert port["fired"] == 1 and port["t_after"] == pytest.approx(0.5)
    assert np.isfinite(port["y"][0]).all()
    assert port["error"] == "DeadlineExceeded"
    assert port["waited_s"] == pytest.approx(1.0) and port["timeout_s"] == 0.2
    assert port["stats"]["A"]["deadline_missed"] == 1


def _timeout_override(side, m):
    clock = FakeClock()
    srv = make_server(side, m, clock=clock,
                      resilience=policy(side, request_timeout_s=10.0))
    xs = side.requests(m.shape[1], 2, seed=1)
    f_tight = srv.submit("A", xs[0], timeout_s=0.1)
    f_loose = srv.submit("A", xs[1])
    clock.advance(1.0)
    srv.flush("A")
    return {"errors": error_names([f_tight, f_loose]), "y": [side.arr(f_loose.result())],
            "stats": srv.stats()}


def test_per_request_timeout_override(csr):
    ref, port = run_both(_timeout_override, csr)
    assert_same_record(ref, port)
    assert port["errors"] == ["DeadlineExceeded", None]


def _disabled(side, m):
    srv = make_server(side, m, resilience=policy(side, enabled=False))
    xs = side.requests(m.shape[1], 4, seed=1)
    with side.faults.inject("plan.spmm", error=RuntimeError("legacy"), times=1):
        futs = [srv.submit("A", x) for x in xs[:3]]
        try:
            srv.submit("A", xs[3])                 # width reached -> flush -> propagate
            raised = None
        except RuntimeError as e:
            raised = str(e)
    return {"raised": raised, "stranded": [not f.done() for f in futs],
            "stats": srv.stats()}


def test_resilience_disabled_is_legacy(csr):
    ref, port = run_both(_disabled, csr)
    assert_same_record(ref, port)
    assert port["raised"] == "legacy"
    assert port["stranded"] == [True] * 3          # the old contract


def test_port_degrade_keeps_the_device_and_the_bits(csr):
    """After a degrade the rebuilt plan runs on the server's device, and a
    fresh registration of the same matrix returns the earlier bits."""
    m = to_port(csr)
    srv = PORT.server(max_batch=4, backend="torch",
                      resilience=PORT.serve.ResiliencePolicy(max_retries=0,
                                                             breaker_threshold=1))
    srv.register("A", m)
    xs = PORT.requests(m.shape[1], 4, seed=1)
    clean = answers(PORT, [srv.submit("A", x) for x in xs])
    with PORT.faults.inject("plan.spmm", error=RuntimeError("torch broken"), times=None,
                            when=lambda ctx: ctx.get("kernel") == "torch"):
        got = answers(PORT, [srv.submit("A", x) for x in xs])
    plan = srv.plan("A")
    assert plan.report.kernel == "loop" and str(plan.device) == "cpu"
    assert srv.stats()["A"]["degraded"] == 1
    assert all(np.allclose(a, b, rtol=1e-6, atol=1e-6) for a, b in zip(clean, got))
    PORT.faults.reset()
    srv.register("A", m)
    assert srv.stats()["A"]["kernel"] == "torch" and srv.stats()["A"]["degraded"] == 0
    assert same_bits(clean, answers(PORT, [srv.submit("A", x) for x in xs]))
