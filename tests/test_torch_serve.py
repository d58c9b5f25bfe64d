"""The port's micro-batching server (``repro_torch.serve``) held against the
reference's (``repro.serve``) on the CPU.

Every case of ``tests/test_serve_batching.py`` that needs no mesh runs as
one scenario on both servers -- the same SELL matrix (the reference's
arrays through ``repro_torch.interop``), the same seeded requests, the same
``FakeClock`` script -- and the records must agree: futures within 2e-5
(f32 requests) and 1e-12 (f64), every ``stats()`` counter equal, the kernel
label through xla -> torch.  Then what only the port has: ``device=``, the
degradation ladder on its registry, the contiguous coalesced operand, column
views, and the verdict read by the first consumer.
"""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import to_port  # noqa: E402
from _torch_serve import (  # noqa: E402
    PORT, PORT_HOST, REF_HOST, FakeClock, assert_same_record, run_both)
from repro.core import formats as RF  # noqa: E402
from repro.core import perfmodel as RPM  # noqa: E402
from repro.serve import resilience as RRES  # noqa: E402
from repro_torch.core import perfmodel as PM  # noqa: E402
from repro_torch.serve import BatchingSpMVServer, resilience as PRES  # noqa: E402
from repro_torch.serve.batching import coalesce  # noqa: E402
from repro_torch.utils.hw import H100  # noqa: E402

DTYPES = (np.float32, np.float64)


@pytest.fixture(scope="module")
def sell(hh_small):
    """The reference's SELL C = 8 of the 600-row surrogate."""
    return RF.convert(hh_small, "sell", C=8)


def served(side, sell, clock=None):
    """A server with one SELL operator at a fixed width-4 policy and a
    far-away deadline (flushes are explicit or width-driven)."""
    srv = side.server(clock=clock, backend="auto", max_batch=4, deadline_s=60.0)
    srv.register("hh", side.mat(sell))
    return srv


def direct(side, sell, xs):
    """What ``plan(x)`` gives for each request, on the same side."""
    srv = served(side, sell)
    return [side.arr(srv.plan("hh")(x)) for x in xs]


# --- width-driven flush + padding -------------------------------------------

def _full_batch(side, sell, dtype):
    srv = served(side, sell)
    xs = side.requests(sell.shape[1], 4, dtype=dtype)
    futs = srv.submit_many("hh", xs)
    done = [f.done() for f in futs]
    return {"done": done, "y": [side.arr(f.result()) for f in futs],
            "y_plan": direct(side, sell, xs), "stats": srv.stats()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_batch_flushes_and_matches_reference(sell, dtype):
    ref, port = run_both(_full_batch, sell, dtype, dtype=dtype)
    assert_same_record(ref, port, dtype)
    assert port["done"] == [True] * 4               # width 4 reached -> flushed
    st = port["stats"]["hh"]
    assert st["batches"] == 1 and st["mean_batch_width"] == 4.0
    assert st["padding_ratio"] == 0.0
    for y, y_plan in zip(port["y"], port["y_plan"]):
        np.testing.assert_allclose(y, y_plan, rtol=1e-12 if dtype == np.float64 else 2e-5,
                                   atol=1e-12 if dtype == np.float64 else 2e-5)


def _partial(side, sell, dtype):
    srv = served(side, sell)
    xs = side.requests(sell.shape[1], 3, seed=1, dtype=dtype)  # one pad column
    futs = srv.submit_many("hh", xs)
    before = [f.done() for f in futs]
    answered = srv.flush("hh")
    return {"before": before, "answered": answered,
            "y": [side.arr(f.result()) for f in futs], "stats": srv.stats()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_partial_batch_padding_correctness(sell, dtype):
    """A flushed partial batch is padded with zero columns; the padding must
    not perturb the real columns and must be visible in the stats."""
    ref, port = run_both(_partial, sell, dtype, dtype=dtype)
    assert_same_record(ref, port, dtype)
    assert port["before"] == [False] * 3 and port["answered"] == 3
    st = port["stats"]["hh"]
    assert st["batches"] == 1 and st["mean_batch_width"] == 3.0
    assert st["padding_ratio"] == pytest.approx(1.0 / 4.0)


def _result_forces_flush(side, sell):
    srv = served(side, sell)
    futs = srv.submit_many("hh", side.requests(sell.shape[1], 2, seed=2))
    before = futs[0].done()
    y = futs[0].result()                          # forces the flush
    return {"before": before, "shape": tuple(y.shape), "after": [f.done() for f in futs],
            "pending": srv.pending("hh"), "y": [side.arr(f.result()) for f in futs],
            "stats": srv.stats()}


def test_result_forces_flush(sell):
    """A consumer demanding a pending result outranks the flush policy."""
    ref, port = run_both(_result_forces_flush, sell)
    assert_same_record(ref, port)
    assert port["before"] is False and port["after"] == [True, True]
    assert port["shape"] == (sell.shape[0],) and port["pending"] == 0


# --- deadline flush ----------------------------------------------------------

def _deadline_pump(side, sell):
    clock = FakeClock()
    srv = served(side, sell, clock)
    futs = srv.submit_many("hh", side.requests(sell.shape[1], 2, seed=3))
    early = srv.pump()                            # deadline not elapsed: no-op
    before = futs[0].done()
    clock.advance(61.0)
    late = srv.pump()                             # the oldest request is overdue
    return {"early": early, "before": before, "late": late,
            "after": [f.done() for f in futs], "y": [side.arr(f.result()) for f in futs],
            "stats": srv.stats()}


def test_deadline_flush_via_pump(sell):
    ref, port = run_both(_deadline_pump, sell)
    assert_same_record(ref, port)
    assert (port["early"], port["before"], port["late"]) == (0, False, 2)
    assert port["after"] == [True, True]
    st = port["stats"]["hh"]
    assert st["batches"] == 1 and st["padding_ratio"] == pytest.approx(0.5)


def _deadline_submit(side, sell):
    clock = FakeClock()
    srv = served(side, sell, clock)
    xs = side.requests(sell.shape[1], 2, seed=4)
    f0 = srv.submit("hh", xs[0])
    clock.advance(61.0)
    f1 = srv.submit("hh", xs[1])
    return {"done": [f0.done(), f1.done()], "y": [side.arr(f0.result()), side.arr(f1.result())],
            "stats": srv.stats()}


def test_deadline_flush_on_submit(sell):
    """An overdue queue flushes as soon as the next submission arrives; the
    newcomer rides along in the same batch."""
    ref, port = run_both(_deadline_submit, sell)
    assert_same_record(ref, port)
    assert port["done"] == [True, True]
    assert port["stats"]["hh"]["mean_batch_width"] == 2.0


# --- backpressure and bad requests -------------------------------------------

def _backpressure(side, sell):
    srv = served(side, sell)
    srv.register("capped", side.mat(sell), max_batch=8, max_pending=3)
    xs = side.requests(sell.shape[1], 4, seed=5)
    futs = [srv.submit("capped", x) for x in xs[:3]]
    try:
        srv.submit("capped", xs[3])
        raised = None
    except side.serve.BackpressureError as e:
        raised = type(e).__name__
    st_shed = srv.stats()["capped"]
    drained = srv.flush("capped")                 # a drain recovers the queue
    srv.submit("capped", xs[3])
    return {"raised": raised, "requests_shed": st_shed["requests"],
            "pending_shed": st_shed["pending"], "drained": drained,
            "y": [side.arr(f.result()) for f in futs], "stats": srv.stats()}


def test_backpressure_cap(sell):
    ref, port = run_both(_backpressure, sell)
    assert_same_record(ref, port)
    assert port["raised"] == "BackpressureError"
    assert port["requests_shed"] == 3 and port["pending_shed"] == 3
    assert port["drained"] == 3 and port["stats"]["capped"]["requests"] == 4
    assert port["stats"]["capped"]["shed"] == 1


def _bad_shape(side, sell):
    srv = served(side, sell)
    futs = srv.submit_many("hh", side.requests(sell.shape[1], 2, seed=9))
    try:
        srv.submit("hh", side.vec(np.zeros(sell.shape[1] + 1, np.float32)))
        raised = None
    except ValueError as e:
        raised = "expected" in str(e)
    pending, requests = srv.pending("hh"), srv.stats()["hh"]["requests"]
    return {"raised": raised, "pending": pending, "requests": requests,
            "flushed": srv.flush("hh"), "done": [f.done() for f in futs],
            "y": [side.arr(f.result()) for f in futs], "stats": srv.stats()}


def test_bad_shape_rejected_at_submit(sell):
    """A wrong-shaped request fails at its own caller and leaves the queue
    and its valid futures untouched."""
    ref, port = run_both(_bad_shape, sell)
    assert_same_record(ref, port)
    assert port["raised"] is True
    assert (port["pending"], port["requests"], port["flushed"]) == (2, 2, 2)
    assert port["done"] == [True, True]


def test_request_on_another_device_rejected_at_submit(sell):
    """The port also refuses a tensor that is not on the plan's device, at
    the caller, before it can reach a batch."""
    srv = served(PORT, sell)
    x = PORT.requests(sell.shape[1], 1)[0].to("meta")
    with pytest.raises(ValueError, match="this plan runs on cpu"):
        srv.submit("hh", x)
    assert srv.pending("hh") == 0 and srv.stats()["hh"]["requests"] == 0


# --- fast path ---------------------------------------------------------------

def _width1(side, sell, dtype):
    srv = served(side, sell)
    srv.register("solo", side.mat(sell), max_batch=1)
    x = side.requests(sell.shape[1], 1, seed=6, dtype=dtype)[0]
    fut = srv.submit("solo", x)
    done = fut.done()                             # synchronous: no queueing
    y, y_plan = side.arr(fut.result()), side.arr(srv.plan("solo")(x))
    return {"done": done, "bitwise_plan": bool(np.array_equal(y, y_plan)), "y": [y],
            "stats": srv.stats()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_width1_fast_path_is_exactly_plan(sell, dtype):
    """A width-1 policy executes exactly ``plan(x)``: bit for bit."""
    ref, port = run_both(_width1, sell, dtype, dtype=dtype)
    assert_same_record(ref, port, dtype)
    assert port["done"] and port["bitwise_plan"]
    st = port["stats"]["solo"]
    assert st["fast_path_calls"] == 1 and st["batches"] == 0


# --- policy + stats ----------------------------------------------------------

def _default_width(side, sell):
    srv = side.server(backend="auto")
    srv.register("hh", side.mat(sell))
    return {"stats": srv.stats()}


def test_default_width_comes_from_perfmodel(sell):
    ref, port = run_both(_default_width, sell)
    assert_same_record(ref, port)
    want = RPM.select_batch_width(sell, chip=REF_HOST)
    got = PM.select_batch_width(to_port(sell), chip=PORT_HOST, backend="torch")
    assert port["stats"]["hh"]["batch_width"] == got.width == want.width > 1
    assert got.width in got.widths and got.saturation >= 0.9


def test_default_chip_is_the_h100_and_prices_the_spmm_kernel(sell):
    """With no ``chip`` the port prices the H100 data sheet, in the stream
    regime of the SpMM kernel the flush runs."""
    srv = BatchingSpMVServer(device="cpu")
    report = srv.register("hh", to_port(sell))
    assert srv.chip is H100 and report.spmm_kernel == "torch"
    plan = srv.plan("hh")
    choice = PM.select_batch_width(plan.matrix, chip=H100, backend="torch")
    assert srv.stats()["hh"]["batch_width"] == choice.width > 1


def _direct_and_batched(side, sell):
    srv = served(side, sell)
    xs = side.requests(sell.shape[1], 4, seed=7)
    y1 = srv.spmv("hh", xs[0])                    # direct single query
    X3 = side.vec(np.stack([side.arr(x) for x in xs[:3]], axis=1))
    Y3 = srv.spmm("hh", X3)                       # a caller-assembled batch of 3
    futs = srv.submit_many("hh", xs)              # one width-4 batched flush
    return {"y_direct": [side.arr(y1)] + [side.arr(Y3)[:, j] for j in range(3)],
            "y": [side.arr(f.result()) for f in futs], "stats": srv.stats()}


def test_stats_count_direct_and_batched_paths(sell):
    ref, port = run_both(_direct_and_batched, sell)
    assert_same_record(ref, port)
    st = port["stats"]["hh"]
    assert st["requests"] == 4                    # only submits are requests
    assert st["calls"] == 1 + 3 + 4
    assert st["batches"] == 2                     # caller spmm + batcher flush
    assert st["mean_batch_width"] == pytest.approx((3 + 4) / 2)


# --- what only the port has ----------------------------------------------------

def test_server_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchingSpMVServer()
    assert BatchingSpMVServer(device="cpu").device == torch.device("cpu")


#: the reference's plan-report label -> the port's, for the ladder's start
LADDER_START = (("xla", "torch"), ("pallas", "cuda"), ("loop", "loop"))


def _ladder_matrices():
    from _torch_parity import ref_matrix
    sur, blk = ref_matrix("surrogate600"), ref_matrix("blocksparse")
    return {"csr": sur, "coo": sur.to_coo(), "ell": RF.convert(sur, "ell"),
            "jds": RF.convert(sur, "jds"), "sell": RF.convert(sur, "sell", C=8),
            "dia": RF.convert(ref_matrix("laplace24"), "dia"),
            "hybrid": RF.convert(sur, "hybrid"),
            "matrix_free": RF.convert(ref_matrix("exact3"), "matrix_free"),
            "bsr": RF.convert(blk, "bsr", block_shape=(8, 128))}


@pytest.mark.parametrize("labels", LADDER_START, ids=lambda p: p[1])
@pytest.mark.parametrize("fmt", ("csr", "coo", "ell", "jds", "sell", "dia", "hybrid",
                                 "matrix_free", "bsr"))
def test_degradation_ladder_matches_reference(fmt, labels):
    """The rungs below a plan's backend, on both registries: the reference's
    ``pallas_interpret`` has no counterpart (the port's kernels do not run
    off the card) and ``xla`` is the port's ``torch``.  Below a card kernel
    the port offers no rung where the reference steps its Pallas kernel
    down: a failing kernel is never answered for by its plain version."""
    ref_label, port_label = labels
    ref_m = _ladder_matrices()[fmt]
    want = RRES.degradation_ladder(fmt, ref_label, ref_m)
    got = PRES.degradation_ladder(fmt, port_label, to_port(ref_m), torch.device("cpu"))
    if port_label == "cuda":
        assert "xla" in want and got == []
    else:
        assert got == [{"xla": "torch"}.get(b, b) for b in want if b != "pallas_interpret"]
    assert got == {"cuda": [], "torch": ["loop_reference"], "loop": []}[port_label]


def test_coalesce_is_one_contiguous_padded_operand():
    rows = torch.arange(1.0, 16.0, dtype=torch.float64).reshape(3, 5)
    X, n_pad = coalesce(rows, 4, True)
    assert n_pad == 1 and X.shape == (5, 4) and X.is_contiguous()
    assert X.dtype == torch.float64 and X.device == rows.device
    assert torch.equal(X[:, :3], rows.t()) and not X[:, 3].any()
    X2, n_pad2 = coalesce(rows, 4, False)
    assert n_pad2 == 0 and X2.shape == (5, 3) and X2.is_contiguous()
    assert torch.equal(X2, rows.t())


def test_submit_copies_the_request(sell):
    """A request written over in place after ``submit`` is still answered
    for the vector that was submitted (the caller may reuse its buffer)."""
    srv = served(PORT, sell)
    xs = PORT.requests(sell.shape[1], 3, seed=5, dtype=np.float64)
    clean = srv.submit_many("hh", [x.clone() for x in xs])
    assert srv.flush("hh") == 3
    want = [f.result() for f in clean]
    futs = srv.submit_many("hh", xs)
    for x in xs:
        x.mul_(-3.0).add_(1.0)
    assert srv.flush("hh") == 3
    for f, w in zip(futs, want):
        assert torch.equal(f.result(), w)


def test_staging_promotes_a_mixed_batch_like_a_stack(sell):
    """An f32 and an f64 request in one batch run as f64, as a stack of the
    two would; the next batch's first request sets its dtype afresh."""
    srv = served(PORT, sell)
    x32, x64 = PORT.requests(sell.shape[1], 2, seed=6, dtype=np.float32)
    x64 = x64.double()
    futs = srv.submit_many("hh", [x32, x64])
    srv.flush("hh")
    plan = srv.plan("hh")
    assert [f.result().dtype for f in futs] == [torch.float64] * 2
    assert torch.allclose(futs[0].result(), plan(x32.double()), rtol=1e-12, atol=1e-12)
    f = srv.submit("hh", x32)
    srv.flush("hh")
    assert f.result().dtype == plan(x32).dtype


@pytest.mark.parametrize("backend,pads", [("torch", True), ("loop_reference", False)])
def test_a_column_by_column_spmm_is_never_padded(sell, backend, pads):
    """A partial flush is padded only when the plan's SpMM streams the
    operator once for all columns: the loop entry runs one SpMV a column,
    so a zero column would cost a whole SpMV."""
    srv = PORT.server(backend=backend, max_batch=4, deadline_s=60.0)
    srv.register("hh", PORT.mat(sell))
    assert srv.plan("hh").spmm_by_columns is not pads
    xs = PORT.requests(sell.shape[1], 3, seed=7, dtype=np.float64)
    futs = srv.submit_many("hh", xs)
    srv.flush("hh")
    st = srv.stats()["hh"]
    assert st["padding_ratio"] == (0.25 if pads else 0.0) and st["batches"] == 1
    for x, f in zip(xs, futs):
        assert torch.allclose(f.result(), srv.plan("hh")(x), rtol=1e-12, atol=1e-12)


def test_futures_are_column_views_and_the_verdict_waits_for_a_consumer(sell):
    """A flush hands each future a view of its column of Y (no copy) and
    leaves the finiteness verdict on the device: the first ``result()``
    reads it for the whole batch."""
    srv = served(PORT, sell)
    futs = srv.submit_many("hh", PORT.requests(sell.shape[1], 4, seed=11))
    shared = futs[0]._check[0]
    assert all(f._check[0] is shared for f in futs) and shared["host"] is None
    assert isinstance(shared["vec"], torch.Tensor) and shared["vec"].shape == (4,)
    ys = [f.result() for f in futs]
    assert shared["host"] == [True] * 4
    base = ys[0].untyped_storage().data_ptr()
    assert all(y.untyped_storage().data_ptr() == base for y in ys)
    assert [y.storage_offset() for y in ys] == [0, 1, 2, 3] and ys[0].stride() == (4,)
