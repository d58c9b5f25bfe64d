"""Resilience for the serving stack: structured errors, deadlines, retry
with poison isolation, and a circuit breaker that degrades the backend.

Port of ``repro.serve.resilience``.  The batching layer
(``serve.batching``) coalesces k requests into one SpMM, which makes the
failure domain k requests wide.  This module shrinks it back to one
request:

* **Structured errors** -- :class:`RequestError` and its subclasses are
  carried on the future (``SpMVFuture.result()`` re-raises them), so one
  bad request reports its own failure and its batch-mates resolve normally.
* **Deadline-aware shedding** -- a request older than
  ``ResiliencePolicy.request_timeout_s`` at flush time is resolved with
  :class:`DeadlineExceeded` instead of being executed.
* **Retry with split** -- a flush whose kernel raises is retried
  (``max_retries``, with ``retry_backoff_s`` waited through the injectable
  clock); if it still fails and the batch has more than one request, it is
  split in half and each half retried on its own, so O(log k) extra
  executions isolate a poison request.  A persistent single-request
  failure becomes a :class:`KernelFault` on exactly that future.
* **Non-finite isolation** -- after a successful execution the batch result
  is checked per column (``core.validate.check_finite_columns``: one
  reduction, left on the plan's device and read on the host by the first
  consumer, so the flush itself never waits for the card); a poisoned
  column fails its own future with :class:`KernelFault`.
* **Circuit breaker + degradation ladder** -- ``breaker_threshold``
  consecutive kernel failures trip the operator's breaker, which recompiles
  its plan one step down the backend ladder (``torch -> loop_reference``,
  filtered through the kernel registry's probes on the plan's device).  A
  plan on a card kernel has no rung below it: a failing ``cuda`` kernel is
  never answered for by its plain version, so its persistent failure ends
  in a :class:`KernelFault` on each affected request.  The ladder is
  finite, so is the recovery loop.

Everything here is cooperative and synchronous, like the batcher it guards:
no threads, and backoff goes through the injectable clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from ..core.validate import check_finite_columns
from ..kernels import registry as R
from ..testing import faults


class RequestError(RuntimeError):
    """Base of per-request serving failures carried on an ``SpMVFuture``."""


class KernelFault(RequestError):
    """The kernel raised, or produced a non-finite result, for this request.

    Attributes:
        op: "spmv" | "spmm" -- the executing operation.
        kernel: the plan's SpMM label at the time of the fault ("cuda" |
            "torch" | "loop").
        nonfinite: True when the fault was a NaN/Inf result rather than an
            exception (the exception case chains the cause).
    """

    def __init__(self, message: str, *, op: str = "spmm", kernel: str = "?",
                 nonfinite: bool = False):
        super().__init__(message)
        self.op = op
        self.kernel = kernel
        self.nonfinite = nonfinite


class DeadlineExceeded(RequestError):
    """The request out-waited its deadline and was shed unexecuted.

    Attributes:
        waited_s: how long the request had been queued at flush time.
        timeout_s: the deadline it exceeded.
    """

    def __init__(self, waited_s: float, timeout_s: float):
        super().__init__(
            f"request shed after waiting {waited_s:.6f}s "
            f"(> request_timeout_s={timeout_s:.6f}s); it was never executed")
        self.waited_s = waited_s
        self.timeout_s = timeout_s


@dataclass(frozen=True)
class ResiliencePolicy:
    """Per-operator knobs for the resilient flush path.

    Attributes:
        enabled: master switch.  Off, ``flush`` executes the legacy way --
            exceptions propagate and strand the batch (the guardrails-off
            side of an overhead measurement).
        max_retries: whole-batch re-executions after a kernel exception
            before the batch is split.
        retry_backoff_s: waited through the queue's clock before each
            retry (``clock.advance`` when the clock has one, otherwise a
            real sleep of at most 0.1 s).
        breaker_threshold: consecutive failed executions that trip the
            operator's circuit breaker and trigger a backend degrade.
        request_timeout_s: per-request deadline for the shedding check
            (None disables).  ``BatchPolicy.deadline_s`` forces a flush;
            this one abandons requests that already missed their SLO.
        check_finite: per-column finiteness check of every batch result
            (one reduction a flush, read by the first consumer).
    """

    enabled: bool = True
    max_retries: int = 1
    retry_backoff_s: float = 0.0
    breaker_threshold: int = 3
    request_timeout_s: float | None = None
    check_finite: bool = True


class CircuitBreaker:
    """Consecutive-failure counter with a trip threshold (per operator)."""

    def __init__(self, threshold: int):
        self.threshold = max(1, int(threshold))
        self.failures = 0
        self.trips = 0

    def record_failure(self) -> bool:
        """Count one failed execution; True when this one trips the breaker."""
        self.failures += 1
        if self.failures >= self.threshold:
            self.trips += 1
            self.failures = 0
            return True
        return False

    def record_success(self) -> None:
        self.failures = 0


#: registry backends in quality order, best first: everything strictly
#: below a plan's own backend is a legal degrade target, except below
#: ``cuda`` (see ``degradation_ladder``)
_LADDER = ("cuda", "torch", "loop_reference")

#: plan-report kernel label -> its ladder backend
_LABEL_TO_BACKEND = {"cuda": "cuda", "torch": "torch", "loop": "loop_reference"}


def degradation_ladder(fmt: str, kernel_label: str, matrix, device) -> list[str]:
    """Registry backends strictly below ``kernel_label`` for ``fmt``, best
    first: the operator's remaining degrade steps.

    A rung needs both an ``spmv`` and an ``spmm`` entry whose probes accept
    ``matrix`` on ``device`` (the plan's own), so on the host a ``cuda``
    rung is never offered.  A ``cuda`` plan gets no rung at all: the plain
    versions below it would hide a kernel that fails on the card, so such a
    failure stays a ``KernelFault`` (the reference steps its Pallas kernel
    down to ``xla``).
    """
    cur = _LABEL_TO_BACKEND.get(kernel_label, "torch")
    if cur == "cuda":
        return []
    ctx = R.KernelContext(device=device)
    out = []
    for be in _LADDER[_LADDER.index(cur) + 1:]:
        if all(R.has(fmt, op, be) and R.get(fmt, op, be).probe(matrix, ctx).ok
               for op in ("spmv", "spmm")):
            out.append(be)
    return out


def _wait(clock, seconds: float) -> None:
    """Back off through the injectable clock (deterministic in tests)."""
    if seconds <= 0:
        return
    if hasattr(clock, "advance"):
        clock.advance(seconds)
    else:  # the real clock: a genuine, bounded backoff sleep
        time.sleep(min(seconds, 0.1))


# ---------------------------------------------------------------------------
# the resilient flush
# ---------------------------------------------------------------------------


def execute_flush(queue, rows, entries: list) -> int:
    """Resolve every drained request of one flush, come what may.

    ``rows`` is the ``(k, n)`` staging block holding the k drained requests
    as rows, and ``entries`` their ``[(future, t_enqueue,
    timeout_override)]`` in the same order.  Every future is resolved by the
    time this returns -- with a value, or with a structured
    :class:`RequestError` -- and the return value is the number of requests
    answered.

    Raises only when the resilience policy is disabled (the legacy
    behaviour: the exception propagates and the batch is stranded).  Each
    request's wait in the queue is accounted (``QueueStats.record_wait``),
    a request shed for its deadline too.
    """
    pol = queue.resilience
    clock = queue._clock
    futs = [e[0] for e in entries]
    now = clock()

    if not pol.enabled:
        for _, t0, _ in entries:
            queue.stats.record_wait(now - t0)
        faults.fire("serve.flush", ctx={"k": len(futs)}, clock=clock)
        _resolve_batch(queue, rows, futs, check_finite=False)
        return len(futs)

    # 1. deadline-aware shedding: abandon requests that already missed
    #    their SLO instead of spending a matrix stream on them
    live = []
    for i, (fut, t0, override) in enumerate(entries):
        limit = override if override is not None else pol.request_timeout_s
        waited = now - t0
        queue.stats.record_wait(waited)
        if limit is not None and waited > limit:
            fut._fail(DeadlineExceeded(waited, limit))
            queue.stats.deadline_missed += 1
        else:
            live.append(i)
    if len(live) < len(entries) and live:
        rows = rows[live]  # a copy of the survivors, in arrival order
    if live:
        _run(queue, rows, [futs[i] for i in live], pol, attempt=0)
    return len(entries)


def _run(queue, rows, futs, pol: ResiliencePolicy, attempt: int) -> None:
    """Execute one (sub-)batch with retry, split, breaker and degrade."""
    try:
        faults.fire("serve.flush", ctx={"k": len(futs)}, clock=queue._clock)
        _resolve_batch(queue, rows, futs, check_finite=pol.check_finite)
        return
    except Exception as e:  # noqa: BLE001 - any kernel/runtime fault
        tripped = queue.breaker.record_failure()
        if tripped and queue.degrade():
            # the world changed (new backend): retry at the same attempt;
            # the ladder is finite, so this cannot loop forever
            queue.stats.retried += 1
            return _run(queue, rows, futs, pol, attempt)
        if attempt < pol.max_retries:
            _wait(queue._clock, pol.retry_backoff_s * (2 ** attempt))
            queue.stats.retried += 1
            return _run(queue, rows, futs, pol, attempt + 1)
        if len(futs) > 1:
            # retries exhausted: split to isolate the poison request; the
            # halves get no fresh whole-batch retries (bounded work)
            mid = len(futs) // 2
            _run(queue, rows[:mid], futs[:mid], pol, attempt=pol.max_retries)
            _run(queue, rows[mid:], futs[mid:], pol, attempt=pol.max_retries)
            return
        fault = KernelFault(
            f"kernel failed for this request after retries: "
            f"{type(e).__name__}: {e}",
            op="spmm", kernel=queue.plan.report.spmm_kernel)
        fault.__cause__ = e
        futs[0]._fail(fault)
        queue.stats.failed += 1


def _resolve_batch(queue, rows, futs, *, check_finite: bool) -> None:
    """One execution: coalesce, ``plan.spmm``, the per-column verdict (left
    on the device), and the futures resolved with column views of Y."""
    from . import batching

    k = len(futs)
    X, n_pad = batching.coalesce(rows, queue.policy.width, queue.pads())
    Y = queue.plan.spmm(X)
    cols = Y[:, :k].unbind(1)
    if check_finite:
        shared = {"vec": check_finite_columns(Y[:, :k]), "host": None,
                  "queue": queue, "kernel": queue.plan.report.spmm_kernel}
        for i, (fut, y) in enumerate(zip(futs, cols)):
            fut._resolve_checked(y, shared, i)
    else:
        for fut, y in zip(futs, cols):
            fut._resolve(y)
    queue.stats.record_batch(k, n_pad)
    queue.breaker.record_success()
