"""Micro-batching primitives: futures, per-operator queues, the coalescer.

Port of ``repro.serve.batching``.  The paper's bound is per pass: one SpMV
streams the whole matrix and saturates at BW / balance.  A serving layer
beats that ceiling only by paying the matrix stream once for many requests:
gather k concurrent ``y = A @ x`` requests for one operator and execute
them as a single ``plan.spmm(X)`` (``perfmodel.spmm_balance_of``).

This module holds the mechanism; the policy (which width, which deadline)
and the operator registry live in ``serve.engine.BatchingSpMVServer``.
Everything is cooperative and single-threaded: batches are flushed by
``submit`` (width reached / deadline elapsed), by ``pump()``, or by a
consumer demanding a ``result()``.

``submit`` copies each request into a row of the queue's staging block,
so the caller may reuse or overwrite its vector as soon as ``submit``
returns.  A flush runs eagerly on the plan's device: one contiguous
``(n, width)`` operand transposed out of that block (:func:`coalesce`), the
plan's SpMM, and the per-column finiteness verdict as one reduction whose
result stays on the device until the first ``result()`` / ``error()`` of
the batch reads it.  Each future's value is a column *view* of the batch
result ``Y``: it shares storage with its batch-mates, and writing into it
writes into theirs.

``submit`` and ``flush`` are the ``serve.submit`` / ``serve.flush`` spans
(``utils.spans``), each carrying the number of the flush that takes the
request.  Every request a flush takes, answered or shed, has its wait in
the queue counted: summed per queue (``QueueStats.queue_wait_s``) and in
one histogram over every queue (:func:`queue_wait_counts`).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import torch

from ..core.validate import validate_vector
from ..testing import faults
from ..utils.spans import span
from .resilience import CircuitBreaker, KernelFault, ResiliencePolicy, execute_flush


class BackpressureError(RuntimeError):
    """Raised when an operator's pending queue is at its ``max_pending`` cap.

    The cap bounds queue memory under open-loop overload: shedding the
    request at submission time is the only backpressure signal a cooperative
    (thread-free) batcher can give its callers.
    """


class SpMVFuture:
    """Handle for one submitted request; resolves when its batch executes.

    ``result()`` never deadlocks: if the batch is still pending, it forces a
    flush of the owning operator queue.  A future can resolve with a
    structured error instead of a value (``serve.resilience``): ``done()``
    is then still True, ``error()`` returns the carried exception, and
    ``result()`` raises it.  A batched value is a column view of the batch
    result and shares storage with its batch-mates.
    """

    __slots__ = ("_queue", "_value", "_error", "_done", "_check")

    def __init__(self, queue: "OperatorQueue"):
        self._queue = queue
        self._value = None
        self._error = None
        self._done = False
        self._check = None  # deferred finiteness verdict: (shared, column)

    def done(self) -> bool:
        """True once the owning batch has executed (value OR error)."""
        return self._done

    def error(self) -> BaseException | None:
        """The structured error this request failed with, or None."""
        if not self._done:
            self._queue.flush()
        self._materialize()
        return self._error

    def result(self) -> torch.Tensor:
        """The request's ``y = A @ x``, flushing its batch if needed.

        Raises the request's structured error (``RequestError`` subclass --
        ``KernelFault``, ``DeadlineExceeded``) when the request failed.
        """
        if not self._done:
            self._queue.flush()
        self._materialize()
        if self._error is not None:
            raise self._error
        return self._value

    def _materialize(self) -> None:
        """Settle a deferred finiteness verdict (see ``_resolve_checked``).

        The batch's verdict vector is read on the host exactly once -- by
        the first consumer, who has to wait for the device anyway -- and
        shared with every batch-mate; a non-finite column flips this future
        to a ``KernelFault`` and does the stats/breaker bookkeeping the
        flush deferred.
        """
        if self._check is None:
            return
        shared, i = self._check
        self._check = None
        if shared["host"] is None:
            shared["host"] = shared["vec"].tolist()
        if not shared["host"][i]:
            queue = shared["queue"]
            self._value = None
            self._error = KernelFault(
                "batch column came back non-finite (kernel fault, or a "
                "NaN/Inf request that bypassed validation)",
                op="spmm", kernel=shared["kernel"], nonfinite=True)
            queue.stats.failed += 1
            queue.breaker.record_failure()

    def _resolve(self, value: torch.Tensor) -> None:
        self._value = value
        self._done = True
        self._queue = None  # drop the back-reference once resolved

    def _resolve_checked(self, value: torch.Tensor, shared: dict, i: int) -> None:
        """Resolve with a batch-shared verdict not yet read on the host.

        ``shared`` holds the device-side per-column verdict of this
        future's batch (``{"vec", "host", "queue", "kernel"}``); reading it
        in the flush would make every flush wait for the device, so the
        read rides on the first ``result()`` / ``error()`` instead.
        """
        self._value = value
        self._check = (shared, i)
        self._done = True
        self._queue = None

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._done = True
        self._queue = None


@dataclass(frozen=True)
class BatchPolicy:
    """When to flush an operator's queue, and how to shape partial batches.

    Attributes:
        width: flush as soon as this many requests are queued.  The serving
            layer derives it from the SpMM roofline
            (``perfmodel.select_batch_width``) unless overridden.
        deadline_s: flush when the oldest queued request has waited this
            long -- bounds latency when traffic is too thin to fill a batch.
        pad_to_width: execute partial batches padded with zero columns up to
            ``width``, so the SpMM always runs at one width (one K tiling of
            the kernel); the padding is accounted in the stats.  A plan
            whose SpMM runs one column at a time is never padded
            (``OperatorQueue.pads``).
        max_pending: queue-length cap; ``submit`` raises
            ``BackpressureError`` beyond it.
    """

    width: int
    deadline_s: float = 1e-3
    pad_to_width: bool = True
    max_pending: int = 256


#: the queue-wait histogram: ``QUEUE_WAIT_BINS`` bins of ``QUEUE_WAIT_BIN_S``
#: (50 us to 10 ms), then one bin for every longer wait
QUEUE_WAIT_BIN_S = 50e-6
QUEUE_WAIT_BINS = 200
_QUEUE_WAITS = [0] * (QUEUE_WAIT_BINS + 1)


def queue_wait_counts() -> list:
    """Copy of the queue-wait histogram over every queue of the process:
    bin i counts the waits in ``[i, i + 1) * QUEUE_WAIT_BIN_S``, the last
    bin every wait of ``QUEUE_WAIT_BINS * QUEUE_WAIT_BIN_S`` or more."""
    return list(_QUEUE_WAITS)


def reset_queue_wait_counts() -> None:
    _QUEUE_WAITS[:] = [0] * len(_QUEUE_WAITS)


def queue_wait_quantile(q: float) -> float:
    """The upper edge of the histogram's bin that holds its ``q``-quantile, in
    seconds: infinite in the last bin, NaN when nothing was counted."""
    counts = queue_wait_counts()
    total = sum(counts)
    if not total:
        return float("nan")
    rank, seen = q * total, 0
    for i, c in enumerate(counts):
        seen += c
        if c and seen >= rank:
            break
    return (i + 1) * QUEUE_WAIT_BIN_S if i < QUEUE_WAIT_BINS else float("inf")


@dataclass
class QueueStats:
    """Per-operator serving counters.

    ``calls`` counts queries answered (batched requests + direct spmv/spmm
    calls); padding columns are streamed work, not queries, so they appear
    only in ``padding_ratio``.
    """

    requests: int = 0          # submitted through the batcher
    calls: int = 0             # queries answered (batched + direct paths)
    batches: int = 0           # spmm flushes executed
    batched_columns: int = 0   # real columns across all flushes
    padded_columns: int = 0    # zero columns streamed for shape stability
    fast_path_calls: int = 0   # width-1 submits executed as plan(x)
    shed: int = 0              # rejected at submit (backpressure cap)
    retried: int = 0           # batch re-executions (transient faults)
    degraded: int = 0          # backend-ladder steps taken by the breaker
    deadline_missed: int = 0   # requests shed with DeadlineExceeded
    failed: int = 0            # requests resolved with a structured error
    queue_wait_s: float = 0.0  # enqueue to the flush that took it, summed

    def record_wait(self, waited: float) -> None:
        """Account one request's wait in the queue, from its enqueue to the
        flush that took it (answered or shed): here and in the histogram of
        every queue (:func:`queue_wait_counts`)."""
        self.queue_wait_s += waited
        _QUEUE_WAITS[min(int(waited / QUEUE_WAIT_BIN_S), QUEUE_WAIT_BINS)] += 1

    def record_batch(self, k: int, n_pad: int = 0) -> None:
        """Account one executed batch of k real columns (+ n_pad zeros) --
        the single bookkeeping point for batcher flushes and direct spmm."""
        self.batches += 1
        self.batched_columns += k
        self.padded_columns += n_pad
        self.calls += k

    @property
    def mean_batch_width(self) -> float:
        """Mean real (unpadded) width over executed batches."""
        return self.batched_columns / self.batches if self.batches else 0.0

    @property
    def padding_ratio(self) -> float:
        """Padded columns / streamed columns (0.0 = every column was real)."""
        streamed = self.batched_columns + self.padded_columns
        return self.padded_columns / streamed if streamed else 0.0


def coalesce(rows: torch.Tensor, width: int,
             pad_to_width: bool) -> tuple[torch.Tensor, int]:
    """Lay k staged requests out as one SpMM operand.

    Args:
        rows: (k, n) the request vectors as rows, in arrival order (the
            queue's staging block).
        width: the policy width to pad up to.
        pad_to_width: whether partial batches get zero columns appended.

    Returns:
        (X, n_pad): X a contiguous (n, k + n_pad) tensor on the rows'
        device, requests as columns, the padding columns zero: the layout
        the SpMM kernel reads without a copy of its own, written by one
        transposing copy.
    """
    k, n = rows.shape
    n_pad = width - k if (pad_to_width and k < width) else 0
    X = rows.new_empty((n, k + n_pad))
    X[:, :k] = rows.t()
    if n_pad:
        X[:, k:] = 0
    return X, n_pad


class OperatorQueue:
    """Pending requests for one registered operator + its flush machinery.

    Holds the compiled plan, the flush policy, the stats counters and the
    robustness state: the request-validation policy, the resilience policy
    + circuit breaker, and the backend degradation ladder
    (``rebuild(backend)`` recompiles the operator one rung down when the
    breaker trips -- see ``serve.resilience``).
    """

    def __init__(self, plan, policy: BatchPolicy, clock, *,
                 validate: str = "off", resilience=None,
                 rebuild=None, ladder=()):
        self.plan = plan
        self.policy = policy
        self._clock = clock
        self._validate = validate
        self.resilience = resilience if resilience is not None else (
            ResiliencePolicy())
        self._rebuild = rebuild
        self.ladder = list(ladder)
        self.breaker = CircuitBreaker(self.resilience.breaker_threshold)
        self._n_cols = int(plan.report.shape[1])
        self._pending: deque = deque()  # (future, t_enqueue, timeout_s)
        self._rows = None  # staging block: pending request i is row i
        self._flush_seq = 0  # the number of the next flush
        self.stats = QueueStats()

    def __len__(self) -> int:
        return len(self._pending)

    # -- submission ---------------------------------------------------------

    def submit(self, x, *, timeout_s: float | None = None) -> SpMVFuture:
        """Enqueue one request; flush if the policy says the batch is due.

        ``x`` is a tensor on the plan's device (a numpy array is moved
        there).  It is copied into the queue's staging block, so the caller
        may overwrite it once this returns.  ``timeout_s`` overrides the
        resilience policy's per-request deadline for this request (None
        keeps the default).
        """
        with span("serve.submit", self._flush_seq):
            # reject bad requests at the offending caller: a bad shape, a tensor
            # on another device (or, under validate="strict", a NaN/Inf payload)
            # reaching flush would poison the whole batch.  When the resilient
            # flush runs the per-column finiteness check, the strict per-request
            # read of a verdict (one wait for the device per submit) is left to
            # it: a non-finite request then fails its own future at flush.
            defer = (self.policy.width > 1 and self.resilience.enabled
                     and self.resilience.check_finite)
            x = validate_vector(self.plan._operand(x, "x"), self._n_cols,
                                policy=self._validate, defer_finite=defer)
            self.stats.requests += 1
            if self.policy.width <= 1:
                # fast path: a width-1 policy means batching cannot amortize
                # anything -- execute exactly what plan(x) would, synchronously
                fut = SpMVFuture(self)
                fut._resolve(self.plan.spmv(x))
                self.stats.fast_path_calls += 1
                self.stats.calls += 1
                return fut
            try:
                faults.fire("serve.queue_full", ctx={"pending": len(self._pending)},
                            clock=self._clock)
                full = len(self._pending) >= self.policy.max_pending
            except BackpressureError:
                full = True
            if full:
                self.stats.requests -= 1  # shed: the request was not admitted
                self.stats.shed += 1
                raise BackpressureError(
                    f"{len(self._pending)} pending requests at the "
                    f"max_pending={self.policy.max_pending} cap; drain with "
                    f"pump()/flush() or raise the cap")
            fut = SpMVFuture(self)
            self._stage(x, len(self._pending))
            self._pending.append((fut, self._clock(), timeout_s))
            if len(self._pending) >= self.policy.width or self._deadline_elapsed():
                self.flush()
            return fut

    def _stage(self, x: torch.Tensor, i: int) -> None:
        """Copy request ``x`` into row ``i`` of the staging block.

        The block has ``width`` rows (a flush is due at ``width`` pending
        requests) and the dtype the batch's requests promote to, as a stack
        of them would have; a batch's first request sets it afresh.
        """
        rows = self._rows
        dtype = x.dtype if i == 0 else torch.promote_types(rows.dtype, x.dtype)
        if rows is None or rows.dtype != dtype:
            fresh = x.new_empty((self.policy.width, x.shape[0]), dtype=dtype)
            if i:
                fresh[:i] = rows[:i]
            self._rows = rows = fresh
        rows[i] = x

    # -- flushing -----------------------------------------------------------

    def pads(self) -> bool:
        """Whether a partial batch is padded to the policy width: only when
        the plan's SpMM streams the operator once for all its columns.  An
        SpMM run one column at a time (``SpMVPlan.spmm_by_columns``) would
        pay a whole SpMV for every zero column."""
        return self.policy.pad_to_width and not self.plan.spmm_by_columns

    def _deadline_elapsed(self) -> bool:
        if not self._pending:
            return False
        return self._clock() - self._pending[0][1] >= self.policy.deadline_s

    def due(self) -> bool:
        """True when the policy wants a flush (width reached or deadline)."""
        return (len(self._pending) >= self.policy.width
                or self._deadline_elapsed())

    def flush(self) -> int:
        """Execute all pending requests as one (padded) SpMM; resolve futures.

        The execution is delegated to the resilience layer
        (``serve.resilience.execute_flush``): every drained future resolves
        with a value or a structured error; with resilience disabled the
        legacy behaviour (exceptions propagate, batch stranded) applies.

        Returns:
            The number of real requests answered (0 if the queue was empty).
        """
        if not self._pending:
            return 0
        with span("serve.flush", self._flush_seq):
            self._flush_seq += 1
            entries = list(self._pending)
            self._pending.clear()
            return execute_flush(self, self._rows[:len(entries)], entries)

    # -- degradation ---------------------------------------------------------

    def degrade(self) -> bool:
        """Step the operator one rung down its backend ladder.

        Called by the resilience layer when the circuit breaker trips.
        Recompiles the plan on the next ladder backend (via the ``rebuild``
        closure the server registered) and resets the breaker so the new
        backend gets a full failure budget.

        Returns:
            True when a degrade happened; False when the ladder is empty
            or the operator was registered without a rebuild hook.
        """
        if not self.ladder or self._rebuild is None:
            return False
        backend = self.ladder.pop(0)
        try:
            self.plan = self._rebuild(backend)
        except Exception:  # noqa: BLE001 - a rung that fails to build is skipped
            return self.degrade()
        self.stats.degraded += 1
        self.breaker.failures = 0
        return True
