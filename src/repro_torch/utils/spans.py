"""Spans of the port's layers: named host ranges that record only while a
``torch.profiler`` session runs.

``with span("kernel.launch"):`` opens a profiler range of the same name
(``record_function``'s, in its C++ form, ``_RecordFunctionFast``: ~2 us a
range under the profiler against ~14 us), so the span lands in the
profiler's events (name, start, end, the enclosing range as its parent) on
the clock of the device operations it enqueued, and is written out with
the profiler's trace.  It also adds its duration to in-memory totals per
name (:func:`totals`): the count, the total seconds and the self seconds,
the duration less the part its child spans cover (a per-thread stack, the
host's monotonic clock).  A span opened with ``n`` counts ``n`` times over
the same duration: one C call that launches two kernels is one range and
two ``kernel.launch`` counts, so the totals give the host time a launch.

With no profiler running, ``span`` returns one shared object that does
nothing: one check of the profiler's state (~0.1 us), no allocation, no
range (13 us for an unguarded ``record_function``).  So totals cover
exactly what ran under a profiler.

Where each span sits and the benchmark metric that reads it:

* ``plan.operand`` -- ``SpMVPlan.spmv`` / ``.spmm``: the operand, its shape,
  the fault point (``plan_check_us``);
* ``kernel.check`` -- a CUDA wrapper's operand checks before its launch
  (``plan_check_us``);
* ``kernel.launch`` -- ``cuda_build.launch``, through which every kernel
  launches: entry point, device, stream, the ctypes call, its error code
  and the launch counts, counted once a name it counts (a launch record's
  C call for a ``dia``, ``sell`` or ``hybrid`` SpMV on the card counts once
  a kernel it launches) (``launch_host_us``);
* ``lanczos.step`` / ``lanczos.sync`` -- one Lanczos iteration of the
  eager loop, or on the card one replayed CUDA graph of ``K`` steps, and
  its read of the alphas and betas on the host (``lanczos_enqueue_ms``,
  ``lanczos_sync_ms``);
* ``serve.submit`` / ``serve.flush`` -- ``OperatorQueue.submit`` and
  ``.flush``; both carry the number of the flush that takes the request as
  the range's ``flush`` argument (in a trace taken with
  ``record_shapes=True``), so a trace joins a submit to its flush
  (``submit_host_us``, ``flush_host_us``);
* ``operator.build`` -- ``core.matrices.holstein_hubbard_operator``: the
  electron x phonon operator's tables (its ``build_stats`` counter feeds
  ``operator_build_ms``; a build in set-up runs under no profiler).
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

#: every span the port opens
NAMES = frozenset({"plan.operand", "kernel.check", "kernel.launch", "lanczos.step",
                   "lanczos.sync", "serve.submit", "serve.flush", "operator.build"})

_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter
_TOTALS: dict[str, list] = {}     # name -> [count, total seconds, self seconds]
_LOCK = threading.Lock()
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()  # the span while no profiler runs


class _Span:
    __slots__ = ("name", "flush", "n", "_range", "_stack", "_t0", "_children")

    def __init__(self, name: str, flush: int | None, n: int = 1):
        self.name = name
        self.flush = flush
        self.n = n

    def __enter__(self):
        try:
            stack = _LOCAL.stack
        except AttributeError:
            stack = _LOCAL.stack = []
        self._stack = stack
        self._range = (_range(self.name) if self.flush is None
                       else _range(self.name, (), {"flush": self.flush}))
        self._range.__enter__()
        self._children = 0.0
        stack.append(self)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        dt = _clock() - self._t0
        self._range.__exit__(*exc)
        stack = self._stack
        stack.pop()
        if stack:
            stack[-1]._children += dt
        with _LOCK:
            tot = _TOTALS.get(self.name)
            if tot is None:
                tot = _TOTALS[self.name] = [0, 0.0, 0.0]
            tot[0] += self.n
            tot[1] += dt
            tot[2] += dt - self._children
        return False


def span(name: str, flush: int | None = None, n: int = 1):
    """A context manager for the span ``name``; ``flush``, the number of the
    flush a server span belongs to, becomes the range's ``flush`` argument;
    the span counts ``n`` times in :func:`totals`."""
    if not _profiling():
        return _OFF
    return _Span(name, flush, n)


def totals() -> dict:
    """{name: {"n", "total_s", "self_s"}} of the spans recorded so far."""
    with _LOCK:
        return {k: {"n": n, "total_s": t, "self_s": s} for k, (n, t, s) in _TOTALS.items()}


def reset() -> None:
    with _LOCK:
        _TOTALS.clear()
