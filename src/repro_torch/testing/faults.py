"""Deterministic fault injection for the SpMV stack.

Port of ``repro.testing.faults``.  Production code declares named fault
points (:func:`fault_point`) and calls :func:`fire` where they sit -- the
plan's ``plan.spmv`` / ``plan.spmm`` around ``plan(x)`` / ``plan.spmm(X)``.
Disarmed, ``fire`` is one dict lookup.  Tests arm a point with
:func:`inject` (a context manager)::

    with faults.inject("plan.spmv", error=RuntimeError("kernel died")):
        plan(x)                      # raises RuntimeError

Fault kinds (exactly one per injection):

* ``error=exc``        the point raises ``exc`` (an instance or a class);
* ``nonfinite=True``   the call site poisons its result with NaN
  (:func:`poison`) -- a kernel writing garbage without failing;
* ``delay_s=t``        a slow kernel: an injected clock is advanced by
  ``t`` (``clock.advance``), or the process sleeps on the real clock.

``times=N`` (default 1) disarms after N firings; ``times=None`` keeps the
fault armed for the context.  ``when=pred`` fires only where
``pred(ctx)`` holds, ``ctx`` being the call site's dict (op, format,
kernel).  Everything is process-local; :func:`reset` disarms all.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable

#: every declared fault point: name -> description
FAULT_POINTS: dict[str, str] = {}

_ARMED: dict[str, "FaultSpec"] = {}


def fault_point(name: str, description: str) -> str:
    """Declare a named fault point (idempotent); returns the name."""
    FAULT_POINTS.setdefault(name, description)
    return name


@dataclass
class FaultSpec:
    """One armed fault: what happens and how many times."""

    name: str
    error: BaseException | type | None = None
    nonfinite: bool = False
    delay_s: float = 0.0
    times: int | None = 1            # None = every firing while armed
    when: Callable | None = None     # ctx predicate; None = always
    column: int = 0                  # which batch column ``poison`` hits
    fired: int = 0
    log: list = field(default_factory=list)

    def _matches(self, ctx) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        return self.when is None or bool(self.when(ctx or {}))


def armed(name: str) -> FaultSpec | None:
    """The spec currently armed at ``name`` (None when disarmed)."""
    return _ARMED.get(name)


def fire(name: str, ctx: dict | None = None, clock=None) -> FaultSpec | None:
    """Fire the fault armed at ``name``, if any: raise its error, or advance
    the clock (sleep on the real one) for a delay.  Returns the spec of a
    ``nonfinite`` fault (the call site applies :func:`poison`), else None."""
    if not _ARMED:
        return None
    spec = _ARMED.get(name)
    if spec is None or not spec._matches(ctx):
        return None
    spec.fired += 1
    spec.log.append(dict(ctx or {}))
    if spec.delay_s:
        if clock is not None and hasattr(clock, "advance"):
            clock.advance(spec.delay_s)
        else:
            time.sleep(spec.delay_s)
    if spec.error is not None:
        exc = spec.error() if isinstance(spec.error, type) else spec.error
        raise exc
    return spec if spec.nonfinite else None


def poison(y, spec: FaultSpec):
    """A copy of the result tensor ``y`` (on any device) with NaN in its
    first element -- of column ``spec.column`` for a batch result -- the way
    a broken kernel would write it."""
    y = y.clone()
    if y.ndim == 1:
        y[0] = float("nan")
    else:
        y[0, min(spec.column, y.shape[1] - 1)] = float("nan")
    return y


@contextlib.contextmanager
def inject(name: str, *, error=None, nonfinite: bool = False,
           delay_s: float = 0.0, times: int | None = 1,
           when: Callable | None = None, column: int = 0):
    """Arm ``name`` for the duration of the context; yields the spec (its
    ``fired`` counter and ``log`` of ctx dicts show where it fired)."""
    if name not in FAULT_POINTS:
        raise KeyError(f"unknown fault point {name!r}; registered points: "
                       f"{sorted(FAULT_POINTS)}")
    if name in _ARMED:
        raise RuntimeError(f"fault point {name!r} is already armed")
    kinds = (error is not None) + bool(nonfinite) + (delay_s > 0)
    if kinds != 1:
        raise ValueError("arm exactly one of error=, nonfinite=, delay_s=")
    spec = FaultSpec(name=name, error=error, nonfinite=nonfinite,
                     delay_s=delay_s, times=times, when=when, column=column)
    _ARMED[name] = spec
    try:
        yield spec
    finally:
        _ARMED.pop(name, None)


def reset() -> None:
    """Disarm everything (test teardown safety net)."""
    _ARMED.clear()


class ShardDeath(RuntimeError):
    """A device or shard dying mid-collective in a distributed plan, raised
    at the distributed executor's fault point."""

    def __init__(self, part: int = 0):
        super().__init__(f"emulated death of shard {part} during the "
                         "distributed SpMV collective")
        self.part = part


# the points of the reference's stack; the distributed and serving ones
# wait for those modules of the port, and are declared here so that the
# table is complete after one import
fault_point("plan.spmv", "local plan SpMV dispatch (kernel raise / "
                         "non-finite output / slow kernel)")
fault_point("plan.spmm", "local plan SpMM dispatch (the serving flush "
                         "executes through this)")
fault_point("dist.spmv", "distributed executor SpMV (shard death, "
                         "collective failure, straggler)")
fault_point("dist.spmm", "distributed executor SpMM (batched serving over "
                         "a mesh)")
fault_point("serve.flush", "serving flush path, before the batch executes "
                           "(straggler via the injected clock)")
fault_point("serve.queue_full", "submission-time queue-full: submit sheds "
                                "with BackpressureError regardless of "
                                "queue length")
