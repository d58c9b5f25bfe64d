"""Injectable timing: one ``measure`` protocol, three clocks.

    timer.measure(fn, args, key="powerlaw/jds/torch", iters=10) -> seconds
    timer.measure_all(fn, args, key=..., iters=10) -> [seconds of each repeat]

``measure`` is the best of ``measure_all``'s repeats.

* :class:`WallTimer` -- host clock: a warm-up call, then best-of-``repeats``
  over ``iters`` back-to-back calls, fenced with ``torch.cuda.synchronize``
  when CUDA is initialised (PyTorch returns before the card finishes).
* :class:`CudaEventTimer` -- device clock: CUDA events recorded around the
  ``iters`` calls of each repeat, queued behind a spin kernel so that host
  launch overhead opens no gaps on the card; best-of-``repeats``.  It needs
  the card and raises without it -- a device time is never taken on the
  host.
* :class:`FakeTimer` -- scripted latencies keyed by ``key``; never calls
  ``fn``, records every key it was asked about.  Tests drive the
  measurement paths through it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..utils.hw import synchronize


def _fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        synchronize(torch.device("cuda", torch.cuda.current_device()))


@dataclass
class WallTimer:
    """Best-of-``repeats`` steady-state host seconds per call."""

    repeats: int = 3

    def measure(self, fn, args=(), *, key: str | None = None,
                iters: int = 10) -> float:
        return min(self.measure_all(fn, args, key=key, iters=iters))

    def measure_all(self, fn, args=(), *, key: str | None = None,
                    iters: int = 10) -> list[float]:
        del key  # provenance only; the clock times whatever it is given
        fn(*args)
        _fence()
        out = []
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            _fence()
            out.append((time.perf_counter() - t0) / iters)
        return out


@dataclass
class CudaEventTimer:
    """Best-of-``repeats`` device seconds per call, from CUDA events."""

    repeats: int = 5
    spin_cycles: int = 50_000_000   # ~25 ms of spin ahead of each repeat

    def measure(self, fn, args=(), *, key: str | None = None,
                iters: int = 10) -> float:
        return min(self.measure_all(fn, args, key=key, iters=iters))

    def measure_all(self, fn, args=(), *, key: str | None = None,
                    iters: int = 10) -> list[float]:
        del key
        if not torch.cuda.is_available():
            raise RuntimeError("CudaEventTimer needs a CUDA device: a device "
                               "time is never taken on the host")
        fn(*args)
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(self.repeats)]
        for start, end in pairs:
            torch.cuda._sleep(self.spin_cycles)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
        torch.cuda.synchronize()
        return [s.elapsed_time(e) * 1e-3 / iters for s, e in pairs]


@dataclass
class FakeTimer:
    """Scripted latencies for deterministic tests.

    ``measure`` never calls ``fn``, appends ``key`` to ``calls`` and
    returns ``latencies[key]`` (``default_s`` for an unlisted key).
    """

    latencies: dict = field(default_factory=dict)
    default_s: float = 1.0
    calls: list = field(default_factory=list)

    def measure(self, fn, args=(), *, key: str | None = None,
                iters: int = 10) -> float:
        return self.measure_all(fn, args, key=key, iters=iters)[0]

    def measure_all(self, fn, args=(), *, key: str | None = None,
                    iters: int = 10) -> list[float]:
        del fn, args, iters
        self.calls.append(key)
        return [float(self.latencies.get(key, self.default_s))]

    def count(self, key: str) -> int:
        """How many times ``measure`` was asked about ``key``."""
        return self.calls.count(key)

    @property
    def n_calls(self) -> int:
        return len(self.calls)
