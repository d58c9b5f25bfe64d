"""The measured window, the benchmark's spans, and the reduction of a
profiler trace to device time.

Spans are ``torch.profiler.record_function`` ranges opened by the
benchmark's own files around its calls into the program (``plan.call``,
``lanczos.solve``, ``server.submit``, ``server.pump``, ``server.result``,
and ``caller.wait`` where a closed-loop caller waits for the card).  They
cost a microsecond when no profiler runs.

A traced run profiles the first seconds of its window (``TRACE_SECONDS``
unless the traffic mix sets ``trace_seconds``), ending at
the first boundary between units of work (calls, solves, loop turns) after
that; the driver's probes are read at both ends, so every per-layer metric
reads the same stretch.  Within it: the device's busy time is the union of
its kernels, copies and sets; an idle gap is named by the innermost span
the host was in at the gap's middle.
"""
from __future__ import annotations

import gc
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_SECONDS = 4.0
WINDOW_SPAN = "window"
#: every span the benchmark opens
SPANS = frozenset({WINDOW_SPAN, "plan.call", "caller.wait", "lanczos.solve",
                   "server.submit", "server.pump", "server.result"})

span = record_function


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_profiler(device: torch.device) -> None:
    """Start and stop the profiler once in set-up, so that its first start
    (CUPTI's initialisation) falls outside the window."""
    with _profiler(device):
        with span(WINDOW_SPAN):
            torch.ones(8, device=device).sum()
        synchronize(device)


def _profiler(device: torch.device):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


class Window:
    """Times the window; in a traced run, profiles its first stretch.

    The driver calls ``open()`` at every boundary between units of work
    and stops when it returns False, then ``close()`` once its last unit has
    completed.  ``probe`` returns the driver's counters (a flat dict of
    numbers); a traced run reads it where the profiled stretch starts and
    ends, and ``traced`` holds the difference.
    """

    def __init__(self, seconds: float, device: torch.device, trace: bool, probe=None,
                 trace_seconds: float | None = None):
        self.seconds = float(seconds)
        self.trace_seconds = TRACE_SECONDS if trace_seconds is None else float(trace_seconds)
        self.device = device
        self.trace = trace
        self.probe = probe or (lambda: {})
        self.t0 = self.t_end = None
        self.trace_end = None        # clock reading where the profiled stretch ended
        self.elapsed = None
        self._prof = None
        self._span = None
        self._probe0 = None
        self._gc_t = None
        self.gc_pauses = defaultdict(list)   # generation -> pause seconds
        self._alloc0 = None
        self._seconds = []
        self.traced = None           # counter differences over the profiled stretch
        self.events = None

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_pauses[info["generation"]].append(time.perf_counter() - self._gc_t)

    def _alloc_stats(self) -> dict:
        if self.device.type != "cuda":
            return {}
        st = torch.cuda.memory_stats(self.device)
        return {k: st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                          "num_alloc_retries")}

    def host_report(self) -> str:
        """What the host did besides the work: the collector's pauses and
        the allocator's calls into the driver during the window, and the
        units of work in each second of it (see ``tick``)."""
        gcs = ", ".join(f"gen{g} {len(p)} (longest {max(p) * 1e3:.3f} ms)"
                        for g, p in sorted(self.gc_pauses.items()))
        a1 = self._alloc_stats()
        alloc = ", ".join(f"{k} {a1[k] - self._alloc0.get(k, 0)}" for k in a1)
        per_s = [b - a for a, b in zip(self._seconds, self._seconds[1:])]
        rates = f"; units a second {min(per_s)}..{max(per_s)}" if per_s else ""
        return f"gc: {gcs or 'none'}; allocator: {alloc or 'n/a'}{rates}"

    def tick(self, units: int) -> None:
        """Note the units done so far at each whole second of the window."""
        if time.perf_counter() >= self.t0 + len(self._seconds):
            self._seconds.append(units)

    def start(self) -> None:
        synchronize(self.device)
        self._alloc0 = self._alloc_stats()
        gc.callbacks.append(self._on_gc)
        if self.trace:
            self._probe0 = self.probe()
            self._prof = _profiler(self.device)
            self._prof.start()
            self._span = span(WINDOW_SPAN)
            self._span.__enter__()
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + self.seconds

    def open(self) -> bool:
        """True while the window runs (the driver calls it between units)."""
        now = time.perf_counter()
        if self._prof is not None and now - self.t0 >= self.trace_seconds:
            self._stop_trace()
        return now < self.t_end

    def _stop_trace(self) -> None:
        synchronize(self.device)
        self._span.__exit__(None, None, None)
        p1 = self.probe()
        self._prof.stop()
        self.traced = {k: p1[k] - self._probe0.get(k, 0) for k in p1}
        self.events = self._prof.profiler.kineto_results.events()
        self._prof = None
        self.trace_end = time.perf_counter()

    def close(self) -> float:
        """End the window after the last unit completed; returns its seconds."""
        synchronize(self.device)
        self.elapsed = time.perf_counter() - self.t0
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        if self._prof is not None:
            self._stop_trace()
        return self.elapsed

    def reduction(self) -> dict | None:
        """``reduce_trace`` of the profiled stretch (None untraced)."""
        return None if self.events is None else reduce_trace(self.events)


def _is_device_op(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()


def reduce_trace(events) -> dict:
    """Device time of the profiled stretch: busy seconds (union of device
    operations), the stretch's seconds (the ``window`` span), seconds by
    device operation name, and idle seconds by the innermost of the
    benchmark's spans that the host was in at each gap's middle."""
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
             if e.device_type() == torch.autograd.DeviceType.CPU and e.name() in SPANS]
    win = [s for s in spans if s[2] == WINDOW_SPAN]
    if not win:
        return {}
    w0, w1, _ = win[0]
    ops = sorted((max(w0, e.start_ns()), min(w1, e.start_ns() + e.duration_ns()), e.name())
                 for e in events if _is_device_op(e))
    by_name = defaultdict(float)
    for s, t, name in ops:
        if t > s:
            by_name[name] += (t - s) * 1e-9
    busy, gaps, cur_s, cur_t = 0, [], None, w0
    for s, t, _ in ops:
        if t <= s:
            continue
        if cur_s is None or s > cur_t:
            if cur_s is not None:
                busy += cur_t - cur_s
            if s > cur_t:
                gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_s is not None:
        busy += cur_t - cur_s
    if w1 > cur_t:
        gaps.append((cur_t, w1))
    # spans of one thread nest: sweep the gaps' middles in order with a
    # stack of the spans open there; its top is the innermost
    inner = sorted(spans, key=lambda s: (s[0], -s[1]))
    idle = defaultdict(float)
    stack, i = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(inner) and inner[i][0] <= mid:
            while stack and stack[-1][1] < inner[i][0]:
                stack.pop()
            stack.append(inner[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[stack[-1][2] if stack else WINDOW_SPAN] += (g1 - g0) * 1e-9
    return {"busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "ops_s": dict(by_name), "idle_s": dict(idle)}
