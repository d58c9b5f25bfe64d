"""Open loop of independent callers against one ``BatchingSpMVServer``
operator: Poisson arrivals on the real clock at a fixed rate, each request
one vector of a pool drawn on the device in set-up.

One generator thread submits each request when it is due, pumps the
server when the oldest unflushed request has waited the deadline (the
cooperative server's stand-in for a flusher), and watches a CUDA event
recorded after each flush; with ``max_flushes`` flushes in flight it waits
for the oldest before submitting more.  A request's latency runs from when
it was due to when the generator saw its flush complete on the device
(polled every ``poll_s``); its lateness is how far after its due time it
was submitted.  The generator reads each flush's finiteness verdict
(``error()``, as a caller's ``result()`` would) once no flush is in flight,
or once ``max_unread`` answers wait for it: the program's read waits for
everything queued on the stream, and one thread standing for many callers
must not wait for flushes that other callers are waiting for.  After the
window it waits up to ``drain_s`` for the last answers.

The arrivals of every seed are the same gaps, drawn once from
``base_seed``, in an order drawn from the run's seed, so every run offers
the same load; which pool vector a request sends is drawn from the seed.

Traffic keys: ``rate_per_s``, ``deadline_s``, ``pool``, ``samples`` (requests
checked, drawn from the seed among those due in the window),
``warmup_s``, ``base_seed``, ``trace_seconds``, the generator's ``poll_s``,
``max_flushes``, ``max_unread`` and ``drain_s`` (above), and the
configuration's ``format`` and ``vector_dtype`` where they differ.

Check: each checked request's result against the reference's f64 product
of its x (``served_rel_err``, as the closed loop's: NaN where a result holds
a NaN, infinite where none was checked), and ``unanswered``, the requests
that failed (a non-finite column among them), were shed or never completed.
"""
from __future__ import annotations

import math
import random
import time
from collections import deque

import numpy as np
import torch

from ..reference import control_precision, rel_err, worst
from ..trace import Window, span, synchronize


def arrivals(b, seconds: float, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Due times (s from the start) of the requests in ``seconds``, and the
    pool vector of each.  The gaps are those of ``base_seed``'s Poisson
    arrivals that fit in ``seconds``, so every seed offers the same number
    of requests; their order and the vectors come from sub-seed ``k`` of the
    run's seed."""
    t = b.traffic
    rate = float(t["rate_per_s"])
    gaps = np.random.default_rng(t["base_seed"]).exponential(
        1.0 / rate, int(math.ceil(rate * seconds * 1.5)) + 64)
    gaps = gaps[np.cumsum(gaps) < seconds]
    rng = np.random.default_rng(b.subseed(k))
    due = np.cumsum(rng.permutation(gaps))
    return due, rng.integers(0, t["pool"], size=len(due))


def setup(b):
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.serve import BatchingSpMVServer

    t = b.traffic
    srv = BatchingSpMVServer(deadline_s=t["deadline_s"], device=b.device)
    with b.phase("plan"):
        rep = srv.register("op", b.program_matrix(), config=PlanConfig(format=b.format))
    st = srv.stats()["op"]
    b.out(f"[setup] server format={rep.format} kernel={rep.kernel} spmm={rep.spmm_kernel} "
          f"width={st['batch_width']} deadline={st['deadline_s']} s "
          f"rate={t['rate_per_s']} req/s")
    with b.phase("inputs"):
        xs = b.pool(1, t["pool"], b.vector_dtype)
    with b.phase("warmup"):
        due, idx = arrivals(b, t["warmup_s"], 5)
        _serve(b, srv, xs, due, idx, set(), None, None)
        keep = _reserve(b, srv, xs)
    return {"srv": srv, "xs": xs, "keep": keep}


def _reserve(b, srv, xs):
    """Fill the card's memory cache to what the window can hold at once:
    ``max_flushes`` flushes in flight, their results alive.  Without it the
    window's first deep queue calls ``cudaMalloc`` and stalls the host.
    Returns the block that the checked answers are copied into, so that no
    batch outlives its flush."""
    t = b.traffic
    width = int(srv.stats()["op"]["batch_width"])
    futs = [srv.submit("op", xs[i % len(xs)]) for i in range((int(t["max_flushes"]) + 1) * width)]
    srv.flush("op")
    answered = [f for f in futs if f.error() is None]
    dtype = answered[0].result().dtype if answered else b.torch_dtype(b.vector_dtype)
    keep = torch.empty((int(t["samples"]), b.n), dtype=dtype, device=b.device)
    del futs, answered
    synchronize(b.device)
    return keep


def _serve(b, srv, xs, due, idx, sampled, win, keep):
    """Offer the requests ``due`` (seconds after the start) and wait for
    every answer; returns the per-request record and, for each checked
    request, the row of ``keep`` its answer was copied into."""
    from repro_torch.serve.batching import BackpressureError

    n = len(due)
    t = b.traffic
    deadline = float(t["deadline_s"])
    poll_s, max_flushes = float(t["poll_s"]), int(t["max_flushes"])
    max_unread, drain_s = int(t["max_unread"]), float(t["drain_s"])
    seconds = b.seconds if win is not None else (float(due[-1]) if n else 0.0)
    t_sub = np.full(n, np.nan)
    t_done = np.full(n, np.nan)
    failed = np.zeros(n, bool)
    kept = {}
    inflight: deque = deque()      # (rid, future) submitted, not yet flushed
    groups: deque = deque()        # (event, [(rid, future)]) flushed, not seen done
    state = {"requests": 0, "completed": 0}

    def collect():
        done = []
        while inflight and inflight[0][1].done():
            done.append(inflight.popleft())
        if done:
            ev = torch.cuda.Event() if b.device.type == "cuda" else None
            if ev is not None:
                ev.record()
            groups.append((ev, done))

    unread: list = []              # complete on the device, verdict not yet read

    def read_verdicts():
        with span("server.result"):
            for rid, fut in unread:
                if fut.error() is not None:
                    failed[rid] = True
                elif rid in sampled:
                    keep[len(kept)].copy_(fut.result())
                    kept[rid] = len(kept)
        unread.clear()

    def poll(now):
        while groups and (groups[0][0] is None or groups[0][0].query()):
            _, members = groups.popleft()
            for rid, _ in members:
                t_done[rid] = now
            unread.extend(members)
            state["completed"] += len(members)
        # a verdict read waits for all the work queued on the stream: read
        # them once nothing is in flight, so that the one generator thread,
        # which stands for many independent callers, waits for no later flush
        if unread and (not groups or len(unread) >= max_unread):
            read_verdicts()

    if win is not None:
        win.probe = lambda: _probe(srv, state)
        win.start()
        t0 = win.t0
    else:
        synchronize(b.device)
        t0 = time.perf_counter()
    t_end = t0 + seconds
    i = 0
    next_poll = t0
    while True:
        now = time.perf_counter()
        if win is not None:
            win.open()
            win.tick(state["completed"])
        if i < n and now >= t0 + due[i]:
            if len(groups) >= max_flushes:
                if groups[0][0] is not None:
                    groups[0][0].synchronize()
                poll(time.perf_counter())
                continue
            t_sub[i] = now
            state["requests"] += 1
            try:
                with span("server.submit"):
                    fut = srv.submit("op", xs[idx[i]])
                inflight.append((i, fut))
            except BackpressureError:
                failed[i] = True
            i += 1
            collect()
            continue
        if i >= n and now >= t_end:
            break
        if inflight and now - t_sub[inflight[0][0]] >= deadline:
            with span("server.pump"):
                srv.pump()
            collect()
        if now >= next_poll:
            poll(now)
            next_poll = now + poll_s
    srv.flush("op")
    collect()
    stop = time.perf_counter() + drain_s
    while groups and time.perf_counter() < stop:
        poll(time.perf_counter())
    read_verdicts()
    elapsed = win.close() if win is not None else None
    return {"t0": t0, "t_end": t_end, "t_sub": t_sub, "t_done": t_done, "failed": failed,
            "kept": kept, "elapsed": elapsed}


def _flushes(srv) -> dict:
    """The server's flushes so far and the real columns they carried."""
    st = srv.stats()["op"]
    return {"batches": st["batches"], "columns": round(st["mean_batch_width"] * st["batches"])}


def _probe(srv, state) -> dict:
    return {"requests": state["requests"], "completed": state["completed"], **_flushes(srv)}


def window(b, st):
    srv, xs = st["srv"], st["xs"]
    t = b.traffic
    due, idx = arrivals(b, b.seconds, 3)
    rng = random.Random(b.subseed(2))
    sampled = set(rng.sample(range(len(due)), min(len(due), t["samples"])))
    win = Window(b.seconds, b.device, b.trace, trace_seconds=t.get("trace_seconds"))
    before = _flushes(srv)
    rec = _serve(b, srv, xs, due, idx, sampled, win, st["keep"])
    after = _flushes(srv)
    t0, t_end = rec["t0"], rec["t_end"]
    lat = rec["t_done"] - (t0 + due)
    missing = np.isnan(lat) | rec["failed"]
    # a failed, shed or unanswered request counts as missing every limit
    lat_all = np.where(missing, np.inf, lat)
    completed = int(np.count_nonzero(~missing & (rec["t_done"] <= t_end)))
    late = rec["t_sub"] - (t0 + due)
    stats = srv.stats()["op"]
    res = {"requests": len(due), "window_s": t_end - t0, "attempted": len(due),
           "failed": int(missing.sum()), "completed_in_window": completed,
           "latency_s": lat_all, "late_s": late, "due_s": due,
           "batches": after["batches"] - before["batches"],
           "columns": after["columns"] - before["columns"], "width": stats["batch_width"],
           "trace_end_s": None if win.trace_end is None else win.trace_end - t0,
           "samples": {"kept": [(int(idx[r]), st["keep"][k]) for r, k in rec["kept"].items()],
                       "unanswered": int(missing.sum())},
           "summary": (f"{len(due)} requests offered at {t['rate_per_s']}/s, {completed} "
                       f"completed in the window, {int(missing.sum())} missing; p50 "
                       f"{np.percentile(lat_all, 50) * 1e3:.4f} ms p95 "
                       f"{np.percentile(lat_all, 95) * 1e3:.4f} ms; generator late p95 "
                       f"{np.nanpercentile(late, 95) * 1e3:.4f} ms; {stats['batches']} "
                       f"flushes, mean width {stats['mean_batch_width']:.3f} of "
                       f"{stats['batch_width']}, shed {stats['shed']}; {win.host_report()}")}
    if win.traced is not None:
        tr = win.traced
        res["traced"] = dict(tr, spmv_passes=tr["batches"], spmv_columns=tr["columns"],
                             units=tr["requests"])
        res["trace"] = win.reduction()
    return res


def check(b, samples) -> dict:
    A = b.reference()
    xs = b.pool(1, b.traffic["pool"], b.vector_dtype)
    return {"served_rel_err": worst(rel_err(y, A.spmv(xs[i], torch.float64))
                                    for i, y in samples["kept"]),
            "unanswered": float(samples["unanswered"])}


def control(b) -> dict:
    """The reference one precision below the configuration's
    (``reference.control_precision``) in the program's place, every request
    answered."""
    A = b.reference()
    xs = b.pool(1, b.traffic["pool"], b.vector_dtype)
    store, sums = control_precision(b.vector_dtype)
    k = min(len(xs), b.traffic["samples"])
    return {"kept": [(i, A.spmv(xs[i], sums, store)) for i in range(k)], "unanswered": 0}
