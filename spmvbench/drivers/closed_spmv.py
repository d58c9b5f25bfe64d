"""Closed loop of one caller: ``y = plan(x)`` over a pool of seeded
vectors, round robin, waiting for each ``y`` before the next call.

Traffic keys: ``pool`` (vectors), ``samples`` (outputs kept for the check,
drawn from the seed over the whole window), ``warmup`` (calls).

Check: each kept ``y`` against the reference's f64 product of its x, as
``spmv_rel_err`` = max |y - y_ref| / max |y_ref| over the kept outputs (NaN
where an output holds a NaN, infinite where none was kept).
"""
from __future__ import annotations

import random

import torch

from ..counts import spmv_flops
from ..reference import control_precision, rel_err, worst
from ..trace import Window, span, synchronize


def setup(b):
    from repro_torch.core.plan import SpMVPlan

    with b.phase("plan"):
        plan = SpMVPlan.compile(b.program_matrix(), b.plan_config())
    b.out(f"[setup] plan format={plan.report.format} kernel={plan.report.kernel}")
    with b.phase("inputs"):
        xs = b.pool(1, b.traffic["pool"], b.vector_dtype)
    with b.phase("warmup"):
        for i in range(b.traffic["warmup"]):
            plan(xs[i % len(xs)])
        synchronize(b.device)
    return {"plan": plan, "xs": xs}


def window(b, st):
    from repro_torch.kernels import cuda_build

    plan, xs = st["plan"], st["xs"]
    pool = len(xs)
    k = b.traffic["samples"]
    rng = random.Random(b.subseed(2))
    kept: list = []
    calls = 0
    win = Window(b.seconds, b.device, b.trace,
                 probe=lambda: {"calls": calls,
                                "launches": sum(cuda_build.launch_counts().values())})
    win.start()
    while win.open():
        win.tick(calls)
        i = calls % pool
        with span("plan.call"):
            y = plan(xs[i])
        with span("caller.wait"):
            synchronize(b.device)
        if len(kept) < k:
            kept.append((i, y))
        else:
            j = rng.randrange(calls + 1)
            if j < k:
                kept[j] = (i, y)
        calls += 1
    seconds = win.close()
    res = {"calls": calls, "window_s": seconds, "attempted": calls, "failed": 0,
           "samples": kept, "summary": f"{calls} SpMVs in {seconds:.3f} s; {win.host_report()}"}
    if win.traced is not None:
        n = win.traced["calls"]
        res["traced"] = dict(win.traced, spmv_passes=n, spmv_columns=n,
                             least_bytes=n * b.spmv_bytes(), least_flops=spmv_flops(b.nnz, n),
                             units=n)
        res["trace"] = win.reduction()
    return res


def check(b, samples) -> dict:
    A = b.reference()
    xs = b.pool(1, b.traffic["pool"], b.vector_dtype)
    return {"spmv_rel_err": worst(rel_err(y, A.spmv(xs[i], torch.float64))
                                  for i, y in samples)}


def control(b) -> list:
    """The reference one precision below the configuration's
    (``reference.control_precision``), its outputs in the program's place."""
    A = b.reference()
    xs = b.pool(1, b.traffic["pool"], b.vector_dtype)
    store, sums = control_precision(b.vector_dtype)
    return [(i, A.spmv(xs[i], sums, store))
            for i in range(min(len(xs), b.traffic["samples"]))]
