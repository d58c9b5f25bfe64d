"""Repeated ground-state solves: ``lanczos(plan, n, m, v0, reorthogonalize)``
from the program's eigensolver, each from its own start vector of a pool
drawn on the device in set-up, E0 read from each.

Traffic keys: ``m`` (steps), ``reorthogonalize``, ``pool`` (start vectors,
used round robin), ``samples`` (solves checked, drawn from the seed),
``warmup`` (solves).

Check: each checked solve against the reference's Lanczos in f64 from the
same start vector: ``coef_rel_err`` = the larger of max |d alpha| / max
|alpha_ref| and max |d beta| / max |beta_ref| (infinite when the step counts
differ), ``e0_rel_err`` = |E0 - E0_ref| / |E0_ref| (both NaN where a number
is NaN, infinite where no solve was checked), and ``failed``, the solves of
the window that broke down on a non-finite coefficient.  Only completed
solves are timed: ``solves`` counts them, ``attempted`` every solve begun.
"""
from __future__ import annotations

import contextlib
import random

import numpy as np
import torch

from .. import counts, reference
from ..trace import Window, span, synchronize


def setup(b):
    from repro_torch.core.eigensolver import LanczosBreakdown, lanczos
    from repro_torch.core.plan import SpMVPlan

    with b.phase("plan"):
        plan = SpMVPlan.compile(b.program_matrix(), b.plan_config())
    b.out(f"[setup] plan format={plan.report.format} kernel={plan.report.kernel}")
    with b.phase("inputs"):
        v0s = b.pool(1, b.traffic["pool"], b.vector_dtype)
    t = b.traffic
    with b.phase("warmup"):
        for i in range(t["warmup"]):
            # a breakdown here recurs in the window, which counts it
            with contextlib.suppress(LanczosBreakdown):
                lanczos(plan, b.n, m=t["m"], v0=v0s[i % len(v0s)],
                        reorthogonalize=t["reorthogonalize"],
                        dtype=b.torch_dtype(b.vector_dtype))
        synchronize(b.device)
    return {"plan": plan, "v0s": v0s}


def solve_bytes(b, steps: int) -> int:
    return counts.lanczos_bytes(steps, b.spmv_bytes(), b.n, b.vector_dtype,
                                b.traffic["reorthogonalize"])


def solve_flops(b, steps: int) -> int:
    return counts.lanczos_flops(steps, b.nnz, b.n, b.traffic["reorthogonalize"])


def window(b, st):
    from repro_torch.core.eigensolver import LanczosBreakdown, lanczos

    plan, v0s = st["plan"], st["v0s"]
    t = b.traffic
    dtype = b.torch_dtype(b.vector_dtype)
    solves = []
    tally = {"attempted": 0, "solves": 0, "spmvs": 0, "least_bytes": 0, "least_flops": 0,
             "failed": 0}
    win = Window(b.seconds, b.device, b.trace, probe=lambda: dict(tally))
    win.start()
    while win.open():
        win.tick(tally["solves"])
        i = tally["attempted"] % len(v0s)
        tally["attempted"] += 1
        try:
            with span("lanczos.solve"):
                r = lanczos(plan, b.n, m=t["m"], v0=v0s[i],
                            reorthogonalize=t["reorthogonalize"], dtype=dtype)
        except LanczosBreakdown:
            tally["failed"] += 1
            continue
        tally["solves"] += 1
        solves.append((i, r.alphas, r.betas, float(r.eigenvalues[0])))
        tally["spmvs"] += r.n_spmv
        tally["least_bytes"] += solve_bytes(b, r.n_iterations)
        tally["least_flops"] += solve_flops(b, r.n_iterations)
    seconds = win.close()
    rng = random.Random(b.subseed(2))
    kept = rng.sample(solves, min(len(solves), t["samples"]))
    e0 = np.array([s[3] for s in solves])
    res = {"solves": tally["solves"], "window_s": seconds, "attempted": tally["attempted"],
           "failed": tally["failed"],
           "samples": {"kept": kept, "failed": tally["failed"]},
           "summary": (f"{tally['solves']} solves ({tally['spmvs']} SpMVs) in {seconds:.3f} s, "
                       f"{tally['failed']} broke down, "
                       f"E0 {e0.min() if len(e0) else float('nan'):.12f} .. "
                       f"{e0.max() if len(e0) else float('nan'):.12f}; {win.host_report()}")}
    if win.traced is not None:
        tr = win.traced
        res["traced"] = dict(tr, spmv_passes=tr["spmvs"], spmv_columns=tr["spmvs"],
                             units=tr["solves"])
        res["trace"] = win.reduction()
    return res


def _coef_err(a, bt, ra, rb) -> float:
    if len(a) != len(ra) or len(bt) != len(rb):
        return float("inf")
    return max(float(np.max(np.abs(a - ra)) / np.max(np.abs(ra))),
               float(np.max(np.abs(bt - rb)) / np.max(np.abs(rb))))


def _compare(samples, refs) -> dict:
    pairs = list(zip(samples, refs))
    return {"coef_rel_err": reference.worst(_coef_err(a, bt, ra, rb)
                                            for (_, a, bt, _), (ra, rb, _) in pairs),
            "e0_rel_err": reference.worst(abs(e - re) / abs(re)
                                          for (*_, e), (*_, re) in pairs)}


def _reference_runs(b, kept, dtype):
    A = b.reference()
    v0s = b.pool(1, b.traffic["pool"], b.vector_dtype)
    t = b.traffic
    return [reference.lanczos(A, v0s[i], t["m"], t["reorthogonalize"], dtype)
            for i, *_ in kept]


def check(b, samples) -> dict:
    kept = samples["kept"]
    return dict(_compare(kept, _reference_runs(b, kept, torch.float64)),
                failed=float(samples["failed"]))


def control(b) -> dict:
    """The reference's Lanczos one precision below the configuration's
    (f32 vectors and sums for f64), its results in the program's place."""
    k = min(b.traffic["samples"], b.traffic["pool"])
    idx = [(i,) for i in range(k)]
    _, sums = reference.control_precision(b.vector_dtype)
    return {"kept": [(i, a, bt, e) for (i,), (a, bt, e) in
                     zip(idx, _reference_runs(b, idx, sums))],
            "failed": 0}
