"""Quickstart: the paper's pipeline in a few calls.

Builds the Holstein-Hubbard matrix, asks the performance model for the best
storage format, runs the SpMV through the chosen kernel, and computes the
ground-state energy with Lanczos -- the full loop of the paper.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart --n 1201200

Runs on the card unless ``--device`` names another device.  The advisor
prices the formats on the device's chip: the H100 data sheet on the card,
``core.microbench.host_chip()`` on the host.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import formats as F
from ..core import perfmodel as PM
from ..core.eigensolver import lanczos
from ..core.matrices import holstein_hubbard_surrogate
from ..core.microbench import host_chip
from ..core.plan import SpMVPlan
from ..core.planconfig import PlanConfig
from ..utils.hw import H100, default_device, synchronize


def device_chip(dev: torch.device):
    """The chip the advisor and the plan price on ``dev``."""
    return H100 if dev.type == "cuda" else host_chip()


def draw_x(n: int, dev: torch.device, dtype=np.float32) -> torch.Tensor:
    """The examples' input vector: ``default_rng(0)`` normals in ``dtype``."""
    return torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(dtype)).to(dev)


def time_plan(plan, x: torch.Tensor, iters: int) -> tuple[float, torch.Tensor]:
    """Wall seconds a call of ``plan(x)``, and its last result: one warm-up
    call, then ``iters`` calls fenced by one synchronize of x's device."""
    plan(x)
    synchronize(x.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        y = plan(x)
    synchronize(x.device)
    return (time.perf_counter() - t0) / iters, y


def main(argv=None) -> dict:
    """Advise, convert, plan, multiply, solve; returns the matrix, its
    stats, the advice, the plan, x, y and the Lanczos result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000, help="surrogate rows")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    chip = device_chip(dev)

    # 1. the paper's test matrix
    n = args.n
    m = holstein_hubbard_surrogate(n, seed=0)
    stats = F.matrix_stats(m)
    print(f"matrix: N={n}, nnz={m.nnz}, {stats['nnz_per_row_mean']:.1f} nnz/row, "
          f"{stats['frac_nnz_top12_diags']:.0%} of nnz in 12 diagonals")

    # 2. ask the performance model for the best format (paper Sec. 1 goal)
    advice = PM.advise(stats, m.row_lengths(), am=PM.LINE128_FP32, chip=chip)
    best = advice["_best"]
    where = "the H100" if chip is H100 else chip.name
    print("format advisor says:", best)
    for name, p in advice.items():
        if name != "_best":
            print(f"  {name:7s} balance={p.balance_bytes_per_flop:5.2f} B/F "
                  f"-> predicted {p.gflops:6.1f} GFLOP/s on {where}")

    # 3. convert + compile an execution plan (preprocess once, run many times)
    obj = F.convert(m, best if best != "csr" else "sell", C=8)
    plan = SpMVPlan.compile(obj, PlanConfig(chip=chip, device=dev))
    print(f"plan: format={plan.report.format} kernel={plan.report.kernel} "
          f"balance={plan.report.balance_bytes_per_flop:.2f} B/F")
    x = draw_x(n, dev)
    y = plan(x)
    print("SpMV ok:", tuple(y.shape), "||y|| =", float(torch.linalg.vector_norm(y)))

    # 4. the host application: Lanczos ground state, the plan reused on
    #    every iteration
    res = lanczos(plan, n, m=48, dtype=torch.float32)
    print(f"Lanczos: E0 = {res.eigenvalues[0]:.6f} after {res.n_spmv} SpMVs on {dev}")
    return {"matrix": m, "stats": stats, "advice": advice, "best": best, "plan": plan,
            "x": x, "y": y, "lanczos": res, "e0": float(res.eigenvalues[0])}


if __name__ == "__main__":
    main()
