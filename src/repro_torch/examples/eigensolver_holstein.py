"""End-to-end example: the paper's application -- a sparse eigensolver.

1. Build the *exact* Holstein-Hubbard Hamiltonian (small, validated against
   dense diagonalization), then the pattern-faithful surrogate at scale.
2. Benchmark every storage format on the surrogate.
3. Run Lanczos through the fastest format, and report the share of its
   time the SpMV takes.
4. Distribute the SpMV over the visible cards (one shard a card; one host
   shard with ``--device cpu``) and hold it against the serial plan.

    PYTHONPATH=src python -m repro_torch.examples.eigensolver_holstein --device cpu
    PYTHONPATH=src python -m repro_torch.examples.eigensolver_holstein --n 1201200

Runs on the card unless ``--device`` names another device.  ELL and JDS
have no hand-written kernel, so their plans run the ``torch`` entry on the
card too; ``report.kernel`` names what ran.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import distributed as D
from ..core import formats as F
from ..core import spmv as S
from ..core.eigensolver import lanczos
from ..core.matrices import (HolsteinHubbardParams, holstein_hubbard_exact,
                             holstein_hubbard_surrogate)
from ..core.plan import SpMVPlan
from ..core.planconfig import PlanConfig
from ..utils.hw import default_device, synchronize
from .quickstart import draw_x, time_plan

#: the shoot-out's formats, each with its conversion from the CSR source
FORMATS = {"csr": lambda m: m, "ell": F.ELL.from_csr, "jds": F.JDS.from_csr,
           "sell": lambda m: F.SELL.from_csr(m, C=8, sigma=1024),
           "hybrid": F.split_dia}


def exact_check(dev: torch.device) -> dict:
    """E0 of the exact L = 3 chain: f32 Lanczos against dense ``eigvalsh``."""
    p = HolsteinHubbardParams(L=3, n_up=1, n_dn=1, max_phonon=2, g=0.5, U=4.0)
    hh = holstein_hubbard_exact(p)
    e_dense = float(np.linalg.eigvalsh(hh.to_dense())[0])
    res = lanczos(S.make_spmv(hh), hh.shape[0], m=60, dtype=torch.float32, device=dev)
    e0 = float(res.eigenvalues[0])
    print(f"[exact] dim={hh.shape[0]} E0(lanczos)={e0:.8f} E0(dense)={e_dense:.8f} "
          f"|diff|={abs(e0 - e_dense):.2e}")
    return {"dim": hh.shape[0], "e0": e0, "e_dense": e_dense}


#: timed calls of each format's plan (after one warm-up call)
ITERS = 3


def shootout(m, x: torch.Tensor, dev: torch.device) -> dict:
    """Convert, plan and time each format on ``x``: {name: {plan, seconds,
    gflops, kernel, convert_s}} (host seconds of the conversion apart)."""
    out = {}
    for name, conv in FORMATS.items():
        t0 = time.perf_counter()
        obj = conv(m)
        convert_s = time.perf_counter() - t0
        f = SpMVPlan.compile(obj, PlanConfig(device=dev))
        t = time_plan(f, x, ITERS)[0]
        out[name] = {"plan": f, "seconds": t, "gflops": 2 * m.nnz / t / 1e9,
                     "kernel": f.report.kernel, "convert_s": convert_s}
        print(f"  {name:7s} {out[name]['gflops']:7.2f} GFLOP/s ({t * 1e3:.3f} ms) "
              f"[{f.report.format}/{f.report.kernel}] converted in {convert_s:.2f} s")
    return out


def main(argv=None) -> dict:
    """The four steps; returns the exact check, the surrogate, x, the
    shoot-out, the winner, the Lanczos result with its seconds and SpMV
    share, and the distributed plan with its difference from the serial."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--lanczos-steps", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    # --- 1a. exact model, validated against dense eigvalsh -------------------
    exact = exact_check(dev)

    # --- 1b. surrogate at scale -------------------------------------------
    m = holstein_hubbard_surrogate(args.n, seed=0)
    print(f"[surrogate] N={args.n} nnz={m.nnz}")

    # --- 2. format shoot-out (compiled plans: preprocess once per format) ---
    x = draw_x(args.n, dev)
    shoot = shootout(m, x, dev)
    best = min(shoot, key=lambda k: shoot[k]["seconds"])
    best_fn, best_t = shoot[best]["plan"], shoot[best]["seconds"]

    # --- 3. Lanczos through the winner --------------------------------------
    print(f"[lanczos] using {best} [{best_fn.report.kernel}]")
    synchronize(dev)
    t0 = time.perf_counter()
    res = lanczos(best_fn, args.n, m=args.lanczos_steps, dtype=torch.float32)
    synchronize(dev)
    dt = time.perf_counter() - t0
    share = res.n_spmv * best_t / dt
    print(f"  E0={res.eigenvalues[0]:.6f} ({res.n_spmv} SpMVs, {dt:.3f}s total, "
          f"~{100 * share:.1f}% in SpMV)")

    # --- 4. distributed SpMV over the visible cards (per-shard plans) -------
    mesh = D.make_mesh_1d() if dev.type == "cuda" else D.make_mesh_1d(device=dev)
    dist = D.compile_distributed_plan(m, mesh, strategy="allgather", balance="nnz")
    y_dist, y_serial = dist(x), best_fn(x)
    err = float((y_dist.double() - y_serial.double()).abs().max())
    rel = err / float(y_serial.double().abs().max())
    print(f"[distributed] {dist.parts} shard(s), {dist.strategy} variant, "
          f"{dist.slab_format} slabs [{dist.slab_backend}], imbalance={dist.imbalance:.3f}, "
          f"max |diff| vs serial = {err:.2e} ({rel:.2e} relative)")
    return {"exact": exact, "matrix": m, "x": x, "shootout": shoot, "best": best,
            "lanczos": res, "lanczos_s": dt, "spmv_share": share,
            "e0": float(res.eigenvalues[0]), "dist": dist, "dist_err": err,
            "dist_rel_err": rel}


if __name__ == "__main__":
    main()
