"""End-to-end example: matrix-free Lanczos on the 3-D Laplacian.

The 7-point stencil is the paper's best case for generated operators:
every diagonal's offset is a function of the grid shape and every value
is a constant, so the SpMV needs *no* matrix arrays at all -- the kernel
computes ``col = row + offset`` and the stencil weights in registers and
streams only the vectors.

1. Detect the ``MatrixFreeOperator`` descriptor from the assembled CSR
   (exact detection: the descriptor materializes back bitwise-identical).
2. Compare the perfmodel's byte accounting: materialized CSR stream vs
   the zero-index-bytes descriptor stream.
3. Time both plans and convert the measured time into achieved bytes/nnz
   through the device's STREAM bandwidth (``core.microbench.card_chip()``
   on the card, ``host_chip()`` on the host) -- the model-vs-measured
   receipt for the traffic the format deletes.
4. Run Lanczos to the ground state through the matrix-free plan.

    PYTHONPATH=src python -m repro_torch.examples.matrix_free_laplacian --device cpu
    PYTHONPATH=src python -m repro_torch.examples.matrix_free_laplacian --nx 112

Runs on the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import formats as F
from ..core import perfmodel as PM
from ..core.eigensolver import lanczos
from ..core.matrices import laplacian_3d
from ..core.microbench import card_chip, host_chip
from ..core.plan import SpMVPlan
from ..core.planconfig import PlanConfig
from ..utils.hw import default_device, synchronize
from .quickstart import draw_x, time_plan

#: timed calls of each plan in step 3 (after one warm-up call)
ITERS = 50


def main(argv=None) -> dict:
    """The four steps; returns the matrix, the descriptor, the modelled and
    measured bytes/nnz, both plans and their times, their difference and the
    Lanczos result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=24, help="grid points per axis")
    ap.add_argument("--lanczos-steps", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    # --- 1. assemble once, detect the descriptor -------------------------
    m = F.with_value_dtype(laplacian_3d(args.nx, args.nx, args.nx), "f32")
    op = F.detect_matrix_free(m)
    if op is None:
        raise RuntimeError("the 7-point stencil must detect as matrix-free")
    print(f"[detect] N={m.shape[0]} nnz={m.nnz} -> {op.n_diags} diagonals, "
          f"{op.n_generated} generated / {op.n_stored} stored "
          f"(container streams {'nothing' if op.data is None else 'stored lanes only'})")
    back = F.materialize(op)
    if not torch.equal(back.val, m.val):
        raise RuntimeError("materialize(detect_matrix_free(m)) is not bitwise m")

    # --- 2. model-side byte accounting ------------------------------------
    bytes_csr = PM.spmv_streamed_bytes(m) / m.nnz
    bytes_mf = PM.spmv_streamed_bytes(op) / m.nnz
    print(f"[model] streamed bytes/nnz: csr={bytes_csr:.2f} "
          f"matrix_free={bytes_mf:.2f} "
          f"(predicted saving {bytes_csr - bytes_mf:.2f} B/nnz)")

    # --- 3. measured traffic through the calibrated roofline ---------------
    chip = card_chip(dev) if dev.type == "cuda" else host_chip()
    x = draw_x(m.shape[0], dev)
    plan_csr = SpMVPlan.compile(m, PlanConfig(format="csr", chip=chip, device=dev))
    plan_mf = SpMVPlan.compile(m, PlanConfig(format="matrix_free", chip=chip, device=dev))
    t_csr, t_mf = time_plan(plan_csr, x, ITERS)[0], time_plan(plan_mf, x, ITERS)[0]
    bw = chip.hbm_bytes_per_s
    moved_csr, moved_mf = t_csr * bw / m.nnz, t_mf * bw / m.nnz
    print(f"[measured] csr        : {t_csr * 1e3:7.4f} ms  "
          f"~{moved_csr:6.2f} B/nnz moved at STREAM bw ({bw / 1e9:.1f} GB/s) "
          f"[{plan_csr.report.kernel}]")
    print(f"[measured] matrix_free: {t_mf * 1e3:7.4f} ms  "
          f"~{moved_mf:6.2f} B/nnz moved at STREAM bw  "
          f"({t_csr / t_mf:.2f}x) [{plan_mf.report.kernel}]")
    y_mf, y_csr = plan_mf(x), plan_csr(x)
    err = float((y_mf.double() - y_csr.double()).abs().max())
    rel = err / float(y_csr.double().abs().max())
    print(f"[parity] max |diff| vs csr plan = {err:.2e} ({rel:.2e} relative)")

    # --- 4. ground state through the matrix-free plan ----------------------
    synchronize(dev)
    t0 = time.perf_counter()
    res = lanczos(plan_mf, m.shape[0], m=args.lanczos_steps, dtype=torch.float32)
    synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[lanczos] E0={res.eigenvalues[0]:.6f} "
          f"({res.n_spmv} matrix-free SpMVs, {dt:.3f}s; "
          f"continuum ground state -> 3*pi^2/(nx+1)^2 per unit h^2)")
    return {"matrix": m, "op": op, "bytes_per_nnz": {"csr": bytes_csr, "matrix_free": bytes_mf},
            "chip": chip, "x": x, "plans": {"csr": plan_csr, "matrix_free": plan_mf},
            "seconds": {"csr": t_csr, "matrix_free": t_mf},
            "moved_per_nnz": {"csr": moved_csr, "matrix_free": moved_mf},
            "parity_err": err, "parity_rel_err": rel, "lanczos": res, "lanczos_s": dt,
            "e0": float(res.eigenvalues[0]), "iters": ITERS}


if __name__ == "__main__":
    main()
