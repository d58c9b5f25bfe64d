"""Distributed SpMV plans: the three variants on a 1-D mesh.

Compiles the Holstein-Hubbard surrogate into all three distributed plan
variants (allgather / ring / overlap), checks them against the CSR
product, prints the model's per-partition slab choices and traffic
accounting, then runs a sharded Lanczos ground-state solve through the
same plan -- the paper's host application, distributed with no solver
changes.

    PYTHONPATH=src python -m repro_torch.examples.distributed_spmv --device cpu
    PYTHONPATH=src python -m repro_torch.examples.distributed_spmv --n 1201200

The mesh is one shard a visible card (``make_mesh_1d()``), or one host
shard with ``--device cpu``; ``core.distributed.make_mesh_1d(n_devices=P,
device=...)`` places P shards on one device.
"""
from __future__ import annotations

import argparse

import torch

from ..core import spmv as S
from ..core.distributed import make_mesh_1d
from ..core.distributed_plan import VARIANTS, plan_all_variants
from ..core.eigensolver import ground_state_energy
from ..core.matrices import holstein_hubbard_surrogate
from ..utils.hw import default_device
from .quickstart import draw_x, time_plan

#: timed calls of each variant (after one warm-up call)
ITERS = 10


def compare_variants(m, mesh, x: torch.Tensor) -> dict:
    """Every variant on ``mesh`` against ``csr_spmv``: {variant: {plan, y,
    seconds, rel_err}}, printed as the reference's table."""
    y_ref = S.csr_spmv(m, x).double()
    scale = float(y_ref.abs().max())
    plans = plan_all_variants(m, mesh)
    print(f"\n{'variant':<10} {'slab':<5} {'imbal':>6} {'local':>6} "
          f"{'coll MB':>8} {'ms/SpMV':>8} {'rel err':>9}")
    out = {}
    for variant in VARIANTS:
        plan = plans[variant]
        dt, y = time_plan(plan, x, ITERS)
        err = float((y.double() - y_ref).abs().max()) / scale
        print(f"{variant:<10} {plan.slab_format:<5} {plan.imbalance:>6.3f} "
              f"{plan.local_fraction:>6.2f} {plan.traffic['collective'] / 1e6:>8.2f} "
              f"{dt * 1e3:>8.3f} {err:>9.2e}")
        out[variant] = {"plan": plan, "y": y, "seconds": dt, "rel_err": err}
    return out


def main(argv=None) -> dict:
    """The variant table, the overlap plan's shard reports and the sharded
    ground state; returns the matrix, the mesh, x, the variants and E0."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=6000, help="surrogate rows")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the cards; 'cpu' for the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    mesh = make_mesh_1d() if dev.type == "cuda" else make_mesh_1d(device=dev)
    print(f"devices: {len(mesh.devices)}  ({', '.join(str(d) for d in mesh.devices)})")
    m = holstein_hubbard_surrogate(args.n, seed=0)
    x = draw_x(args.n, mesh.devices[0])
    variants = compare_variants(m, mesh, x)

    overlap = variants["overlap"]["plan"]
    print(f"\nper-partition model choices (overlap plan, {overlap.slab_backend} slabs):")
    for r in overlap.shard_reports:
        print(f"  shard {r.part}: rows={r.rows} nnz={r.nnz} "
              f"local={r.local_nnz / max(1, r.nnz):.2f} -> {r.format}")

    e0 = ground_state_energy(overlap, args.n, m=60)
    print(f"\nsharded Lanczos ground state (overlap plan): {e0:.6f}")
    return {"matrix": m, "mesh": mesh, "x": x, "variants": variants, "e0": e0}


if __name__ == "__main__":
    main()
