"""Kernel implementations and the backend registry.

Per-format modules (``coo``/``csr``/``ell``/``jds``/``sell``/``dia``/
``bsr``/``hybrid``/``matrix_free``/``mf_product``/``slab``) hold the
composite PyTorch formulations, the loop oracles and the ``cuda`` entries;
``*_spmv.py``/``bsr_spmm.py``/``moe_gemm.py``/``gather_bench.py`` wrap the
hand-written CUDA kernels of ``csrc/`` (built by ``cuda_build`` at first
use) beside their plain versions; ``plan_launch`` launches the DIA and
SELL kernels of a ``dia``, ``sell`` or ``hybrid`` SpMV on the card in one
C call.  Every implementation registers with
``registry`` under a ``(format, op, backend)`` key; the plan,
distributed-plan and serving layers dispatch through that table.
"""
# core first: its modules import kernels.registry, and core.spmv re-exports
# the per-format kernel modules below
from .. import core as _core  # noqa: F401

from . import (  # noqa: F401,E402
    accum,
    bsr,
    bsr_spmm,
    cache,
    coo,
    csr,
    csr_spmv,
    cuda_build,
    dia,
    dia_spmv,
    ell,
    gather_bench,
    hybrid,
    jds,
    matrix_free,
    mf_product,
    moe_gemm,
    ops,
    plan_launch,
    registry,
    sell,
    sell_spmv,
    slab,
)
