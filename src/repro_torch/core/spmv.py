"""The type-dispatching SpMV façade: ``spmv(matrix, x)`` for any container.

Port of ``repro.core.spmv``.  Nothing here computes: each call reaches the
registry entry of the container's format -- the composite ``torch`` entry
(the reference's XLA formulation) for ``spmv`` / ``spmm``, the per-call
loop formulations for ``naive_spmv`` -- built once per container and
device and cached on the container.  For the compiled path with the CUDA
kernels use ``core.plan.SpMVPlan.compile``.  The reference's per-format
functions (``csr_spmv(m, x)``, ``sell_spmv_loop(m, x)``, ...) are
re-exported from ``repro_torch.kernels``: ``*_spmv`` / ``*_spmm`` run the
format's ``torch`` entry on x's device, ``*_loop`` its loop oracle.

Every function runs on the device of a tensor ``x``.  A numpy ``x`` is
placed on the card, or on the host when ``device="cpu"`` is passed (never
on the host by default).  ``y = A @ x`` for ``A`` of shape ``(M, N)``;
multi-vector calls take ``X`` of shape ``(N, K)``.  PyTorch runs eagerly,
so there is no ``jit`` step.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..kernels import registry as R
from ..kernels.bsr import bsr_block_row_ids, bsr_spmm, bsr_spmv  # noqa: F401
from ..kernels.cache import precompute_stats  # noqa: F401
from ..kernels.coo import coo_spmm, coo_spmv  # noqa: F401
from ..kernels.csr import (  # noqa: F401
    csr_row_ids,
    csr_spmm,
    csr_spmv,
    csr_spmv_searchsorted,
)
from ..kernels.dia import (  # noqa: F401
    dia_gather_tables,
    dia_spmm,
    dia_spmv,
    dia_spmv_loop,
)
from ..kernels.ell import ell_spmm, ell_spmv, ell_spmv_loop  # noqa: F401
from ..kernels.hybrid import (  # noqa: F401
    hybrid_spmm,
    hybrid_spmv,
    hybrid_spmv_loop,
)
from ..kernels.jds import (  # noqa: F401
    jds_segment_ids,
    jds_spmm,
    jds_spmv,
    jds_spmv_loop,
)
from ..kernels.sell import (  # noqa: F401
    sell_padded_views,
    sell_spmm,
    sell_spmm_padded,
    sell_spmv,
    sell_spmv_loop,
    sell_spmv_padded,
)
from ..utils.hw import default_device
from .formats import BSR, COO, CSR, DIA, ELL, JDS, SELL, HybridDIA

#: container type -> registry format (the reference's dispatch table)
_FORMATS = {COO: "coo", CSR: "csr", ELL: "ell", JDS: "jds", SELL: "sell",
            BSR: "bsr", DIA: "dia", HybridDIA: "hybrid"}

#: formats whose naive (pre-plan) formulation is the loop entry; the rest
#: are the same formulation as ``spmv``
_NAIVE_LOOP = ("csr", "jds", "sell", "dia", "hybrid")


def _operand(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if device is not None and default_device(device) != x.device:
            raise ValueError(f"x is on {x.device}, not on the requested {device}")
        return x
    return torch.as_tensor(np.asarray(x), device=default_device(device))


def _run(matrix, op: str, naive: bool, x, device) -> torch.Tensor:
    fmt = _FORMATS.get(type(matrix))
    if fmt is None:
        raise TypeError(f"no {op} for {type(matrix).__name__}")
    x = _operand(x, device)
    backend = "loop_reference" if naive and fmt in _NAIVE_LOOP else "torch"
    return R.container_fn(matrix, fmt, op, backend, x.device)(x)


def spmv(matrix, x, *, device=None) -> torch.Tensor:
    """Format-dispatching SpMV (the composite ``torch`` formulation)."""
    return _run(matrix, "spmv", False, x, device)


def spmm(matrix, X, *, device=None) -> torch.Tensor:
    """Format-dispatching multi-vector SpMV: X (N, K) -> Y (M, K)."""
    return _run(matrix, "spmm", False, X, device)


def naive_spmv(matrix, x, *, device=None) -> torch.Tensor:
    """SpMV through the per-call loop formulations (the benchmark
    baseline): searchsorted row ids for CSR, per-diagonal / per-chunk loops
    for JDS, SELL, DIA and the hybrid."""
    return _run(matrix, "spmv", True, x, device)


def make_naive_spmv(matrix, *, device=None):
    """``f(x) -> y`` of ``naive_spmv`` closed over ``matrix``."""
    return partial(naive_spmv, matrix, device=device)


def make_spmv(matrix, *, device=None):
    """``f(x) -> y`` of ``spmv`` closed over ``matrix``."""
    return partial(spmv, matrix, device=device)


def flops_of(matrix) -> int:
    """Useful FLOPs of one SpMV: 2 per stored non-zero (for BSR, the dense
    block entries)."""
    return 2 * matrix.nnz
