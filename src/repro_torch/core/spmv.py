"""The type-dispatching SpMV façade: ``spmv(matrix, x)`` for any container.

Port of ``repro.core.spmv``.  Nothing here computes: each call reaches the
registry entry of the container's format -- the composite ``torch`` entry
(the reference's XLA formulation) for ``spmv`` / ``spmm``, the per-call
loop formulations for ``naive_spmv`` -- built once per container and
device and cached on the container.  For the compiled path with the CUDA
kernels use ``core.plan.SpMVPlan.compile``.

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
    cache = getattr(matrix, "_facade_fns", None)
    if cache is None:
        cache = {}
        object.__setattr__(matrix, "_facade_fns", cache)
    key = (op, backend, str(x.device))
    fn = cache.get(key)
    if fn is None:
        ctx = R.KernelContext(device=x.device)
        fn = cache[key] = R.build(matrix, fmt, op, backend, ctx).fn
    return fn(x)


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
