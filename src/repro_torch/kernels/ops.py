"""Kernel entry points with backend dispatch: the reference's ``ops`` shim.

backend:
  "cuda"   -- the hand-written kernels (the reference's "pallas");
  "torch"  -- the composite PyTorch formulations (the reference's "ref");
  "auto"   -- the registry's pick: the ``cuda`` kernel whenever its probe
              accepts the operand (on a CUDA device), else by cost.

The legacy names "pallas" and "ref" map to "cuda" and "torch".  Every
function below resolves to a registry entry (``kernels.registry``) on the
device ``device`` names (default: the card, a ``RuntimeError`` without
one; ``"cpu"`` runs the plain versions); the reference's TPU probe and
interpret flag have no counterpart.  An explicitly requested backend whose
probe refuses the operand runs the ``torch`` entry, as the plan layer does;
a kernel that fails to build or launch raises.  The reference's SELL and
DIA block sizes (``chunk_block``, ``width_pad``, ``tile``) are Pallas VMEM
tilings with no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.formats import BSR, DIA, SELL, HybridDIA
from ..utils.hw import default_device
from . import moe_gemm as _moe
from . import registry as R

_LEGACY = {"pallas": "cuda", "ref": "torch"}


def _resolve(backend: str) -> str:
    """Legacy name -> registry backend ("auto" stays symbolic)."""
    return _LEGACY.get(backend, backend)


def _build(matrix, fmt: str, op: str, backend: str, device=None):
    ctx = R.KernelContext(device=default_device(device))
    be = _resolve(backend)
    if be == "auto":
        return R.build(matrix, fmt, op, R.select_backend(matrix, fmt, op, ctx)[0], ctx)
    try:
        return R.build(matrix, fmt, op, be, ctx)
    except (KeyError, R.BackendUnavailable):
        return R.build(matrix, fmt, op, "torch", ctx)


def make_sell_spmv(m: SELL, *, backend: str = "auto", device=None):
    """``f(x) -> y`` for a SELL matrix, through the plan layer."""
    from ..core.plan import SpMVPlan
    from ..core.planconfig import PlanConfig

    be = _resolve(backend)
    return SpMVPlan.compile(m, PlanConfig(backend=be, device=device)).apply


def make_bsr_spmm(m: BSR, *, backend: str = "auto", device=None):
    """``f(X) -> Y`` for a BSR matrix and X (K, N): on the card the BELL
    kernel."""
    return _build(m, "bsr", "spmm", backend, device).fn


def make_dia_spmv(m: DIA, *, backend: str = "auto", device=None):
    return _build(m, "dia", "spmv", backend, device).fn


def make_hybrid_spmv(m: HybridDIA, *, backend: str = "auto", device=None):
    f_dia = make_dia_spmv(m.dia, backend=backend, device=device)
    f_sell = make_sell_spmv(m.rest, backend=backend, device=device)
    return lambda x: f_dia(x) + f_sell(x)


def grouped_gemm(X, expert_of_token, W, *, backend: str = "auto", bt: int = 128,
                 device=None):
    """MoE expert GEMM with host routing: ``Y[t] = X[t] @ W[expert_of_token[t]]``.

    ``X (T, D)`` and ``W (E, D, F)`` are tensors (their device decides) or
    numpy arrays (moved to ``device``, default the card).  Not a registry
    format: "torch" runs the plain version, any other name -- "auto"
    included -- the kernel path, which launches the grouped GEMM kernel on
    card tensors and runs the plain version on CPU tensors."""
    dev = None if isinstance(X, torch.Tensor) else default_device(device)
    X = X if dev is None else torch.as_tensor(np.asarray(X), device=dev)
    W = W if isinstance(W, torch.Tensor) else torch.as_tensor(np.asarray(W), device=X.device)
    return _moe.grouped_gemm(X, expert_of_token, W, bt=bt,
                             plain=_resolve(backend) == "torch")


_FMT_OF = {SELL: "sell", BSR: "bsr", DIA: "dia", HybridDIA: "hybrid"}


def make_kernel_spmv(matrix, *, backend: str = "auto", device=None):
    """``f(x) -> y`` for any container with a kernel path."""
    if isinstance(matrix, SELL):
        return make_sell_spmv(matrix, backend=backend, device=device)
    if isinstance(matrix, HybridDIA):
        return make_hybrid_spmv(matrix, backend=backend, device=device)
    fmt = _FMT_OF.get(type(matrix))
    if fmt is None:
        raise TypeError(f"no kernel path for {type(matrix).__name__}")
    return _build(matrix, fmt, "spmv", backend, device).fn
