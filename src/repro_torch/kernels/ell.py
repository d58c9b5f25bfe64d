"""ELL registry entries: ``(ell, {spmv, spmm}, {torch, loop_reference})``.

ELL has no TPU kernel in the reference, so it has no CUDA kernel here: on
the card it runs the composite ``torch`` entry (one (M, W) gather and a
width reduction), and the perfmodel's ``h100`` table prices it as such.
"""
from __future__ import annotations

import torch

from ..core.formats import ELL
from .accum import acc_dtype
from .cache import spmm_by_columns
from .registry import CompiledKernel, container_fn, on_device, register_kernel


def ell_spmv_plain(col, val, scale, x):
    """Row-major ELL: one (M, W) gather, a reduction over W, the per-row
    scale of a quantized container on the row sums."""
    acc = acc_dtype(val.dtype, x.dtype)
    g = x.index_select(0, col.reshape(-1)).reshape(col.shape).to(acc)
    y = (val.to(acc) * g).sum(1)
    return y if scale is None else y * scale.to(acc)


def ell_spmm_plain(col, val, scale, X):
    acc = acc_dtype(val.dtype, X.dtype)
    g = X.index_select(0, col.reshape(-1)).reshape(col.shape + (X.shape[1],)).to(acc)
    Y = torch.einsum("mw,mwk->mk", val.to(acc), g)
    return Y if scale is None else Y * scale.to(acc)[:, None]


def ell_spmv_loop_plain(col, val, scale, x):
    """One pass per padded jagged column (host loop over W): the oracle."""
    acc = acc_dtype(val.dtype, x.dtype)
    y = torch.zeros(col.shape[0], dtype=acc, device=x.device)
    for j in range(col.shape[1]):
        y = y + val[:, j].to(acc) * x.to(acc)[col[:, j].long()]
    return y if scale is None else y * scale.to(acc)


def ell_spmv(m: ELL, x: torch.Tensor) -> torch.Tensor:
    """The ``torch`` entry on x's device."""
    return container_fn(m, "ell", "spmv", "torch", x.device)(x)


def ell_spmm(m: ELL, X: torch.Tensor) -> torch.Tensor:
    return container_fn(m, "ell", "spmm", "torch", X.device)(X)


def ell_spmv_loop(m: ELL, x: torch.Tensor) -> torch.Tensor:
    """The loop oracle on x's device."""
    return container_fn(m, "ell", "spmv", "loop_reference", x.device)(x)


def _operands(m: ELL, ctx):
    return on_device(ctx, m.col_idx, m.val, m.scale)


@register_kernel("ell", "spmv", "torch", description="one (M, W) gather + width sum")
def _build_spmv(m: ELL, ctx) -> CompiledKernel:
    col, val, scale = _operands(m, ctx)
    return CompiledKernel(lambda x: ell_spmv_plain(col, val, scale, x), "torch")


@register_kernel("ell", "spmm", "torch", description="(M, W, K) gather + einsum")
def _build_spmm(m: ELL, ctx) -> CompiledKernel:
    col, val, scale = _operands(m, ctx)
    return CompiledKernel(lambda X: ell_spmm_plain(col, val, scale, X), "torch")


@register_kernel("ell", "spmv", "loop_reference",
                 description="per-jagged-column traversal oracle")
def _build_spmv_loop(m: ELL, ctx) -> CompiledKernel:
    col, val, scale = _operands(m, ctx)
    return CompiledKernel(lambda x: ell_spmv_loop_plain(col, val, scale, x), "loop")


@register_kernel("ell", "spmm", "loop_reference",
                 description="column-by-column jagged-traversal oracle")
def _build_spmm_loop(m: ELL, ctx) -> CompiledKernel:
    col, val, scale = _operands(m, ctx)
    return CompiledKernel(
        spmm_by_columns(lambda x: ell_spmv_loop_plain(col, val, scale, x)), "loop")
