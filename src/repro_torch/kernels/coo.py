"""COO registry entries: ``(coo, {spmv, spmm}, {torch, loop_reference})``.

COO has no TPU kernel in the reference, so it has no CUDA kernel here: the
``torch`` entry (gather + ``index_add_`` over the explicit row ids) runs on
the plan's device, the card included.  On the card ``index_add_`` adds with
atomics, so the order of each row's sum -- and with it the last bits of the
result -- can change from one call to the next; on the host the sums run
in entry order.  The ``loop_reference`` oracle adds with ``scatter_add_``,
so the two entries share no reduction code.
"""
from __future__ import annotations

import torch

from ..core.formats import COO
from .accum import acc_dtype
from .cache import spmm_by_columns
from .registry import CompiledKernel, on_device, register_kernel


def coo_spmv_plain(rows, cols, vals, scale, x, n_rows: int):
    """y = A x: one gather of x, products, ``index_add_`` into the rows."""
    acc = acc_dtype(vals.dtype, x.dtype)
    prod = vals.to(acc) * x.index_select(0, cols).to(acc)
    y = torch.zeros(n_rows, dtype=acc, device=x.device).index_add_(0, rows, prod)
    return y if scale is None else y * scale.to(acc)


def coo_spmm_plain(rows, cols, vals, scale, X, n_rows: int):
    acc = acc_dtype(vals.dtype, X.dtype)
    prod = vals.to(acc)[:, None] * X.index_select(0, cols).to(acc)
    Y = torch.zeros((n_rows, X.shape[1]), dtype=acc, device=X.device).index_add_(0, rows, prod)
    return Y if scale is None else Y * scale.to(acc)[:, None]


def coo_spmv_scatter_plain(rows, cols, vals, scale, x, n_rows: int):
    """The oracle: the same products added by ``scatter_add_``."""
    acc = acc_dtype(vals.dtype, x.dtype)
    prod = vals.to(acc) * x.to(acc)[cols.long()]
    y = torch.zeros(n_rows, dtype=acc, device=x.device).scatter_add_(0, rows.long(), prod)
    return y if scale is None else y * scale.to(acc)


def _arrays(m: COO, device):
    return [None if t is None else t.to(device) for t in (m.rows, m.cols, m.vals, m.scale)]


def coo_spmv(m: COO, x: torch.Tensor) -> torch.Tensor:
    """``coo_spmv_plain`` of a container, on x's device."""
    return coo_spmv_plain(*_arrays(m, x.device), x, m.shape[0])


def coo_spmm(m: COO, X: torch.Tensor) -> torch.Tensor:
    return coo_spmm_plain(*_arrays(m, X.device), X, m.shape[0])


def coo_spmv_scatter(m: COO, x: torch.Tensor) -> torch.Tensor:
    return coo_spmv_scatter_plain(*_arrays(m, x.device), x, m.shape[0])


def _operands(m: COO, ctx):
    return on_device(ctx, m.rows, m.cols, m.vals, m.scale)


@register_kernel("coo", "spmv", "torch",
                 description="gather + index_add_ over explicit row ids")
def _build_spmv(m: COO, ctx) -> CompiledKernel:
    rows, cols, vals, scale = _operands(m, ctx)
    n = m.shape[0]
    return CompiledKernel(lambda x: coo_spmv_plain(rows, cols, vals, scale, x, n), "torch")


@register_kernel("coo", "spmm", "torch",
                 description="multi-vector gather + index_add_")
def _build_spmm(m: COO, ctx) -> CompiledKernel:
    rows, cols, vals, scale = _operands(m, ctx)
    n = m.shape[0]
    return CompiledKernel(lambda X: coo_spmm_plain(rows, cols, vals, scale, X, n), "torch")


@register_kernel("coo", "spmv", "loop_reference",
                 description="independent scatter_add_ oracle")
def _build_spmv_loop(m: COO, ctx) -> CompiledKernel:
    rows, cols, vals, scale = _operands(m, ctx)
    n = m.shape[0]
    return CompiledKernel(
        lambda x: coo_spmv_scatter_plain(rows, cols, vals, scale, x, n), "loop")


@register_kernel("coo", "spmm", "loop_reference",
                 description="column-by-column scatter_add_ oracle")
def _build_spmm_loop(m: COO, ctx) -> CompiledKernel:
    rows, cols, vals, scale = _operands(m, ctx)
    n = m.shape[0]
    return CompiledKernel(spmm_by_columns(
        lambda x: coo_spmv_scatter_plain(rows, cols, vals, scale, x, n)), "loop")
