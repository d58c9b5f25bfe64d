"""CSR registry entries: ``(csr, {spmv, spmm}, {torch, loop_reference})``
and the CUDA SpMV of ``csr_spmv.py``.

The loop reference expands the row ids on every call with a searchsorted,
independent of the cached row ids of the ``torch`` entry it validates.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.formats import CSR, _np
from . import csr_spmv as KP
from .accum import acc_dtype
from .cache import cached, register_stat, spmm_by_columns
from .registry import CompiledKernel, container_fn, on_device, register_kernel

register_stat("csr_row_ids")
register_stat("csr_row_blocks")


def csr_row_ids(m: CSR) -> torch.Tensor:
    """One row id per nonzero, host-built once per container."""

    def build():
        rp = _np(m.row_ptr).astype(np.int64)
        return torch.from_numpy(
            np.repeat(np.arange(len(rp) - 1, dtype=np.int32), np.diff(rp)))

    return cached(m, "_row_ids", "csr_row_ids", build)


def csr_row_blocks(m: CSR) -> KP.RowBlocks:
    """The CUDA kernel's row blocks (``csr_spmv.RowBlocks``), host-built and
    checked once per container."""
    return cached(m, "_row_blocks", "csr_row_blocks",
                  lambda: KP.csr_row_blocks(_np(m.row_ptr)))


def csr_spmm_plain(row_ptr, col_idx, val, scale, X, row_ids):
    acc = acc_dtype(val.dtype, X.dtype)
    prod = val.to(acc)[:, None] * X.to(acc).index_select(0, col_idx)
    Y = torch.zeros((row_ptr.shape[0] - 1, X.shape[1]), dtype=acc,
                    device=X.device).index_add_(0, row_ids, prod)
    return Y if scale is None else Y * scale.to(acc)[:, None]


def csr_spmv_searchsorted_plain(row_ptr, col_idx, val, scale, x):
    """The naive oracle on arrays: row ids from a per-call searchsorted."""
    nnz = col_idx.shape[0]
    row_ids = torch.searchsorted(
        row_ptr, torch.arange(nnz, dtype=row_ptr.dtype, device=row_ptr.device),
        right=True) - 1
    acc = acc_dtype(val.dtype, x.dtype)
    prod = val.to(acc) * x.to(acc)[col_idx.long()]
    y = torch.zeros(row_ptr.shape[0] - 1, dtype=acc, device=x.device)
    y.index_add_(0, row_ids, prod)
    return y if scale is None else y * scale.to(acc)


def csr_spmv(m: CSR, x: torch.Tensor) -> torch.Tensor:
    """The ``torch`` entry on x's device: cached row ids, gather +
    ``index_add_``, the per-row scale on the row sums."""
    return container_fn(m, "csr", "spmv", "torch", x.device)(x)


def csr_spmm(m: CSR, X: torch.Tensor) -> torch.Tensor:
    return container_fn(m, "csr", "spmm", "torch", X.device)(X)


def csr_spmv_searchsorted(m: CSR, x: torch.Tensor) -> torch.Tensor:
    """The loop oracle on x's device: the row ids expanded by a
    searchsorted on every call (the naive baseline)."""
    return container_fn(m, "csr", "spmv", "loop_reference", x.device)(x)


@register_kernel("csr", "spmv", "torch",
                 description="cached row ids, gather + index_add_")
def _build_spmv(m: CSR, ctx) -> CompiledKernel:
    rp, col, val, scale, rid = on_device(ctx, m.row_ptr, m.col_idx, m.val, m.scale,
                                   csr_row_ids(m))
    return CompiledKernel(
        lambda x: KP.csr_spmv_plain(rp, col, val, scale, x, rid), "torch")


@register_kernel("csr", "spmm", "torch",
                 description="multi-vector gather + index_add_")
def _build_spmm(m: CSR, ctx) -> CompiledKernel:
    rp, col, val, scale, rid = on_device(ctx, m.row_ptr, m.col_idx, m.val, m.scale,
                                   csr_row_ids(m))
    return CompiledKernel(
        lambda X: csr_spmm_plain(rp, col, val, scale, X, rid), "torch")


@register_kernel("csr", "spmv", "loop_reference",
                 description="per-call searchsorted row ids (naive oracle)")
def _build_spmv_loop(m: CSR, ctx) -> CompiledKernel:
    rp, col, val, scale = on_device(ctx, m.row_ptr, m.col_idx, m.val, m.scale)
    return CompiledKernel(
        lambda x: csr_spmv_searchsorted_plain(rp, col, val, scale, x), "loop")


@register_kernel("csr", "spmm", "loop_reference",
                 description="column-by-column naive-oracle SpMVs")
def _build_spmm_loop(m: CSR, ctx) -> CompiledKernel:
    rp, col, val, scale = on_device(ctx, m.row_ptr, m.col_idx, m.val, m.scale)
    return CompiledKernel(spmm_by_columns(
        lambda x: csr_spmv_searchsorted_plain(rp, col, val, scale, x)), "loop")


def _check_indices(m: CSR) -> None:
    """Host bounds check before the raw-pointer kernel ever sees the arrays."""
    rp, col = _np(m.row_ptr), _np(m.col_idx)
    if rp.shape[0] != m.n_rows + 1 or rp[0] != 0 or rp[-1] != col.shape[0] \
            or (np.diff(rp) < 0).any():
        raise ValueError("CSR row_ptr is not a valid offset table")
    if col.size and (col.min() < 0 or col.max() >= m.shape[1]):
        raise ValueError("CSR col_idx out of range for the matrix's columns")


@register_kernel("csr", "spmv", "cuda",
                 description="row blocks balanced by nonzeros (CSR-stream / CSR-vector)")
def _build_spmv_cuda(m: CSR, ctx) -> CompiledKernel:
    _check_indices(m)
    rp, col, val, scale = on_device(ctx, m.row_ptr, m.col_idx, m.val, m.scale)
    blocks = csr_row_blocks(m)
    blocks.on(rp.device)  # to the card at plan compile, not on the first SpMV
    return CompiledKernel(
        lambda x: KP.csr_spmv_arrays(rp, col, val, scale, x, blocks), "cuda")
