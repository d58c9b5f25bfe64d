"""JDS registry entries: ``(jds, {spmv, spmm}, {torch, loop_reference})``.

JDS (the paper's jagged diagonals, a sparse vector triad at 18 B/F) has no
TPU kernel in the reference, so it has no CUDA kernel here: on the card it
runs the composite ``torch`` entry, and the perfmodel's ``h100`` table
prices it as such.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.formats import JDS, _np
from .accum import acc_dtype
from .cache import cached, register_stat, spmm_by_columns
from .registry import CompiledKernel, container_fn, on_device, register_kernel

register_stat("jds_segment_ids")


def jds_segment_ids(m: JDS) -> torch.Tensor:
    """Permuted-row id per stored element: within jagged diagonal d the
    k-th entry belongs to permuted row k.  Host-built once."""

    def build():
        jp = _np(m.jd_ptr).astype(np.int64)
        lens = np.diff(jp)
        return torch.from_numpy(np.arange(int(jp[-1]), dtype=np.int64)
                                - np.repeat(jp[:-1], lens))

    return cached(m, "_segment_ids", "jds_segment_ids", build)


def jds_spmm_plain(col, val, scale, perm, X, seg, n_rows: int):
    """Gather + ``index_add_`` over the permuted-row table, the per-permuted-
    row scale, then the scatter back to original row order (X: (N, K))."""
    acc = acc_dtype(val.dtype, X.dtype)
    prod = val.to(acc)[:, None] * X.index_select(0, col).to(acc)
    Yp = torch.zeros((perm.shape[0], X.shape[1]), dtype=acc,
                     device=X.device).index_add_(0, seg, prod)
    if scale is not None:
        Yp = Yp * scale.to(acc)[:, None]
    return torch.zeros((n_rows, X.shape[1]), dtype=acc, device=X.device
                       ).index_copy_(0, perm[:n_rows].long(), Yp[:n_rows])


def jds_spmv_loop_plain(jd_ptr: list, col, val, scale, perm, x, n_rows: int):
    """One pass per jagged diagonal (the paper's outer loop): the oracle."""
    acc = acc_dtype(val.dtype, x.dtype)
    yp = torch.zeros(perm.shape[0], dtype=acc, device=x.device)
    for d in range(len(jd_ptr) - 1):
        lo, hi = jd_ptr[d], jd_ptr[d + 1]
        yp[: hi - lo] += val[lo:hi].to(acc) * x.to(acc)[col[lo:hi].long()]
    if scale is not None:
        yp = yp * scale.to(acc)
    y = torch.zeros(n_rows, dtype=acc, device=x.device)
    y[perm[:n_rows].long()] = yp[:n_rows]
    return y


def jds_spmv(m: JDS, x: torch.Tensor) -> torch.Tensor:
    """The ``torch`` entry on x's device."""
    return container_fn(m, "jds", "spmv", "torch", x.device)(x)


def jds_spmm(m: JDS, X: torch.Tensor) -> torch.Tensor:
    return container_fn(m, "jds", "spmm", "torch", X.device)(X)


def jds_spmv_loop(m: JDS, x: torch.Tensor) -> torch.Tensor:
    """The loop oracle on x's device."""
    return container_fn(m, "jds", "spmv", "loop_reference", x.device)(x)


def _operands(m: JDS, ctx):
    return on_device(ctx, m.col_idx, m.val, m.scale, m.perm)


@register_kernel("jds", "spmv", "torch",
                 description="gather + index_add_ over the permuted-row table")
def _build_spmv(m: JDS, ctx) -> CompiledKernel:
    col, val, scale, perm = _operands(m, ctx)
    (seg,) = on_device(ctx, jds_segment_ids(m))
    n = m.shape[0]
    return CompiledKernel(
        lambda x: jds_spmm_plain(col, val, scale, perm, x[:, None], seg, n)[:, 0],
        "torch")


@register_kernel("jds", "spmm", "torch",
                 description="multi-vector permuted index_add_")
def _build_spmm(m: JDS, ctx) -> CompiledKernel:
    col, val, scale, perm = _operands(m, ctx)
    (seg,) = on_device(ctx, jds_segment_ids(m))
    n = m.shape[0]
    return CompiledKernel(lambda X: jds_spmm_plain(col, val, scale, perm, X, seg, n),
                          "torch")


def _loop_fn(m: JDS, ctx):
    col, val, scale, perm = _operands(m, ctx)
    jp, n = _np(m.jd_ptr).tolist(), m.shape[0]
    return lambda x: jds_spmv_loop_plain(jp, col, val, scale, perm, x, n)


@register_kernel("jds", "spmv", "loop_reference",
                 description="per-jagged-diagonal traversal (oracle)")
def _build_spmv_loop(m: JDS, ctx) -> CompiledKernel:
    return CompiledKernel(_loop_fn(m, ctx), "loop")


@register_kernel("jds", "spmm", "loop_reference",
                 description="column-by-column jagged-diagonal traversals")
def _build_spmm_loop(m: JDS, ctx) -> CompiledKernel:
    return CompiledKernel(spmm_by_columns(_loop_fn(m, ctx)), "loop")
