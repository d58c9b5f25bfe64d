"""SELL-C-sigma registry entries: ``(sell, {spmv, spmm}, {torch,
loop_reference})`` and the CUDA SpMV of ``sell_spmv.py``.  The multi-vector
SELL kernel is still to port (ROADMAP.md, queue 2), so SpMM is ``torch``
only."""
from __future__ import annotations

import numpy as np
import torch

from ..core.formats import SELL, _np
from . import sell_spmv as KP
from .accum import acc_dtype
from .cache import cached, register_stat, spmm_by_columns
from .registry import CompiledKernel, KernelContext, on_device, register_kernel

register_stat("sell_segment_ids")


def sell_segment_ids(m: SELL) -> torch.Tensor:
    """Per-slot permuted-row ids of the flat layout, host-built once."""
    return cached(m, "_segment_ids", "sell_segment_ids",
                  lambda: KP.sell_segment_ids(m.chunk_ptr, m.chunk_width, m.C,
                                              m.col_idx.shape[0]))


def _operands(m: SELL, ctx):
    return on_device(ctx, m.chunk_ptr, m.chunk_width, m.col_idx, m.val, m.scale, m.perm)


def sell_spmm_plain(chunk_width, col_idx, val, scale, perm, X, n_rows: int,
                    C: int, seg):
    acc = acc_dtype(val.dtype, X.dtype)
    prod = val.to(acc)[:, None] * X.to(acc).index_select(0, col_idx)
    tiles = torch.zeros((chunk_width.shape[0] * C, X.shape[1]), dtype=acc,
                        device=X.device).index_add_(0, seg, prod)
    if scale is not None:
        tiles = tiles * scale.to(acc).repeat_interleave(C)[:, None]
    return torch.empty((n_rows, X.shape[1]), dtype=acc, device=X.device
                       ).index_copy_(0, perm[:n_rows].long(), tiles[:n_rows])


def sell_spmv_loop(m: SELL, ctx: KernelContext):
    """The chunk-local slab traversal (host loop over chunks): the oracle."""
    cp, cw = _np(m.chunk_ptr).tolist(), _np(m.chunk_width).tolist()
    C, n = m.C, m.shape[0]
    _, _, col, val, scale, perm = _operands(m, ctx)
    perm = perm.long()
    scales = None if m.scale is None else _np(m.scale).tolist()

    def fn(x):
        acc = acc_dtype(val.dtype, x.dtype)
        y = torch.zeros(n + 1, dtype=acc, device=x.device)
        for c in range(len(cw)):
            lo, hi = cp[c], cp[c + 1]
            slab_v = val[lo:hi].to(acc).reshape(cw[c], C)
            slab_x = x.to(acc)[col[lo:hi].long()].reshape(cw[c], C)
            tile = (slab_v * slab_x).sum(0)
            if scales is not None:
                tile = tile * scales[c]
            y.index_add_(0, perm[c * C:(c + 1) * C], tile)
        return y[:n]

    return fn


@register_kernel("sell", "spmv", "torch",
                 description="flat gather + index_add_ + inverse permutation")
def _build_spmv(m: SELL, ctx) -> CompiledKernel:
    cp, cw, col, val, scale, perm = _operands(m, ctx)
    (seg,) = on_device(ctx, sell_segment_ids(m))
    n, C = m.shape[0], m.C
    return CompiledKernel(lambda x: KP.sell_spmv_plain(
        cp, cw, col, val, scale, perm, x, n, C, seg), "torch")


@register_kernel("sell", "spmm", "torch",
                 description="multi-vector flat gather + index_add_")
def _build_spmm(m: SELL, ctx) -> CompiledKernel:
    _, cw, col, val, scale, perm = _operands(m, ctx)
    (seg,) = on_device(ctx, sell_segment_ids(m))
    n, C = m.shape[0], m.C
    return CompiledKernel(lambda X: sell_spmm_plain(
        cw, col, val, scale, perm, X, n, C, seg), "torch")


@register_kernel("sell", "spmv", "loop_reference",
                 description="chunk-local slab traversal (oracle)")
def _build_spmv_loop(m: SELL, ctx) -> CompiledKernel:
    return CompiledKernel(sell_spmv_loop(m, ctx), "loop")


@register_kernel("sell", "spmm", "loop_reference",
                 description="column-by-column slab traversals")
def _build_spmm_loop(m: SELL, ctx) -> CompiledKernel:
    return CompiledKernel(spmm_by_columns(sell_spmv_loop(m, ctx)), "loop")


def _check_indices(m: SELL) -> None:
    """Host bounds check before the raw-pointer kernel ever sees the pack."""
    cp, cw, col = _np(m.chunk_ptr), _np(m.chunk_width), _np(m.col_idx)
    if cp[0] != 0 or cp[-1] != col.shape[0] or not np.array_equal(
            np.diff(cp), cw.astype(np.int64) * m.C):
        raise ValueError("SELL chunk_ptr does not match chunk_width * C")
    if col.size and (col.min() < 0 or col.max() >= m.shape[1]):
        raise ValueError("SELL col_idx out of range for the matrix's columns")
    perm, n = _np(m.perm), m.shape[0]
    if perm.shape[0] != m.n_chunks * m.C or (perm[n:] < n).any() or \
            not np.array_equal(np.sort(perm[:n]), np.arange(n)):
        raise ValueError("SELL perm is not a permutation of the rows")


@register_kernel("sell", "spmv", "cuda",
                 description="thread per chunk row, own chunk width, fused "
                             "scale + inverse permutation")
def _build_spmv_cuda(m: SELL, ctx) -> CompiledKernel:
    _check_indices(m)
    cp, cw, col, val, scale, perm = _operands(m, ctx)
    n, C = m.shape[0], m.C
    return CompiledKernel(lambda x: KP.sell_spmv_arrays(
        cp, cw, col, val, scale, perm, x, n, C), "cuda")
