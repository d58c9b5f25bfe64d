"""BSR registry entries: ``(bsr, {spmv, spmm}, {torch, cuda,
loop_reference})``.

* ``torch`` -- the composite formulation of the reference's ``xla`` entry:
  gather the X block row of every stored block, one per-block ``einsum``,
  the per-block scale of an int8 / fp8 container on the partials, and an
  ``index_add_`` over block rows.
* ``cuda`` -- the BELL kernel of ``bsr_spmm.py`` (``csrc/bell_spmm.cu``)
  over the container's BELL pack, built once; SpMV is its N = 1 case.  It
  takes every value dtype, int8 / fp8 with their per-block scale.
* ``loop_reference`` -- one pass per BELL block-column slot (the
  block-granular jagged-diagonal traversal), never picked automatically.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import formats as F
from ..core.formats import BSR, _np
from . import bsr_spmm as KP
from .accum import acc_dtype
from .cache import cached, register_stat
from .registry import CompiledKernel, container_fn, on_device, register_kernel

register_stat("bsr_block_row_ids")
register_stat("bsr_bell_pack")


def bsr_block_row_ids(m: BSR) -> torch.Tensor:
    """The block row of every stored block, host-built once per container."""

    def build():
        brp = _np(m.block_row_ptr).astype(np.int64)
        return torch.from_numpy(np.repeat(np.arange(len(brp) - 1), np.diff(brp)))

    return cached(m, "_block_row_ids", "bsr_block_row_ids", build)


def bsr_spmv(m: BSR, x: torch.Tensor) -> torch.Tensor:
    """The ``torch`` entry on x's device: block gather, per-block einsum,
    ``index_add_`` over block rows."""
    return container_fn(m, "bsr", "spmv", "torch", x.device)(x)


def bsr_spmm(m: BSR, X: torch.Tensor) -> torch.Tensor:
    return container_fn(m, "bsr", "spmm", "torch", X.device)(X)


def bell_pack(m: BSR):
    """``(bcols, slab, scale slab or None, row_nblocks)``, built once per
    container."""
    return cached(m, "_bell_pack", "bsr_bell_pack",
                  lambda: (*KP.bsr_to_bell(m), KP.bell_scale(m), KP.bell_row_nblocks(m)))


def bsr_spmm_composite(blocks, block_col_idx, scale, rows, X, n_rows: int):
    """Block SpMM as gather + per-block ``einsum`` + ``index_add_``."""
    nb, bm, bn = blocks.shape
    acc = acc_dtype(blocks.dtype, X.dtype)
    Xb = X.to(acc).reshape(-1, bn, X.shape[1]).index_select(0, block_col_idx)
    part = torch.einsum("kmn,knj->kmj", blocks.to(acc), Xb)      # (nb, bm, K)
    if scale is not None:
        part = part * scale.to(acc)[:, None, None]
    Y = torch.zeros((n_rows // bm, bm, X.shape[1]), dtype=acc, device=X.device)
    return Y.index_add_(0, rows, part).reshape(n_rows, X.shape[1])


def bsr_spmm_slotloop(m: BSR, ctx):
    """Loop-reference oracle: one pass per BELL slot (padded slots hold
    zero blocks).  A quantized container is dequantized up front: the pack
    reorders blocks into slots, and the oracle stays independent of the
    kernel's fused scale."""
    if m.scale is not None:
        m = F.dequantize(m)
    bcols, slab, _, _ = bell_pack(m)
    bc, sl = on_device(ctx, bcols.long(), slab)
    bm, bk = m.block_shape
    nbr, nbpp = bcols.shape
    M = m.shape[0]

    def fn(X):
        acc = acc_dtype(sl.dtype, X.dtype)
        Xb = X.to(acc).reshape(-1, bk, X.shape[1])
        Y = torch.zeros((nbr, bm, X.shape[1]), dtype=acc, device=X.device)
        for j in range(nbpp):
            Y = Y + torch.einsum("rmk,rkj->rmj", sl[:, j].to(acc), Xb[bc[:, j]])
        return Y.reshape(nbr * bm, X.shape[1])[:M]

    return fn


def _composite(m: BSR, ctx):
    blocks, bci, scale, rows = on_device(ctx, m.blocks, m.block_col_idx.long(), m.scale,
                                         bsr_block_row_ids(m))
    M = m.shape[0]
    return lambda X: bsr_spmm_composite(blocks, bci, scale, rows, X, M)


@register_kernel("bsr", "spmv", "torch",
                 description="block gather + per-block einsum + index_add_")
def _build_spmv(m: BSR, ctx) -> CompiledKernel:
    f = _composite(m, ctx)
    return CompiledKernel(lambda x: f(x.reshape(-1, 1))[:, 0], "torch")


@register_kernel("bsr", "spmm", "torch",
                 description="multi-vector block einsum + index_add_")
def _build_spmm(m: BSR, ctx) -> CompiledKernel:
    return CompiledKernel(_composite(m, ctx), "torch")


@register_kernel("bsr", "spmv", "loop_reference",
                 description="BELL slot-loop oracle (single column)")
def _build_spmv_loop(m: BSR, ctx) -> CompiledKernel:
    f = bsr_spmm_slotloop(m, ctx)
    return CompiledKernel(lambda x: f(x.reshape(-1, 1))[:, 0], "loop")


@register_kernel("bsr", "spmm", "loop_reference",
                 description="BELL slot-loop oracle")
def _build_spmm_loop(m: BSR, ctx) -> CompiledKernel:
    return CompiledKernel(bsr_spmm_slotloop(m, ctx), "loop")


def _check_indices(m: BSR) -> None:
    """Host bounds check before the raw-pointer kernel sees the pack."""
    brp, bci = _np(m.block_row_ptr), _np(m.block_col_idx)
    bm, bn = m.block_shape
    if m.shape[0] % bm or m.shape[1] % bn:
        raise ValueError(f"BSR shape {m.shape} does not tile by {m.block_shape}")
    if brp.shape[0] != m.shape[0] // bm + 1 or brp[0] != 0 or brp[-1] != bci.shape[0] \
            or (np.diff(brp) < 0).any():
        raise ValueError("BSR block_row_ptr is not a row pointer over its blocks")
    if bci.size and (bci.min() < 0 or bci.max() >= m.shape[1] // bn):
        raise ValueError("BSR block_col_idx out of range for the matrix's columns")


def _build_cuda(m: BSR, ctx):
    _check_indices(m)
    bc, sl, sc, ln = on_device(ctx, *bell_pack(m))
    M = m.shape[0]
    return lambda X: KP.bell_spmm_arrays(bc, sl, X, sc, ln, M)


@register_kernel("bsr", "spmv", "cuda",
                 description="BELL kernel at N = 1: a warp per block-row row, "
                             "lanes along bk, shuffle reduction")
def _build_spmv_cuda(m: BSR, ctx) -> CompiledKernel:
    f = _build_cuda(m, ctx)
    return CompiledKernel(lambda x: f(x.reshape(-1, 1))[:, 0], "cuda")


@register_kernel("bsr", "spmm", "cuda",
                 description="BELL kernel: block + X panel staged in shared "
                             "memory, stored slots only, fused per-block scale")
def _build_spmm_cuda(m: BSR, ctx) -> CompiledKernel:
    return CompiledKernel(_build_cuda(m, ctx), "cuda")
