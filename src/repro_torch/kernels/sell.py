"""SELL-C-sigma registry entries: ``(sell, {spmv, spmm}, {torch, cuda,
loop_reference})``.

The ``torch`` entries carry two formulations and pick one per container
(``perfmodel.sell_xla_uses_flat``), so that the model's stream bytes
describe the code that runs: the flat form (gather + ``index_add_`` over
the chunk-local layout, ``sum_c w_c * C`` elements plus one segment id
each) and the padded form (gather + sum over the globally padded
``(nc, W_max, C)`` views, regular but blind to sigma-sorting).  The ``cuda``
entries are the kernels of ``sell_spmv.py``, which stream the flat layout.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import perfmodel as PM
from ..core.formats import SELL, _np
from . import plan_launch as PL
from . import sell_spmv as KP
from .accum import acc_dtype
from .cache import cached, register_stat, spmm_by_columns
from .registry import CompiledKernel, KernelContext, container_fn, on_device, register_kernel

register_stat("sell_segment_ids")
register_stat("sell_padded_views")
register_stat("sell_chunk_schedule")
register_stat("sell_chunk_blocks")

#: integer dtype of each value width, for moving values as raw bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def sell_segment_ids(m: SELL) -> torch.Tensor:
    """Per-slot permuted-row ids of the flat layout, host-built once."""
    return cached(m, "_segment_ids", "sell_segment_ids",
                  lambda: KP.sell_segment_ids(m.chunk_ptr, m.chunk_width, m.C,
                                              m.col_idx.shape[0]))


def sell_chunk_schedule(m: SELL) -> KP.ChunkSchedule:
    """The SpMM kernel's chunk order (``sell_spmv.ChunkSchedule``),
    host-built and checked once per container."""
    return cached(m, "_chunk_schedule", "sell_chunk_schedule",
                  lambda: KP.chunk_schedule(_np(m.perm), m.C, m.shape[0]))


def sell_chunk_blocks(m: SELL) -> KP.ChunkBlocks:
    """The SpMV kernel's chunk blocks (``sell_spmv.ChunkBlocks``),
    host-built and checked once per container."""
    return cached(m, "_chunk_blocks", "sell_chunk_blocks",
                  lambda: KP.sell_chunk_blocks(_np(m.chunk_ptr), _np(m.chunk_width), m.C))


def padded_views(m: SELL, pad_width_to: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The globally padded (nc, W_max, C) column and value views of the
    flat layout (zero padding; W_max rounded up to a multiple of
    ``pad_width_to``), as the reference's ``SELL.padded_views``."""
    cp, cw = _np(m.chunk_ptr), _np(m.chunk_width).astype(np.int64)
    nc, C = m.n_chunks, m.C
    wmax = max(1, -(-int(cw.max() if cw.size else 1) // pad_width_to) * pad_width_to)
    chunk_of = np.repeat(np.arange(nc), cw * C)
    pos = np.arange(int(cp[-1])) - cp[chunk_of]
    dest = torch.from_numpy(chunk_of * wmax * C + pos)
    col = torch.zeros(nc * wmax * C, dtype=torch.int32).index_copy_(0, dest, m.col_idx.cpu())
    # values move as raw bits (index_copy_ takes no fp8), zero bits = 0.0
    bits = _BITS[m.val.element_size()]
    val = torch.zeros(nc * wmax * C, dtype=bits).index_copy_(
        0, dest, m.val.cpu().view(bits)).view(m.val.dtype)
    return col.reshape(nc, wmax, C), val.reshape(nc, wmax, C)


def sell_padded_views(m: SELL, pad_width_to: int = 1):
    """``(col3, val3, chunk widths)``: ``padded_views`` and the per-chunk
    widths, built once per container and ``pad_width_to``."""
    attr = "_padded_views" if pad_width_to == 1 else f"_padded_views_{pad_width_to}"
    return cached(m, attr, "sell_padded_views",
                  lambda: (*padded_views(m, pad_width_to), m.chunk_width.cpu()))


def inverse_perm(m: SELL) -> torch.Tensor | None:
    """``inv[orig_row]`` = tile position of the row, or None for the natural
    order (the padded form then slices instead of gathering)."""
    p, n = _np(m.perm), m.shape[0]
    if (p[:n] == np.arange(n, dtype=p.dtype)).all():
        return None
    inv = np.empty(n, dtype=np.int64)
    pos = np.nonzero(p < n)[0]
    inv[p[pos]] = pos
    return torch.from_numpy(inv)


def sell_spmv_padded(col3, val3, perm, x, n_rows: int, scale=None):
    """SpMV on the padded views: one (nc, W, C) gather, a sum over W, the
    per-chunk scale and the un-permute.  ``perm`` is the *inverse* row
    permutation (``inverse_perm``), applied as a gather; ``None`` means the
    natural row order (a slice)."""
    acc = acc_dtype(val3.dtype, x.dtype)
    g = x.index_select(0, col3.reshape(-1)).reshape(col3.shape).to(acc)
    tiles = (val3.to(acc) * g).sum(1)
    if scale is not None:
        tiles = tiles * scale.to(acc)[:, None]
    flat = tiles.reshape(-1)
    return flat[:n_rows] if perm is None else flat[perm]


def sell_spmm_padded(col3, val3, perm, X, n_rows: int, scale=None):
    """Multi-vector ``sell_spmv_padded``: an (nc, W, C, K) gather and an
    einsum over W; ``perm`` as there."""
    acc = acc_dtype(val3.dtype, X.dtype)
    g = X.index_select(0, col3.reshape(-1)).reshape(col3.shape + (X.shape[1],)).to(acc)
    tiles = torch.einsum("nwc,nwck->nck", val3.to(acc), g)
    if scale is not None:
        tiles = tiles * scale.to(acc)[:, None, None]
    flat = tiles.reshape(-1, X.shape[1])
    return flat[:n_rows] if perm is None else flat[perm]


def _operands(m: SELL, ctx):
    return on_device(ctx, m.chunk_ptr, m.chunk_width, m.col_idx, m.val, m.scale, m.perm)


def _loop_fn(m: SELL, ctx: KernelContext):
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


def sell_spmv(m: SELL, x: torch.Tensor) -> torch.Tensor:
    """The ``torch`` entry on x's device (flat or padded form, as the model
    prices it for the H100)."""
    return container_fn(m, "sell", "spmv", "torch", x.device)(x)


def sell_spmm(m: SELL, X: torch.Tensor) -> torch.Tensor:
    return container_fn(m, "sell", "spmm", "torch", X.device)(X)


def sell_spmv_loop(m: SELL, x: torch.Tensor) -> torch.Tensor:
    """The loop oracle on x's device: the chunk-local slab traversal."""
    return container_fn(m, "sell", "spmv", "loop_reference", x.device)(x)


def _build_torch(m: SELL, ctx, flat_fn, padded_fn) -> CompiledKernel:
    """The ``torch`` executor: flat or padded, as the model prices it for
    the context's chip."""
    n, C = m.shape[0], m.C
    if PM.sell_xla_uses_flat(m, PM.chip_family(ctx.chip)):
        cp, cw, col, val, scale, perm = _operands(m, ctx)
        (seg,) = on_device(ctx, sell_segment_ids(m))
        return CompiledKernel(lambda x: flat_fn(cp, cw, col, val, scale, perm, x,
                                                n, C, seg), "torch")
    col3, val3, inv, scale = on_device(ctx, *sell_padded_views(m)[:2], inverse_perm(m),
                                       m.scale)
    return CompiledKernel(lambda x: padded_fn(col3, val3, inv, x, n, scale), "torch")


@register_kernel("sell", "spmv", "torch",
                 description="flat gather + index_add_, or padded-view gather + "
                             "sum (per-container pick) + inverse permutation")
def _build_spmv(m: SELL, ctx) -> CompiledKernel:
    return _build_torch(m, ctx, KP.sell_spmv_plain, sell_spmv_padded)


@register_kernel("sell", "spmm", "torch",
                 description="multi-vector flat or padded-view form "
                             "(per-container pick)")
def _build_spmm(m: SELL, ctx) -> CompiledKernel:
    return _build_torch(m, ctx, KP.sell_spmm_plain, sell_spmm_padded)


@register_kernel("sell", "spmv", "loop_reference",
                 description="chunk-local slab traversal (oracle)")
def _build_spmv_loop(m: SELL, ctx) -> CompiledKernel:
    return CompiledKernel(_loop_fn(m, ctx), "loop")


@register_kernel("sell", "spmm", "loop_reference",
                 description="column-by-column slab traversals")
def _build_spmm_loop(m: SELL, ctx) -> CompiledKernel:
    return CompiledKernel(spmm_by_columns(_loop_fn(m, ctx)), "loop")


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


def spmv_part(m: SELL, ctx) -> PL.SellPart:
    """Kernel 1's operands of ``m`` on ``ctx.device`` and its cached
    ``ChunkBlocks``, for a launch record."""
    _check_indices(m)
    return PL.SellPart(*_operands(m, ctx), m.shape[0], m.C, sell_chunk_blocks(m))


@register_kernel("sell", "spmv", "cuda",
                 description="blocks of whole chunks, span streamed coalesced, rows "
                             "summed from shared memory; fused scale + inverse "
                             "permutation (+ add_to)")
def _build_spmv_cuda(m: SELL, ctx) -> CompiledKernel:
    """The kernel on the container's cached ``ChunkBlocks`` from a launch
    record (``plan_launch``; the blocks go to the card when it is built, at
    plan compile).  Built on the card only: the entry's probe refuses any
    other device."""
    return CompiledKernel(PL.spmv_fn((spmv_part(m, ctx),), ctx.device), "cuda")


@register_kernel("sell", "spmm", "cuda",
                 description="chunks in original-row order, K tiles along the grid, "
                             "columns a thread; fused scale + inverse permutation")
def _build_spmm_cuda(m: SELL, ctx) -> CompiledKernel:
    """``sell_spmm_arrays`` on the container's chunk schedule, which goes to
    the card here, at plan compile, not on the first SpMM; the K tiling is
    chosen per call from X's width (``sell_spmm_launch``).  Built on the card
    only: the entry's probe refuses any other device."""
    _check_indices(m)
    ops = _operands(m, ctx)
    n, C = m.shape[0], m.C
    sched = sell_chunk_schedule(m)
    sched.on(ctx.device)
    return CompiledKernel(lambda X: KP.sell_spmm_arrays(*ops, X, n, C, schedule=sched), "cuda")
