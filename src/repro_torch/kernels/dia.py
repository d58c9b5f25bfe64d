"""DIA registry entries: ``(dia, {spmv, spmm}, {torch, loop_reference})`` and
the CUDA SpMV of ``dia_spmv.py``."""
from __future__ import annotations

import numpy as np
import torch

from ..core.formats import DIA, _np
from . import plan_launch as PL
from . import dia_spmv as KP
from .accum import acc_dtype
from .cache import cached, register_stat, spmm_by_columns
from .registry import CompiledKernel, container_fn, on_device, register_kernel

register_stat("dia_gather_index")
register_stat("dia_gather_tables")

#: integer dtype of each value width, for masking values as raw bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def dia_layout(m: DIA) -> tuple[int, int, int]:
    """(pad0, pad1, n) of the zero-padded x every DIA executor reads."""
    n, ncols = m.shape
    pad0, pad1 = KP.dia_pads(_np(m.offsets).tolist(), n, ncols)
    return pad0, pad1, n


def dia_gather_index(m: DIA) -> torch.Tensor:
    """Host-built (nd, n) x_pad positions, once per container."""
    pad0, _, n = dia_layout(m)
    return cached(m, "_gather_index", "dia_gather_index",
                  lambda: KP.dia_gather_index(m.offsets, pad0, n))


def dia_gather_tables(m: DIA):
    """The reference's shift-gather tables, host-built once:
    ``idx[k, i] = i + offsets[k]`` clipped into range (int32), and the
    (nd, n) data zeroed where the shift runs off the matrix.  The port's
    executors read a padded x instead (``dia_gather_index``)."""

    def build():
        n, ncols = m.shape
        offs = torch.from_numpy(_np(m.offsets).astype(np.int64))
        idx = torch.arange(n, dtype=torch.int64)[None, :] + offs[:, None]
        valid = (idx >= 0) & (idx < ncols)
        idx = idx.clamp(0, max(0, ncols - 1))
        d = m.data.cpu()[:, :n]
        # zeroed as raw bits (where takes no fp8); zero bits = 0.0
        bits = _BITS[d.element_size()]
        data = torch.where(valid, d.view(bits), torch.zeros((), dtype=bits)).view(d.dtype)
        return idx.to(torch.int32), data

    return cached(m, "_gather_tables", "dia_gather_tables", build)


def dia_spmm_plain(data, scales, X_pad, n: int, idx):
    """Multi-vector DIA: one (nd, n, K) gather of the padded X, an einsum."""
    acc = acc_dtype(data.dtype, X_pad.dtype)
    G = X_pad.to(acc)[idx]                              # (nd, n, K)
    d = data[:, :n].to(acc)
    if scales is not None:
        d = d * scales.to(acc)[:, None]
    return torch.einsum("kn,knj->nj", d, G)


def dia_spmv_loop_plain(m_offsets: list, data, scales, x, n: int, ncols: int):
    """One boundary-clipped shifted slice per diagonal, no padding: the
    per-diagonal oracle."""
    acc = acc_dtype(data.dtype, x.dtype)
    y = torch.zeros(n, dtype=acc, device=x.device)
    for k, off in enumerate(m_offsets):
        lo, hi = max(0, -off), min(n, ncols - off)
        if hi <= lo:
            continue
        contrib = data[k, lo:hi].to(acc) * x[lo + off:hi + off].to(acc)
        if scales is not None:
            contrib = contrib * scales[k].to(acc)
        y[lo:hi] += contrib
    return y


def dia_spmv(m: DIA, x: torch.Tensor) -> torch.Tensor:
    """The ``torch`` entry on x's device."""
    return container_fn(m, "dia", "spmv", "torch", x.device)(x)


def dia_spmm(m: DIA, X: torch.Tensor) -> torch.Tensor:
    return container_fn(m, "dia", "spmm", "torch", X.device)(X)


def dia_spmv_loop(m: DIA, x: torch.Tensor) -> torch.Tensor:
    """The loop oracle on x's device: one clipped shifted slice a diagonal."""
    return container_fn(m, "dia", "spmv", "loop_reference", x.device)(x)


def _dia_operands(m: DIA, ctx):
    data, offsets, scale = on_device(ctx, m.data, m.offsets, m.scale)
    return data, offsets, scale, dia_layout(m)


@register_kernel("dia", "spmv", "torch",
                 description="one (nd, n) gather of the padded x + sum")
def _build_spmv(m: DIA, ctx) -> CompiledKernel:
    data, offsets, scale, (pad0, pad1, n) = _dia_operands(m, ctx)
    (idx,) = on_device(ctx, dia_gather_index(m))

    def fn(x):
        acc = acc_dtype(data.dtype, x.dtype)
        return KP.dia_spmv_plain(data, offsets, scale,
                                 KP.pad_x(x, pad0, pad1, acc), pad0, n, idx)

    return CompiledKernel(fn, "torch")


@register_kernel("dia", "spmm", "torch",
                 description="multi-vector gather of the padded X + einsum")
def _build_spmm(m: DIA, ctx) -> CompiledKernel:
    data, offsets, scale, (pad0, pad1, n) = _dia_operands(m, ctx)
    (idx,) = on_device(ctx, dia_gather_index(m))

    def fn(X):
        acc = acc_dtype(data.dtype, X.dtype)
        return dia_spmm_plain(data, scale, KP.pad_x(X, pad0, pad1, acc), n, idx)

    return CompiledKernel(fn, "torch")


def _loop_fn(m: DIA, ctx):
    data, scale = on_device(ctx, m.data, m.scale)
    offs = _np(m.offsets).tolist()
    n, ncols = m.shape
    return lambda x: dia_spmv_loop_plain(offs, data, scale, x, n, ncols)


@register_kernel("dia", "spmv", "loop_reference",
                 description="per-diagonal clipped slices (oracle)")
def _build_spmv_loop(m: DIA, ctx) -> CompiledKernel:
    return CompiledKernel(_loop_fn(m, ctx), "loop")


@register_kernel("dia", "spmm", "loop_reference",
                 description="column-by-column per-diagonal slices")
def _build_spmm_loop(m: DIA, ctx) -> CompiledKernel:
    return CompiledKernel(spmm_by_columns(_loop_fn(m, ctx)), "loop")


def spmv_part(m: DIA, ctx) -> PL.DiaPart:
    """Kernel 2's operands of ``m`` on ``ctx.device``, for a launch record."""
    data, offsets, scale, (_, _, n) = _dia_operands(m, ctx)
    return PL.DiaPart(data, offsets, scale, n, m.shape[1])


@register_kernel("dia", "spmv", "cuda",
                 description="thread per row over the diagonals; x unpadded, one C call "
                             "from a launch record")
def _build_spmv_cuda(m: DIA, ctx) -> CompiledKernel:
    """The kernel on x itself from a launch record (``plan_launch``).  Built
    on the card only: the entry's probe refuses any other device."""
    return CompiledKernel(PL.spmv_fn((spmv_part(m, ctx),), ctx.device), "cuda")
