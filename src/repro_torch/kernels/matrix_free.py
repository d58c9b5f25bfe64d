"""Matrix-free generated-operator SpMV: indices computed, never streamed.

For a ``core.formats.MatrixFreeOperator``, ``col = row + offset`` on every
diagonal; a generated diagonal holds one constant under the periodic rule
``lo <= row % p < hi`` and streams nothing, a stored diagonal streams one
dense lane.  x is zero-padded, so reads past either matrix edge are zeros.
Accumulation runs in ascending offset order, as in the reference.

``mf_spmv_arrays`` launches ``csrc/mf_spmv.cu`` on a CUDA tensor and runs
``mf_spmv_plain`` on a CPU tensor.  Registry entries: ``(matrix_free,
{spmv, spmm}, {torch, loop_reference, cuda})``; the ``cuda`` SpMM goes
column by column over the SpMV kernel, as the reference's Pallas SpMM does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.formats import VALUE_DTYPES, MatrixFreeOperator, _cast
from . import cuda_build as CB
from .accum import acc_dtype
from .cache import cached, register_stat, spmm_by_columns
from .dia_spmv import pad_x
from .registry import CompiledKernel, KernelContext, register_kernel

NAME = "mf_spmv"
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p]

register_stat("mf_tables")


def _round_gen(gv: float, value_dtype: str) -> float:
    """A generated constant rounded through the storage dtype, so the kernel
    multiplies by exactly what a materialized container would stream."""
    return float(_cast(np.asarray([gv], np.float64), value_dtype)
                 .to(torch.float64)[0])


def mf_tables(op: MatrixFreeOperator):
    """Per-diagonal ``(off, spec)``: spec None for a stored lane (taken from
    ``op.data`` in order), else ``(p, lo, hi, gv)`` with ``p = 0`` when no
    mask is needed (trivial rule, or the matrix boundary the padding
    already enforces).  Built once per container."""

    def build():
        n, ncols = op.shape
        diags = []
        for k, off in enumerate(op.offsets):
            gv = op.gen_values[k]
            if gv is None:
                diags.append((int(off), None))
                continue
            p, lo, hi = op.periods[k], op.los[k], op.his[k]
            trivial = lo == 0 and hi == p
            boundary = (p == n and lo == max(0, -off) and hi == min(n, ncols - off))
            gvr = _round_gen(gv, op.value_dtype)
            diags.append((int(off), (0, 0, 0, gvr) if trivial or boundary
                          else (p, lo, hi, gvr)))
        return tuple(diags)

    return cached(op, "_mf_tables", "mf_tables", build)


def mf_pads(op: MatrixFreeOperator) -> tuple[int, int]:
    n, ncols = op.shape
    return max(0, -min(op.offsets)), max(0, n + max(op.offsets) - ncols)


def mf_pack_descriptor(diags) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's descriptor: (nd, 5) int32 rows ``(off, p, lo, hi,
    stored_lane or -1)`` and the (nd,) f64 generated constants."""
    desc = np.zeros((len(diags), 5), np.int32)
    gen = np.zeros(len(diags), np.float64)
    ks = 0
    for k, (off, spec) in enumerate(diags):
        if spec is None:
            desc[k] = (off, 0, 0, 0, ks)
            ks += 1
        else:
            p, lo, hi, gvr = spec
            desc[k] = (off, p, lo, hi, -1)
            gen[k] = gvr
    return torch.from_numpy(desc), torch.from_numpy(gen)


def mf_data(op: MatrixFreeOperator) -> torch.Tensor:
    """The stored lanes, or an empty (0, n) tensor of the storage dtype when
    every diagonal is generated (so the dtype is always known)."""
    if op.data is not None:
        return op.data
    return torch.zeros((0, op.shape[0]), dtype=VALUE_DTYPES[op.value_dtype])


def mf_spmv_plain(data, desc, gen, x_pad, pad0: int, n: int):
    """Shifted slices of the padded x (a vector, or an (N, K) block), one
    per diagonal, added in ascending offset order.  ``desc`` / ``gen`` may
    lie on the host or the device."""
    acc = acc_dtype(data.dtype, x_pad.dtype)
    x_pad = x_pad.to(acc)
    y = torch.zeros((n,) + tuple(x_pad.shape[1:]), dtype=acc, device=x_pad.device)
    rows = torch.arange(n, device=x_pad.device)
    for (off, p, lo, hi, s), gv in zip(desc.tolist(), gen.tolist()):
        xs = x_pad[pad0 + off:pad0 + off + n]
        if s >= 0:
            lane = data[s, :n].to(acc)
            contrib = (lane if xs.dim() == 1 else lane[:, None]) * xs
        else:
            contrib = gv * xs
            if p:
                keep = (rows % p >= lo) & (rows % p < hi)
                keep = keep if xs.dim() == 1 else keep[:, None]
                contrib = torch.where(keep, contrib, torch.zeros((), dtype=acc,
                                                                 device=xs.device))
        y = y + contrib
    return y


def mf_spmv_arrays(data, desc, gen, x_pad, pad0: int, n: int):
    """Matrix-free SpMV: the CUDA kernel for a CUDA ``x_pad``, the plain
    version for a CPU one."""
    if x_pad.device.type == "cpu":
        return mf_spmv_plain(data, desc, gen, x_pad, pad0, n)
    if x_pad.device.type != "cuda":
        raise ValueError(f"mf_spmv: no kernel for device {x_pad.device}")
    dev = x_pad.device
    acc = acc_dtype(data.dtype, x_pad.dtype)
    x_pad = x_pad.to(acc).contiguous()
    CB.check_tensor(data, "data", dev, None, 2)
    CB.check_tensor(desc, "desc", dev, (torch.int32,), 2)
    CB.check_tensor(gen, "gen", dev, (torch.float64,), 1)
    CB.check_tensor(x_pad, "x_pad", dev, None, 1)
    nd = desc.shape[0]
    if desc.shape[1] != 5 or gen.shape[0] != nd:
        raise ValueError(f"descriptor {tuple(desc.shape)} / {tuple(gen.shape)} "
                         "is not (nd, 5) / (nd,)")
    if data.shape[0] and data.shape[1] < n:
        raise ValueError(f"stored lanes {tuple(data.shape)} shorter than {n} rows")
    if pad0 < 0:
        raise ValueError(f"pad0={pad0} < 0")
    y = torch.empty(n, dtype=acc, device=dev)
    fn = CB.kernel_function(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(CB.value_code(data, "data"), int(acc == torch.float64),
                CB.ptr(data), data.shape[1], CB.ptr(desc), CB.ptr(gen), nd,
                CB.ptr(x_pad), x_pad.shape[0], pad0, CB.ptr(y), n,
                CB.stream_handle(dev))
    CB.raise_on_error(NAME, rc)
    CB.count_launch(NAME)
    return y


def mf_spmv_loop(op: MatrixFreeOperator, ctx: KernelContext):
    """The oracle: one boundary-clipped slice per diagonal, host-built masks."""
    n, ncols = op.shape
    diags = mf_tables(op)
    data = mf_data(op).to(ctx.device)

    def fn(x):
        acc = acc_dtype(data.dtype, x.dtype)
        y = torch.zeros(n, dtype=acc, device=x.device)
        ks = 0
        for off, spec in diags:
            lo_b, hi_b = max(0, -off), min(n, ncols - off)
            if spec is None:
                lane = data[ks]
                ks += 1
            if hi_b <= lo_b:
                continue
            xs = x[lo_b + off:hi_b + off].to(acc)
            if spec is None:
                contrib = lane[lo_b:hi_b].to(acc) * xs
            else:
                p, lo, hi, gvr = spec
                contrib = gvr * xs
                if p:
                    i = np.arange(lo_b, hi_b)
                    mask = torch.from_numpy((i % p >= lo) & (i % p < hi))
                    contrib = torch.where(mask.to(x.device), contrib,
                                          torch.zeros((), dtype=acc, device=x.device))
            y[lo_b:hi_b] += contrib
        return y

    return fn


def _executor(op: MatrixFreeOperator, ctx: KernelContext, spmv, desc_device):
    """x -> spmv(data, desc, gen, x_pad, pad0, n).  The kernel reads the
    descriptor on the device; the plain version reads it on the host (no
    device-to-host copy per call)."""
    desc, gen = mf_pack_descriptor(mf_tables(op))
    desc, gen = desc.to(desc_device), gen.to(desc_device)
    data = mf_data(op).to(ctx.device)
    pad0, pad1 = mf_pads(op)
    n = op.shape[0]

    def fn(x):
        acc = acc_dtype(data.dtype, x.dtype)
        return spmv(data, desc, gen, pad_x(x, pad0, pad1, acc), pad0, n)

    return fn


@register_kernel("matrix_free", "spmv", "torch",
                 description="generated diagonals: shifted slices + masks")
def _build_spmv(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(_executor(op, ctx, mf_spmv_plain, "cpu"), "torch")


@register_kernel("matrix_free", "spmm", "torch",
                 description="multi-vector shifted slices + masks")
def _build_spmm(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(_executor(op, ctx, mf_spmv_plain, "cpu"), "torch")


@register_kernel("matrix_free", "spmv", "loop_reference",
                 description="per-diagonal clipped-segment oracle, host masks")
def _build_spmv_loop(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(mf_spmv_loop(op, ctx), "loop")


@register_kernel("matrix_free", "spmm", "loop_reference",
                 description="column-by-column per-diagonal oracles")
def _build_spmm_loop(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(spmm_by_columns(mf_spmv_loop(op, ctx)), "loop")


@register_kernel("matrix_free", "spmv", "cuda",
                 description="thread per row; cols = row + offset in registers")
def _build_spmv_cuda(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(_executor(op, ctx, mf_spmv_arrays, ctx.device), "cuda")


@register_kernel("matrix_free", "spmm", "cuda",
                 description="column by column over the SpMV kernel")
def _build_spmm_cuda(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(
        spmm_by_columns(_executor(op, ctx, mf_spmv_arrays, ctx.device)), "cuda")
