"""DIA SpMV: the CUDA kernel's wrapper and its plain PyTorch version.

Both read a zero-padded x: ``x_pad[row + pad0 + off]`` is x at column
``row + off``, and columns off either edge of the matrix read zeros.
``dia_spmv_arrays`` launches ``csrc/dia_spmv.cu`` on a CUDA tensor and runs
``dia_spmv_plain`` on a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as Fnn

from ..utils.spans import span
from . import cuda_build as CB
from .accum import acc_dtype

NAME = "dia_spmv"
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p]


def dia_pads(offsets, n_rows: int, n_cols: int) -> tuple[int, int]:
    """Left/right zero padding of x that keeps every shifted read
    ``row + off`` (0 <= row < n_rows) in range."""
    offsets = list(offsets)
    if not offsets:
        return 0, 0
    return max(0, -min(offsets)), max(0, n_rows + max(offsets) - n_cols)


def pad_x(x: torch.Tensor, pad0: int, pad1: int, acc: torch.dtype) -> torch.Tensor:
    """x (or an (N, K) block) cast to ``acc`` and zero-padded along rows."""
    x = x.to(acc)
    return Fnn.pad(x, (pad0, pad1) if x.dim() == 1 else (0, 0, pad0, pad1))


def dia_gather_index(offsets: torch.Tensor, pad0: int, n: int) -> torch.Tensor:
    """(nd, n) positions in x_pad: pad0 + offsets[k] + row."""
    rows = torch.arange(n, dtype=torch.int64, device=offsets.device)
    return pad0 + offsets.to(torch.int64)[:, None] + rows[None, :]


def dia_spmv_plain(data, offsets, scales, x_pad, pad0: int, n: int, idx=None):
    """One (nd, n) gather of x_pad, the product table, a sum over the
    diagonals.  ``idx`` (``dia_gather_index``) is derived when absent."""
    acc = acc_dtype(data.dtype, x_pad.dtype)
    if idx is None:
        idx = dia_gather_index(offsets, pad0, n)
    g = x_pad.to(acc).index_select(0, idx.reshape(-1)).reshape(idx.shape)
    prod = data[:, :n].to(acc) * g
    if scales is not None:
        prod = prod * scales.to(acc)[:, None]
    return prod.sum(0) if prod.shape[0] else torch.zeros(n, dtype=acc,
                                                          device=x_pad.device)


def check_operands(data, offsets, scales, n: int, dev) -> None:
    """Raise unless the kernel can read the (nd, ld) ``data``, its int32
    ``offsets`` and f32 ``scales`` (or None) on ``dev`` for ``n`` rows:
    ``dia_spmv_arrays``' checks of the matrix, which a plan's launch record
    (``plan_launch``) runs once."""
    CB.check_tensor(data, "data", dev, None, 2)
    CB.check_tensor(offsets, "offsets", dev, (torch.int32,), 1)
    nd, ld = data.shape
    if offsets.shape[0] != nd or ld < n:
        raise ValueError(f"data {tuple(data.shape)} does not fit {offsets.shape[0]} "
                         f"offsets and {n} rows")
    if scales is not None:
        CB.check_tensor(scales, "scales", dev, (torch.float32,), 1)
        if scales.shape[0] != nd:
            raise ValueError(f"{scales.shape[0]} scales for {nd} diagonals")


def dia_spmv_arrays(data, offsets, scales, x_pad, pad0: int, n: int):
    """DIA SpMV: the CUDA kernel for a CUDA ``x_pad``, the plain version for
    a CPU one.  ``data`` is (nd, ld) with ld >= n."""
    if x_pad.device.type == "cpu":
        return dia_spmv_plain(data, offsets, scales, x_pad, pad0, n)
    if x_pad.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {x_pad.device}")
    dev = x_pad.device
    acc = acc_dtype(data.dtype, x_pad.dtype)
    with span("kernel.check"):
        x_pad = x_pad.to(acc).contiguous()
        check_operands(data, offsets, scales, n, dev)
        CB.check_tensor(x_pad, "x_pad", dev, None, 1)
        if pad0 < 0:
            raise ValueError(f"pad0={pad0} < 0")
    nd, ld = data.shape
    y = torch.empty(n, dtype=acc, device=dev)
    CB.launch(NAME, _ARGTYPES, dev, CB.value_code(data, "data"), int(acc == torch.float64),
              CB.ptr(data), ld, CB.ptr(offsets), CB.ptr(scales), nd,
              CB.ptr(x_pad), x_pad.shape[0], pad0, CB.ptr(y), n)
    return y
