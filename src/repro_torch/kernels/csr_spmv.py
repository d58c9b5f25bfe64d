"""CSR (the paper's CRS) SpMV: the CUDA kernel's wrapper and its plain
PyTorch version.

``csr_spmv_arrays`` launches ``csrc/csr_spmv.cu`` on a CUDA tensor and runs
``csr_spmv_plain`` on a CPU tensor.  Both read ``row_ptr`` / ``col_idx`` /
``val`` as they are (the reference's padded row-split slabs are a TPU
layout) and return y in original row order, with the per-row scale of a
quantized container applied to the finished sums.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build as CB
from .accum import acc_dtype

NAME = "csr_spmv"
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_int64, ctypes.c_void_p]


def csr_lanes(n_rows: int, nnz: int) -> int:
    """Lanes per row of the CUDA kernel: the power of two in [4, 32] at or
    above the mean row length (16 for the Holstein matrix's ~14 nnz/row)."""
    mean = nnz / max(1, n_rows)
    lanes = 4
    while lanes < mean and lanes < 32:
        lanes *= 2
    return lanes


def csr_row_ids(row_ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """One row id per nonzero (int32), on ``row_ptr``'s device (``nnz``
    given, so no device-to-host sync)."""
    n = row_ptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=row_ptr.device),
        (row_ptr[1:] - row_ptr[:-1]).long(), output_size=nnz)


def csr_spmv_plain(row_ptr, col_idx, val, scale, x, row_ids=None):
    """Gather + ``index_add_``: y[r] = scale[r] * sum_i val[i] * x[col[i]].
    ``row_ids`` (one per nonzero) is derived from ``row_ptr`` when absent."""
    n = row_ptr.shape[0] - 1
    acc = acc_dtype(val.dtype, x.dtype)
    if row_ids is None:
        row_ids = csr_row_ids(row_ptr, col_idx.shape[0])
    prod = val.to(acc) * x.to(acc).index_select(0, col_idx)
    y = torch.zeros(n, dtype=acc, device=x.device).index_add_(0, row_ids, prod)
    return y if scale is None else y * scale.to(acc)


def csr_spmv_arrays(row_ptr, col_idx, val, scale, x, lanes: int | None = None):
    """CSR SpMV: the CUDA kernel for a CUDA ``x``, the plain version for a
    CPU ``x``.  On the card every operand must lie on x's device."""
    if x.device.type == "cpu":
        return csr_spmv_plain(row_ptr, col_idx, val, scale, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv: no kernel for device {x.device}")
    dev = x.device
    n = row_ptr.shape[0] - 1
    acc = acc_dtype(val.dtype, x.dtype)
    x = x.to(acc).contiguous()
    CB.check_tensor(row_ptr, "row_ptr", dev, (torch.int32,), 1)
    CB.check_tensor(col_idx, "col_idx", dev, (torch.int32,), 1)
    CB.check_tensor(val, "val", dev, None, 1)
    if val.shape != col_idx.shape:
        raise ValueError(f"val {tuple(val.shape)} and col_idx "
                         f"{tuple(col_idx.shape)} differ")
    if scale is not None:
        CB.check_tensor(scale, "scale", dev, (torch.float32,), 1)
        if scale.shape[0] != n:
            raise ValueError(f"scale has {scale.shape[0]} rows, expected {n}")
    lanes = csr_lanes(n, col_idx.shape[0]) if lanes is None else lanes
    if lanes not in (4, 8, 16, 32):
        raise ValueError(f"lanes={lanes}; expected 4, 8, 16 or 32")
    y = torch.empty(n, dtype=acc, device=dev)
    fn = CB.kernel_function(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(CB.value_code(val, "val"), int(acc == torch.float64), lanes,
                CB.ptr(row_ptr), CB.ptr(col_idx), CB.ptr(val), CB.ptr(scale),
                CB.ptr(x), CB.ptr(y), n, CB.stream_handle(dev))
    CB.raise_on_error(NAME, rc)
    CB.count_launch(NAME)
    return y
