"""CSR (the paper's CRS) SpMV: the CUDA kernel's wrapper, its plain
PyTorch version, and the host partition the kernel runs on.

``csr_spmv_arrays`` launches ``csrc/csr_spmv.cu`` on a CUDA tensor and runs
``csr_spmv_plain`` on a CPU tensor.  Both read ``row_ptr`` / ``col_idx`` /
``val`` as they are (the reference's padded row-split slabs are a TPU
layout) and return y in original row order, with the per-row scale of a
quantized container applied to the finished sums.  The kernel takes one
block of whole rows per CUDA block, from ``csr_row_blocks``
(a checked ``RowBlocks``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.spans import span
from . import cuda_build as CB
from .accum import acc_dtype

NAME = "csr_spmv"
_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p,
                                                           ctypes.c_int64, ctypes.c_void_p]

#: nonzeros (and rows) of one row block: 4 loads in flight for each of a
#: CUDA block's 256 threads (``kCsrBudget`` in csr_spmv.cu)
CSR_BUDGET = 1024


class RowBlocks:
    """The CUDA kernel's partition of a matrix's rows into blocks of whole
    rows holding at most ``CSR_BUDGET`` nonzeros and at most ``CSR_BUDGET``
    rows; a row longer than the budget gets a block of its own, empty rows
    stay in their block.  ``starts`` (int32, on the host) holds the
    ``n_blocks + 1`` first rows: block b is rows ``[starts[b], starts[b +
    1])``.  Built greedily and checked on the host, once per container;
    ``on(device)`` copies it to a card once.  ``csr_spmv_arrays`` takes the
    partition in no other form, so every row it launches on is written."""

    def __init__(self, row_ptr):
        rp = (row_ptr.cpu().numpy() if isinstance(row_ptr, torch.Tensor)
              else np.asarray(row_ptr)).astype(np.int64)
        n = rp.shape[0] - 1
        if n < 0 or (np.diff(rp) < 0).any():
            raise ValueError("csr row blocks: row_ptr is not a nondecreasing offset table")
        starts, r0 = [0], 0
        while r0 < n:
            # the last row r1 with rp[r1] - rp[r0] <= budget ends the block
            r1 = int(np.searchsorted(rp, rp[r0] + CSR_BUDGET, side="right")) - 1
            r1 = min(max(r1, r0 + 1), r0 + CSR_BUDGET, n)
            starts.append(r1)
            r0 = r1
        s = np.asarray(starts, np.int64)
        rows, nnz = np.diff(s), rp[s[1:]] - rp[s[:-1]]
        # every row in one block, each block within budget or one row alone
        if s[-1] != n or (rows < 1).any() or (rows > CSR_BUDGET).any() or \
                ((nnz > CSR_BUDGET) & (rows > 1)).any():
            raise ValueError("csr row blocks: the partition broke its budget")
        self.n_rows = n
        self.starts = torch.from_numpy(s.astype(np.int32))
        self._on: dict = {}

    @property
    def n_blocks(self) -> int:
        return self.starts.shape[0] - 1

    def on(self, device) -> torch.Tensor:
        """``starts`` on ``device``, copied there once."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = self.starts.to(device)
        return self._on[key]


def csr_row_blocks(row_ptr) -> RowBlocks:
    """The kernel's row blocks of ``row_ptr`` (numpy or torch, any device)."""
    return RowBlocks(row_ptr)


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


def csr_spmv_arrays(row_ptr, col_idx, val, scale, x, row_blocks=None):
    """CSR SpMV: the CUDA kernel for a CUDA ``x``, the plain version for a
    CPU ``x``.  On the card every operand must lie on x's device.
    ``row_blocks`` is the ``RowBlocks`` of ``row_ptr`` (a plan passes its
    cached one; without it the partition is built here, from a host copy
    of ``row_ptr``).  The kernel gives NaN rows for a block over the
    budget: the partition of another matrix with as many rows."""
    n = row_ptr.shape[0] - 1
    if row_blocks is not None:
        if not isinstance(row_blocks, RowBlocks):
            raise TypeError(f"csr_spmv: row_blocks must be a RowBlocks "
                            f"(csr_row_blocks(row_ptr)), got {type(row_blocks).__name__}")
        if row_blocks.n_rows != n:
            raise ValueError(f"csr_spmv: row_blocks cover {row_blocks.n_rows} rows, "
                             f"the matrix has {n}")
    if x.device.type == "cpu":
        return csr_spmv_plain(row_ptr, col_idx, val, scale, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv: no kernel for device {x.device}")
    dev = x.device
    acc = acc_dtype(val.dtype, x.dtype)
    with span("kernel.check"):
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
    if row_blocks is None:
        row_blocks = csr_row_blocks(row_ptr)
    blocks = row_blocks.on(dev)
    y = torch.empty(n, dtype=acc, device=dev)
    CB.launch(NAME, _ARGTYPES, dev, CB.value_code(val, "val"), int(acc == torch.float64),
              CB.ptr(row_ptr), CB.ptr(col_idx), CB.ptr(val), CB.ptr(scale),
              CB.ptr(x), CB.ptr(y), n, CB.ptr(blocks), row_blocks.n_blocks)
    return y
