"""SELL-C-sigma SpMV and SpMM: the CUDA kernels' wrappers and their plain
PyTorch versions.

All consume the flat chunk layout of ``core.formats.SELL`` (chunk c is a
column-major ``(width_c, C)`` slab at ``chunk_ptr[c]``), apply the per-chunk
scale of a quantized container to the finished row sums, and undo the
sigma permutation: ``y[perm[q]] = tile[q]`` for every real row.
``sell_spmv_arrays`` launches ``csrc/sell_spmv.cu`` and ``sell_spmm_arrays``
``csrc/sell_spmm.cu`` on CUDA tensors; on CPU tensors they run
``sell_spmv_plain`` / ``sell_spmm_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build as CB
from .accum import acc_dtype

NAME = "sell_spmv"
_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
_MM_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def sell_k_lanes(K: int) -> int:
    """Lanes per chunk row of the SELL SpMM kernel, the launch's one
    source: the next power of two >= K, capped at a warp (wider K loops
    over tiles of 32 columns).  Nothing is staged in shared memory, so
    every K fits."""
    k = 1
    while k < min(max(1, int(K)), 32):
        k *= 2
    return k


def sell_segment_ids(chunk_ptr: torch.Tensor, chunk_width: torch.Tensor,
                     C: int, total: int) -> torch.Tensor:
    """Permuted row (``c*C + lane``) of each of the ``total`` stored slots:
    slot p of chunk c belongs to lane ``(p - chunk_ptr[c]) % C``."""
    nc = chunk_width.shape[0]
    dev = chunk_ptr.device
    chunk_of = torch.repeat_interleave(torch.arange(nc, device=dev),
                                       chunk_width.long() * C, output_size=total)
    pos = torch.arange(total, device=dev) - chunk_ptr[chunk_of]
    return chunk_of * C + pos % C


def sell_spmv_plain(chunk_ptr, chunk_width, col_idx, val, scale, perm, x,
                    n_rows: int, C: int, seg=None):
    """Gather + ``index_add_`` into (nc*C,) tiles, scale, un-permute.
    ``seg`` (``sell_segment_ids``) is derived when absent."""
    acc = acc_dtype(val.dtype, x.dtype)
    if seg is None:
        seg = sell_segment_ids(chunk_ptr, chunk_width, C, col_idx.shape[0])
    prod = val.to(acc) * x.to(acc).index_select(0, col_idx)
    nc = chunk_width.shape[0]
    tiles = torch.zeros(nc * C, dtype=acc, device=x.device).index_add_(0, seg, prod)
    if scale is not None:
        tiles = tiles * scale.to(acc).repeat_interleave(C)
    # perm[:n_rows] holds every real row once (pad rows sit at the end)
    return torch.empty(n_rows, dtype=acc, device=x.device).index_copy_(
        0, perm[:n_rows].long(), tiles[:n_rows])


def sell_spmm_plain(chunk_ptr, chunk_width, col_idx, val, scale, perm, X,
                    n_rows: int, C: int, seg=None):
    """Multi-vector ``sell_spmv_plain``: an (nnz, K) gather-product,
    ``index_add_`` into (nc*C, K) tiles, scale, un-permute."""
    acc = acc_dtype(val.dtype, X.dtype)
    if seg is None:
        seg = sell_segment_ids(chunk_ptr, chunk_width, C, col_idx.shape[0])
    prod = val.to(acc)[:, None] * X.to(acc).index_select(0, col_idx)
    tiles = torch.zeros((chunk_width.shape[0] * C, X.shape[1]), dtype=acc,
                        device=X.device).index_add_(0, seg, prod)
    if scale is not None:
        tiles = tiles * scale.to(acc).repeat_interleave(C)[:, None]
    return torch.empty((n_rows, X.shape[1]), dtype=acc, device=X.device
                       ).index_copy_(0, perm[:n_rows].long(), tiles[:n_rows])


def _check_operands(chunk_ptr, chunk_width, col_idx, val, scale, perm, C, dev):
    CB.check_tensor(chunk_ptr, "chunk_ptr", dev, (torch.int64,), 1)
    CB.check_tensor(chunk_width, "chunk_width", dev, (torch.int32,), 1)
    CB.check_tensor(col_idx, "col_idx", dev, (torch.int32,), 1)
    CB.check_tensor(val, "val", dev, None, 1)
    CB.check_tensor(perm, "perm", dev, (torch.int32,), 1)
    nc = chunk_width.shape[0]
    if chunk_ptr.shape[0] != nc + 1 or perm.shape[0] != nc * C:
        raise ValueError(f"{nc} chunks of {C} rows need chunk_ptr of {nc + 1} "
                         f"and perm of {nc * C}; got {chunk_ptr.shape[0]} and "
                         f"{perm.shape[0]}")
    if val.shape != col_idx.shape:
        raise ValueError(f"val {tuple(val.shape)} and col_idx "
                         f"{tuple(col_idx.shape)} differ")
    if scale is not None:
        CB.check_tensor(scale, "scale", dev, (torch.float32,), 1)
        if scale.shape[0] != nc:
            raise ValueError(f"{scale.shape[0]} scales for {nc} chunks")


def sell_spmv_arrays(chunk_ptr, chunk_width, col_idx, val, scale, perm, x,
                     n_rows: int, C: int):
    """SELL SpMV: the CUDA kernel for a CUDA ``x``, the plain version for a
    CPU ``x``.  Returns y (n_rows,) in original row order."""
    if x.device.type == "cpu":
        return sell_spmv_plain(chunk_ptr, chunk_width, col_idx, val, scale,
                               perm, x, n_rows, C)
    if x.device.type != "cuda":
        raise ValueError(f"sell_spmv: no kernel for device {x.device}")
    dev = x.device
    acc = acc_dtype(val.dtype, x.dtype)
    x = x.to(acc).contiguous()
    _check_operands(chunk_ptr, chunk_width, col_idx, val, scale, perm, C, dev)
    nc = chunk_width.shape[0]
    y = torch.empty(n_rows, dtype=acc, device=dev)
    fn = CB.kernel_function(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(CB.value_code(val, "val"), int(acc == torch.float64),
                CB.ptr(chunk_ptr), CB.ptr(chunk_width), CB.ptr(col_idx),
                CB.ptr(val), CB.ptr(scale), CB.ptr(perm), CB.ptr(x), CB.ptr(y),
                nc, C, n_rows, CB.stream_handle(dev))
    CB.raise_on_error(NAME, rc)
    CB.count_launch(NAME)
    return y


def sell_spmm_arrays(chunk_ptr, chunk_width, col_idx, val, scale, perm, X,
                     n_rows: int, C: int):
    """SELL SpMM, one matrix pass for the K columns of X (N, K): the CUDA
    kernel for a CUDA ``X``, the plain version for a CPU ``X``.  Returns
    Y (n_rows, K) in original row order, in ``acc_dtype(val, X)``."""
    if X.device.type == "cpu":
        return sell_spmm_plain(chunk_ptr, chunk_width, col_idx, val, scale,
                               perm, X, n_rows, C)
    if X.device.type != "cuda":
        raise ValueError(f"sell_spmm: no kernel for device {X.device}")
    if X.dim() != 2:
        raise ValueError(f"X must be (N, K), got shape {tuple(X.shape)}")
    dev = X.device
    acc = acc_dtype(val.dtype, X.dtype)
    X = X.to(acc).contiguous()
    _check_operands(chunk_ptr, chunk_width, col_idx, val, scale, perm, C, dev)
    nc, K = chunk_width.shape[0], int(X.shape[1])
    Y = torch.empty((n_rows, K), dtype=acc, device=dev)
    fn = CB.kernel_function("sell_spmm", _MM_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(CB.value_code(val, "val"), int(acc == torch.float64),
                CB.ptr(chunk_ptr), CB.ptr(chunk_width), CB.ptr(col_idx),
                CB.ptr(val), CB.ptr(scale), CB.ptr(perm), CB.ptr(X), CB.ptr(Y),
                nc, C, n_rows, K, sell_k_lanes(K), CB.stream_handle(dev))
    CB.raise_on_error("sell_spmm", rc)
    CB.count_launch("sell_spmm")
    return Y
