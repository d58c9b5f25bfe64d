"""SELL-C-sigma SpMV and SpMM: the CUDA kernels' wrappers and their plain
PyTorch versions.

All consume the flat chunk layout of ``core.formats.SELL`` (chunk c is a
column-major ``(width_c, C)`` slab at ``chunk_ptr[c]``), apply the per-chunk
scale of a quantized container to the finished row sums, and undo the
sigma permutation: ``y[perm[q]] = tile[q]`` for every real row.
``sell_spmv_arrays`` launches ``csrc/sell_spmv.cu`` and ``sell_spmm_arrays``
``csrc/sell_spmm.cu`` on CUDA tensors; on CPU tensors they run
``sell_spmv_plain`` / ``sell_spmm_plain``.  The SpMV kernel takes one block
of whole chunks per CUDA block, from a host-checked ``ChunkBlocks``, and
can add its rows into a given vector in place (``add_to``: the hybrid
plan's DIA output).  The SpMM kernel visits the chunks in the order of a
host-checked ``ChunkSchedule`` (original-row order) and tiles K as
``sell_spmm_launch`` says.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.spans import span
from . import cuda_build as CB
from .accum import acc_dtype

NAME = "sell_spmv"
_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_void_p]
_MM_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


#: stored slots (and rows) of one chunk block of the SpMV kernel: 2 loads
#: in flight for each of a CUDA block's 256 threads (``kSellBudget`` in
#: sell_spmv.cu)
SELL_BUDGET = 512


class ChunkBlocks:
    """The SpMV kernel's partition of a SELL matrix's chunks into blocks of
    whole chunks holding at most ``SELL_BUDGET`` stored slots and at most
    ``SELL_BUDGET`` rows; a chunk over the budget gets a block of its own.
    A run of whole chunks is one contiguous span of ``col_idx`` / ``val``
    (chunk c is the ``(width_c, C)`` slab at ``chunk_ptr[c]``), and the
    partition is refused unless the chunks lie back to back.  ``starts``
    (int32, on the host) holds the ``n_blocks + 1`` first chunks: block b is
    chunks ``[starts[b], starts[b + 1])``.  Built greedily and checked on the
    host, once per container; ``on(device)`` copies it to a card once.
    ``sell_spmv_arrays`` takes the partition in no other form, so every row
    it launches on is written."""

    def __init__(self, chunk_ptr, chunk_width, C: int):
        cp = (chunk_ptr.cpu().numpy() if isinstance(chunk_ptr, torch.Tensor)
              else np.asarray(chunk_ptr)).astype(np.int64)
        cw = (chunk_width.cpu().numpy() if isinstance(chunk_width, torch.Tensor)
              else np.asarray(chunk_width)).astype(np.int64)
        nc, C = cw.shape[0], int(C)
        if C < 1 or cp.shape != (nc + 1,) or cp[0] != 0 or \
                not np.array_equal(np.diff(cp), cw * C):
            raise ValueError("sell chunk blocks: the chunks are not contiguous "
                             "(chunk_ptr[c + 1] - chunk_ptr[c] != chunk_width[c] * C)")
        max_chunks = max(1, SELL_BUDGET // C)
        starts, c0 = [0], 0
        while c0 < nc:
            # the last chunk c1 with cp[c1] - cp[c0] <= budget ends the block
            c1 = int(np.searchsorted(cp, cp[c0] + SELL_BUDGET, side="right")) - 1
            c1 = min(max(c1, c0 + 1), c0 + max_chunks, nc)
            starts.append(c1)
            c0 = c1
        s = np.asarray(starts, np.int64)
        chunks, slots = np.diff(s), cp[s[1:]] - cp[s[:-1]]
        # every chunk in one block, each block within budget or one chunk alone
        if s[-1] != nc or (chunks < 1).any() or ((chunks > 1) & (
                (slots > SELL_BUDGET) | (chunks * C > SELL_BUDGET))).any():
            raise ValueError("sell chunk blocks: the partition broke its budget")
        self.n_chunks, self.C = nc, C
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


def sell_chunk_blocks(chunk_ptr, chunk_width, C: int) -> ChunkBlocks:
    """The SpMV kernel's chunk blocks (numpy or torch operands, any device)."""
    return ChunkBlocks(chunk_ptr, chunk_width, C)


#: bytes of each X row one K tile of the SpMM kernel covers (one grid row):
#: 32 f64 / 64 f32 columns, so the window of X in flight stays in L2
SPMM_TILE_BYTES = 256
#: bytes of X one thread of the SpMM kernel gathers a slot (one 32-byte sector)
SPMM_THREAD_BYTES = 32


def sell_spmm_launch(K: int, acc_bytes: int, aligned: bool = True) -> tuple[int, int]:
    """``(ct, tpr)`` of one SpMM launch, its one source: a thread owns
    ``ct`` neighbouring columns of a row (the largest power of two up to
    32 bytes that divides K, so a thread's columns lie all inside K or all
    outside; 1 when X or Y is not 16-byte ``aligned``), and ``tpr`` threads
    (a power of two <= 8) share a row in one K tile of ``tpr * ct``
    columns, at most ``SPMM_TILE_BYTES`` of each X row.  The grid has
    ``ceil(K / (tpr * ct))`` tiles along K."""
    K = int(K)
    if K < 1 or acc_bytes not in (4, 8):
        raise ValueError(f"sell_spmm_launch: K={K}, acc_bytes={acc_bytes}")
    ct = 1
    while aligned and 2 * ct * acc_bytes <= SPMM_THREAD_BYTES and K % (2 * ct) == 0:
        ct *= 2
    tpr = 1
    while tpr < 8 and tpr * ct < K and 2 * tpr * ct * acc_bytes <= SPMM_TILE_BYTES:
        tpr *= 2
    return ct, tpr


class ChunkSchedule:
    """The order in which the SELL SpMM kernel visits the chunks: a
    permutation of ``range(n_chunks)`` (``order``, int32, on the host),
    checked when it is made.  ``chunk_schedule`` builds the one the kernel
    wants, chunks by the first original row they hold, so that the sigma
    sort's length classes are walked in step and the CTAs in flight gather
    from one window of X.  ``on(device)`` copies it to a card once;
    ``sell_spmm_arrays`` takes the order in no other form."""

    def __init__(self, order):
        o = (order.cpu().numpy() if isinstance(order, torch.Tensor)
             else np.asarray(order))
        if o.ndim != 1 or not np.issubdtype(o.dtype, np.integer) or not np.array_equal(
                np.sort(o.astype(np.int64)), np.arange(o.shape[0])):
            raise ValueError("chunk schedule: the order is not a permutation of "
                             "range(n_chunks)")
        self.order = torch.from_numpy(o.astype(np.int32))
        self._on: dict = {}

    @property
    def n_chunks(self) -> int:
        return self.order.shape[0]

    def on(self, device) -> torch.Tensor:
        """``order`` on ``device``, copied there once."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = self.order.to(device)
        return self._on[key]


def chunk_first_rows(perm, C: int, n_rows: int) -> np.ndarray:
    """The first original row of each chunk (``n_rows`` for a chunk of pad
    rows only)."""
    p = (perm.cpu().numpy() if isinstance(perm, torch.Tensor) else np.asarray(perm))
    p = p.astype(np.int64).reshape(-1, C)
    return np.where(p < n_rows, p, n_rows).min(axis=1) if p.size else np.zeros(0, np.int64)


def chunk_schedule(perm, C: int, n_rows: int) -> ChunkSchedule:
    """The kernel's chunk order for a container's ``perm`` (numpy or torch,
    any device): chunks by first original row, ties in storage order.  For
    sigma = 1 (``perm`` the identity) it is the identity."""
    return ChunkSchedule(np.argsort(chunk_first_rows(perm, C, n_rows), kind="stable"))


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


def _check_add_to(add_to, n_rows: int, acc, dev):
    if add_to is None:
        return
    CB.check_tensor(add_to, "add_to", dev, (acc,), 1)
    if add_to.shape[0] != n_rows:
        raise ValueError(f"add_to has {add_to.shape[0]} rows, expected {n_rows}")


def sell_spmv_plain(chunk_ptr, chunk_width, col_idx, val, scale, perm, x,
                    n_rows: int, C: int, seg=None, add_to=None):
    """Gather + ``index_add_`` into (nc*C,) tiles, scale, un-permute.
    ``seg`` (``sell_segment_ids``) is derived when absent.  With ``add_to``
    (n_rows,) in the accumulator type, y is added into it in place and it is
    returned."""
    acc = acc_dtype(val.dtype, x.dtype)
    _check_add_to(add_to, n_rows, acc, x.device)
    if seg is None:
        seg = sell_segment_ids(chunk_ptr, chunk_width, C, col_idx.shape[0])
    prod = val.to(acc) * x.to(acc).index_select(0, col_idx)
    nc = chunk_width.shape[0]
    tiles = torch.zeros(nc * C, dtype=acc, device=x.device).index_add_(0, seg, prod)
    if scale is not None:
        tiles = tiles * scale.to(acc).repeat_interleave(C)
    # perm[:n_rows] holds every real row once (pad rows sit at the end)
    y = torch.empty(n_rows, dtype=acc, device=x.device).index_copy_(
        0, perm[:n_rows].long(), tiles[:n_rows])
    return y if add_to is None else add_to.add_(y)


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


def check_operands(chunk_ptr, chunk_width, col_idx, val, scale, perm, C, dev) -> None:
    """Raise unless the SELL kernels can read the matrix's arrays on ``dev``:
    ``sell_spmv_arrays``' and ``sell_spmm_arrays``' checks of the matrix,
    which a plan's launch record (``plan_launch``) runs once."""
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


def check_chunk_blocks(chunk_blocks, n_chunks: int, C: int) -> None:
    """Raise unless ``chunk_blocks`` is a ``ChunkBlocks`` of ``n_chunks``
    chunks of ``C`` rows."""
    if not isinstance(chunk_blocks, ChunkBlocks):
        raise TypeError(f"sell_spmv: chunk_blocks must be a ChunkBlocks "
                        f"(sell_chunk_blocks(chunk_ptr, chunk_width, C)), got "
                        f"{type(chunk_blocks).__name__}")
    if (chunk_blocks.n_chunks, chunk_blocks.C) != (n_chunks, C):
        raise ValueError(f"sell_spmv: chunk_blocks cover {chunk_blocks.n_chunks} chunks "
                         f"of {chunk_blocks.C} rows, the matrix has {n_chunks} of {C}")


def sell_spmv_arrays(chunk_ptr, chunk_width, col_idx, val, scale, perm, x,
                     n_rows: int, C: int, chunk_blocks: ChunkBlocks | None = None,
                     add_to=None):
    """SELL SpMV: the CUDA kernel for a CUDA ``x``, the plain version for a
    CPU ``x``.  Returns y (n_rows,) in original row order.  ``chunk_blocks``
    is the container's ``ChunkBlocks`` (a plan passes its cached one;
    without it the partition is built here, from host copies of
    ``chunk_ptr`` / ``chunk_width``).  With ``add_to`` (a contiguous
    (n_rows,) tensor in the accumulator type, on x's device) the kernel
    stores ``add_to[row] + y[row]`` into it in place and returns it."""
    nc = chunk_width.shape[0]
    if chunk_blocks is not None:
        check_chunk_blocks(chunk_blocks, nc, C)
    if x.device.type == "cpu":
        return sell_spmv_plain(chunk_ptr, chunk_width, col_idx, val, scale,
                               perm, x, n_rows, C, add_to=add_to)
    if x.device.type != "cuda":
        raise ValueError(f"sell_spmv: no kernel for device {x.device}")
    dev = x.device
    acc = acc_dtype(val.dtype, x.dtype)
    with span("kernel.check"):
        x = x.to(acc).contiguous()
        check_operands(chunk_ptr, chunk_width, col_idx, val, scale, perm, C, dev)
        _check_add_to(add_to, n_rows, acc, dev)
    if chunk_blocks is None:
        chunk_blocks = sell_chunk_blocks(chunk_ptr, chunk_width, C)
    blocks = chunk_blocks.on(dev)
    y = torch.empty(n_rows, dtype=acc, device=dev) if add_to is None else add_to
    CB.launch(NAME, _ARGTYPES, dev, CB.value_code(val, "val"), int(acc == torch.float64),
              CB.ptr(chunk_ptr), CB.ptr(chunk_width), CB.ptr(col_idx),
              CB.ptr(val), CB.ptr(scale), CB.ptr(perm), CB.ptr(x), CB.ptr(y),
              int(add_to is not None), nc, C, n_rows, CB.ptr(blocks),
              chunk_blocks.n_blocks)
    return y


def sell_spmm_arrays(chunk_ptr, chunk_width, col_idx, val, scale, perm, X,
                     n_rows: int, C: int, schedule: ChunkSchedule | None = None):
    """SELL SpMM, Y = A X for the K columns of X (N, K): the CUDA kernel
    for a CUDA ``X``, the plain version for a CPU ``X``.  Returns Y
    (n_rows, K) in original row order, in ``acc_dtype(val, X)``.
    ``schedule`` is the container's ``ChunkSchedule`` (a plan passes its
    cached one; without it the schedule is built here, from a host copy of
    ``perm``)."""
    nc = chunk_width.shape[0]
    if schedule is not None:
        if not isinstance(schedule, ChunkSchedule):
            raise TypeError(f"sell_spmm: schedule must be a ChunkSchedule "
                            f"(chunk_schedule(perm, C, n_rows)), got {type(schedule).__name__}")
        if schedule.n_chunks != nc:
            raise ValueError(f"sell_spmm: the schedule orders {schedule.n_chunks} chunks, "
                             f"the matrix has {nc}")
    if X.device.type == "cpu":
        return sell_spmm_plain(chunk_ptr, chunk_width, col_idx, val, scale,
                               perm, X, n_rows, C)
    if X.device.type != "cuda":
        raise ValueError(f"sell_spmm: no kernel for device {X.device}")
    with span("kernel.check"):
        if X.dim() != 2:
            raise ValueError(f"X must be (N, K), got shape {tuple(X.shape)}")
        dev = X.device
        acc = acc_dtype(val.dtype, X.dtype)
        X = X.to(acc).contiguous()
        check_operands(chunk_ptr, chunk_width, col_idx, val, scale, perm, C, dev)
    K = int(X.shape[1])
    Y = torch.empty((n_rows, K), dtype=acc, device=dev)
    if K == 0:
        return Y
    if schedule is None:
        schedule = chunk_schedule(perm, C, n_rows)
    order = schedule.on(dev)
    ct, tpr = sell_spmm_launch(K, Y.element_size(),
                               aligned=(X.data_ptr() | Y.data_ptr()) % 16 == 0)
    CB.launch("sell_spmm", _MM_ARGTYPES, dev, CB.value_code(val, "val"),
              int(acc == torch.float64), CB.ptr(chunk_ptr), CB.ptr(chunk_width),
              CB.ptr(col_idx), CB.ptr(val), CB.ptr(scale), CB.ptr(perm), CB.ptr(order),
              CB.ptr(X), CB.ptr(Y), nc, C, n_rows, K, ct, tpr)
    return Y
