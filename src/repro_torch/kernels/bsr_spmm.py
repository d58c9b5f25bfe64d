"""BELL (block-ELL) SpMM: the CUDA kernel's wrapper and its plain PyTorch
version, and the BSR -> BELL pack.

BELL stores a BSR matrix as a fixed number ``nbpp`` of block slots per
block row, padded with zero blocks (column id 0): ``bcols (nbr, nbpp)``
int32 and ``blocks (nbr, nbpp, bm, bk)``.  The function is::

    Y[i*bm:(i+1)*bm] = sum_j scale[i, j] * blocks[i, j] @ X[bcols[i, j]*bk : +bk]

for ``X (K, N)`` row-major, accumulated in ``acc_dtype(blocks, X)`` (f64
when either is f64, else f32).  ``scale (nbr, nbpp)`` f32 carries the
per-block scale of an int8 / fp8 container (padding slots 0); without it
every slot's scale is 1.  ``bell_spmm_arrays`` launches ``csrc/bell_spmm.cu``
on CUDA tensors and runs ``bell_spmm_plain`` on CPU tensors.

The kernel walks only each block row's stored slots (``row_nblocks``), so
the padding ``bsr_to_bell`` adds is never streamed; SpMV is the N = 1 case
of the same kernel (no lane-padded x panel).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build as CB
from .accum import acc_dtype

NAME = "bell_spmm"
_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

#: threads of one CUDA block of the kernel (kThreads in bell_spmm.cu)
THREADS = 256
#: shared memory a block may take without an opt-in attribute
SMEM_MAX = 48 * 1024
#: most slots one stage of the kernel stages (loads in flight per thread)
MAX_STAGE = 8

#: integer dtype of each value width, for moving values as raw bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


# ---------------------------------------------------------------------------
# BSR -> BELL host-side pack
# ---------------------------------------------------------------------------


def _row_lengths(m) -> np.ndarray:
    return np.diff(m.block_row_ptr.cpu().numpy().astype(np.int64))


def bsr_to_bell(m) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad each block row to the most blocks any row holds: ``(bcols
    (nbr, nbpp) int32, slab (nbr, nbpp, bm, bk))``, padding slots column 0
    and zero blocks; the same arrays as the reference's ``bsr_to_bell``.
    Values move as raw bits, so every storage dtype packs exactly."""
    bm, bk = m.block_shape
    lens = _row_lengths(m)
    nbr = lens.shape[0]
    nbpp = int(max(1, lens.max())) if nbr else 1
    row = np.repeat(np.arange(nbr, dtype=np.int64), lens)
    start = m.block_row_ptr.cpu().numpy().astype(np.int64)[:-1]
    slot = np.arange(row.shape[0], dtype=np.int64) - np.repeat(start, lens)
    bcols = np.zeros((nbr, nbpp), dtype=np.int32)
    bcols[row, slot] = m.block_col_idx.cpu().numpy()
    blocks = m.blocks.detach().cpu().contiguous()
    src = blocks.view(_BITS[blocks.element_size()]).numpy()
    slab = np.zeros((nbr, nbpp, bm, bk), dtype=src.dtype)
    slab[row, slot] = src
    return (torch.from_numpy(bcols),
            torch.from_numpy(slab).view(blocks.dtype))


def bell_scale(m) -> torch.Tensor | None:
    """The per-block scale of a quantized BSR as a ``(nbr, nbpp)`` f32
    slab beside ``bsr_to_bell``'s (padding slots 0), or None."""
    if m.scale is None:
        return None
    lens = _row_lengths(m)
    nbr = lens.shape[0]
    nbpp = int(max(1, lens.max())) if nbr else 1
    mask = np.arange(nbpp)[None, :] < lens[:, None]
    out = np.zeros((nbr, nbpp), dtype=np.float32)
    out[mask] = m.scale.cpu().numpy()
    return torch.from_numpy(out)


def bell_row_nblocks(m) -> torch.Tensor:
    """Stored blocks of each block row, ``(nbr,)`` int32: the slots the
    kernel walks."""
    return torch.from_numpy(_row_lengths(m).astype(np.int32))


def bell_fill_ratio(m) -> float:
    """Streamed blocks of the padded BELL slab (padding included) over
    stored blocks."""
    lens = _row_lengths(m)
    nbpp = int(max(1, lens.max())) if lens.size else 1
    return nbpp * lens.shape[0] / max(1, int(lens.sum()))


# ---------------------------------------------------------------------------
# the kernel's launch geometry
# ---------------------------------------------------------------------------


def bell_launch(bm: int, bk: int, N: int, acc_bytes: int,
                nbpp: int = MAX_STAGE) -> tuple[int, int, int, int]:
    """``(nt, G, rn, S)`` of one launch: each CUDA block computes one block
    row times ``nt`` columns of Y; a thread computes ``rn`` neighbouring
    columns of one row, and ``G`` threads (a power of two <= 32, lanes of
    one warp) split each output's sum along ``bk`` and meet in a shuffle
    reduction.  Each stage stages ``S`` slots (at most ``nbpp``, the slots
    a block row has): their blocks and ``(bk, nt)`` X panels in shared
    memory, which bounds ``nt`` and ``S``.  Raises ValueError for a block
    shape whose single row of outputs does not fit."""
    if min(bm, bk, N) < 1:
        raise ValueError(f"bell_launch: bm={bm}, bk={bk}, N={N} must be >= 1")
    rn = 4 if N >= 32 else 1
    nt = min(-(-N // rn) * rn, 32 * rn)

    def ntc(nt):
        return -(-nt // rn)

    def smem(nt):
        return (bm * bk + bk * ntc(nt) * rn) * acc_bytes

    while nt > 1 and (bm * ntc(nt) > THREADS or smem(nt) > SMEM_MAX):
        nt = max(1, nt // 2)
    if bm * ntc(nt) > THREADS or smem(nt) > SMEM_MAX:
        raise ValueError(f"bell_spmm: a ({bm}, {bk}) block does not fit one CUDA "
                         f"block ({bm * ntc(nt)} outputs, {smem(nt)} B of shared "
                         f"memory; at most {THREADS} and {SMEM_MAX})")
    G = 1
    while G < 32 and 2 * G * bm * ntc(nt) <= THREADS:
        G *= 2
    S = max(1, min(MAX_STAGE, int(nbpp), SMEM_MAX // smem(nt)))
    return nt, G, rn, S


# ---------------------------------------------------------------------------
# plain version and kernel wrapper
# ---------------------------------------------------------------------------


def bell_spmm_plain(bcols, blocks, X, scale=None, n_rows: int | None = None):
    """Gather the X block rows each slot names and contract them with the
    blocks (``einsum``), scaled per slot; ``Y[:n_rows]``."""
    nbr, nbpp, bm, bk = blocks.shape
    K, N = X.shape
    acc = acc_dtype(blocks.dtype, X.dtype)
    g = X.to(acc).reshape(K // bk, bk, N)[bcols.long()]     # (nbr, nbpp, bk, N)
    if scale is None:
        y = torch.einsum("rjmk,rjkn->rmn", blocks.to(acc), g)
    else:
        part = torch.einsum("rjmk,rjkn->rjmn", blocks.to(acc), g)
        y = (part * scale.to(acc)[:, :, None, None]).sum(1)
    y = y.reshape(nbr * bm, N)
    return y if n_rows is None else y[:n_rows]


def _check_operands(bcols, blocks, X, scale, row_nblocks, dev):
    CB.check_tensor(bcols, "bcols", dev, (torch.int32,), 2)
    CB.check_tensor(blocks, "blocks", dev, None, 4)
    CB.check_tensor(X, "X", dev, None, 2)
    nbr, nbpp, bm, bk = blocks.shape
    if tuple(bcols.shape) != (nbr, nbpp):
        raise ValueError(f"bcols {tuple(bcols.shape)} does not match blocks "
                         f"{tuple(blocks.shape)}")
    if X.shape[0] % bk:
        raise ValueError(f"X has {X.shape[0]} rows, not a multiple of bk={bk}")
    if scale is not None:
        CB.check_tensor(scale, "scale", dev, (torch.float32,), 2)
        if tuple(scale.shape) != (nbr, nbpp):
            raise ValueError(f"scale {tuple(scale.shape)} for {nbr} x {nbpp} slots")
    if row_nblocks is not None:
        CB.check_tensor(row_nblocks, "row_nblocks", dev, (torch.int32,), 1)
        if row_nblocks.shape[0] != nbr:
            raise ValueError(f"row_nblocks has {row_nblocks.shape[0]} rows, "
                             f"expected {nbr}")


def bell_spmm_arrays(bcols, blocks, X, scale=None, row_nblocks=None,
                     n_rows: int | None = None):
    """BELL SpMM ``Y = A @ X`` for X (K, N): the CUDA kernel for a CUDA
    ``X``, the plain version for a CPU ``X``.  Returns the first ``n_rows``
    (default all ``nbr * bm``) rows of Y in ``acc_dtype(blocks, X)``.
    ``row_nblocks`` (int32, per block row) lets the kernel skip padding
    slots, which must hold zero blocks; the plain version reads them."""
    nbr, nbpp, bm, bk = blocks.shape
    M = nbr * bm if n_rows is None else int(n_rows)
    if X.device.type == "cpu":
        return bell_spmm_plain(bcols, blocks, X, scale, M)
    if X.device.type != "cuda":
        raise ValueError(f"bell_spmm: no kernel for device {X.device}")
    if X.dim() != 2:
        raise ValueError(f"X must be (K, N), got shape {tuple(X.shape)}")
    if not 0 <= M <= nbr * bm:
        raise ValueError(f"n_rows={M} outside [0, {nbr * bm}]")
    dev = X.device
    acc = acc_dtype(blocks.dtype, X.dtype)
    X = X.to(acc).contiguous()
    _check_operands(bcols, blocks, X, scale, row_nblocks, dev)
    N = int(X.shape[1])
    Y = torch.empty((M, N), dtype=acc, device=dev)
    if M == 0 or N == 0:
        return Y
    nt, G, rn, S = bell_launch(bm, bk, N, torch.tensor([], dtype=acc).element_size(), nbpp)
    fn = CB.kernel_function(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(CB.value_code(blocks, "blocks"), int(acc == torch.float64),
                CB.ptr(bcols), CB.ptr(blocks), CB.ptr(scale), CB.ptr(row_nblocks),
                CB.ptr(X), CB.ptr(Y), nbr, nbpp, bm, bk, M, N, nt, G, rn, S,
                CB.stream_handle(dev))
    CB.raise_on_error(NAME, rc)
    CB.count_launch(NAME)
    return Y


def bsr_spmm(m, X: torch.Tensor) -> torch.Tensor:
    """``m @ X`` for a BSR container through the BELL pack (built per
    call; the registry entries cache it), on X's device."""
    bcols, slab = bsr_to_bell(m)
    scale = bell_scale(m)
    dev = X.device
    lens = bell_row_nblocks(m).to(dev)
    return bell_spmm_arrays(bcols.to(dev), slab.to(dev), X,
                            None if scale is None else scale.to(dev), lens, m.shape[0])


def bsr_spmv(m, x: torch.Tensor) -> torch.Tensor:
    """``m @ x`` as the N = 1 case of ``bsr_spmm``."""
    return bsr_spmm(m, x.reshape(-1, 1))[:, 0]
