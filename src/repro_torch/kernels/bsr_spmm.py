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
of the same kernel (no lane-padded x panel).  ``bell_launch`` picks its
geometry and ``bell_panels`` lays X out as it reads it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build as CB
from .accum import acc_dtype

NAME = "bell_spmm"
_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64] + [
    ctypes.c_int] * 10 + [ctypes.c_void_p]

#: consumer threads of one CTA (8 warps; a producer warp comes on top)
THREADS = 256
WARPS = 8
#: dynamic shared memory one CTA may take on sm_90, and what its mbarriers
#: take of it (kSmemMax, kBarBytes in bell_spmm.cu)
SMEM_MAX = 232448
SMEM_BARRIERS = 128
#: ring stages at most, and the bytes a ring aims at (two CTAs' rings then
#: fit one SM at the widest tile)
MAX_STAGES = 8
RING_BYTES = 96 * 1024
#: bytes of each X row one work item covers at most
TILE_BYTES = 256
#: rows a thread owns on the wide path (kWideRows)
WIDE_ROWS = 8

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


class BellLaunch(NamedTuple):
    """One launch of the BELL kernel.  A work item is one block row times
    ``ntile`` columns of Y (X is read as ``(n_tiles, K, ntile)`` panels).
    A thread owns ``rm`` rows x ``cw`` columns: (1, 1) on the "decode" path
    (N < 8), 2 or 8 rows x 16 bytes of the accumulator on the "wide" path.
    With rm < 8, ``G`` lanes of one warp split bk; with rm = 8, ``cl`` lanes
    of a warp run along the column groups and 32 / ``cl`` along bk, ``uh``
    warps along the (row group, column chunk) units and ``gw`` warps along
    bk (``G`` = 32 / ``cl`` * ``gw``).  Each of the ``stages`` ring stages
    holds one stored block (rows padded to a multiple of ``rm``) and its X
    panel (``stage_bytes``); ``smem`` is the CTA's dynamic shared memory."""
    path: str
    cw: int
    rm: int
    ntile: int
    G: int
    cl: int
    uh: int
    gw: int
    stages: int
    stage_bytes: int
    smem: int


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def _lanes_along_bk(units: int, bk: int) -> int:
    """A power of two <= 32 lanes a unit, as many as 256 threads hold."""
    G = 1
    while G < 32 and 2 * G * units <= THREADS and G < bk:
        G *= 2
    return G


def bell_launch(bm: int, bk: int, N: int, acc_bytes: int, val_bytes: int = 4) -> BellLaunch:
    """The geometry of one launch, its one source (``csrc/bell_spmm.cu``
    checks it).  N >= 8 takes the wide path: 16 bytes of outputs a thread,
    a work item at most ``TILE_BYTES`` of each X row; 8 rows a thread with
    the lanes of a quarter-warp on neighbouring 16-byte pieces of one X row
    (no bank conflicts) where an item has 4 or more column groups and at
    most 8 units for the 8 warps, else 2 rows a thread with the lanes along
    bk (N = 8 in f32: fewer cross-warp sums).  N < 8 takes the decode path: a
    thread an output, the lanes of a warp along bk.  The ring takes ``RING_BYTES`` (at least two stages, at most
    ``MAX_STAGES``).  Raises ValueError for a block whose stage does not fit
    shared memory or whose rows do not fit the threads."""
    if min(bm, bk, N) < 1 or acc_bytes not in (4, 8):
        raise ValueError(f"bell_launch: bm={bm}, bk={bk}, N={N}, acc_bytes={acc_bytes}")
    if N >= 8:
        cw = 16 // acc_bytes
        ntile = min(-(-N // cw) * cw, TILE_BYTES // acc_bytes)
        n_cg = ntile // cw
        cl = min(8, _pow2_ceil(n_cg))
        units = -(-bm // WIDE_ROWS) * -(-n_cg // cl)
        if n_cg >= 4 and units <= WARPS:
            path, rm, uh = "wide", WIDE_ROWS, _pow2_ceil(units)
            gw = WARPS // uh
            G = 32 // cl * gw
        else:
            while -(-bm // 2) * (ntile // cw) > THREADS and ntile > cw:
                ntile = max(cw, ntile // 2 // cw * cw)   # fewer columns an item
            units = -(-bm // 2) * (ntile // cw)
            path, rm, cl, uh, gw = "wide", 2, 0, 0, 0
            G = _lanes_along_bk(units, bk)
    else:
        path, cw, rm, cl, uh, gw = "decode", 1, 1, 0, 0, 0
        units = bm
        ntile = max(1, min(N, THREADS // bm))
        G = _lanes_along_bk(bm * ntile, bk)
    if units > THREADS:
        raise ValueError(f"bell_spmm: a ({bm}, {bk}) block does not fit one CTA ({units} "
                         f"output units of {rm} rows; at most {THREADS})")
    red = WARPS * cl * WIDE_ROWS * cw * acc_bytes if rm == WIDE_ROWS else 0
    blk = -(-(-(-bm // rm) * rm) * bk * val_bytes // 16) * 16
    stage = blk + -(-bk * ntile * acc_bytes // 16) * 16
    room = SMEM_MAX - SMEM_BARRIERS - red
    if stage > room:
        raise ValueError(f"bell_spmm: a ({bm}, {bk}) block does not fit one CTA (a stage "
                         f"of {stage} B of shared memory; at most {room})")
    stages = min(MAX_STAGES, max(2, RING_BYTES // stage), room // stage)
    return BellLaunch(path, cw, rm, ntile, G, cl, uh, gw, stages, stage,
                      SMEM_BARRIERS + red + stages * stage)


def bell_panels(X: torch.Tensor, ntile: int) -> torch.Tensor:
    """X (K, N) as the kernel reads it: ``(n_tiles, K, ntile)`` panels, the
    last padded with zeros; X itself when one tile spans N."""
    K, N = X.shape
    if ntile == N:
        return X
    n_tiles = -(-N // ntile)
    Xp = torch.nn.functional.pad(X, (0, n_tiles * ntile - N))
    return Xp.view(K, n_tiles, ntile).permute(1, 0, 2).contiguous()


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
    L = bell_launch(bm, bk, N, Y.element_size(), blocks.element_size())
    P = bell_panels(X, L.ntile)
    CB.launch(NAME, _ARGTYPES, dev, CB.value_code(blocks, "blocks"), int(acc == torch.float64),
              CB.ptr(bcols), CB.ptr(blocks), CB.ptr(scale), CB.ptr(row_nblocks), CB.ptr(P),
              CB.ptr(Y), nbr, nbpp, bm, bk, M, int(X.shape[0]), N, L.cw, L.rm, L.ntile, L.G,
              L.cl, L.uh, L.gw, L.stages, counts=(NAME, f"{NAME}_{L.path}"))
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
