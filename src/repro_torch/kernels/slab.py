"""Distributed slab multiplies: the shard executors' inner kernels.

Port of ``repro.kernels.slab``.  ``core.distributed_plan`` packs each
shard's row partition as a padded 2-D ELL slab or a flat SELL-C slab, one
per column block, and runs one multiply per block.  Those multiplies are
registry entries ``(slab_ell | slab_sell, spmv | spmm, backend)``:

* ``torch`` -- the reference's ``xla`` entries: gather + width sum (ell),
  gather + ``index_add_`` segment sum over partition-local row ids (sell);
* ``loop_reference`` -- one pass a width column (ell), an accumulating
  ``index_put_`` scatter (sell): the oracles;
* ``cuda`` -- the hand-written SELL kernels: kernel 1
  (``sell_spmv_arrays``) for ``spmv``, adding into the running shard result
  through its ``add_to=`` store, and kernel 5 (``sell_spmm_arrays``) for
  ``spmm``.  The reference runs no Pallas kernel inside ``shard_map``; the
  port has no such limit.

The operand of an entry is a :class:`SlabMeta` (pack + partition rows).
Each built function takes ``(operand, x, add_to=None)``: the operand of one
(shard, column block) -- a :class:`SlabArrays` of the host arrays on the
shard's device for ``torch`` / ``loop_reference``, a :class:`SlabChunks`
for ``cuda`` -- ``x`` (n,) or (n, K), and ``add_to``, the shard's running
result, which the product is added into in place and returned.

``slab_chunks`` derives a ``cuda`` operand once, at compile time, from the
reference-bitwise host arrays: a ``sell`` block is already SELL-C
(chunk-column-major ``(w, C)`` chunks); its descriptor lists every chunk
of the partition's rows, the ones the packer skipped (all rows empty) as
zero-width chunks, so that every row of the shard result is written; the
rows padded to ``rows_pp`` sort after the real ones, so the kernel's
permutation holds its pads only at its end; and the descriptor ends at the
block's real chunks (the zero tail that stacks every block to the longest
one carries no work).  An ``ell`` block is relaid once into chunks of
``ELL_CHUNK`` rows in row order, each as wide as its longest row, so a
chunk's column is read coalesced.  An empty block has no operand and no
launch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.distributed import sell_layout
from .accum import acc_dtype
from .registry import CompiledKernel, register_kernel
from .sell_spmv import (ChunkBlocks, ChunkSchedule, chunk_schedule, sell_chunk_blocks,
                        sell_spmm_arrays, sell_spmv_arrays)

#: rows of a chunk of an ``ell`` block relaid for the SELL kernels
ELL_CHUNK = 8


@dataclass(frozen=True)
class SlabMeta:
    """What a slab-kernel build hook needs to know about the partition."""

    pack: str       # "ell" | "sell"
    rows_pp: int    # padded rows per partition (result tile height)

    #: registry cost hooks key on nnz; slabs are pre-balanced per shard
    nnz = 1


@dataclass(frozen=True)
class SlabArrays:
    """One (shard, column block) of a ``ShardSlabs`` on the shard's device:
    ``col`` / ``val`` (rows_pp, W) for ell, (L,) for sell with ``rid``."""

    col: torch.Tensor
    val: torch.Tensor
    rid: torch.Tensor | None = None


@dataclass(frozen=True)
class SlabChunks:
    """The SELL-C descriptor of one (shard, column block) on the shard's
    device: ``n_rows`` (= rows_pp) rows in ``chunk_width.shape[0]`` chunks
    of ``C``, with the kernels' host-checked chunk blocks and schedule."""

    chunk_ptr: torch.Tensor    # (nc + 1,) int64
    chunk_width: torch.Tensor  # (nc,) int32
    col: torch.Tensor          # (total,) int32
    val: torch.Tensor          # (total,)
    perm: torch.Tensor         # (nc * C,) int32, pads (= n_rows) at the end
    C: int
    n_rows: int
    blocks: ChunkBlocks
    schedule: ChunkSchedule

    @property
    def nbytes(self) -> int:
        """Bytes of the descriptor the kernels stream."""
        return sum(t.numel() * t.element_size() for t in
                   (self.chunk_ptr, self.chunk_width, self.col, self.val, self.perm))


def slab_chunks(pack: str, col: np.ndarray, val: np.ndarray, lens: np.ndarray,
                C: int) -> dict | None:
    """The host SELL-C descriptor of one block: ``col`` / ``val`` its host
    arrays ((L,) for sell, (rows_pp, W) for ell), ``lens`` (rows_pp,) its
    rows' lengths, ``C`` the sell pack's chunk height (ell: relaid into
    chunks of ``ELL_CHUNK``).  None for a block without entries; else the
    numpy arrays ``chunk_ptr``, ``chunk_width``, ``col``, ``val``, ``perm``
    and the ints ``C``, ``n_rows``."""
    rows_pp = int(lens.shape[0])
    if pack == "sell":
        order, widths, _, total = (a[0, 0] for a in sell_layout(lens[None, None], C))
        total = int(total)
        fcol, fval = col[:total], val[:total]
    elif pack == "ell":
        C = ELL_CHUNK
        nc = -(-rows_pp // C)
        padded = np.zeros(nc * C, np.int64)
        padded[:rows_pp] = lens
        widths = padded.reshape(nc, C).max(axis=1)
        total = int(widths.sum()) * C
        order = np.arange(rows_pp)
        keep = np.arange(col.shape[1])[None, :, None] < widths[:, None, None]

        def relay(a):  # (rows_pp, W) -> chunks (nc, W, C), each cut to its width
            ap = np.zeros((nc * C, a.shape[1]), a.dtype)
            ap[:rows_pp] = a
            a3 = ap.reshape(nc, C, -1).transpose(0, 2, 1)
            return a3[np.broadcast_to(keep, a3.shape)]

        fcol, fval = relay(col), relay(val)
    else:
        raise ValueError(f"unknown slab pack {pack!r}")
    if total == 0:
        return None
    nc = widths.shape[0]
    perm = np.full(nc * C, rows_pp, np.int32)
    perm[:rows_pp] = order
    chunk_ptr = np.zeros(nc + 1, np.int64)
    np.cumsum(widths * C, out=chunk_ptr[1:])
    return {"chunk_ptr": chunk_ptr, "chunk_width": widths.astype(np.int32),
            "col": np.ascontiguousarray(fcol, np.int32), "val": np.ascontiguousarray(fval),
            "perm": perm, "C": int(C), "n_rows": rows_pp}


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return (t if dtype is None else t.to(dtype)).to(device)


def chunks_on(d: dict, device, value_dtype: torch.dtype | None = None) -> SlabChunks:
    """A host descriptor of :func:`slab_chunks` placed on ``device``."""
    return SlabChunks(
        _tensor(d["chunk_ptr"], device), _tensor(d["chunk_width"], device),
        _tensor(d["col"], device), _tensor(d["val"], device, value_dtype),
        _tensor(d["perm"], device), d["C"], d["n_rows"],
        sell_chunk_blocks(d["chunk_ptr"], d["chunk_width"], d["C"]),
        chunk_schedule(d["perm"], d["C"], d["n_rows"]))


def slab_operands(blocks, lens: np.ndarray, backend: str, devices, C: int,
                  value_dtype: torch.dtype | None = None) -> tuple:
    """Every (shard, column block) operand of a ``ShardSlabs`` for
    ``backend``, on the shard's device: ``operands[p][q]``; a ``cuda``
    operand is None for a block without entries.  ``lens`` (P, Q, rows_pp)
    are the blocks' row lengths; ``value_dtype`` the stored values' torch
    dtype (the host arrays of bf16 / fp8 hold their exact f32 upcast)."""
    out = []
    for p in range(blocks.parts):
        dev = devices[p]
        row = []
        for q in range(blocks.q_blocks):
            if backend == "cuda":
                d = slab_chunks(blocks.pack, blocks.col[p, q], blocks.val[p, q], lens[p, q], C)
                row.append(None if d is None else chunks_on(d, dev, value_dtype))
            else:
                rid = None if blocks.rid is None else _tensor(blocks.rid[p, q], dev)
                row.append(SlabArrays(_tensor(blocks.col[p, q], dev),
                                      _tensor(blocks.val[p, q], dev, value_dtype), rid))
        out.append(tuple(row))
    return tuple(out)


# ---------------------------------------------------------------------------
# the multiplies
# ---------------------------------------------------------------------------


def _add(add_to, y):
    return y if add_to is None else add_to.add_(y)


def _gather(x: torch.Tensor, col: torch.Tensor, acc) -> torch.Tensor:
    """``x[col]`` for an int32 index of any shape, cast to ``acc``."""
    return x.index_select(0, col.reshape(-1)).reshape(
        tuple(col.shape) + tuple(x.shape[1:])).to(acc)


def _ell_mult(rows_pp: int):
    def mult(op: SlabArrays, x, add_to=None):
        acc = acc_dtype(op.val.dtype, x.dtype)
        g = _gather(x, op.col, acc)  # (rows_pp, W[, K])
        v = op.val.to(acc)
        return _add(add_to, (v * g if x.dim() == 1 else v[..., None] * g).sum(dim=1))
    return mult


def _sell_mult(rows_pp: int):
    def mult(op: SlabArrays, x, add_to=None):
        acc = acc_dtype(op.val.dtype, x.dtype)
        g = _gather(x, op.col, acc)  # (L[, K])
        v = op.val.to(acc)
        prod = v * g if x.dim() == 1 else v[:, None] * g
        y = prod.new_zeros((rows_pp + 1,) + tuple(prod.shape[1:]))
        return _add(add_to, y.index_add_(0, op.rid, prod)[:rows_pp])
    return mult


def _ell_mult_loop(rows_pp: int):
    """Loop oracle: one pass per slab width column."""
    def mult(op: SlabArrays, x, add_to=None):
        acc = acc_dtype(op.val.dtype, x.dtype)
        v = op.val.to(acc)
        y = torch.zeros((rows_pp,) + tuple(x.shape[1:]), dtype=acc, device=x.device)
        for j in range(op.col.shape[1]):
            g = x.index_select(0, op.col[:, j]).to(acc)
            y = y + (v[:, j] * g if x.dim() == 1 else v[:, j, None] * g)
        return _add(add_to, y)
    return mult


def _sell_mult_loop(rows_pp: int):
    """Loop oracle: an accumulating scatter over partition-local row ids
    (independent of the segment sum it validates)."""
    def mult(op: SlabArrays, x, add_to=None):
        acc = acc_dtype(op.val.dtype, x.dtype)
        g = x.index_select(0, op.col).to(acc)
        v = op.val.to(acc)
        prod = v * g if x.dim() == 1 else v[:, None] * g
        y = torch.zeros((rows_pp + 1,) + tuple(x.shape[1:]), dtype=acc, device=x.device)
        return _add(add_to, y.index_put_((op.rid.long(),), prod, accumulate=True)[:rows_pp])
    return mult


def _cuda_spmv(rows_pp: int):
    """Kernel 1 on the block's descriptor; the running result is its
    ``add_to`` (the add happens in the kernel's store)."""
    def mult(op: SlabChunks, x, add_to=None):
        return sell_spmv_arrays(op.chunk_ptr, op.chunk_width, op.col, op.val, None, op.perm,
                                x, op.n_rows, op.C, chunk_blocks=op.blocks, add_to=add_to)
    return mult


def _cuda_spmm(rows_pp: int):
    """Kernel 5 on the block's descriptor (it has no ``add_to``: the running
    result adds its output)."""
    def mult(op: SlabChunks, X, add_to=None):
        return _add(add_to, sell_spmm_arrays(op.chunk_ptr, op.chunk_width, op.col, op.val,
                                             None, op.perm, X, op.n_rows, op.C,
                                             schedule=op.schedule))
    return mult


_BUILDERS = {
    ("ell", "torch"): (_ell_mult, _ell_mult),
    ("sell", "torch"): (_sell_mult, _sell_mult),
    ("ell", "loop_reference"): (_ell_mult_loop, _ell_mult_loop),
    ("sell", "loop_reference"): (_sell_mult_loop, _sell_mult_loop),
    ("ell", "cuda"): (_cuda_spmv, _cuda_spmm),
    ("sell", "cuda"): (_cuda_spmv, _cuda_spmm),
}
_LABELS = {"torch": "torch", "loop_reference": "loop", "cuda": "cuda"}


def _const_cost(seconds: float):
    """Slab entries rank only among themselves: a flat nominal cost (the
    loop oracles last; a ``cuda`` entry whose probe accepts always wins)."""
    return lambda meta, ctx: seconds


for (_pack, _backend), _fns in _BUILDERS.items():
    for _op, _fn in zip(("spmv", "spmm"), _fns):
        def _build(meta: SlabMeta, ctx, _fn=_fn, _backend=_backend) -> CompiledKernel:
            return CompiledKernel(_fn(meta.rows_pp), _LABELS[_backend])
        register_kernel(
            f"slab_{_pack}", _op, _backend, cost=_const_cost(
                1.0 if _backend == "loop_reference" else 0.0),
            description=f"partition-local {_pack} slab multiply" + (
                " (oracle)" if _backend == "loop_reference" else ""))(_build)


def slab_mult(pack: str, rows_pp: int, backend: str = "torch", op: str = "spmv",
              ctx=None):
    """The shard-local multiply of one slab pack through the registry (the
    distributed executors' dispatch point): ``fn(operand, x, add_to=None)``.
    ``BackendUnavailable`` when the entry's probe refuses ``ctx.device``."""
    from . import registry as R
    return R.build(SlabMeta(pack, rows_pp), f"slab_{pack}", op, backend, ctx).fn
