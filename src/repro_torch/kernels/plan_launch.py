"""The ``cuda`` SpMV of a ``dia``, ``sell`` or ``hybrid`` container on the
card: its kernels launched in one C call from a launch record.

The entries' builders (``kernels/dia.py``, ``sell.py``, ``hybrid.py``) hand
the frozen operands of their kernels -- a :class:`DiaPart`, a
:class:`SellPart`, or both in launch order -- to :func:`spmv_fn`, which
builds a :class:`LaunchRecord` for each accumulator dtype the values admit.
Building a record runs, once, every check that ``dia_spmv_arrays`` and
``sell_spmv_arrays`` run on those operands at every call, and freezes
their pointers, sizes and codes into one C struct (``PlanSpmv`` in
``csrc/plan_launch.cu``).

A call checks x's device, casts x to the accumulator dtype and makes it
contiguous (no copy where it already is), allocates y and makes one ctypes
call (``plan_spmv``).  That call launches kernel 2 on the unpadded x, then
kernel 1 adding its rows into y, or the one part there is: the kernels,
order and sums of ``dia_spmv_arrays`` on a padded x followed by
``sell_spmv_arrays`` with ``add_to``, so y is theirs bit for bit.  The
call goes through ``cuda_build.launch``, as every kernel's does, and counts
a launch under each kernel's name (``cuda_build.launch_counts``): it is one
``kernel.check`` span and one ``kernel.launch`` span, which counts once a
kernel launched (``utils.spans``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.spans import span
from . import cuda_build as CB
from . import dia_spmv as KD
from . import sell_spmv as KS
from .accum import acc_dtype

ENTRY = "plan_spmv"
_ARGTYPES = [ctypes.c_void_p] * 4
#: ``parts`` bits of ``PlanSpmv``
_PART_DIA, _PART_SELL = 1, 2


class DiaPart(NamedTuple):
    """Kernel 2's operands on the entry's device: (nd, ld) ``data``, int32
    ``offsets``, f32 ``scales`` or None, for ``n_rows`` rows of x of
    ``n_cols``."""

    data: torch.Tensor
    offsets: torch.Tensor
    scales: torch.Tensor | None
    n_rows: int
    n_cols: int


class SellPart(NamedTuple):
    """Kernel 1's operands on the entry's device and the container's
    ``ChunkBlocks``."""

    chunk_ptr: torch.Tensor
    chunk_width: torch.Tensor
    col_idx: torch.Tensor
    val: torch.Tensor
    scale: torch.Tensor | None
    perm: torch.Tensor
    n_rows: int
    C: int
    chunk_blocks: KS.ChunkBlocks


def _values(part) -> torch.Tensor:
    return part.data if isinstance(part, DiaPart) else part.val


class _PlanSpmv(ctypes.Structure):
    """``PlanSpmv`` of ``csrc/plan_launch.cu``, field for field."""

    _fields_ = [("acc64", ctypes.c_int32), ("parts", ctypes.c_int32),
                ("n_rows", ctypes.c_int64), ("n_x", ctypes.c_int64),
                ("dia_vcode", ctypes.c_int32), ("nd", ctypes.c_int32),
                ("ld", ctypes.c_int64), ("dia_data", ctypes.c_void_p),
                ("offsets", ctypes.c_void_p), ("dia_scales", ctypes.c_void_p),
                ("sell_vcode", ctypes.c_int32), ("C", ctypes.c_int32),
                ("n_chunks", ctypes.c_int64), ("n_blocks", ctypes.c_int64),
                ("chunk_ptr", ctypes.c_void_p), ("chunk_width", ctypes.c_void_p),
                ("col", ctypes.c_void_p), ("val", ctypes.c_void_p),
                ("sell_scale", ctypes.c_void_p), ("perm", ctypes.c_void_p),
                ("blocks", ctypes.c_void_p)]


class LaunchRecord:
    """The checked operands of a container's kernels for x and y in ``acc``
    on ``device``, as one ``PlanSpmv``; ``record.launch(x)`` is y = A x for
    an x that is contiguous, in ``acc``, on ``device``.  Holds the tensors
    whose pointers the struct carries (``parts``; the chunk blocks' copy on
    the card stays in its ``ChunkBlocks``).  Raises ``TypeError`` /
    ``ValueError`` where a check of ``dia_spmv_arrays`` or
    ``sell_spmv_arrays`` would."""

    def __init__(self, parts, acc: torch.dtype, device: torch.device):
        kinds = [type(p) for p in parts]
        if kinds not in ([DiaPart], [SellPart], [DiaPart, SellPart]):
            raise ValueError(f"launch record: parts {[k.__name__ for k in kinds]}, expected "
                             "a DiaPart, a SellPart, or a DiaPart then a SellPart")
        rows = {p.n_rows for p in parts}
        if len(rows) != 1:
            raise ValueError(f"launch record: the parts have {sorted(rows)} rows")
        for p in parts:
            if acc_dtype(_values(p).dtype, acc) != acc:
                raise TypeError(f"launch record: {_values(p).dtype} values take no "
                                f"{acc} accumulator")
        self.acc, self.n_rows, self.device = acc, rows.pop(), device
        self.parts = tuple(parts)
        self.kernels = tuple(KD.NAME if isinstance(p, DiaPart) else KS.NAME for p in parts)
        rec = _PlanSpmv(acc64=int(acc == torch.float64), n_rows=self.n_rows)
        # the DIA part reads x unpadded, within its length (pad0 = 0)
        rec.n_x = parts[0].n_cols if isinstance(parts[0], DiaPart) else 0
        for p in parts:
            if isinstance(p, DiaPart):
                KD.check_operands(p.data, p.offsets, p.scales, p.n_rows, device)
                rec.parts |= _PART_DIA
                rec.dia_vcode = CB.value_code(p.data, "data")
                rec.nd, rec.ld = p.data.shape
                rec.dia_data, rec.offsets = CB.ptr(p.data), CB.ptr(p.offsets)
                rec.dia_scales = CB.ptr(p.scales)
            else:
                nc = p.chunk_width.shape[0]
                KS.check_chunk_blocks(p.chunk_blocks, nc, p.C)
                KS.check_operands(p.chunk_ptr, p.chunk_width, p.col_idx, p.val, p.scale,
                                  p.perm, p.C, device)
                blocks = p.chunk_blocks.on(device)
                rec.parts |= _PART_SELL
                rec.sell_vcode = CB.value_code(p.val, "val")
                rec.C, rec.n_chunks, rec.n_blocks = p.C, nc, p.chunk_blocks.n_blocks
                rec.chunk_ptr, rec.chunk_width = CB.ptr(p.chunk_ptr), CB.ptr(p.chunk_width)
                rec.col, rec.val = CB.ptr(p.col_idx), CB.ptr(p.val)
                rec.sell_scale, rec.perm = CB.ptr(p.scale), CB.ptr(p.perm)
                rec.blocks = CB.ptr(blocks)
        self._struct = rec
        self._addr = ctypes.addressof(rec)

    def launch(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.empty(self.n_rows, dtype=self.acc, device=self.device)
        CB.launch(ENTRY, _ARGTYPES, self.device, self._addr, x.data_ptr(), y.data_ptr(),
                  counts=self.kernels)
        return y


def spmv_fn(parts, device: torch.device):
    """y = A x on ``device`` (a CUDA device with its index) for the parts of
    a ``cuda`` SpMV entry: one :class:`LaunchRecord` for each of f32 and f64
    that the values admit (f64 values admit f64 alone), built and checked
    now; a call picks the record of ``acc_dtype(values, x)``.  x on another
    device is a ``ValueError``, as in ``dia_spmv_arrays``."""
    values = [_values(p).dtype for p in parts]
    records = {acc: LaunchRecord(parts, acc, device)
               for acc in (torch.float32, torch.float64) if acc_dtype(*values, acc) == acc}

    def fn(x: torch.Tensor) -> torch.Tensor:
        with span("kernel.check"):
            if x.device != device:
                raise ValueError(f"x is on {x.device}, expected {device}")
            rec = records[acc_dtype(*values, x.dtype)]
            if x.dtype != rec.acc:
                x = x.to(rec.acc)
            if not x.is_contiguous():
                x = x.contiguous()
        return rec.launch(x)

    return fn
