"""Matrix-free generated-operator SpMV: indices computed, never streamed.

For a ``core.formats.MatrixFreeOperator``, ``col = row + offset`` on every
diagonal; a generated diagonal holds one constant under the periodic rule
``lo <= row % p < hi`` and streams nothing, a stored diagonal streams one
dense lane.  Accumulation runs in ascending offset order, as in the
reference.

``mf_spmv_arrays`` launches ``csrc/mf_spmv.cu`` on a CUDA tensor and runs
``mf_spmv_plain`` on a CPU tensor.  The kernel takes the operator's
descriptor only as an ``MfLaunch``: packed and checked on the host once per
operator (32-bit rows and columns, at most ``MAX_DIAGS`` diagonals, the
divisor magic of every period, no quantized storage), copied to a card
once.  It reads the stored lanes as ``mf_lanes`` leaves them on the card:
1-byte codes into a table of values (``MfCodes``) where the lanes hold at
most ``MAX_CODES`` distinct nonzero bit patterns, else the lanes as they
are; both give the same bits, and ``lane_code_counts()`` says which ran.
The kernel reads x unpadded and masks columns outside the matrix in
registers; the plain version and the ``torch`` and ``loop_reference``
entries read a zero-padded x, as the reference does.  Registry entries:
``(matrix_free, {spmv, spmm}, {torch, loop_reference, cuda})``; the
``cuda`` SpMM goes column by column over the SpMV kernel, as the
reference's Pallas SpMM does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.formats import VALUE_DTYPES, MatrixFreeOperator, _cast
from ..utils.spans import span
from . import cuda_build as CB
from .accum import acc_dtype
from .cache import cached, register_stat, spmm_by_columns
from .dia_spmv import pad_x
from .registry import CompiledKernel, KernelContext, register_kernel

NAME = "mf_spmv"
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p]

#: diagonals one launch takes (``kMaxDiags`` in csrc/mf_spmv.cu), the
#: default cap of ``MatrixFreeOperator.from_csr``
MAX_DIAGS = 256
#: storage dtypes the kernel takes: int8 and fp8 have no per-group scale
#: home in a matrix-free operator
KERNEL_VALUE_DTYPES = ("f64", "f32", "bf16", "f16")
#: one diagonal of the kernel's descriptor (``struct MfDiag`` in
#: csrc/mf_spmv.cu, 40 bytes)
MF_DIAG = np.dtype([("off", "<i4"), ("lane", "<i4"), ("p", "<u4"), ("lo", "<u4"),
                    ("hi", "<u4"), ("magic", "<u4"), ("shift", "<u4"),
                    ("unused", "<u4"), ("gen", "<f8")])
_LIMIT = 1 << 31  # rows, columns and offsets are 32-bit on the card
#: distinct nonzero bit patterns coded lanes may hold: code 0 is +0.0
#: (``kMaxValues`` - 1 in csrc/mf_spmv.cu)
MAX_CODES = 255
#: threads a CTA (``kBlock`` in csrc/common.cuh) and rows a thread on coded
#: lanes (``kCodeRows`` in csrc/mf_spmv.cu): the codes' tile is their product
BLOCK, CODE_ROWS = 256, 4
#: the integer of each storage dtype's width, whose values are its bits
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
         torch.bfloat16: torch.int16, torch.float16: torch.int16}

register_stat("mf_tables")
register_stat("mf_launch")
register_stat("mf_lanes")
#: a kernel-4 launch over stored lanes counts under the entry point and
#: under the form it read them in
_PATHS = {True: ("mf_spmv", "mf_spmv_coded"), False: ("mf_spmv", "mf_spmv_streamed")}


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


def divisor_magic(p: int) -> tuple[int, int]:
    """``(magic, shift)`` with ``row // p == (2 * row * magic >> 32) >>
    shift`` for every ``0 <= row < 2^31``, magic below 2^32: the kernel's
    phase ``row % p`` in one 32-bit multiply-high.  With ``l = ceil(log2
    p)`` and ``magic = ceil(2^(31 + l) / p)``, ``magic * p - 2^(31 + l) < p
    <= 2^l`` bounds the error of ``row * magic / 2^(31 + l)`` against ``row
    / p`` below ``1 / p`` (Granlund and Montgomery's round-up method for
    31-bit dividends)."""
    if not 1 <= p < _LIMIT:
        raise ValueError(f"mf_spmv: period {p} outside [1, 2^31)")
    shift = (p - 1).bit_length()
    return -(-(1 << (31 + shift)) // p), shift


def mf_phase(rows: np.ndarray, p: int, magic: int, shift: int) -> np.ndarray:
    """``rows % p`` as the kernel computes it from ``divisor_magic(p)``
    (uint32 arithmetic, rows below 2^31)."""
    r = np.asarray(rows, np.uint64)
    q = (((r << np.uint64(1)) * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift)
    return (r - q * np.uint64(p)).astype(np.uint32)


class MfLaunch:
    """The kernel's descriptor of one operator: a ``MF_DIAG`` row per
    diagonal in ascending offset order (offset, stored-lane index or -1,
    period, bounds, divisor magic, generated constant rounded through the
    storage dtype), built from ``mf_tables`` and checked on the host once:
    rows, columns and offsets 32-bit, at most ``MAX_DIAGS`` diagonals, a
    storage dtype the kernel takes.  ``on(device)`` copies the table to a
    card once; the kernel stages it into shared memory once per CTA.
    ``mf_spmv_arrays`` takes the descriptor in no other form, and checks at
    each call only that its lanes and x have the operator's shapes."""

    def __init__(self, op: MatrixFreeOperator):
        if not isinstance(op, MatrixFreeOperator):
            raise TypeError(f"MfLaunch: expected a MatrixFreeOperator, got "
                            f"{type(op).__name__}")
        if op.value_dtype not in KERNEL_VALUE_DTYPES:
            raise TypeError(f"mf_spmv: storage {op.value_dtype!r} has no kernel "
                            f"(quantized storage has no scale home); takes "
                            f"{KERNEL_VALUE_DTYPES}")
        n, ncols = op.shape
        if not (0 <= n < _LIMIT and 0 <= ncols < _LIMIT):
            raise ValueError(f"mf_spmv: shape {op.shape}: rows and columns must "
                             "be below 2^31")
        diags = mf_tables(op)
        if len(diags) > MAX_DIAGS:
            raise ValueError(f"mf_spmv: {len(diags)} diagonals > MAX_DIAGS={MAX_DIAGS}")
        offs = [off for off, _ in diags]
        if offs != sorted(set(offs)) or (offs and not -_LIMIT < offs[0] <= offs[-1] < _LIMIT):
            raise ValueError("mf_spmv: offsets must ascend and fit 32 bits")
        table = np.zeros(len(diags), MF_DIAG)
        ks = 0
        for k, (off, spec) in enumerate(diags):
            if spec is None:
                table[k] = (off, ks, 0, 0, 0, 0, 0, 0, 0.0)
                ks += 1
                continue
            p, lo, hi, gvr = spec
            magic, shift = divisor_magic(p) if p else (0, 0)
            if p and not 0 <= lo <= hi <= p:
                raise ValueError(f"mf_spmv: rule {lo} <= row % {p} < {hi} out of range")
            table[k] = (off, -1, p, lo, hi, magic, shift, 0, gvr)
        if ks != op.n_stored:
            raise ValueError(f"mf_spmv: {ks} stored diagonals, the operator has "
                             f"{op.n_stored}")
        self.shape = (n, ncols)
        self.n_stored = ks
        self.storage = VALUE_DTYPES[op.value_dtype]
        self.pads = mf_pads(op)
        self.table = table
        self.desc, self.gen = mf_pack_descriptor(diags)  # the plain version's form
        self._on: dict = {}

    @property
    def n_diags(self) -> int:
        return self.table.shape[0]

    def on(self, device) -> torch.Tensor:
        """The table's bytes (uint8) on ``device``, copied there once."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = torch.from_numpy(self.table.view(np.uint8)).to(device)
        return self._on[key]

    def check(self, lanes, x: torch.Tensor) -> None:
        """Raise unless ``lanes`` holds this operator's lanes (as values, or
        as the ``MfCodes`` made for this descriptor) and ``x`` has its
        columns."""
        self.check_lanes(lanes)
        if tuple(x.shape) != (self.shape[1],):
            raise ValueError(f"mf_spmv: x has shape {tuple(x.shape)}, the descriptor's "
                             f"operator has {self.shape[1]} columns")

    def check_lanes(self, lanes) -> None:
        """Raise unless ``lanes`` is this operator's lanes, or codes made
        for this descriptor and tiled as the kernel reads them."""
        n = self.shape[0]
        if isinstance(lanes, MfCodes):
            if lanes.launch is not self:
                raise ValueError("mf_spmv: codes made for another operator's descriptor")
            if lanes.rows != CODE_ROWS:
                raise ValueError(f"mf_spmv: codes tiled for {lanes.rows} rows a thread, the "
                                 f"kernel reads {CODE_ROWS}")
        elif lanes.dim() != 2 or lanes.shape[0] != self.n_stored or lanes.shape[1] < n \
                or lanes.dtype != self.storage:
            raise ValueError(f"mf_spmv: lanes {tuple(lanes.shape)} {lanes.dtype} are not "
                             f"this descriptor's ({self.n_stored}, {n}) {self.storage}")


def mf_launch(op: MatrixFreeOperator) -> MfLaunch:
    """The operator's ``MfLaunch``, built once per container."""
    return cached(op, "_mf_launch", "mf_launch", lambda: MfLaunch(op))


def tile_codes(codes: torch.Tensor, rows: int = CODE_ROWS) -> torch.Tensor:
    """(n_stored, n) codes laid out by the coded kernel's tiles of ``BLOCK *
    rows`` rows, zero padded to whole tiles: in a tile the byte of row
    ``t + r * BLOCK`` is ``t * rows + r``, so thread t's codes of a lane are
    one ``rows``-byte word and a warp's words lie back to back."""
    s, n = codes.shape
    tile = BLOCK * rows
    nt = -(-n // tile)
    out = torch.zeros((s, nt * tile), dtype=torch.uint8, device=codes.device)
    out[:, :n] = codes
    return out.view(s, nt, rows, BLOCK).transpose(2, 3).reshape(s, nt * tile)


def untile_codes(tiled: torch.Tensor, rows: int = CODE_ROWS) -> torch.Tensor:
    """``tile_codes``'s inverse, padding kept: (n_stored, whole tiles)."""
    s, ld = tiled.shape
    return tiled.view(s, ld // (BLOCK * rows), BLOCK, rows).transpose(2, 3).reshape(s, ld)


class MfCodes:
    """Stored lanes as the coded kernel reads them (``mf_encode``): a table
    ``values`` of the lanes' distinct bit patterns in the storage dtype,
    +0.0 first, at most ``MAX_CODES + 1`` entries, and ``codes`` (uint8,
    ``(n_stored, ld)``), the index into it of each row of each lane, laid
    out by ``tile_codes``.  Made for one ``MfLaunch``: its ``check`` takes
    no other's."""

    def __init__(self, launch: MfLaunch, codes: torch.Tensor, values: torch.Tensor,
                 rows: int = CODE_ROWS):
        self.launch, self.codes, self.values, self.rows = launch, codes, values, rows

    def lanes(self) -> torch.Tensor:
        """The (n_stored, n) lanes the codes stand for, bit for bit."""
        idx = untile_codes(self.codes, self.rows)[:, :self.launch.shape[0]]
        return self.values[idx.long()]


def mf_encode(data: torch.Tensor, launch: MfLaunch, rows: int = CODE_ROWS):
    """``data``'s stored lanes as ``MfCodes`` on their device, or None where
    there is no lane or the lanes hold more than ``MAX_CODES`` distinct
    nonzero bit patterns.  Bits are compared, not values: -0.0, each NaN
    payload and each narrow storage value keep a code of their own."""
    launch.check_lanes(data)
    if launch.n_stored == 0:
        return None
    bits = data[:, :launch.shape[0]].view(_BITS[data.dtype])
    patterns, inverse = torch.unique(bits, return_inverse=True)
    nonzero = patterns != 0
    if int(nonzero.sum()) > MAX_CODES:
        return None
    code_of = torch.cumsum(nonzero, 0) * nonzero   # +0.0 -> 0, the rest 1, 2, ... in order
    values = torch.cat([patterns.new_zeros(1), patterns[nonzero]]).view(data.dtype)
    return MfCodes(launch, tile_codes(code_of[inverse].to(torch.uint8), rows), values, rows)


def mf_lanes(op: MatrixFreeOperator, device):
    """The operator's stored lanes as kernel 4 reads them on ``device``,
    built once per container and device: copied there, then coded there
    (``mf_encode``), so that where codes engage only the codes and the
    value table stay on the device; else the lanes themselves."""
    on = cached(op, "_mf_lanes", "mf_lanes", dict)
    key = str(torch.device(device))
    if key not in on:
        data = mf_data(op).to(device)
        on[key] = mf_encode(data, mf_launch(op)) or data
    return on[key]


def lane_code_counts() -> dict:
    """Kernel-4 launches over stored lanes since the launch counters were
    last reset, by the form the lanes were read in: ``{"coded": ...,
    "streamed": ...}`` (``cuda_build.launch_counts()``, where a replayed
    CUDA graph adds the launches its capture counted)."""
    c = CB.launch_counts()
    return {"coded": c["mf_spmv_coded"], "streamed": c["mf_spmv_streamed"]}


def mf_spmv_arrays(lanes, launch: MfLaunch, x):
    """Matrix-free SpMV of the operator ``launch`` describes, whose stored
    lanes are ``lanes``: the lanes (``mf_data``) or their ``MfCodes``.  The
    CUDA kernel for a CUDA ``x`` (unpadded, cast only when its dtype is not
    the accumulator's), the plain version on the zero-padded x for a CPU
    one."""
    if not isinstance(launch, MfLaunch):
        raise TypeError(f"mf_spmv: the descriptor must be an MfLaunch (mf_launch(op)), "
                        f"got {type(launch).__name__}")
    launch.check(lanes, x)
    coded = isinstance(lanes, MfCodes)
    acc = acc_dtype(launch.storage, x.dtype)
    if x.device.type == "cpu":
        pad0, pad1 = launch.pads
        return mf_spmv_plain(lanes.lanes() if coded else lanes, launch.desc, launch.gen,
                             pad_x(x, pad0, pad1, acc), pad0, launch.shape[0])
    if x.device.type != "cuda":
        raise ValueError(f"mf_spmv: no kernel for device {x.device}")
    dev = x.device
    with span("kernel.check"):
        held = (lanes.codes, lanes.values) if coded else (lanes,)
        if any(t.device != dev or not t.is_contiguous() for t in held):
            raise ValueError(f"mf_spmv: lanes on {held[0].device} (contiguous: "
                             f"{all(t.is_contiguous() for t in held)}), x on {dev}")
        if x.dtype != acc:
            x = x.to(acc)
        if not x.is_contiguous():
            x = x.contiguous()
    if coded:
        form = (CB.value_code(lanes.values, "values"), None, lanes.codes.shape[1],
                CB.ptr(lanes.codes), CB.ptr(lanes.values), lanes.values.numel())
    else:
        form = (CB.value_code(lanes, "data"), CB.ptr(lanes), lanes.shape[1], None, None, 0)
    vcode, data, ld, codes, values, nv = form
    n, ncols = launch.shape
    y = torch.empty(n, dtype=acc, device=dev)
    CB.launch(NAME, _ARGTYPES, dev, vcode, int(acc == torch.float64), data, ld, codes, values,
              nv, CB.ptr(launch.on(dev)), launch.n_diags, CB.ptr(x), ncols, CB.ptr(y), n,
              counts=_PATHS[coded] if launch.n_stored else None)
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


def _plain_executor(op: MatrixFreeOperator, ctx: KernelContext):
    """x -> the plain version on the zero-padded x (the descriptor stays on
    the host: no device-to-host copy per call)."""
    desc, gen = mf_pack_descriptor(mf_tables(op))
    data = mf_data(op).to(ctx.device)
    pad0, pad1 = mf_pads(op)
    n = op.shape[0]

    def fn(x):
        acc = acc_dtype(data.dtype, x.dtype)
        return mf_spmv_plain(data, desc, gen, pad_x(x, pad0, pad1, acc), pad0, n)

    return fn


def _cuda_executor(op: MatrixFreeOperator, ctx: KernelContext):
    """x -> the kernel: lanes (``mf_lanes``) and descriptor on the card
    from plan compile on, x passed as it is."""
    launch = mf_launch(op)
    lanes = mf_lanes(op, ctx.device)
    launch.on(ctx.device)
    return lambda x: mf_spmv_arrays(lanes, launch, x)


@register_kernel("matrix_free", "spmv", "torch",
                 description="generated diagonals: shifted slices + masks")
def _build_spmv(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(_plain_executor(op, ctx), "torch")


@register_kernel("matrix_free", "spmm", "torch",
                 description="multi-vector shifted slices + masks")
def _build_spmm(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(_plain_executor(op, ctx), "torch")


@register_kernel("matrix_free", "spmv", "loop_reference",
                 description="per-diagonal clipped-segment oracle, host masks")
def _build_spmv_loop(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(mf_spmv_loop(op, ctx), "loop")


@register_kernel("matrix_free", "spmm", "loop_reference",
                 description="column-by-column per-diagonal oracles")
def _build_spmm_loop(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(spmm_by_columns(mf_spmv_loop(op, ctx)), "loop")


@register_kernel("matrix_free", "spmv", "cuda",
                 description="rows a thread; cols = row + offset in registers, x unpadded")
def _build_spmv_cuda(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(_cuda_executor(op, ctx), "cuda")


@register_kernel("matrix_free", "spmm", "cuda",
                 description="column by column over the SpMV kernel")
def _build_spmm_cuda(op: MatrixFreeOperator, ctx) -> CompiledKernel:
    return CompiledKernel(spmm_by_columns(_cuda_executor(op, ctx)), "cuda")
