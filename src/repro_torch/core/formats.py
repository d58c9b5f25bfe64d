"""Sparse storage formats of the paper, as containers of PyTorch tensors.

Port of ``repro.core.formats``: COO, CSR (the paper's CRS), ELL, JDS (the
paper's jagged diagonals), SELL-C-sigma (blocked JDS), BSR (block CSR with
dense (bm, bn) blocks), DIA, the hybrid DIA + SELL split, the
matrix-free generated operator, the electron x phonon operator generated
from the Holstein-Hubbard model's tables, and ``matrix_stats`` (the pattern
statistics the performance model reads).

Containers are frozen dataclasses whose array fields are CPU tensors; the
packing itself is host preprocessing in numpy, exactly as in the paper, and
produces the same arrays as the reference packers.  A plan moves the arrays
it needs to the device once, when it is compiled.

Value storage precision is orthogonal to the format: f64, f32, bf16, f16,
fp8 (e4m3) and int8.  bf16 and fp8 have no numpy dtype, so host code works
on their f32 upcast (exact) and casts back with PyTorch; numpy's own dtypes
are cast by numpy, which rounds f64 -> f16 directly where PyTorch does not.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

#: default SELL-C-sigma sorting window (the reference's DEFAULT_SELL_SIGMA)
DEFAULT_SELL_SIGMA = 256

#: canonical name -> torch dtype of every supported value-storage precision
VALUE_DTYPES = {
    "f64": torch.float64,
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "f16": torch.float16,
    "fp8_e4m3": torch.float8_e4m3fn,
    "int8": torch.int8,
}

#: storage dtypes with a numpy counterpart (host code casts these in numpy)
_NUMPY_DTYPES = {"f64": np.float64, "f32": np.float32, "f16": np.float16,
                 "int8": np.int8}

#: dtypes stored with a per-group fp32 scale (symmetric quantization)
_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}
QUANTIZED_DTYPES = tuple(_QMAX)


# ---------------------------------------------------------------------------
# tensor <-> numpy helpers
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    """Host numpy view of a tensor; bf16/fp8 come back as their exact f32
    upcast (numpy has no such dtype)."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(t)


def _t(a, dtype: torch.dtype | None = None) -> torch.Tensor:
    """CPU tensor from a numpy array, cast to ``dtype`` when given."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _cast(a: np.ndarray, name: str) -> torch.Tensor:
    """Round a numpy array into storage dtype ``name`` (numpy rounds its own
    dtypes, PyTorch rounds bf16/fp8: both match the reference's casts)."""
    if name in _NUMPY_DTYPES:
        return _t(np.asarray(a).astype(_NUMPY_DTYPES[name]))
    return _t(np.asarray(a)).to(VALUE_DTYPES[name])


def value_dtype_name(dtype: torch.dtype) -> str:
    """Canonical name ("f32", "int8", ...) of a torch dtype."""
    for name, d in VALUE_DTYPES.items():
        if dtype == d:
            return name
    return str(dtype).replace("torch.", "")


def sigma_sort_order(lens, sigma: int) -> np.ndarray:
    """The SELL-C-sigma row permutation: a stable descending-length argsort
    within consecutive windows of ``sigma`` rows (``sigma = 1`` is the
    identity, ``sigma >= len(lens)`` the full JDS sort)."""
    lens = np.asarray(lens, dtype=np.int64)
    n = int(lens.shape[0])
    sigma = max(1, int(sigma))
    order = np.arange(n, dtype=np.int32)
    if sigma == 1:
        return order
    for s in range(0, n, sigma):
        e = min(s + sigma, n)
        order[s:e] = np.argsort(-lens[s:e], kind="stable").astype(np.int32) + s
    return order


def pack_chunks_flat(rows, C: int, order=None, rid_fill: int | None = None,
                     val_dtype=None):
    """Flat SELL-C pack of ragged rows into chunk-column-major slabs.

    ``rows`` is a list of ``(col_idx, val)`` numpy pairs; ``order`` a row
    permutation (default identity).  All-empty chunks are skipped.  Returns
    flat numpy ``(col, val, rid)`` where ``rid`` is each element's
    pre-permutation row and padding carries ``rid_fill`` (default
    ``len(rows)``).
    """
    n = len(rows)
    if order is None:
        order = np.arange(n, dtype=np.int32)
    if rid_fill is None:
        rid_fill = n
    if val_dtype is None:
        val_dtype = rows[0][1].dtype if n else np.float32
    k = np.array([len(c) for c, _ in rows], dtype=np.int64)
    fc, fv, fr = [], [], []
    for c0 in range(0, n, C):
        chunk = order[c0:c0 + C]
        w = int(k[chunk].max()) if len(chunk) else 0
        if w == 0:
            continue
        ccol = np.zeros((w, C), dtype=np.int32)
        cval = np.zeros((w, C), dtype=val_dtype)
        crid = np.full((w, C), rid_fill, dtype=np.int32)
        for j, i in enumerate(chunk):
            c, vv = rows[i]
            ccol[: len(c), j] = c
            cval[: len(c), j] = vv
            crid[: len(c), j] = i
        fc.append(ccol.ravel())
        fv.append(cval.ravel())
        fr.append(crid.ravel())
    return (np.concatenate(fc) if fc else np.zeros(0, np.int32),
            np.concatenate(fv) if fv else np.zeros(0, val_dtype),
            np.concatenate(fr) if fr else np.zeros(0, np.int32))


# ---------------------------------------------------------------------------
# value dtypes
# ---------------------------------------------------------------------------


def container_values(obj) -> torch.Tensor:
    """The stored value tensor of any container (val / vals / blocks / data)."""
    if isinstance(obj, MatrixFreeOperator):
        if obj.data is None:
            raise TypeError("MatrixFreeOperator with fully generated values "
                            "stores no value array")
        return obj.data
    for attr in ("val", "vals", "blocks", "data"):
        if hasattr(obj, attr):
            return getattr(obj, attr)
    raise TypeError(f"{type(obj).__name__} has no value array")


def container_value_dtype(obj) -> str:
    """Canonical value-dtype name of a container (hybrid: the SELL part)."""
    if isinstance(obj, HybridDIA):
        obj = obj.rest
    if isinstance(obj, MatrixFreeOperator):
        return obj.value_dtype
    return value_dtype_name(container_values(obj).dtype)


def _group_scales(amax: np.ndarray, value_dtype: str) -> np.ndarray:
    """fp32 scale per group; all-zero groups get 1.0 (exact zero round trip)."""
    qmax = _QMAX[value_dtype]
    return np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)


def _quantize(qv: np.ndarray, value_dtype: str) -> torch.Tensor:
    if value_dtype == "int8":
        return _t(np.clip(np.rint(qv), -127, 127).astype(np.int8))
    return _cast(qv, value_dtype)


def _quantize_flat(v: np.ndarray, group_ids: np.ndarray, n_groups: int,
                   value_dtype: str):
    """Symmetric per-group quantization of a flat value array."""
    amax = np.zeros(n_groups, np.float64)
    if v.size:
        np.maximum.at(amax, group_ids, np.abs(v.astype(np.float64)))
    scale = _group_scales(amax, value_dtype)
    qv = v.astype(np.float64) / scale[group_ids] if v.size else v.astype(np.float64)
    return _quantize(qv, value_dtype), _t(scale)


def _quantize_axis0(v: np.ndarray, value_dtype: str):
    """Per-leading-axis-group quantization (ELL rows, BSR blocks, DIA
    diagonals)."""
    n = v.shape[0]
    flat = np.abs(v.astype(np.float64)).reshape(n, -1)
    amax = flat.max(axis=1) if flat.size else np.zeros(n)
    scale = _group_scales(amax, value_dtype)
    qv = v.astype(np.float64) / scale.reshape((n,) + (1,) * (v.ndim - 1))
    return _quantize(qv, value_dtype), _t(scale)


def _flat_group_ids(obj) -> tuple[np.ndarray, int]:
    """(group id per stored element, n_groups) for flat-value containers."""
    if isinstance(obj, CSR):
        return np.repeat(np.arange(obj.n_rows), obj.row_lengths()), obj.n_rows
    if isinstance(obj, COO):
        return _np(obj.rows).astype(np.int64), obj.shape[0]
    if isinstance(obj, JDS):
        # group = *permuted* row: jagged diagonal d holds rows 0..n_active-1
        segs = [np.arange(L) for L in obj.diag_lengths()]
        ids = np.concatenate(segs) if segs else np.zeros(0, np.int64)
        return ids, obj.shape[0]
    if isinstance(obj, SELL):
        cp = _np(obj.chunk_ptr)
        return np.repeat(np.arange(obj.n_chunks), np.diff(cp)), obj.n_chunks
    raise TypeError(f"no flat grouping for {type(obj).__name__}")


def dequantize(obj):
    """Undo ``with_value_dtype``: an f32-valued (f64 stays f64), scale-free
    copy of ``obj``; int8/fp8 fold their per-group scale back in."""
    if isinstance(obj, HybridDIA):
        return HybridDIA(dequantize(obj.dia), dequantize(obj.rest), obj.shape)
    v = container_values(obj)
    if getattr(obj, "scale", None) is None:
        vf = v if v.dtype == torch.float64 else v.to(torch.float32)
        return _replace_values(obj, vf, None)
    vn = _np(v).astype(np.float32)
    scale = _np(obj.scale)
    if isinstance(obj, (ELL, BSR, DIA)):
        vf = vn * scale.reshape((vn.shape[0],) + (1,) * (vn.ndim - 1))
    else:
        ids, _ = _flat_group_ids(obj)
        vf = vn * scale[ids]
    return _replace_values(obj, _t(vf), None)


def _replace_values(obj, new_values, new_scale):
    """Same container, new value tensor (+ scale); everything else kept."""
    if isinstance(obj, COO):
        return COO(obj.rows, obj.cols, new_values, obj.shape, new_scale)
    if isinstance(obj, CSR):
        return CSR(obj.row_ptr, obj.col_idx, new_values, obj.shape, new_scale)
    if isinstance(obj, ELL):
        return ELL(obj.col_idx, new_values, obj.shape, obj.nnz, new_scale)
    if isinstance(obj, JDS):
        return JDS(obj.jd_ptr, obj.col_idx, new_values, obj.perm, obj.shape, new_scale)
    if isinstance(obj, SELL):
        return SELL(obj.chunk_ptr, obj.chunk_width, obj.col_idx, new_values,
                    obj.perm, obj.shape, obj.C, obj.sigma, obj.nnz, new_scale)
    if isinstance(obj, BSR):
        return BSR(obj.block_row_ptr, obj.block_col_idx, new_values, obj.shape,
                   obj.block_shape, new_scale)
    if isinstance(obj, DIA):
        return DIA(obj.offsets, new_values, obj.shape, new_scale)
    raise TypeError(f"cannot replace values on {type(obj).__name__}")


def _require_unquantized(obj, where: str):
    if getattr(obj, "scale", None) is not None:
        raise TypeError(
            f"{where}: source is quantized (scale is set) and its scale "
            "groups would not survive the conversion -- dequantize() first, "
            "or use convert(m, fmt, value_dtype=...)")


def _require_materialized(obj, where: str):
    if isinstance(obj, MatrixFreeOperator):
        raise TypeError(
            f"{where}: source is a MatrixFreeOperator (a pattern descriptor, "
            "not index arrays) -- call materialize(op) to get a CSR first")


def with_value_dtype(obj, value_dtype: str):
    """A copy of ``obj`` storing its values in ``value_dtype``.

    f64/f32/bf16/f16 are plain casts (``scale`` stays None).  int8 and
    fp8_e4m3 store symmetrically quantized values plus an fp32 ``scale``
    per group: row for CSR/COO/ELL, permuted row for JDS, chunk for SELL,
    block for BSR, diagonal for DIA.
    """
    if value_dtype not in VALUE_DTYPES:
        raise ValueError(f"value_dtype={value_dtype!r}; expected one of "
                         f"{tuple(VALUE_DTYPES)}")
    if isinstance(obj, HybridDIA):
        return HybridDIA(with_value_dtype(obj.dia, value_dtype),
                         with_value_dtype(obj.rest, value_dtype), obj.shape)
    if isinstance(obj, MatrixFreeOperator):
        if value_dtype in _QMAX:
            raise TypeError(
                "with_value_dtype: MatrixFreeOperator stores generated values "
                f"as exact scalars; quantized storage ({value_dtype!r}) has no "
                "per-group scale home -- materialize() first")
        data = None if obj.data is None else _recast(obj.data, value_dtype)
        return dataclasses.replace(obj, data=data, value_dtype=value_dtype)
    if obj.scale is not None:
        obj = dequantize(obj)
    v = container_values(obj)
    if value_dtype not in _QMAX:
        return _replace_values(obj, _recast(v, value_dtype), None)
    vn = _np(v)
    if isinstance(obj, (ELL, BSR, DIA)):
        q, scale = _quantize_axis0(vn, value_dtype)
    else:
        ids, n_groups = _flat_group_ids(obj)
        q, scale = _quantize_flat(vn, ids, n_groups, value_dtype)
    return _replace_values(obj, q, scale)


def _recast(v: torch.Tensor, value_dtype: str) -> torch.Tensor:
    """Plain storage cast of a value tensor (rounded as the reference does)."""
    if value_dtype in _NUMPY_DTYPES and v.dtype in (
            torch.float64, torch.float32, torch.float16):
        return _cast(_np(v), value_dtype)
    return v.to(VALUE_DTYPES[value_dtype])


# ---------------------------------------------------------------------------
# COO / CSR (paper's CRS)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class COO:
    """Coordinate format - the interchange format."""

    rows: torch.Tensor  # (nnz,) int32
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,)
    shape: tuple[int, int]
    scale: torch.Tensor = None  # (n_rows,) fp32 per-row scale for int8/fp8

    def __post_init__(self):
        for f in ("rows", "cols", "vals", "scale"):
            object.__setattr__(self, f, _t(getattr(self, f)))

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    def sorted_by_row(self) -> "COO":
        r, c = _np(self.rows), _np(self.cols)
        order = torch.from_numpy(np.lexsort((c, r)))
        return COO(self.rows[order], self.cols[order], self.vals[order], self.shape)

    def to_dense(self) -> np.ndarray:
        v = _np(self.vals)
        d = np.zeros(self.shape, dtype=v.dtype)
        np.add.at(d, (_np(self.rows), _np(self.cols)), v)
        return d


@dataclass(frozen=True)
class CSR:
    """Compressed row storage -- the paper's CRS (row_ptr, col_idx, val)."""

    row_ptr: torch.Tensor  # (n_rows+1,) int32
    col_idx: torch.Tensor  # (nnz,) int32
    val: torch.Tensor      # (nnz,)
    shape: tuple[int, int]
    scale: torch.Tensor = None  # (n_rows,) fp32 per-row scale for int8/fp8

    def __post_init__(self):
        for f in ("row_ptr", "col_idx", "val", "scale"):
            object.__setattr__(self, f, _t(getattr(self, f)))

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    def row_lengths(self) -> np.ndarray:
        rp = _np(self.row_ptr)
        return rp[1:] - rp[:-1]

    @staticmethod
    def from_coo(m: COO) -> "CSR":
        m = m.sorted_by_row()
        n_rows = m.shape[0]
        counts = np.bincount(_np(m.rows), minlength=n_rows)
        row_ptr = np.zeros(n_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=row_ptr[1:])
        return CSR(row_ptr, m.cols.to(torch.int32), m.vals, m.shape)

    @staticmethod
    def from_dense(d, tol: float = 0.0) -> "CSR":
        """Every entry of the dense array ``d`` with ``|v| > tol``."""
        d = _np(d)
        rows, cols = np.nonzero(np.abs(d) > tol)
        return CSR.from_coo(COO(rows.astype(np.int32), cols.astype(np.int32),
                                d[rows, cols], d.shape))

    def to_coo(self) -> COO:
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int32), self.row_lengths())
        return COO(rows, self.col_idx, self.val, self.shape)

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()


# ---------------------------------------------------------------------------
# ELL and JDS
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ELL:
    """ELLPACK: every row padded to the longest row's length; padding
    entries have val = 0 and col = 0."""

    col_idx: torch.Tensor  # (n_rows, width) int32
    val: torch.Tensor      # (n_rows, width)
    shape: tuple[int, int]
    nnz: int
    scale: torch.Tensor = None  # (n_rows,) fp32 per-row scale for int8/fp8

    def __post_init__(self):
        for f in ("col_idx", "val", "scale"):
            object.__setattr__(self, f, _t(getattr(self, f)))

    @property
    def width(self) -> int:
        return int(self.val.shape[1])

    @staticmethod
    def from_csr(m: CSR, width: int | None = None, pad_to: int = 1) -> "ELL":
        _require_materialized(m, "ELL.from_csr")
        _require_unquantized(m, "ELL.from_csr")
        lens = m.row_lengths()
        w = int(lens.max()) if lens.size else 0
        if width is not None:
            w = max(w, width)
        w = max(1, -(-w // pad_to) * pad_to)
        n = m.n_rows
        rp, ci, v = _np(m.row_ptr), _np(m.col_idx), _np(m.val)
        col = np.zeros((n, w), dtype=np.int32)
        val = np.zeros((n, w), dtype=v.dtype)
        rows = np.repeat(np.arange(n), lens)
        offs = np.arange(len(ci)) - np.repeat(rp[:-1], lens)
        col[rows, offs] = ci
        val[rows, offs] = v
        return ELL(col, _t(val, m.val.dtype), m.shape, m.nnz)

    def to_dense(self) -> np.ndarray:
        v = _np(self.val)
        d = np.zeros(self.shape, dtype=v.dtype)
        n, w = v.shape
        np.add.at(d, (np.repeat(np.arange(n), w), _np(self.col_idx).ravel()), v.ravel())
        return d


@dataclass(frozen=True)
class JDS:
    """Jagged diagonals storage (paper Sec. 2): rows permuted by decreasing
    length; the j-th entries of all rows form jagged diagonal j, stored
    consecutively.  ``perm`` maps permuted -> original row."""

    jd_ptr: torch.Tensor   # (n_diags+1,) int32
    col_idx: torch.Tensor  # (nnz,) int32
    val: torch.Tensor      # (nnz,)
    perm: torch.Tensor     # (n_rows,) int32
    shape: tuple[int, int]
    scale: torch.Tensor = None  # (n_rows,) fp32 per-*permuted*-row scale

    def __post_init__(self):
        for f in ("jd_ptr", "col_idx", "val", "perm", "scale"):
            object.__setattr__(self, f, _t(getattr(self, f)))

    @property
    def n_diags(self) -> int:
        return int(self.jd_ptr.shape[0]) - 1

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def diag_lengths(self) -> np.ndarray:
        jp = _np(self.jd_ptr)
        return jp[1:] - jp[:-1]

    @staticmethod
    def from_csr(m: CSR) -> "JDS":
        _require_materialized(m, "JDS.from_csr")
        _require_unquantized(m, "JDS.from_csr")
        lens = m.row_lengths()
        perm = np.argsort(-lens, kind="stable").astype(np.int32)
        sorted_lens = lens[perm]
        n_diags = int(sorted_lens.max()) if sorted_lens.size else 0
        rp, ci, v = _np(m.row_ptr), _np(m.col_idx), _np(m.val)
        cols_out, vals_out, jd_ptr = [], [], [0]
        for d in range(n_diags):
            # rows (in permuted order) long enough to reach diagonal d
            n_active = int(np.searchsorted(-sorted_lens, -d, side="left"))
            idx = rp[perm[:n_active]] + d
            cols_out.append(ci[idx])
            vals_out.append(v[idx])
            jd_ptr.append(jd_ptr[-1] + n_active)
        col_idx = np.concatenate(cols_out) if cols_out else np.zeros(0, np.int32)
        val = np.concatenate(vals_out) if vals_out else np.zeros(0, v.dtype)
        return JDS(np.asarray(jd_ptr, np.int32), col_idx.astype(np.int32),
                   _t(val, m.val.dtype), perm, m.shape)

    def to_dense(self) -> np.ndarray:
        jp, ci, v, perm = map(_np, (self.jd_ptr, self.col_idx, self.val, self.perm))
        d = np.zeros(self.shape, dtype=v.dtype)
        for k in range(self.n_diags):
            seg = slice(jp[k], jp[k + 1])
            d[perm[: jp[k + 1] - jp[k]], ci[seg]] += v[seg]
        return d


# ---------------------------------------------------------------------------
# SELL-C-sigma
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SELL:
    """SELL-C-sigma: rows sorted by length within windows of sigma rows, cut
    into chunks of C rows, each chunk padded to its own width and stored
    column-major: chunk c is ``val[chunk_ptr[c]:chunk_ptr[c+1]]`` viewed as
    a ``(width_c, C)`` slab.  ``perm`` maps permuted -> original row (pad
    rows -> n_rows).
    """

    chunk_ptr: torch.Tensor    # (n_chunks+1,) int64
    chunk_width: torch.Tensor  # (n_chunks,) int32
    col_idx: torch.Tensor      # (total,) int32, padding -> 0
    val: torch.Tensor          # (total,), padding -> 0
    perm: torch.Tensor         # (n_rows_padded,) int32
    shape: tuple[int, int]
    C: int
    sigma: int
    nnz: int
    scale: torch.Tensor = None  # (n_chunks,) fp32 per-chunk scale for int8/fp8

    def __post_init__(self):
        for f in ("chunk_ptr", "chunk_width", "col_idx", "val", "perm", "scale"):
            object.__setattr__(self, f, _t(getattr(self, f)))

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_width.shape[0])

    @staticmethod
    def from_csr(m: CSR, C: int = 8, sigma: int | None = None,
                 sort_cols: bool = False, pad_width_to: int = 1) -> "SELL":
        """Pack ``m``; the same arrays as the reference's per-chunk loop,
        built with one vectorised scatter."""
        _require_materialized(m, "SELL.from_csr")
        _require_unquantized(m, "SELL.from_csr")
        n = m.n_rows
        sigma = max(1, min(n, DEFAULT_SELL_SIGMA)) if sigma is None else max(1, sigma)
        lens = m.row_lengths().astype(np.int64)
        n_pad = -(-n // C) * C
        perm = np.arange(n_pad, dtype=np.int32)
        perm[:n] = sigma_sort_order(lens, sigma)
        perm[n:] = n
        plens = np.zeros(n_pad, dtype=np.int64)
        plens[:n] = lens[perm[:n]]
        n_chunks = n_pad // C
        cw = plens.reshape(n_chunks, C).max(axis=1)
        cw = np.maximum(1, -(-cw // pad_width_to) * pad_width_to).astype(np.int32)
        chunk_ptr = np.zeros(n_chunks + 1, dtype=np.int64)
        np.cumsum(cw.astype(np.int64) * C, out=chunk_ptr[1:])
        total = int(chunk_ptr[-1])
        rp = _np(m.row_ptr).astype(np.int64)
        ci, v = _np(m.col_idx), _np(m.val)
        rows = np.repeat(np.arange(n, dtype=np.int64), lens)
        if sort_cols:  # per-row stable column sort (SOJDS)
            order = np.lexsort((ci, rows))
            ci, v = ci[order], v[order]
        slot = np.arange(rows.shape[0], dtype=np.int64) - rp[rows]
        pos = np.empty(n, dtype=np.int64)
        pos[perm[:n]] = np.arange(n)
        q = pos[rows]
        dest = chunk_ptr[q // C] + slot * C + q % C
        col_idx = np.zeros(total, dtype=np.int32)
        val = np.zeros(total, dtype=v.dtype)
        col_idx[dest] = ci
        val[dest] = v
        return SELL(chunk_ptr, cw, col_idx, _t(val, m.val.dtype), perm, m.shape,
                    C, int(sigma), m.nnz)


# ---------------------------------------------------------------------------
# BSR (block CSR with dense subblocks)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BSR:
    """Block CSR with dense ``(bm, bn)`` blocks: block row ``r`` holds
    blocks ``block_row_ptr[r]:block_row_ptr[r+1]``, block ``b`` covering
    columns ``block_col_idx[b] * bn`` onwards.  Index traffic amortizes
    over ``bm * bn`` stored entries -- the paper's "dense subblocks" remark
    made a format, the one for structured-sparse weights."""

    block_row_ptr: torch.Tensor  # (n_brows+1,) int32
    block_col_idx: torch.Tensor  # (n_blocks,) int32
    blocks: torch.Tensor         # (n_blocks, bm, bn)
    shape: tuple[int, int]
    block_shape: tuple[int, int]
    scale: torch.Tensor = None   # (n_blocks,) fp32 per-block scale for int8/fp8

    def __post_init__(self):
        for f in ("block_row_ptr", "block_col_idx", "blocks", "scale"):
            object.__setattr__(self, f, _t(getattr(self, f)))
        object.__setattr__(self, "block_shape", tuple(int(b) for b in self.block_shape))

    @property
    def n_blocks(self) -> int:
        return int(self.block_col_idx.shape[0])

    @property
    def nnz(self) -> int:  # stored (dense-block) entries
        bm, bn = self.block_shape
        return self.n_blocks * bm * bn

    @staticmethod
    def from_dense(d, block_shape: tuple[int, int] = (8, 128),
                   tol: float = 0.0) -> "BSR":
        """Every ``(bm, bn)`` tile of ``d`` with an entry ``|v| > tol``, in
        row-major tile order (the reference's packer)."""
        d = _np(d)
        bm, bn = block_shape
        M, N = d.shape
        assert M % bm == 0 and N % bn == 0, \
            f"dense {d.shape} not divisible by block {tuple(block_shape)}"
        nbr, nbc = M // bm, N // bn
        tiles = d.reshape(nbr, bm, nbc, bn).transpose(0, 2, 1, 3)
        keep = np.abs(tiles).max(axis=(2, 3)) > tol
        rows, cols = np.nonzero(keep)
        brp = np.zeros(nbr + 1, dtype=np.int32)
        np.cumsum(np.bincount(rows, minlength=nbr), out=brp[1:])
        return BSR(brp, cols.astype(np.int32), tiles[rows, cols], d.shape,
                   tuple(block_shape))

    @staticmethod
    def from_csr(m: CSR, block_shape: tuple[int, int] = (8, 128),
                 tol: float = 0.0) -> "BSR":
        """The arrays of ``BSR.from_dense(m.to_dense(), block_shape, tol)``,
        built from the entries alone (no dense matrix): duplicates are
        summed in entry order, as ``to_dense`` sums them, and a tile whose
        summed entries are all within ``tol`` of zero is dropped."""
        _require_materialized(m, "BSR.from_csr")
        _require_unquantized(m, "BSR.from_csr")
        bm, bn = block_shape
        M, N = m.shape
        if M % bm or N % bn:
            raise ValueError(f"matrix {tuple(m.shape)} not divisible by block "
                             f"{tuple(block_shape)}")
        nbr, nbc = M // bm, N // bn
        r = np.repeat(np.arange(M, dtype=np.int64), m.row_lengths())
        c = _np(m.col_idx).astype(np.int64)
        v = _np(m.val)
        key, inv = np.unique(r // bm * nbc + c // bn, return_inverse=True)
        tiles = np.zeros((key.shape[0], bm, bn), dtype=v.dtype)
        lin = r * N + c
        if lin.size < 2 or (np.diff(lin) > 0).all():   # no duplicate entries
            tiles[inv, r % bm, c % bn] = v
        else:
            np.add.at(tiles, (inv, r % bm, c % bn), v)
        keep = np.abs(tiles).max(axis=(1, 2)) > tol if key.size else \
            np.zeros(0, bool)
        key, tiles = key[keep], tiles[keep]
        brp = np.zeros(nbr + 1, dtype=np.int32)
        np.cumsum(np.bincount(key // nbc, minlength=nbr), out=brp[1:])
        return BSR(brp, (key % nbc).astype(np.int32), _t(tiles, m.val.dtype),
                   m.shape, tuple(block_shape))

    def to_dense(self) -> np.ndarray:
        bm, bn = self.block_shape
        M, N = self.shape
        blocks = _np(self.blocks)
        d = np.zeros((M // bm, N // bn, bm, bn), dtype=blocks.dtype)
        brp = _np(self.block_row_ptr)
        rows = np.repeat(np.arange(M // bm), np.diff(brp))
        np.add.at(d, (rows, _np(self.block_col_idx)), blocks)
        return d.transpose(0, 2, 1, 3).reshape(M, N)

    def density(self) -> float:
        """Stored blocks over all ``(bm, bn)`` tiles of the shape."""
        nbr = self.shape[0] // self.block_shape[0]
        nbc = self.shape[1] // self.block_shape[1]
        return self.n_blocks / max(1, nbr * nbc)


# ---------------------------------------------------------------------------
# DIA and the hybrid DIA + SELL split
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DIA:
    """Diagonal storage: ``data[k, i]`` is element (i, i + offsets[k])."""

    offsets: torch.Tensor  # (n_diags,) int32
    data: torch.Tensor     # (n_diags, n_rows); out-of-range entries are 0
    shape: tuple[int, int]
    scale: torch.Tensor = None  # (n_diags,) fp32 per-diagonal scale

    def __post_init__(self):
        for f in ("offsets", "data", "scale"):
            object.__setattr__(self, f, _t(getattr(self, f)))

    @property
    def nnz(self) -> int:
        return int((self.data != 0).sum())

    @staticmethod
    def from_csr(m: CSR, max_diags: int | None = None) -> "DIA":
        """Pure diagonal storage of every populated (sub)diagonal."""
        _require_materialized(m, "DIA.from_csr")
        _require_unquantized(m, "DIA.from_csr")
        coo = m.to_coo()
        rows = _np(coo.rows).astype(np.int64)
        offs = _np(coo.cols).astype(np.int64) - rows
        vals = _np(coo.vals)
        uniq = np.unique(offs)
        if max_diags is not None and len(uniq) > max_diags:
            raise ValueError(
                f"matrix has {len(uniq)} populated diagonals > max_diags="
                f"{max_diags}; use split_dia (hybrid) instead")
        data = np.zeros((len(uniq), m.shape[0]), dtype=vals.dtype)
        np.add.at(data, (np.searchsorted(uniq, offs), rows), vals)
        return DIA(uniq.astype(np.int32), _t(data, m.val.dtype), m.shape)


@dataclass(frozen=True)
class HybridDIA:
    """DIA part + SELL remainder."""

    dia: DIA
    rest: SELL
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.dia.nnz + self.rest.nnz


def split_dia(m: CSR, min_occupancy: float = 0.5, max_diags: int = 16,
              C: int = 8, sigma: int | None = None) -> HybridDIA:
    """Split well-occupied (sub)diagonals off into DIA, the rest into SELL.

    A diagonal is promoted when at least ``min_occupancy`` of its length is
    populated; at most ``max_diags`` are, the best-occupied first.
    """
    _require_materialized(m, "split_dia")
    _require_unquantized(m, "split_dia")
    n, ncols = m.shape
    coo = m.to_coo()
    rows, cols, vals = _np(coo.rows), _np(coo.cols), _np(coo.vals)
    offs = cols.astype(np.int64) - rows.astype(np.int64)
    uniq, counts = np.unique(offs, return_counts=True)
    occ = counts / np.maximum(1, np.minimum(n, ncols) - np.abs(uniq))
    cand = np.argsort(-occ)
    chosen = sorted({int(uniq[i]) for i in cand[:max_diags]
                     if occ[i] >= min_occupancy})
    offsets = np.asarray(chosen, dtype=np.int32)
    in_dia = np.isin(offs, offsets) if chosen else np.zeros(len(offs), bool)
    data = np.zeros((len(offsets), n), dtype=vals.dtype)
    sel = np.nonzero(in_dia)[0]
    np.add.at(data, (np.searchsorted(offsets, offs[sel]), rows[sel]), vals[sel])
    dia = DIA(offsets, _t(data, m.val.dtype), m.shape)
    rsel = torch.from_numpy(~in_dia)
    rest_csr = CSR.from_coo(COO(coo.rows[rsel], coo.cols[rsel], coo.vals[rsel],
                                m.shape))
    return HybridDIA(dia, SELL.from_csr(rest_csr, C=C, sigma=sigma), m.shape)


# ---------------------------------------------------------------------------
# matrix-free generated operators
# ---------------------------------------------------------------------------


def _divisors(n: int) -> list[int]:
    small = [d for d in range(1, int(n ** 0.5) + 1) if n % d == 0]
    return sorted({*small, *(n // d for d in small)})


def _periodic_rule(mask: np.ndarray) -> tuple[int, int, int] | None:
    """``(p, lo, hi)`` with ``mask[i] == (lo <= i % p < hi)`` for the minimal
    period ``p`` dividing ``len(mask)``, or None when no single contiguous
    run per period reproduces the mask."""
    n = int(mask.shape[0])
    if not mask.any():
        return None
    for p in _divisors(n):
        pat = mask[:p]
        if not np.array_equal(np.tile(pat, n // p), mask):
            continue
        idx = np.flatnonzero(pat)
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        return (p, lo, hi) if hi - lo == len(idx) else None
    return None


@dataclass(frozen=True)
class MatrixFreeOperator:
    """A structured operator stored as a pattern descriptor.

    Per diagonal ``k`` (ascending ``offsets``): ``col = row + offsets[k]``.
    ``gen_values[k]`` a float means every row with ``lo <= row % p < hi``
    holds that constant and nothing is streamed; None means the diagonal's
    values are the next row of ``data`` (a dense ``(n_rows,)`` lane).
    """

    data: torch.Tensor            # (n_stored, n_rows), or None when all generated
    shape: tuple[int, int]
    offsets: tuple[int, ...]
    periods: tuple[int, ...]
    los: tuple[int, ...]
    his: tuple[int, ...]
    gen_values: tuple
    nnz: int
    stored_nnz: int
    value_dtype: str

    def __post_init__(self):
        object.__setattr__(self, "data", _t(self.data))

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def n_stored(self) -> int:
        return sum(1 for g in self.gen_values if g is None)

    @property
    def n_generated(self) -> int:
        return self.n_diags - self.n_stored

    @staticmethod
    def from_csr(m: CSR, max_diags: int = 256) -> "MatrixFreeOperator":
        """Detect the generated-diagonal structure of ``m`` exactly: a
        diagonal is generated when its values are all equal, its rows are
        duplicate-free and its populated rows follow one periodic rule."""
        _require_unquantized(m, "MatrixFreeOperator.from_csr")
        n, _ = m.shape
        coo = m.to_coo()
        rows = _np(coo.rows).astype(np.int64)
        vals = _np(coo.vals)
        if rows.size == 0:
            raise ValueError("MatrixFreeOperator.from_csr: empty matrix")
        offs = _np(coo.cols).astype(np.int64) - rows
        uniq = np.unique(offs)
        if len(uniq) > max_diags:
            raise ValueError(
                f"matrix has {len(uniq)} populated diagonals > "
                f"max_diags={max_diags}; matrix-free storage does not apply")
        offsets, periods, los, his, gen_values, stored = [], [], [], [], [], []
        stored_nnz = 0
        for off in uniq.tolist():
            sel = offs == off
            r, v = rows[sel], vals[sel]
            rule = None
            if len(np.unique(r)) == len(r) and np.all(v == v[0]):
                mask = np.zeros(n, dtype=bool)
                mask[r] = True
                rule = _periodic_rule(mask)
            offsets.append(int(off))
            if rule is not None:
                p, lo, hi = rule
                periods.append(p)
                los.append(lo)
                his.append(hi)
                gen_values.append(float(v[0]))
            else:
                periods.append(1)
                los.append(0)
                his.append(1)
                gen_values.append(None)
                lane = np.zeros(n, dtype=vals.dtype)
                np.add.at(lane, r, v)
                stored.append(lane)
                stored_nnz += int((lane != 0).sum())
        data = _t(np.stack(stored), m.val.dtype) if stored else None
        return MatrixFreeOperator(
            data=data, shape=m.shape, offsets=tuple(offsets),
            periods=tuple(periods), los=tuple(los), his=tuple(his),
            gen_values=tuple(gen_values), nnz=m.nnz, stored_nnz=stored_nnz,
            value_dtype=value_dtype_name(m.val.dtype))

    def to_dense(self) -> np.ndarray:
        return materialize(self).to_dense()


def detect_matrix_free(m: CSR, max_diags: int = 256):
    """Cached ``MatrixFreeOperator.from_csr``; None when ``m`` has no
    affordable diagonal structure (or is quantized).  Never raises."""
    cache = getattr(m, "_mf_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(m, "_mf_cache", cache)
    if max_diags not in cache:
        try:
            cache[max_diags] = MatrixFreeOperator.from_csr(m, max_diags=max_diags)
        except (ValueError, TypeError):
            cache[max_diags] = None
    return cache[max_diags]


def materialize(op: MatrixFreeOperator) -> CSR:
    """Expand a ``MatrixFreeOperator`` back to explicit-index CSR
    (generated diagonals boundary-clipped, stored lanes without their
    padding zeros)."""
    if not isinstance(op, MatrixFreeOperator):
        raise TypeError(f"materialize expects a MatrixFreeOperator, "
                        f"got {type(op).__name__}")
    n, ncols = op.shape
    data = None if op.data is None else _np(op.data)
    rows_l, cols_l, vals_l = [], [], []
    k_stored = 0
    for k, off in enumerate(op.offsets):
        gv = op.gen_values[k]
        if gv is None:
            lane = data[k_stored]
            k_stored += 1
            r = np.flatnonzero(lane).astype(np.int64)
            v = lane[r].astype(np.float64)
        else:
            p, lo, hi = op.periods[k], op.los[k], op.his[k]
            i = np.arange(n, dtype=np.int64)
            r = i[(i % p >= lo) & (i % p < hi)]
            v = np.full(len(r), gv, dtype=np.float64)
        keep = (r + off >= 0) & (r + off < ncols)
        r = r[keep]
        rows_l.append(r.astype(np.int32))
        cols_l.append((r + off).astype(np.int32))
        vals_l.append(v[keep])
    vals = _cast(np.concatenate(vals_l), op.value_dtype)
    return CSR.from_coo(COO(np.concatenate(rows_l), np.concatenate(cols_l),
                            vals, op.shape))


@dataclass(frozen=True)
class ElectronPhononOperator:
    """The Holstein-Hubbard Hamiltonian as the tables of its model, not as
    stored entries: ``H = (T_el x I_ph) + diag + sum_i n_i(e) (b_i + b_i+)``
    on the basis (electron state e, phonon state p), row ``e * n_ph + p``
    (``core.matrices.holstein_hubbard_operator`` builds it).

    * ``hop_target`` / ``hop_value`` -- ``(n_el, H)``: each electron state's
      hops (both spins) as the target electron state and the signed ``-t``;
      -1 pads a state with fewer than H hops.
    * ``el_diag`` -- ``(n_el,)`` f64: ``U`` times the double occupancy.
    * ``el_occ`` -- ``(n_el, L)`` int32: the site occupations n_i(e) in
      {0, 1, 2}.
    * ``ph_occ`` -- ``(n_ph, L)`` int32: the phonon occupations.
    * ``ph_up`` / ``ph_dn`` -- ``(n_ph, L)`` int32: the rank of the phonon
      state with one phonon more / less at site i, -1 outside the basis (the
      per-site or the total cap).

    Values are f64, computed from these as the CSR builder computes them:
    ``U * docc + omega0 * sum(ph)`` on the diagonal, ``(g * omega0 * n_i) *
    sqrt(n + 1)`` (or ``sqrt(n)``) on the ladder.  ``nnz`` counts the
    nonzeros of the equivalent CSR (exact zeros left out)."""

    shape: tuple[int, int]
    hop_target: torch.Tensor
    hop_value: torch.Tensor
    el_diag: torch.Tensor
    el_occ: torch.Tensor
    ph_occ: torch.Tensor
    ph_up: torch.Tensor
    ph_dn: torch.Tensor
    g: float
    omega0: float
    nnz: int
    value_dtype: str = "f64"

    @property
    def n_el(self) -> int:
        return int(self.el_diag.shape[0])

    @property
    def n_ph(self) -> int:
        return int(self.ph_occ.shape[0])

    @property
    def n_sites(self) -> int:
        return int(self.ph_occ.shape[1])

    def table_bytes(self) -> int:
        """Bytes of every table the operator holds."""
        return sum(t.numel() * t.element_size() for t in (
            self.hop_target, self.hop_value, self.el_diag, self.el_occ, self.ph_occ,
            self.ph_up, self.ph_dn))


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def convert(m: CSR, fmt: str, value_dtype: str | None = None, **kw):
    """Convert ``m`` to ``fmt``, optionally storing values as ``value_dtype``
    (a quantized source is dequantized and re-quantized in the target's own
    scale-group layout)."""
    if isinstance(m, MatrixFreeOperator) and fmt != "matrix_free":
        raise TypeError(
            f"convert: cannot repack a MatrixFreeOperator into {fmt!r}; "
            "materialize(op) is the way back to explicit CSR")
    if getattr(m, "scale", None) is not None:
        if value_dtype is None:
            value_dtype = container_value_dtype(m)
        m = dequantize(m)
    out = _convert(m, fmt, **kw)
    if value_dtype is not None:
        out = with_value_dtype(out, value_dtype)
    return out


def _convert(m: CSR, fmt: str, **kw):
    if fmt == "csr":
        return m
    if fmt == "ell":
        return ELL.from_csr(m, **kw)
    if fmt == "jds":
        return JDS.from_csr(m)
    if fmt == "sell":
        return SELL.from_csr(m, **kw)
    if fmt == "dia":
        return DIA.from_csr(m, **kw)
    if fmt == "hybrid":
        return split_dia(m, **kw)
    if fmt == "matrix_free":
        if isinstance(m, MatrixFreeOperator):
            return m
        return MatrixFreeOperator.from_csr(m, **kw)
    if fmt == "bsr":
        return BSR.from_csr(m, **kw)
    raise ValueError(f"unknown format {fmt!r}")


#: the ``convert`` keys of the port's containers
FORMATS = {"csr": CSR, "ell": ELL, "jds": JDS, "sell": SELL, "bsr": BSR,
           "dia": DIA, "hybrid": HybridDIA, "matrix_free": MatrixFreeOperator}


def matrix_stats(m: CSR) -> dict:
    """Compressed sparsity-pattern statistics, paper Fig. 5-style: the inputs
    the performance model needs instead of the full pattern."""
    lens = m.row_lengths()
    ci = _np(m.col_idx)
    rp = _np(m.row_ptr)
    strides = np.diff(ci)
    # remove the row-crossing strides (paper: backward jumps at row starts)
    row_starts = rp[1:-1]
    inner_mask = np.ones(len(strides), bool)
    valid = (row_starts > 0) & (row_starts < m.nnz)
    inner_mask[row_starts[valid] - 1] = False
    inner = strides[inner_mask]
    cross = strides[~inner_mask]
    coo = m.to_coo()
    offs = _np(coo.cols).astype(np.int64) - _np(coo.rows).astype(np.int64)
    uq, cnt = np.unique(offs, return_counts=True)
    order = np.argsort(-cnt)
    return {
        "n_rows": m.shape[0],
        "n_cols": m.shape[1],
        "nnz": m.nnz,
        "nnz_per_row_mean": float(lens.mean()) if lens.size else 0.0,
        "nnz_per_row_std": float(lens.std()) if lens.size else 0.0,
        "nnz_per_row_max": int(lens.max()) if lens.size else 0,
        "mean_inner_stride": float(np.abs(inner).mean()) if inner.size else 0.0,
        "frac_backward_jumps": float((np.concatenate([inner, cross]) < 0).mean())
        if m.nnz > 1 else 0.0,
        "frac_stride_le_8": float((np.abs(inner) <= 8).mean()) if inner.size else 0.0,
        "top_diag_offsets": uq[order[:16]].tolist(),
        "top_diag_counts": cnt[order[:16]].tolist(),
        "frac_nnz_top12_diags": float(cnt[order[:12]].sum() / max(1, m.nnz)),
        "bandwidth": int(np.abs(offs).max()) if m.nnz else 0,
    }
