"""Structural and numerical validation of matrices and request vectors.

Port of ``repro.core.validate``.  A column index past the matrix edge, a
non-monotone ``row_ptr``, a duplicate entry, a NaN in one request or a
float64 value that overflows to Inf when narrowed all give wrong answers
without an error further down.  This module holds the checks and the
policy for what to do when one fires:

* ``validate_matrix(m, policy=...)`` -- index bounds, ``row_ptr``
  monotonicity, duplicate entries, unsorted columns, NaN/Inf values and
  overflow on a narrowing cast, for ``CSR``/``COO`` containers (host numpy
  work, as the packers are);
* ``validate_vector(x, n, policy=...)`` -- shape, dtype and finiteness of
  one request vector;
* ``check_finite_columns(Y)`` -- the per-column finiteness verdict of a
  batch result.

The last two take a torch tensor (on the card or the host) or a numpy
array.  A tensor is checked on its own device: the card reduces it and the
host reads one verdict, so the vector is never copied to the host.

Policies: ``strict`` raises :class:`ValidationError` naming every violated
check; ``repair`` fixes what is fixable (out-of-range entries dropped,
duplicates summed, rows sorted, non-finite values zeroed; the repairs are
recorded on the result as ``_repairs``); ``off`` skips everything.

Errors::

    ValidationError (ValueError)
      +-- MatrixValidationError     bad matrix structure/values
      +-- VectorValidationError     bad request vector
      +-- MatrixFormatError         a malformed MatrixMarket file, with path/line
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

POLICIES = ("strict", "repair", "off")


class ValidationError(ValueError):
    """A structural or numerical validation check failed (policy 'strict')."""


class MatrixValidationError(ValidationError):
    """A matrix container violated the structural/numerical contract."""


class VectorValidationError(ValidationError):
    """A request vector violated the shape/dtype/finiteness contract."""


class MatrixFormatError(ValidationError):
    """A MatrixMarket file is malformed; carries file/line provenance.

    Attributes:
        path: the offending file.
        line: 1-based line number of the first offending line (None when
            the problem is file-level, e.g. an entry-count mismatch).
    """

    def __init__(self, message: str, *, path=None, line: int | None = None):
        loc = f"{path}" + (f":{line}" if line is not None else "")
        super().__init__(f"{loc}: {message}" if path is not None else message)
        self.path = path
        self.line = line


def _check_policy(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(f"unknown validation policy {policy!r}; "
                         f"expected one of {POLICIES}")
    return policy


@dataclass
class ValidationReport:
    """What ``validate_matrix`` found (and, under 'repair', fixed)."""

    problems: list[str] = field(default_factory=list)
    repairs: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems


# ---------------------------------------------------------------------------
# matrix validation
# ---------------------------------------------------------------------------

#: largest finite value of each narrowing target, by value-dtype name
_FINITE_MAX = {"f16": float(np.finfo(np.float16).max),
               "f32": float(np.finfo(np.float32).max),
               "f64": float(np.finfo(np.float64).max),
               "bf16": float(torch.finfo(torch.bfloat16).max)}

_DTYPE_NAMES = {np.dtype(np.float16): "f16", np.dtype(np.float32): "f32",
                np.dtype(np.float64): "f64", torch.float16: "f16",
                torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def _target_name(target) -> str | None:
    """Value-dtype name of a narrowing target: a name ("f32", "bf16"), a
    torch dtype or a numpy dtype; None for one with no finite limit here."""
    if isinstance(target, str) and target in _FINITE_MAX:
        return target
    if isinstance(target, torch.dtype):
        return _DTYPE_NAMES.get(target)
    try:
        return _DTYPE_NAMES.get(np.dtype(target))
    except TypeError:
        return None


def dtype_overflow_count(vals: np.ndarray, target_dtype) -> int:
    """Entries of ``vals`` that are finite but overflow to Inf in
    ``target_dtype`` (f64, f32, f16 or bf16; any other target counts 0).

    The corpus loaders narrow float64 MatrixMarket values to the container
    dtype; a value like 1e300 survives the file checks but becomes Inf
    after the cast -- this counts those before they do.
    """
    name = _target_name(target_dtype)
    vals = np.asarray(vals)
    if name is None or vals.size == 0:
        return 0
    finite = np.isfinite(vals)
    return int((finite & (np.abs(vals) > _FINITE_MAX[name])).sum())


def _coo_arrays(m):
    """(rows, cols, vals, shape) as host numpy arrays for CSR or COO."""
    from .formats import COO, CSR, _np
    if isinstance(m, CSR):
        rp = _np(m.row_ptr)
        rows = np.repeat(np.arange(m.shape[0], dtype=np.int64),
                         np.maximum(rp[1:] - rp[:-1], 0))
        return rows, _np(m.col_idx).astype(np.int64), _np(m.val), m.shape
    if isinstance(m, COO):
        return (_np(m.rows).astype(np.int64), _np(m.cols).astype(np.int64),
                _np(m.vals), m.shape)
    raise TypeError(f"validate_matrix expects CSR or COO, got "
                    f"{type(m).__name__}; validate before converting")


def inspect_matrix(m, *, value_dtype=None) -> ValidationReport:
    """Run every check without raising or repairing; returns the report."""
    from .formats import CSR, _np
    rep = ValidationReport()
    n_rows, n_cols = m.shape
    if isinstance(m, CSR):
        rp = _np(m.row_ptr)
        if len(rp) != n_rows + 1:
            rep.problems.append(
                f"row_ptr has {len(rp)} entries, expected n_rows+1={n_rows + 1}")
            return rep  # structure too broken for the remaining checks
        if rp[0] != 0 or np.any(np.diff(rp) < 0):
            rep.problems.append("row_ptr is not a monotone prefix-sum "
                                "starting at 0")
            return rep
        if int(rp[-1]) != m.nnz:
            rep.problems.append(
                f"row_ptr[-1]={int(rp[-1])} does not match nnz={m.nnz}")
            return rep
    rows, cols, vals, _ = _coo_arrays(m)
    oob = (rows < 0) | (rows >= n_rows) | (cols < 0) | (cols >= n_cols)
    n_oob = int(oob.sum())
    if n_oob:
        i = int(np.argmax(oob))
        rep.problems.append(
            f"{n_oob} entries with indices out of range for "
            f"{n_rows}x{n_cols} (first at entry {i}: "
            f"({int(rows[i])}, {int(cols[i])}))")
    inb = ~oob
    if inb.any():
        keys = rows[inb] * np.int64(n_cols) + cols[inb]
        steps = np.diff(keys)
        # strictly increasing keys (every clean CSR) hold no duplicate: the
        # count needs no sort of tens of millions of keys then
        n_dup = 0 if steps.size == 0 or steps.min() > 0 else \
            int(keys.size - np.unique(keys).size)
        if n_dup:
            rep.problems.append(f"{n_dup} duplicate (row, col) entries "
                                "(their values would silently sum)")
        if isinstance(m, CSR) and np.any(steps < 0):
            rep.problems.append("columns are not sorted within rows "
                                "(chunked kernels assume sorted CSR)")
    if np.issubdtype(vals.dtype, np.floating):
        n_bad = int((~np.isfinite(vals)).sum())
        if n_bad:
            i = int(np.argmax(~np.isfinite(vals)))
            rep.problems.append(
                f"{n_bad} non-finite values (first at entry {i}: {vals[i]!r})")
        if value_dtype is not None:
            n_ovf = dtype_overflow_count(vals, value_dtype)
            if n_ovf:
                rep.problems.append(
                    f"{n_ovf} finite values overflow to Inf when cast to "
                    f"{_dtype_label(value_dtype)}")
    return rep


def _dtype_label(value_dtype) -> str:
    """The reference's name of a numpy target ("float32"); the value-dtype
    name of any other."""
    if isinstance(value_dtype, (str, torch.dtype)):
        return _target_name(value_dtype) or str(value_dtype)
    return np.dtype(value_dtype).name


def repair_matrix(m):
    """Return a repaired copy of ``m`` (same container class) + repair log.

    Drops out-of-range entries, merges duplicates (summing their values),
    sorts rows/columns, and zeroes non-finite values.  A clean matrix is
    returned unchanged (the same object).
    """
    from .formats import COO, CSR
    rep = inspect_matrix(m)
    if rep.ok:
        return m, []
    rows, cols, vals, shape = _coo_arrays(m)
    repairs = []
    keep = ((rows >= 0) & (rows < shape[0]) & (cols >= 0) & (cols < shape[1]))
    if not keep.all():
        repairs.append(f"dropped {int((~keep).sum())} out-of-range entries")
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if np.issubdtype(vals.dtype, np.floating):
        bad = ~np.isfinite(vals)
        if bad.any():
            repairs.append(f"zeroed {int(bad.sum())} non-finite values")
            vals = np.where(bad, np.zeros((), vals.dtype), vals)
    keys = rows * np.int64(shape[1]) + cols
    uniq, inv = np.unique(keys, return_inverse=True)
    if uniq.size != keys.size:
        repairs.append(f"merged {int(keys.size - uniq.size)} duplicate entries")
        summed = np.zeros(uniq.size, vals.dtype)
        np.add.at(summed, inv, vals)
        rows = (uniq // shape[1]).astype(np.int64)
        cols = (uniq % shape[1]).astype(np.int64)
        vals = summed
    elif np.any(np.diff(keys) < 0):
        repairs.append("sorted entries by (row, col)")
        order = np.argsort(keys, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
    coo = COO(rows.astype(np.int32), cols.astype(np.int32), vals, shape)
    fixed = coo if isinstance(m, COO) else CSR.from_coo(coo)
    object.__setattr__(fixed, "_repairs", tuple(repairs))
    src = getattr(m, "_source", None)
    if src is not None:
        object.__setattr__(fixed, "_source", src)
    return fixed, repairs


def validate_matrix(m, policy: str = "strict", *, value_dtype=None):
    """Validate (and under 'repair', fix) a CSR/COO container.

    Args:
        m: the container to check (CSR or COO; validate *before* converting
            to packed formats -- packers assume a clean source).  Any other
            container passes through untouched: it was packed by the port's
            own converters from a CSR/COO source.
        policy: ``"strict"`` raises :class:`MatrixValidationError` listing
            every violated check; ``"repair"`` returns a fixed copy (see
            :func:`repair_matrix`); ``"off"`` returns ``m`` untouched.
        value_dtype: optional narrowing target (a numpy or torch dtype or a
            value-dtype name) -- adds the overflow check.

    Returns:
        The validated (possibly repaired) container.
    """
    from .formats import COO, CSR
    if _check_policy(policy) == "off":
        return m
    if not isinstance(m, (CSR, COO)):
        return m
    if policy == "repair":
        fixed, _ = repair_matrix(m)
        return fixed
    rep = inspect_matrix(m, value_dtype=value_dtype)
    if not rep.ok:
        raise MatrixValidationError(
            "matrix failed validation (policy='strict'; use 'repair' to "
            "fix fixable problems):\n  - " + "\n  - ".join(rep.problems))
    return m


# ---------------------------------------------------------------------------
# request vectors and batch results (tensors on their device, or numpy)
# ---------------------------------------------------------------------------


def _is_floating(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype.is_floating_point
    return bool(np.issubdtype(x.dtype, np.floating))


def validate_vector(x, n: int, policy: str = "strict", *, name: str = "x",
                    defer_finite: bool = False):
    """Validate one request vector against an (M, n) operator.

    A shape mismatch raises under every policy (a wrong-shaped operand
    cannot be repaired); finiteness follows the policy: ``strict`` raises
    :class:`VectorValidationError`, ``repair`` zeroes the non-finite
    entries, ``off`` skips the check.  A tensor is checked where it lies --
    on the card one reduction and one read of its verdict -- and the
    returned vector is on the same device.  ``defer_finite=True`` skips the
    strict finiteness check on the caller's promise that a batch-wide
    :func:`check_finite_columns` enforces it later.

    Returns the (possibly repaired) vector.
    """
    if tuple(x.shape) != (n,):
        raise VectorValidationError(
            f"{name} has shape {tuple(x.shape)}, expected ({n},)")
    if _check_policy(policy) == "off":
        return x
    if not _is_floating(x):
        raise VectorValidationError(
            f"{name} has dtype {x.dtype}, expected a floating dtype")
    if isinstance(x, torch.Tensor):
        if policy == "repair":
            return torch.where(torch.isfinite(x), x,
                               torch.zeros((), dtype=x.dtype, device=x.device))
        ok = defer_finite or bool(torch.isfinite(x).all())
    else:
        x = np.asarray(x)
        if policy == "repair":
            return np.where(np.isfinite(x), x, np.zeros((), x.dtype))
        ok = defer_finite or bool(np.isfinite(x).all())
    if not ok:
        raise VectorValidationError(
            f"{name} contains non-finite entries (NaN/Inf); policy='strict' "
            "rejects them at submission so they cannot poison a batch")
    return x


def check_finite_columns(Y):
    """Per-column all-finite verdict of a batch result Y (M, K) -> (K,) bool.

    A tensor gets a bool tensor on its own device (one reduction, no copy
    of Y); a numpy array gets a numpy array.  For a floating tensor the
    reduction is one min/max pass over Y: a NaN propagates into both
    extremes and an Inf reaches one of them, so a column is finite exactly
    when its two extremes are (phase 12 of ``chip_smoke.py`` timed the
    verdict of a (1,201,200, 16) f64 batch at 0.2831 ms as ``isfinite``
    then ``all`` and at 0.1345 ms as this pass, NVIDIA H100 80GB HBM3 at
    700 W).
    """
    if isinstance(Y, torch.Tensor):
        if Y.shape[0] == 0 or not Y.dtype.is_floating_point:
            return torch.isfinite(Y).all(dim=0)
        lo, hi = torch.aminmax(Y, dim=0)
        return torch.isfinite(lo) & torch.isfinite(hi)
    return np.isfinite(np.asarray(Y)).all(axis=0)
