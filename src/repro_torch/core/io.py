"""Matrix I/O: MatrixMarket coordinate files round-tripped through ``COO``.

Port of ``repro.core.io``, numpy only on the host:

* ``read_mtx`` -- ``coordinate`` files with ``real | integer | pattern``
  fields and ``general | symmetric | skew-symmetric`` symmetry, plain or
  gzip-compressed (a path ending in ``.gz``), into a ``COO``;
* ``write_mtx`` -- the inverse, with symmetry folding, byte for byte the
  reference's file; it formats the entries in blocks rather than a line at
  a time, so a matrix of tens of millions of entries is written in seconds;
* ``load_matrix`` -- name-based loading for the corpus registry
  (``core.corpus``): ``<name>.mtx[.gz]`` in the corpus data directory, or a
  deterministic synthetic stand-in seeded from the name when the file is
  not on disk.

Provenance is recorded on the returned container as ``m._source`` (the
resolved path, or ``"synthetic:<name>"`` for fallbacks).
"""
from __future__ import annotations

import gzip
import os
import zlib
from pathlib import Path

import numpy as np

from .formats import COO, CSR, _np

#: default on-disk location of corpus matrices (repo_root/data/corpus);
#: override with the REPRO_CORPUS_DIR environment variable.
CORPUS_DIR = Path(__file__).resolve().parents[3] / "data" / "corpus"

_FIELDS = ("real", "integer", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric")

#: entries formatted per block by ``write_mtx``
_WRITE_BLOCK = 1 << 20


def _open_text(path, mode: str):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, mode + "t")
    return open(path, mode)


def _entry_lines(path, start_after: int):
    """``(lineno, stripped_line)`` of the data lines after the size line:
    the slow rescan that names the offending line once the bulk parse
    (``np.loadtxt``, no line provenance) has failed."""
    with _open_text(path, "r") as fh:
        for lineno, raw in enumerate(fh, start=1):
            if lineno <= start_after:
                continue
            s = raw.strip()
            if not s or s.startswith("%"):
                continue
            yield lineno, s


def _locate_bad_entry(path, start_after: int, want_cols: int,
                      n_rows: int, n_cols: int):
    """(lineno, message) of the first malformed/out-of-range entry line."""
    for lineno, s in _entry_lines(path, start_after):
        toks = s.split()
        if len(toks) < want_cols:
            return lineno, (f"entry line has {len(toks)} fields, expected "
                            f"{want_cols}: {s!r}")
        try:
            r, c = int(float(toks[0])), int(float(toks[1]))
            if want_cols > 2:
                float(toks[2])
        except ValueError:
            return lineno, f"entry line is not numeric: {s!r}"
        if not (1 <= r <= n_rows and 1 <= c <= n_cols):
            return lineno, (f"entry ({r}, {c}) out of range for a "
                            f"{n_rows}x{n_cols} matrix (indices are 1-based)")
    return None, None


def read_mtx(path, *, validate: str = "strict") -> COO:
    """Read a MatrixMarket ``coordinate`` file (optionally ``.gz``) into COO.

    Symmetric files are expanded (off-diagonal entries mirrored, negated
    for skew), so the returned COO holds the full pattern.

    Args:
        path: file path; gzip-decompressed when it ends in ``.gz``.
        validate: matrix-level policy applied to the parsed container
            (``core.validate.validate_matrix``): ``"strict"`` raises,
            ``"repair"`` fixes, ``"off"`` skips.  File-format errors always
            raise.

    Returns:
        A ``COO`` with int32 indices and float64 values (``pattern``
        entries become 1.0).

    Raises:
        MatrixFormatError: on a malformed banner, an unsupported
            layout/field/symmetry, a malformed or out-of-range entry line,
            or an entry-count mismatch -- with the file path and the 1-based
            line number of the first offending line.
    """
    from .validate import MatrixFormatError, validate_matrix

    with _open_text(path, "r") as fh:
        banner = fh.readline().strip().split()
        if (len(banner) < 5 or banner[0].lower() != "%%matrixmarket"
                or banner[1].lower() != "matrix"):
            raise MatrixFormatError(
                f"not a MatrixMarket file (banner {banner!r}; want "
                "'%%MatrixMarket matrix <layout> <field> <symmetry>')",
                path=path, line=1)
        layout, field, symmetry = (w.lower() for w in banner[2:5])
        if layout != "coordinate":
            raise MatrixFormatError(
                f"only 'coordinate' layout supported, got {layout!r}",
                path=path, line=1)
        if field not in _FIELDS:
            raise MatrixFormatError(
                f"unsupported field {field!r} (want one of {_FIELDS})",
                path=path, line=1)
        if symmetry not in _SYMMETRIES:
            raise MatrixFormatError(
                f"unsupported symmetry {symmetry!r} (want one of {_SYMMETRIES})",
                path=path, line=1)
        lineno = 2
        line = fh.readline()
        while line and line.lstrip().startswith("%"):
            line = fh.readline()
            lineno += 1
        if not line or not line.strip():
            raise MatrixFormatError("missing size line ('rows cols nnz')",
                                    path=path, line=lineno)
        try:
            n_rows, n_cols, nnz = (int(t) for t in line.split())
        except ValueError as e:
            raise MatrixFormatError(
                f"bad size line {line.strip()!r} (want 'rows cols nnz')",
                path=path, line=lineno) from e
        size_lineno = lineno
        want_cols = 2 if field == "pattern" else 3
        try:
            data = np.loadtxt(fh, ndmin=2, dtype=np.float64)
        except ValueError as e:
            bad_line, msg = _locate_bad_entry(path, size_lineno, want_cols,
                                              n_rows, n_cols)
            raise MatrixFormatError(
                msg or f"unparseable entry data ({e})",
                path=path, line=bad_line) from e
    if data.size == 0:
        data = np.zeros((0, want_cols))
    if data.shape[0] != nnz:
        raise MatrixFormatError(
            f"size line declares {nnz} entries but the file has "
            f"{data.shape[0]}", path=path, line=size_lineno)
    if data.shape[1] < want_cols:
        bad_line, msg = _locate_bad_entry(path, size_lineno, want_cols,
                                          n_rows, n_cols)
        raise MatrixFormatError(
            msg or f"entries have {data.shape[1]} fields, expected "
                   f"{want_cols}", path=path, line=bad_line)
    rows = data[:, 0].astype(np.int64) - 1  # 1-based -> 0-based
    cols = data[:, 1].astype(np.int64) - 1
    vals = np.ones(nnz, np.float64) if field == "pattern" else data[:, 2]
    if nnz and (rows.min() < 0 or cols.min() < 0
                or rows.max() >= n_rows or cols.max() >= n_cols):
        bad_line, msg = _locate_bad_entry(path, size_lineno, want_cols,
                                          n_rows, n_cols)
        raise MatrixFormatError(
            msg or f"entry indices out of range for {n_rows}x{n_cols}",
            path=path, line=bad_line)
    if symmetry != "general":
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, rows[: nnz][off]])
        vals = np.concatenate([vals, sign * vals[off]])
    coo = COO(rows.astype(np.int32), cols.astype(np.int32), vals, (n_rows, n_cols))
    object.__setattr__(coo, "_source", str(path))
    return validate_matrix(coo, policy=validate)


def write_mtx(path, matrix, *, field: str = "real", symmetry: str = "general",
              comment: str | None = None, precision: int = 17) -> Path:
    """Write a COO/CSR container as a MatrixMarket coordinate file.

    Args:
        path: output path; gzip-compressed when it ends in ``.gz``
            (parent directories are created).
        matrix: a ``COO``, or anything with ``.to_coo()`` (``CSR`` etc.).
        field: ``"real" | "integer" | "pattern"`` (pattern drops values).
        symmetry: ``"general"`` writes every entry; ``"symmetric"`` /
            ``"skew-symmetric"`` store only the lower triangle (entries of
            the upper triangle are dropped, so pass only such matrices).
        comment: optional ``%``-prefixed comment line content.
        precision: significant digits of ``real`` values (17 = exact
            float64 round trip).

    Returns:
        The path written.
    """
    if field not in _FIELDS:
        raise ValueError(f"unsupported field {field!r}")
    if symmetry not in _SYMMETRIES:
        raise ValueError(f"unsupported symmetry {symmetry!r}")
    coo = matrix if isinstance(matrix, COO) else matrix.to_coo()
    rows = _np(coo.rows).astype(np.int64)
    cols = _np(coo.cols).astype(np.int64)
    vals = _np(coo.vals)
    if symmetry != "general":
        keep = rows >= cols if symmetry == "symmetric" else rows > cols
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    # one str.format a line over Python ints and floats: the bytes of the
    # reference's per-line f-string (numpy scalars format as int / float)
    line = {"pattern": "{} {}\n", "integer": "{} {} {}\n",
            "real": f"{{}} {{}} {{:.{precision}g}}\n"}[field].format
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with _open_text(path, "w") as fh:
        fh.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        if comment:
            fh.write(f"% {comment}\n")
        fh.write(f"{coo.shape[0]} {coo.shape[1]} {len(rows)}\n")
        for s in range(0, len(rows), _WRITE_BLOCK):
            r = (rows[s:s + _WRITE_BLOCK] + 1).tolist()
            c = (cols[s:s + _WRITE_BLOCK] + 1).tolist()
            if field == "pattern":
                fh.write("".join(map(line, r, c)))
                continue
            v = vals[s:s + _WRITE_BLOCK].tolist()
            if field == "integer":
                v = [int(x) for x in v]
            fh.write("".join(map(line, r, c, v)))
    return path


# ---------------------------------------------------------------------------
# name-based corpus loading with deterministic synthetic fallback
# ---------------------------------------------------------------------------


def resolve_matrix_path(name: str, search_dirs=None) -> Path | None:
    """Find ``<name>``/``<name>.mtx``/``<name>.mtx.gz`` in the search dirs."""
    dirs = [Path(d) for d in (search_dirs if search_dirs is not None
                              else _default_dirs())]
    candidates = [name, f"{name}.mtx", f"{name}.mtx.gz"]
    for d in dirs:
        for c in candidates:
            p = d / c
            if p.is_file():
                return p
    return None


def _default_dirs() -> list[Path]:
    env = os.environ.get("REPRO_CORPUS_DIR")
    return [Path(env)] if env else [CORPUS_DIR]


def synthetic_fallback(name: str, n: int = 512, dtype=np.float32) -> CSR:
    """Deterministic stand-in for a named matrix that is not on disk: a
    banded matrix whose bandwidth, density and values are seeded from
    ``crc32(name)`` -- the same name always gives the same bits."""
    from .matrices import random_banded

    seed = zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF
    rng = np.random.default_rng(seed)
    hw = int(rng.integers(4, max(5, n // 32)))
    density = float(rng.uniform(0.3, 0.9))
    m = random_banded(n, hw, density, seed=seed, dtype=dtype)
    object.__setattr__(m, "_source", f"synthetic:{name}")
    return m


def load_matrix(name: str, *, search_dirs=None, fallback_n: int = 512,
                dtype=np.float32, validate: str = "strict") -> CSR:
    """Load a named corpus matrix as CSR, falling back to a synthetic.

    Args:
        name: matrix name; resolved as ``<name>[.mtx[.gz]]`` against
            ``search_dirs`` (default: ``$REPRO_CORPUS_DIR`` or
            ``data/corpus/`` at the repository root).
        search_dirs: optional explicit directory list.
        fallback_n: dimension of the synthetic stand-in when no file is
            found (see ``synthetic_fallback``).
        dtype: numpy value dtype of the returned CSR.
        validate: matrix-level policy (``core.validate``), checked on the
            float64 parse *before* narrowing to ``dtype``, so values that
            would overflow the cast are named explicitly.

    Returns:
        A ``CSR`` whose ``_source`` attribute records the resolved path or
        ``"synthetic:<name>"``.
    """
    from .validate import validate_matrix

    path = resolve_matrix_path(name, search_dirs)
    if path is None:
        return synthetic_fallback(name, n=fallback_n, dtype=dtype)
    coo = read_mtx(path, validate="off")
    coo = validate_matrix(coo, policy=validate, value_dtype=dtype)
    m = CSR.from_coo(COO(coo.rows, coo.cols, _np(coo.vals).astype(dtype), coo.shape))
    object.__setattr__(m, "_source", str(path))
    return m
