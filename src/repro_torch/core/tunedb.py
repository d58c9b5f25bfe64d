"""On-disk tuning database: the measured tier of the format and backend
selectors.

Port of ``repro.core.tunedb``.  ``perfmodel.select_format`` and
``kernels.registry.select_backend`` rank by the calibrated roofline, and
what separates their pick from the fastest plan is model error.  A DB of
measured candidates closes that loop:

* a measurement run records every timed candidate (format, backend,
  measured seconds, the model's seconds) of a matrix here;
* the **warm path** of the selectors consults the DB first: a fresh entry
  returns the measured winner instead of the model's guess;
* ``perfmodel.fit_efficiency_from_db`` refits the ``EXEC_EFFICIENCY``
  factors from the measured-vs-model ratios;
* with no DB, or a corrupt or stale one, every selection takes the **cold
  path**, identical to the model-only behaviour.

Key schema: one entry per ``(signature, chip_family, platform,
value_dtype)``:

* ``signature`` -- a hash of the matrix's pattern statistics, the same
  string as the reference's for the same pattern;
* ``chip_family`` -- ``perfmodel.chip_family`` of the priced chip ("h100"
  for the card);
* ``platform`` -- the type of the device the plan runs on: ``"cuda"`` on
  the card, ``"cpu"`` on the host.  (The reference records
  ``jax.default_backend()``, which says ``"gpu"`` on a GPU, so a record
  measured with XLA's GPU kernels never answers for the port's kernels.)
* ``value_dtype`` -- the stored value dtype.

An entry whose recorded winner has no registry entry here, or whose probe
refuses the operand here, is stale and ignored: the DB can move between
machines without ever breaking a selection.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import warnings
from dataclasses import asdict, dataclass, field
from pathlib import Path

import numpy as np
import torch

SCHEMA_VERSION = 1

#: ``corpus_stats`` fields the signature hashes -- independent of the SELL
#: chunk geometry, so a matrix signs the same whatever packing is priced
SIGNATURE_KEYS = (
    "n_rows", "n_cols", "nnz", "bandwidth", "n_populated_diags",
    "nnz_per_row_mean", "nnz_per_row_max", "frac_nnz_top12_diags",
    "nnz_per_row_hist", "top_diag_offsets", "top_diag_counts",
)

#: ops whose measurements are recorded (and so can warm a backend pick)
_FRESHNESS_OPS = ("spmv",)

_TOKENS = itertools.count()


class TuneDBWarning(UserWarning):
    """A tuning DB could not be read; selection degrades to the cold
    (model-only) path instead of failing."""


def _sig_round(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, dict):
        return {k: _sig_round(x) for k, x in sorted(v.items())}
    if isinstance(v, (list, tuple)):
        return [_sig_round(x) for x in v]
    return v


def _matrix_free_signature(op) -> str:
    """Sign a MatrixFreeOperator from its descriptor (diagonal set, periodic
    rules, generated scalars) and the content of its stored lanes."""
    cached = getattr(op, "_tune_sig", None)
    if cached is not None:
        return cached
    desc = {
        "kind": "matrix_free",
        "shape": list(op.shape),
        "offsets": list(op.offsets),
        "periods": list(op.periods),
        "los": list(op.los),
        "his": list(op.his),
        "gen_values": list(op.gen_values),
        "nnz": op.nnz,
        "stored_nnz": op.stored_nnz,
        "value_dtype": op.value_dtype,
    }
    h = hashlib.sha1(json.dumps(_sig_round(desc), sort_keys=True).encode())
    if op.data is not None:   # the raw bytes the reference hashes (bf16 as its bits)
        h.update(op.data.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    sig = h.hexdigest()[:16]
    object.__setattr__(op, "_tune_sig", sig)
    return sig


def _signature_stats(csr) -> dict:
    """The ``corpus.corpus_stats`` values of ``SIGNATURE_KEYS`` alone (not
    the SELL occupancy sweep, the costly part on a large matrix)."""
    from . import formats as F
    from .corpus import row_length_histogram
    s = dict(F.matrix_stats(csr))
    s["nnz_per_row_hist"] = row_length_histogram(csr.row_lengths())
    coo = csr.to_coo()
    offs = np.sort(F._np(coo.cols).astype(np.int64) - F._np(coo.rows).astype(np.int64))
    s["n_populated_diags"] = int(np.count_nonzero(np.diff(offs)) + 1) if offs.size else 0
    return s


def signature_of(m) -> str | None:
    """Stable pattern signature of a container, or None when it has none.

    CSR/COO containers are signed from their ``corpus_stats``; a container
    converted by the plan layer is signed through the source it was
    converted from (``_tune_src``); a hand-built packing returns None and
    stays on the cold path.
    """
    from . import formats as F

    if isinstance(m, F.MatrixFreeOperator):
        return _matrix_free_signature(m)
    if not isinstance(m, (F.CSR, F.COO)):
        src = getattr(m, "_tune_src", None)
        if src is None:
            return None
        m = src
    cached = getattr(m, "_tune_sig", None)
    if cached is not None:
        return cached
    csr = F.CSR.from_coo(m) if isinstance(m, F.COO) else m
    stats = _signature_stats(csr)
    payload = json.dumps({k: _sig_round(stats[k]) for k in SIGNATURE_KEYS},
                         sort_keys=True)
    sig = hashlib.sha1(payload.encode()).hexdigest()[:16]
    object.__setattr__(m, "_tune_sig", sig)
    return sig


def _kwargs(kw) -> dict:
    """Conversion kwargs of a record, hashable again: a JSON round trip
    turns a tuple (BSR's ``block_shape``) into a list."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in dict(kw or {}).items()}


def db_key(signature: str, chip_family: str, platform: str,
           value_dtype: str) -> str:
    return f"{signature}/{chip_family}/{platform}/{value_dtype}"


def _platform(device=None) -> str:
    """The platform of a plan on ``device``: its device type (``None``: the
    card, and a ``RuntimeError`` without one)."""
    from ..utils.hw import default_device
    return default_device(device).type


@dataclass
class Candidate:
    """One measured (format, backend) implementation of a matrix's SpMV.

    ``t_model_s`` is the calibrated roofline's prediction (the drift
    table); ``t_model_eff1_s`` the prediction at efficiency 1.0 (the
    efficiency refit: achieved efficiency = ``t_model_eff1_s /
    t_measured_s``).
    """

    format: str
    backend: str
    t_measured_s: float
    t_model_s: float | None = None
    t_model_eff1_s: float | None = None
    convert_kwargs: dict = field(default_factory=dict)

    @property
    def label(self) -> str:
        return f"{self.format}/{self.backend}"


class TuneDB:
    """The on-disk (JSON) tuning database.

    Attributes:
        path: where ``save()`` writes by default (None = in memory only).
        entries: {db_key: entry dict} -- see the module docstring.
        efficiency: {chip_family: {format: fitted efficiency}}.
        token: process-unique identity; selection memo keys use it, so a
            choice warmed by one DB never answers for another.
    """

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path is not None else None
        self.entries: dict[str, dict] = {}
        self.efficiency: dict[str, dict] = {}
        self.token = f"tunedb-{next(_TOKENS)}"

    def __len__(self) -> int:
        return len(self.entries)

    # -- persistence --------------------------------------------------------

    @classmethod
    def load(cls, path: str | Path) -> "TuneDB":
        """Read a DB from disk.  A missing file is an empty DB; a corrupt,
        truncated or wrong-schema file warns (``TuneDBWarning``) and gives
        an empty DB -- the cold path stays reachable."""
        db = cls(path)
        p = Path(path)
        if not p.exists():
            return db
        try:
            payload = json.loads(p.read_text())
            if not isinstance(payload, dict):
                raise ValueError("top-level JSON value is not an object")
            version = payload.get("version")
            if version != SCHEMA_VERSION:
                raise ValueError(f"schema version {version!r} != {SCHEMA_VERSION}")
            entries = payload.get("entries", {})
            efficiency = payload.get("efficiency", {})
            if not isinstance(entries, dict) or not isinstance(efficiency, dict):
                raise ValueError("'entries'/'efficiency' are not objects")
        except (ValueError, OSError) as e:
            warnings.warn(
                f"tuning DB {p} unreadable ({e}); continuing with the cold "
                f"(model-only) path", TuneDBWarning, stacklevel=2)
            return db
        db.entries = entries
        db.efficiency = efficiency
        return db

    def save(self, path: str | Path | None = None) -> Path:
        """Write the DB as deterministic JSON (the reference's layout)."""
        p = Path(path) if path is not None else self.path
        if p is None:
            raise ValueError("TuneDB has no path; pass save(path=...)")
        p.parent.mkdir(parents=True, exist_ok=True)
        payload = {"version": SCHEMA_VERSION, "entries": self.entries,
                   "efficiency": self.efficiency}
        p.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
        self.path = p
        return p

    # -- recording ----------------------------------------------------------

    def record(self, m, *, chip, candidates, matrix_name: str | None = None,
               value_dtype: str | None = None, platform: str | None = None,
               device=None) -> dict | None:
        """Store the measured candidates of ``m`` (best = measured argmin)
        under the platform of ``device`` unless ``platform`` names it.

        Returns the stored entry, or None when ``m`` has no signature or no
        candidate carries a positive measurement.
        """
        from . import formats as F
        from . import perfmodel as PM

        sig = signature_of(m)
        if sig is None:
            return None
        cands = [asdict(c) if isinstance(c, Candidate) else dict(c)
                 for c in candidates]
        cands = [c for c in cands
                 if c.get("t_measured_s") and c["t_measured_s"] > 0]
        if not cands:
            return None
        vd = value_dtype or F.container_value_dtype(m)
        best = min(cands, key=lambda c: c["t_measured_s"])
        entry = {
            "signature": sig,
            "chip_family": PM.chip_family(chip),
            "chip_name": chip.name,
            "platform": platform or _platform(device),
            "value_dtype": vd,
            "matrix": matrix_name,
            "best": {"format": best["format"], "backend": best["backend"],
                     "convert_kwargs": best.get("convert_kwargs", {})},
            "candidates": cands,
        }
        key = db_key(sig, entry["chip_family"], entry["platform"], vd)
        self.entries[key] = entry
        return entry

    # -- lookup (the warm path) ---------------------------------------------

    def raw_lookup(self, m, *, chip, value_dtype: str | None = None,
                   platform: str | None = None, device=None) -> dict | None:
        """Key-exact entry for ``m`` with no freshness check."""
        from . import formats as F
        from . import perfmodel as PM

        sig = signature_of(m)
        if sig is None:
            return None
        try:
            vd = value_dtype or F.container_value_dtype(m)
        except TypeError:
            return None
        key = db_key(sig, PM.chip_family(chip), platform or _platform(device), vd)
        entry = self.entries.get(key)
        if not isinstance(entry, dict) or "best" not in entry:
            return None
        return entry

    def lookup(self, m, *, chip, value_dtype: str | None = None,
               platform: str | None = None, device=None) -> dict | None:
        """The entry of ``m`` whose winner is still buildable on ``device``,
        or None (a stale winner: no registry entry, or its probe refuses
        the operand here)."""
        entry = self.raw_lookup(m, chip=chip, value_dtype=value_dtype,
                                platform=platform, device=device)
        if entry is None:
            return None
        best = entry["best"]
        if not self._candidate_fresh(m, best["format"], best["backend"],
                                     best.get("convert_kwargs", {}), chip, device):
            return None
        return entry

    def _candidate_fresh(self, m, fmt: str, backend: str, convert_kwargs: dict,
                         chip, device=None, convert: bool = True) -> bool:
        """Whether a recorded candidate can be built here: its registry entry
        exists, the CSR/COO source converts (when ``convert``), and the
        entry's probe accepts.  The port's probes read only the device, so
        ``convert=False`` probes the source itself and skips the conversion
        of a large matrix into a format that will not be compiled."""
        from ..kernels import registry as R
        from . import formats as F

        if not R.has(fmt, "spmv", backend):
            return False
        if convert and isinstance(m, (F.CSR, F.COO)):
            try:
                from .plan import _convert_cached
                obj = _convert_cached(m, fmt, _kwargs(convert_kwargs))
            except (ValueError, TypeError):  # a conversion that fails = stale
                return False
        else:
            obj = m
        ctx = R.KernelContext(device=device, chip=chip)
        return bool(R.get(fmt, "spmv", backend).probe(obj, ctx).ok)

    def lookup_format(self, m, *, chip, allowed=None,
                      value_dtype: str | None = None,
                      platform: str | None = None, device=None) -> tuple | None:
        """Warm ``select_format``: ``(format, convert_kwargs, {format:
        measured seconds})`` over the fresh candidates (the fastest backend
        a format), or None when there is no entry or nothing fresh is left
        after ``allowed``."""
        entry = self.raw_lookup(m, chip=chip, value_dtype=value_dtype,
                                platform=platform, device=device)
        if entry is None:
            return None
        allow = set(allowed) if allowed is not None else None
        times, kwargs = {}, {}
        for c in sorted((c for c in entry.get("candidates", ())
                         if c.get("t_measured_s")),
                        key=lambda c: c["t_measured_s"]):
            fmt = c["format"]
            if (allow is not None and fmt not in allow) or fmt in times:
                continue
            # only the pick (the first fresh one in time order) is converted
            if not self._candidate_fresh(m, fmt, c["backend"], c.get("convert_kwargs", {}),
                                         chip, device, convert=not times):
                continue
            times[fmt] = c["t_measured_s"]
            kwargs[fmt] = _kwargs(c.get("convert_kwargs"))
        if not times:
            return None
        best = next(iter(times))
        return best, kwargs[best], times

    def lookup_backend(self, matrix, format: str, op: str, *, chip,
                       device=None) -> dict | None:
        """Warm ``select_backend``: the measured-fastest fresh candidate of
        this matrix under ``format`` (a candidate dict with ``backend`` and
        ``t_measured_s``), or None.  Only SpMV is recorded, so other ops
        stay cold."""
        if op not in _FRESHNESS_OPS:
            return None
        entry = self.raw_lookup(matrix, chip=chip, device=device)
        if entry is None:
            return None
        cands = sorted(
            (c for c in entry.get("candidates", ())
             if c.get("format") == format and c.get("t_measured_s")),
            key=lambda c: c["t_measured_s"])
        for c in cands:
            if self._candidate_fresh(matrix, format, c["backend"],
                                     c.get("convert_kwargs", {}), chip, device):
                return c
        return None

    def efficiency_for(self, chip) -> dict | None:
        """Refitted ``EXEC_EFFICIENCY`` factors of ``chip``'s family, or
        None when none were persisted."""
        from . import perfmodel as PM

        eff = self.efficiency.get(PM.chip_family(chip))
        return dict(eff) if eff else None


#: ``open_db`` cache: {(resolved path, mtime_ns): TuneDB}
_OPEN_CACHE: dict[tuple, TuneDB] = {}


def open_db(tuning) -> TuneDB | None:
    """Coerce a ``tuning=`` argument (TuneDB | path | None) to a TuneDB; a
    path is parsed once until its file changes."""
    if tuning is None or isinstance(tuning, TuneDB):
        return tuning
    p = Path(tuning)
    try:
        mtime = p.stat().st_mtime_ns
    except OSError:
        mtime = None
    key = (str(p.resolve()), mtime)
    if key not in _OPEN_CACHE:
        _OPEN_CACHE[key] = TuneDB.load(p)
    return _OPEN_CACHE[key]


def drift_table(db: TuneDB) -> list[dict]:
    """Model-vs-measured rows, one per recorded candidate: ``ratio`` =
    predicted / measured seconds (< 1: slower than modelled)."""
    rows = []
    for entry in db.entries.values():
        for c in entry.get("candidates", ()):
            t, p = c.get("t_measured_s"), c.get("t_model_s")
            rows.append({
                "matrix": entry.get("matrix") or entry["signature"],
                "chip_family": entry["chip_family"],
                "value_dtype": entry["value_dtype"],
                "format": c["format"],
                "backend": c["backend"],
                "t_measured_s": t,
                "t_model_s": p,
                "ratio_model_vs_measured": (p / t) if (p and t) else None,
                "is_best": (c["format"] == entry["best"]["format"]
                            and c["backend"] == entry["best"]["backend"]),
            })
    return rows
