"""The paper's predictive performance model, calibrated on the H100.

The paper's central claim (Sec. 1): a useful model must be *predictive* for
SpMVM performance "for a given matrix on the basis of its sparsity pattern,
and give a hint to the respective optimal storage scheme".  Its ingredients:

* **algorithmic balance** B = bytes moved per Flop for a (format, pattern)
  pair -- CRS = 10 B/F and JDS = 18 B/F at fp64/int32 (Sec. 2), blocked JDS
  approaching CRS balance;
* **line-granularity waste** -- at stride k a whole cache line is moved per
  touched element and only 1/k of it is used (Sec. 4.1, penalty #2);
* **index traffic** -- +4 B/element for the indexing array (penalty #1);
* the bandwidth roofline  perf = min(peak, BW / B).

The byte accounting, the balances and the selectors are those of the
reference (``repro.core.perfmodel``), kept in this package so that the port
imports nothing of it.  What is the port's own:

* the stream-byte regimes are the port's backends: ``cuda`` (the
  hand-written kernels, which stream SELL's flat chunk layout) and
  ``torch`` (the composite PyTorch entries, whose SELL form is picked per
  container, flat or padded, by ``sell_xla_uses_flat``);
* that pick reads the family of the chip the caller prices (every byte
  count takes ``chip``; a plan passes its own), never the process's
  platform, so the model and the entry that runs agree;
* the H100 has its own chip family, ``"h100"``, with formulation
  efficiencies measured on the card (``EXEC_EFFICIENCY["h100"]``);
* the SELL kernels stage nothing in shared memory, so the reference's VMEM
  block budget (``select_pallas_blocks``) has no counterpart.

The access granule is 128 bytes (``line_elems = 128 // value_bytes``): the
H100's L2 line, and the granule of the reference's presets, so the two
packages' byte counts agree.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..utils.hw import H100, ChipSpec


@dataclass(frozen=True)
class AccessModel:
    """Byte-accounting parameters for one SpMV execution."""

    value_bytes: int = 8      # fp64 in the paper
    index_bytes: int = 4
    line_elems: int = 8       # elements per memory-access granule (64 B line / fp64)
    invec_waste: float = 1.0  # mean granule fraction wasted multiplier (>= 1)
    invec_reuse: float = 1.0  # < 1 if invec elements are re-served from cache

    def invec_bytes_per_access(self) -> float:
        return self.value_bytes * self.invec_waste * self.invec_reuse


def waste_from_stride(mean_stride: float, line_elems: int) -> float:
    """Paper penalty #2: at stride k only 1/k of each granule is useful.

    waste = min(k, line_elems): stride 1 -> 1.0 (dense), stride >= line
    -> line_elems (whole granule per element).
    """
    return float(np.clip(mean_stride, 1.0, line_elems))


# ---------------------------------------------------------------------------
# per-format balance (bytes per Flop); 2 Flops per stored element
# ---------------------------------------------------------------------------


def balance_csr(am: AccessModel, nnz_per_row: float = np.inf) -> float:
    """CRS: val + col_idx + invec per element; result kept in register,
    written once per row (amortized over nnz_per_row)."""
    per_elem = am.value_bytes + am.index_bytes + am.invec_bytes_per_access()
    per_elem += 2 * am.value_bytes / max(1.0, nnz_per_row)  # resvec ld+st per row
    return per_elem / 2.0


def balance_jds(am: AccessModel) -> float:
    """JDS: like CRS plus a resvec load+store per element (paper: 18 B/F)."""
    per_elem = (am.value_bytes + am.index_bytes + am.invec_bytes_per_access()
                + 2 * am.value_bytes)
    return per_elem / 2.0


def balance_blocked_jds(am: AccessModel, rows_per_block: int, nnz_per_row: float) -> float:
    """NBJDS/RBJDS/SELL: the resvec tile stays cached across the block's
    diagonals, so its round trip amortizes over nnz_per_row -- with full
    amortization this is CRS balance (paper Sec. 2)."""
    per_elem = am.value_bytes + am.index_bytes + am.invec_bytes_per_access()
    per_elem += 2 * am.value_bytes / max(1.0, nnz_per_row)
    return per_elem / 2.0


def balance_ell(am: AccessModel, pad_ratio: float, nnz_per_row: float = np.inf) -> float:
    """ELL streams padding too: all streamed terms scale by pad_ratio
    (= padded elements / nnz >= 1)."""
    return balance_csr(am, nnz_per_row) * pad_ratio


def balance_sell(am: AccessModel, pad_ratio: float, nnz_per_row: float) -> float:
    return balance_blocked_jds(am, 0, nnz_per_row) * pad_ratio


def flat_sell_access_model(am: AccessModel, overhead: float = 1.0) -> AccessModel:
    """Flat SELL-C as a composite (gather + ``index_add_``) streams one extra
    row id per stored element on top of the column index; ``overhead``
    scales the whole per-element stream cost by the measured execution
    deficit of that formulation (``sell_flat_overhead``)."""
    return replace(am, value_bytes=am.value_bytes * overhead,
                   index_bytes=2 * am.index_bytes * overhead)


def balance_slab(pack: str, am: AccessModel, pad_ratio: float,
                 nnz_per_row: float) -> float:
    """Balance of one distributed slab pack: padded-ELL pays the partition's
    padding ratio; flat SELL pays only per-chunk padding but adds the
    row-index stream of a segment-sum."""
    if pack == "ell":
        return balance_ell(am, pad_ratio, nnz_per_row)
    if pack == "sell":
        return balance_sell(flat_sell_access_model(am), pad_ratio, nnz_per_row)
    raise ValueError(f"unknown slab format {pack!r}")


def balance_bsr(am: AccessModel, block_shape: tuple[int, int], fill_ratio: float) -> float:
    """BSR: index traffic amortized over bm*bn, invec reuse factor bm inside
    a block (each x element feeds bm rows), a resvec tile load + store per
    block row.  ``fill_ratio`` = stored elements / true nnz (explicit zeros
    streamed and multiplied); balance is per *useful* Flop, so the streamed
    terms scale by it."""
    bm, bn = block_shape
    per_stored = (am.value_bytes + am.index_bytes / (bm * bn)
                  + am.value_bytes * am.invec_reuse / bm)  # stride 1 in the block
    per_stored += 2 * am.value_bytes / bn
    return per_stored * fill_ratio / 2.0


def balance_dia(am: AccessModel, n_diags: int, occupancy: float = 1.0,
                invec_cached: bool = True) -> float:
    """DIA: zero index traffic, stride-1 shifted invec reads.  Streams one
    val + one invec element per *stored* slot; unoccupied slots (zeros) are
    streamed too -> divide by occupancy.  If the invec working set stays in
    cache across diagonals, its traffic amortizes over n_diags."""
    invec = am.value_bytes * (1.0 / n_diags if invec_cached and n_diags > 0 else 1.0)
    per_stored = am.value_bytes + invec + 2 * am.value_bytes / max(1, n_diags)
    return per_stored / (occupancy * 2.0)


def balance_matrix_free(am: AccessModel, n_stored: int, n_rows: int,
                        nnz: int) -> float:
    """Matrix-free generated operator: zero index traffic and zero value
    traffic for generated diagonals.  What moves: the stored lanes
    (``n_stored * n_rows`` values), x once, and the result read + written."""
    streamed = am.value_bytes * (n_stored * n_rows + 3 * n_rows)
    return streamed / (2.0 * max(1, nnz))


# paper-calibrated presets ------------------------------------------------

PAPER_FP64 = AccessModel(value_bytes=8, index_bytes=4, line_elems=8)
#: 128-byte granule (the H100's L2 line) at f32
LINE128_FP32 = AccessModel(value_bytes=4, index_bytes=4, line_elems=32)


def value_bytes_of(fmt_obj) -> int:
    """itemsize of the container's *stored* value array (hybrid: SELL part);
    the per-group fp32 scale of int8/fp8 containers is ignored."""
    from . import formats as F

    if isinstance(fmt_obj, F.HybridDIA):
        fmt_obj = fmt_obj.rest
    if isinstance(fmt_obj, (F.MatrixFreeOperator, F.ElectronPhononOperator)):
        # generated-only operators store nothing; the widths follow the
        # declared storage precision (x / y / stored-lane streams)
        return int(F.VALUE_DTYPES.get(fmt_obj.value_dtype, torch.float32).itemsize)
    return int(F.container_values(fmt_obj).element_size())


def access_model_for(fmt_obj, chip: ChipSpec | None = None,
                     base: AccessModel | None = None) -> AccessModel:
    """An ``AccessModel`` whose ``value_bytes`` matches the container's
    stored dtype, with a 128-byte access granule.  ``chip`` is accepted for
    signature stability; the byte widths are chip-independent."""
    del chip
    vb = value_bytes_of(fmt_obj)
    b = base if base is not None else LINE128_FP32
    return replace(b, value_bytes=vb, line_elems=max(1, 128 // vb))


# ---------------------------------------------------------------------------
# roofline predictor
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Prediction:
    format: str
    balance_bytes_per_flop: float
    flops: float                 # useful Flops of one SpMV
    bytes_streamed: float
    time_s: float
    gflops: float
    cycles_per_element: float    # paper Fig 2/6 y-axis (at chip clock)
    bound: str                   # "memory" | "compute"


def predict(fmt: str, balance: float, nnz: int, chip: ChipSpec = H100,
            clock_hz: float | None = None) -> Prediction:
    """perf = min(peak, BW / balance); times for one SpMV of 2*nnz Flops.
    ``clock_hz`` sets the cycles-per-element column (default 1 GHz)."""
    flops = 2.0 * nnz
    bytes_streamed = balance * flops
    t_mem = bytes_streamed / chip.hbm_bytes_per_s
    t_cmp = flops / chip.peak_flops_fp32
    # floor for degenerate empty operands (0 flops in > 0 time)
    time_s = max(t_mem, t_cmp, 1e-30)
    clock = clock_hz if clock_hz is not None else 1e9
    return Prediction(
        format=fmt, balance_bytes_per_flop=balance, flops=flops,
        bytes_streamed=bytes_streamed, time_s=time_s,
        gflops=flops / time_s / 1e9,
        cycles_per_element=time_s / max(1, nnz) * clock,
        bound="memory" if t_mem >= t_cmp else "compute")


# ---------------------------------------------------------------------------
# SELL stream regimes
# ---------------------------------------------------------------------------


def ell_pad_ratio(row_lengths: np.ndarray) -> float:
    """ELL padding ratio (stored / nnz): every row padded to the longest."""
    ml = row_lengths.max() if row_lengths.size else 0
    mean = row_lengths.mean() if row_lengths.size else 1
    return float(ml / max(1e-9, mean))


#: registry backends whose SELL execution streams the *flat* chunk-local
#: layout (sum_c w_c * C elements, no row-id stream): the CUDA kernels and
#: the loop oracle.  The ``torch`` entry picks flat or the globally padded
#: (nc, W_max, C) views per container (``sell_xla_uses_flat``).
FLAT_SELL_BACKENDS = ("cuda", "loop_reference")

#: measured execution overhead of the flat (gather + ``index_add_``)
#: composite SELL relative to the padded gather + sum, per chip family, as a
#: multiplier on its per-element stream cost.  ``cpu`` is the reference's
#: calibration of the same predicate (4.5), kept so the port's CPU pick and
#: the reference's agree; ``tpu`` is the reference's; ``h100`` is measured
#: on the card by ``chip_smoke.py`` phase 7 as the flat form's time per
#: modelled byte over the padded form's (flat 0.5436 ms, padded 0.7496 ms:
#: 0.970; full Holstein surrogate, C = 8, the sigma ``select_sell_sigma``
#: picks, f32 values, f64 x; NVIDIA H100 80GB HBM3 at 700.00 W, the run
#: PERF.md section 6 calls chip run 2).
SELL_FLAT_OVERHEAD = {"cpu": 4.5, "tpu": 1.0, "h100": 0.97}


def sell_flat_overhead(family: str) -> float:
    """Flat-formulation overhead factor of a chip family (``chip_family``)."""
    return float(SELL_FLAT_OVERHEAD.get(family, 1.0))


def sell_xla_uses_flat(m, family: str) -> bool:
    """Does the ``torch`` SELL entry pick its *flat* (gather + ``index_add_``)
    formulation for this container on a chip of ``family``?  It does when
    the flat form's matrix bytes, charged at its measured overhead, are
    below the padded views'::

        flat * (vb + 2*ib) * overhead  <  padded * (vb + ib)

    The name is the reference's (its composite backend is XLA)."""
    flat = int(m.val.shape[0])
    cw = m.chunk_width
    wmax = int(cw.max()) if cw.numel() else 1
    padded = int(m.n_chunks * wmax * m.C)
    am = access_model_for(m)
    vb, ib = am.value_bytes, am.index_bytes
    return flat * (vb + 2 * ib) * sell_flat_overhead(family) < padded * (vb + ib)


def sell_streamed_elements(m, backend: str = "torch", chip: ChipSpec = H100) -> int:
    """Stored elements one SpMV streams for a ``SELL`` container under
    ``backend`` on ``chip`` (flat chunk-local vs globally padded)."""
    flat = int(m.val.shape[0])
    if backend in FLAT_SELL_BACKENDS:
        return flat
    if backend == "torch" and sell_xla_uses_flat(m, chip_family(chip)):
        return flat
    cw = m.chunk_width
    wmax = int(cw.max()) if cw.numel() else 1
    return int(m.n_chunks * wmax * m.C)


def sell_stream_am(m, am: AccessModel, backend: str = "torch",
                   chip: ChipSpec = H100) -> AccessModel:
    """The access model the executed SELL regime streams with: the flat
    composite adds the row-id stream, charged at its measured overhead on
    ``chip``'s family; the padded composite and the kernels stream
    physically."""
    family = chip_family(chip)
    if backend == "torch" and sell_xla_uses_flat(m, family):
        return flat_sell_access_model(am, sell_flat_overhead(family))
    return am


def sell_padded_view_ratio(row_lengths: np.ndarray, C: int) -> float:
    """Padding ratio (streamed / nnz) of the globally padded SELL views:
    every chunk is padded to the longest row."""
    n = len(row_lengths)
    if n == 0:
        return 1.0
    n_pad = -(-n // C) * C
    wmax = int(row_lengths.max())
    return n_pad * wmax / max(1, int(row_lengths.sum()))


def sell_pad_ratio(row_lengths: np.ndarray, C: int, sigma: int) -> float:
    """Exact padding ratio of SELL-C-sigma for the given row lengths."""
    n = len(row_lengths)
    if n == 0:
        return 1.0
    lens = row_lengths.astype(np.int64).copy()
    out = np.empty_like(lens)
    for s in range(0, n, max(1, sigma)):
        e = min(s + sigma, n)
        out[s:e] = np.sort(lens[s:e])[::-1]
    n_pad = -(-n // C) * C
    padded = np.zeros(n_pad, dtype=np.int64)
    padded[:n] = out
    widths = padded.reshape(-1, C).max(axis=1)
    stored = int((widths * C).sum())
    return stored / max(1, int(lens.sum()))


def sell_sigma_candidates(n_rows: int, C: int = 8) -> tuple:
    """Candidate sorting windows: identity (1), chunk-local (C), 64, the
    default window, and the full JDS sort (n), clipped to [1, n_rows]."""
    from . import formats as F

    n = max(1, int(n_rows))
    cands = {1, int(C), 64, F.DEFAULT_SELL_SIGMA, n}
    return tuple(sorted({max(1, min(n, s)) for s in cands}))


def select_sell_sigma(row_lengths, C: int = 8,
                      candidates=None) -> tuple[int, float]:
    """The sorting window of least flat padding ratio, and that ratio; ties
    go to the smaller window (less reordering)."""
    lens = np.asarray(row_lengths)
    n = len(lens)
    if candidates is None:
        candidates = sell_sigma_candidates(n, C)
    best_s, best_r = 1, None
    for s in candidates:            # ascending: ties keep the smaller sigma
        r = sell_pad_ratio(lens, C, int(s))
        if best_r is None or r < best_r - 1e-12:
            best_s, best_r = int(s), r
    return best_s, float(best_r if best_r is not None else 1.0)


def advise(stats: dict, row_lengths: np.ndarray, am: AccessModel = LINE128_FP32,
           C: int = 8, sigma: int | None = None, chip: ChipSpec = H100) -> dict:
    """Rank formats by predicted SpMV time from pattern statistics alone
    (``stats`` from ``formats.matrix_stats``).  Returns {format:
    Prediction} plus '_best'."""
    nnz = int(stats["nnz"])
    npr = float(stats["nnz_per_row_mean"])
    mean_stride = max(1.0, float(stats["mean_inner_stride"]))
    am_eff = replace(am, invec_waste=waste_from_stride(mean_stride, am.line_elems))
    sig = sigma if sigma is not None else len(row_lengths)
    preds = {
        "csr": predict("csr", balance_csr(am_eff, npr), nnz, chip),
        "jds": predict("jds", balance_jds(am_eff), nnz, chip),
        "ell": predict("ell", balance_ell(am_eff, ell_pad_ratio(row_lengths), npr), nnz, chip),
        "sell": predict("sell", balance_sell(am_eff, sell_pad_ratio(row_lengths, C, sig), npr),
                        nnz, chip),
    }
    frac_diag = float(stats.get("frac_nnz_top12_diags", 0.0))
    if frac_diag > 0.3:
        b_dia = balance_dia(am_eff, 12, occupancy=0.9)
        rest_pad = sell_pad_ratio(row_lengths, C, sig)  # approx: same distribution
        b_rest = balance_sell(am_eff, rest_pad, npr * (1 - frac_diag))
        preds["hybrid"] = predict("hybrid", frac_diag * b_dia + (1 - frac_diag) * b_rest,
                                  nnz, chip)
    best = min(preds, key=lambda k: preds[k].time_s)
    out = dict(preds)
    out["_best"] = best
    return out


def balance_of(fmt_obj, am: AccessModel | None = None, backend: str = "torch",
               chip: ChipSpec = H100) -> float:
    """Algorithmic balance (bytes/Flop) of a concrete converted container;
    pad ratios are exact.  ``backend`` selects the stream-byte regime and
    ``chip`` the family whose ``torch`` SELL form it prices (both matter
    for SELL only); ``am=None`` takes byte widths from the stored dtype."""
    from . import formats as F

    if am is None:
        am = access_model_for(fmt_obj)
    if isinstance(fmt_obj, F.CSR):
        return balance_csr(am, fmt_obj.nnz / max(1, fmt_obj.shape[0]))
    if isinstance(fmt_obj, F.COO):
        per_elem = (am.value_bytes + 2 * am.index_bytes
                    + am.invec_bytes_per_access() + 2 * am.value_bytes)
        return per_elem / 2.0
    if isinstance(fmt_obj, F.ELL):
        stored = int(fmt_obj.val.numel())
        npr = fmt_obj.nnz / max(1, fmt_obj.shape[0])
        return balance_ell(am, stored / max(1, fmt_obj.nnz), npr)
    if isinstance(fmt_obj, F.JDS):
        return balance_jds(am)
    if isinstance(fmt_obj, F.SELL):
        stored = sell_streamed_elements(fmt_obj, backend, chip)
        npr = fmt_obj.nnz / max(1, fmt_obj.shape[0])
        return balance_sell(sell_stream_am(fmt_obj, am, backend, chip),
                            stored / max(1, fmt_obj.nnz), npr)
    if isinstance(fmt_obj, F.BSR):
        return balance_bsr(am, fmt_obj.block_shape, fill_ratio=1.0)
    if isinstance(fmt_obj, F.DIA):
        stored = int(fmt_obj.data.numel())
        nd = max(1, int(fmt_obj.offsets.shape[0]))
        occ = fmt_obj.nnz / max(1, stored)
        return balance_dia(am, nd, occupancy=max(1e-3, occ))
    if isinstance(fmt_obj, F.MatrixFreeOperator):
        return balance_matrix_free(am, fmt_obj.n_stored, fmt_obj.shape[0], fmt_obj.nnz)
    if isinstance(fmt_obj, F.ElectronPhononOperator):
        return balance_matrix_free(am, 0, fmt_obj.shape[0], fmt_obj.nnz)
    if isinstance(fmt_obj, F.HybridDIA):
        n_dia, n_rest = fmt_obj.dia.nnz, fmt_obj.rest.nnz
        total = max(1, n_dia + n_rest)
        return (n_dia * balance_of(fmt_obj.dia, am)
                + n_rest * balance_of(fmt_obj.rest, am, backend, chip)) / total
    raise TypeError(type(fmt_obj))


# ---------------------------------------------------------------------------
# concrete-container format selection
# ---------------------------------------------------------------------------

#: Fraction of the memory rate each formulation achieves relative to the
#: byte model, per chip family.  ``tpu`` and ``cpu`` are the reference's
#: tables (kept so that the port's picks on those families equal the
#: reference's).  ``h100`` prices, per format, the backend that
#: ``backend="auto"`` runs on the card: the CUDA kernel for csr, sell,
#: dia, hybrid, matrix_free and bsr, the composite ``torch`` entry for ell
#: and jds (no kernel).  Each value is the achieved efficiency as
#: ``fit_efficiency_from_db`` defines it -- the model's time at efficiency
#: 1 with the measured STREAM-triad bandwidth (3.011 TB/s), over the
#: measured plan time (CUDA events) -- as the geometric mean over the
#: full-size matrices of ``chip_smoke.py`` phase 7 where the format is a
#: candidate (the Holstein surrogate N = 1,201,200, laplacian_2d(1100,
#: 1100), power_law_rows at 1,048,576 rows; the L = 4 exact matrix, 9,492
#: nnz, measures launch latency and is left out); NVIDIA H100 80GB HBM3 at
#: 700.00 W, the run PERF.md section 6 calls chip run 2 (of PR 12).  bsr
#: is fitted the same way on ``block_sparse_dense(8192, 8192, (8, 128),
#: 0.25, seed=4)`` with an f64 x (``chip_smoke.py`` phase 9, BELL kernel,
#: 3.067 TB/s measured; chip run 4 of PR 13 on the same card and limit).
#: csr is refitted for the row-block CSR kernel: 0.645, the ``fitted_h100``
#: geomean of ``chip_smoke.py`` phase 7 on the same card and limit (3.063
#: TB/s measured; surrogate 0.705, laplacian 1.202, power law 0.318), the
#: run PERF.md section 6 records as the first of that kernel.  bsr is
#: refitted for the ring BELL kernel: 0.683, ``fitted_h100_bsr`` of
#: ``chip_smoke.py`` phase 9c on the same card and limit (3.057 TB/s
#: measured), the run PERF.md section 6 records for that kernel.  sell is
#: refitted for the chunk-block SELL kernel: 0.567, the ``fitted_h100``
#: geomean of phase 7 on the same card and limit (3.026 TB/s measured;
#: surrogate 0.519, laplacian 0.938, power law 0.374), the run PERF.md
#: section 6 records for that kernel.  hybrid keeps 0.421: its refit there
#: (0.459, from surrogate 0.395 and laplacian 0.533) would make
#: ``format="auto"`` pick the hybrid plan on the surrogate, 26 % slower
#: than the csr plan.  matrix_free is refitted for the MfLaunch kernel
#: (x unpadded, no pad copy a call): 0.802, the ``fitted_h100`` value of
#: phase 7 on the same card and limit (3.033 TB/s measured), where the
#: format is a candidate on one full-size matrix, laplacian_2d(1100,
#: 1100); the run PERF.md section 6 calls chip run 2 of PR 17.
EXEC_EFFICIENCY = {
    "tpu": {
        "csr": 0.10, "coo": 0.08, "jds": 0.15, "ell": 0.90,
        "sell": 0.60, "hybrid": 0.50, "dia": 0.80, "bsr": 0.80,
        "matrix_free": 0.85,
    },
    "cpu": {
        "csr": 0.08, "coo": 0.05, "jds": 0.085, "ell": 1.00,
        "sell": 0.29, "hybrid": 0.065, "dia": 0.19, "bsr": 0.90,
        "matrix_free": 0.90,
    },
    "h100": {
        "csr": 0.645, "jds": 0.201, "ell": 0.280,
        "sell": 0.567, "hybrid": 0.421, "dia": 0.619,
        "matrix_free": 0.802, "bsr": 0.683,
    },
}

#: chip-name substrings that resolve to the ``cpu`` table
CPU_CHIP_MARKERS = ("cpu", "host", "woodcrest", "shanghai", "nehalem", "x86")
#: chip-name substrings that resolve to the ``h100`` table
H100_CHIP_MARKERS = ("h100", "hopper")
#: family of an unknown accelerator (the reference's rule)
DEFAULT_CHIP_FAMILY = "tpu"


def chip_family(chip: ChipSpec | None) -> str:
    """Resolve a chip to its ``EXEC_EFFICIENCY`` family (never raises): an
    H100 name is ``h100``; otherwise the reference's rule -- ``"tpu"`` in
    the name wins, the CPU markers give ``cpu``, anything else ``tpu``."""
    name = chip.name.lower() if chip is not None else ""
    if any(marker in name for marker in H100_CHIP_MARKERS):
        return "h100"
    if "tpu" in name:
        return "tpu"
    if any(marker in name for marker in CPU_CHIP_MARKERS):
        return "cpu"
    return DEFAULT_CHIP_FAMILY


def exec_efficiency(chip: ChipSpec) -> dict:
    """The formulation-efficiency table matching a chip family."""
    return EXEC_EFFICIENCY[chip_family(chip)]


@dataclass(frozen=True)
class FormatChoice:
    """Outcome of ``select_format``: the pick (a ``formats.convert`` key),
    the predicted seconds of every candidate (a warm pick: the measured
    seconds the tuning DB recorded), the conversion kwargs of the pick, the
    ``matrix_stats`` snapshot used, the balance (bytes/Flop) of every
    candidate with the conversion kwargs that packs it (cold path only),
    and ``source``: ``"model"`` (cold path) or ``"measured"`` (a fresh
    tuning-DB entry decided)."""

    format: str
    predicted_time_s: dict
    convert_kwargs: dict
    stats: dict
    balances: dict = field(default_factory=dict)
    candidate_kwargs: dict = field(default_factory=dict)
    source: str = "model"


def predict_exec(fmt: str, balance: float, nnz: int, chip: ChipSpec = H100,
                 efficiency: dict | None = None) -> Prediction:
    """``predict`` with the formulation's achievable-bandwidth derating."""
    eff = (efficiency if efficiency is not None
           else exec_efficiency(chip)).get(fmt, 1.0)
    derated = replace(chip, hbm_bytes_per_s=chip.hbm_bytes_per_s * eff)
    return predict(fmt, balance, nnz, chip=derated)


def resolve_stream_backend(backend: str = "auto", device=None) -> str:
    """The stream-byte regime of the default executor: ``cuda`` on a CUDA
    device, ``torch`` elsewhere (``device=None``: on the card when there is
    one)."""
    if backend != "auto":
        return backend
    if device is None:
        return "cuda" if torch.cuda.is_available() else "torch"
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def select_format(m, *, am: AccessModel | None = None, chip: ChipSpec = H100,
                  C: int = 8, sigma: int | None = None, allowed=None,
                  efficiency: dict | None = None, max_dia_diags: int = 256,
                  bsr_block: tuple[int, int] = (8, 128),
                  backend: str = "auto", device=None, tuning=None) -> FormatChoice:
    """Pick the storage format for a concrete CSR/COO container: exact pad
    ratios, counted diagonal occupancy, matrix-free detection, counted BSR
    block fill, and every candidate's balance through the execution-aware
    roofline (``predict_exec``).  BSR is a candidate when the shape tiles by
    ``bsr_block`` and the populated blocks are at least a quarter full.

    ``backend`` is the stream-byte regime (``"auto"`` = the executor on
    ``device``; see ``resolve_stream_backend``).  ``sigma=None`` autotunes
    the SELL window (``select_sell_sigma``).

    ``tuning`` (a ``core.tunedb.TuneDB`` or a path to one) is the measured
    warm path: an entry of this matrix's signature, keyed by ``chip``'s
    family, the platform of ``device`` and the stored value dtype, whose
    candidates are still buildable there, decides the pick directly -- the
    measured-fastest format within ``allowed`` (``source ==
    "measured"``).  Without such an entry the DB's refitted efficiencies,
    if it holds any for the family and no ``efficiency`` is given, refine
    the roofline ranking.  ``tuning=None`` is the cold path.
    """
    from . import formats as F

    if isinstance(m, F.COO):
        m = F.CSR.from_coo(m)
    if not isinstance(m, F.CSR):
        name = {v: k for k, v in F.FORMATS.items()}.get(type(m))
        if name is None:
            raise TypeError(f"select_format: unsupported container {type(m).__name__}")
        return FormatChoice(name, {}, {}, {})

    if tuning is not None:
        from . import tunedb as TDB
        db = TDB.open_db(tuning)
        hit = db.lookup_format(m, chip=chip, allowed=allowed, device=device)
        if hit is not None:
            fmt, kw, times = hit
            return FormatChoice(fmt, times, kw, F.matrix_stats(m), source="measured")
        if efficiency is None:
            efficiency = db.efficiency_for(chip)

    if am is None:
        am = access_model_for(m)
    stats = F.matrix_stats(m)
    lens = m.row_lengths()
    nnz = max(1, m.nnz)
    npr = float(stats["nnz_per_row_mean"])
    if sigma is None:
        sig, flat_ratio = select_sell_sigma(lens, C)
    else:
        sig = max(1, min(m.shape[0], int(sigma)))
        flat_ratio = sell_pad_ratio(lens, C, sig)
    be = resolve_stream_backend(backend, device)
    if be in FLAT_SELL_BACKENDS:
        sell_ratio, am_sell = flat_ratio, am
    else:
        # pattern-level mirror of sell_xla_uses_flat
        padded_ratio = sell_padded_view_ratio(lens, C)
        vb, ib = am.value_bytes, am.index_bytes
        ovh = sell_flat_overhead(chip_family(chip))
        if flat_ratio * (vb + 2 * ib) * ovh < padded_ratio * (vb + ib):
            sell_ratio, am_sell = flat_ratio, flat_sell_access_model(am, ovh)
        else:
            sell_ratio, am_sell = padded_ratio, am

    balances = {
        "csr": balance_csr(am, npr),
        "jds": balance_jds(am),
        "ell": balance_ell(am, ell_pad_ratio(lens), npr),
        "sell": balance_sell(am_sell, sell_ratio, npr),
    }
    kwargs = {"csr": {}, "jds": {}, "ell": {}, "sell": {"C": C, "sigma": int(sig)}}

    coo = m.to_coo()
    offs = F._np(coo.cols).astype(np.int64) - F._np(coo.rows).astype(np.int64)
    n_diags = len(np.unique(offs))

    frac_diag = float(stats.get("frac_nnz_top12_diags", 0.0))
    if frac_diag > 0.3:
        b_dia = balance_dia(am, 12, occupancy=0.9)
        b_rest = balance_sell(am_sell, sell_ratio, npr * (1 - frac_diag))
        balances["hybrid"] = frac_diag * b_dia + (1 - frac_diag) * b_rest
        kwargs["hybrid"] = {"C": C, "sigma": int(sig)}

    # pure DIA only for a narrow, reasonably full diagonal profile
    if 0 < n_diags <= max_dia_diags:
        stored = n_diags * min(m.shape)
        occ = nnz / max(1, stored)
        if occ >= 0.2:
            balances["dia"] = balance_dia(am, n_diags, occupancy=occ)
            kwargs["dia"] = {}

    # matrix-free: detection-gated, stored lanes at least 20 % occupied
    if 0 < n_diags <= max_dia_diags:
        mf = F.detect_matrix_free(m, max_diags=max_dia_diags)
        if mf is not None and (
                mf.n_stored == 0
                or mf.stored_nnz / (mf.n_stored * m.shape[0]) >= 0.2):
            balances["matrix_free"] = balance_matrix_free(am, mf.n_stored, m.shape[0], nnz)
            kwargs["matrix_free"] = {}

    # BSR: only when the shape tiles exactly and populated blocks are full
    bm, bn = bsr_block
    if m.shape[0] % bm == 0 and m.shape[1] % bn == 0 and nnz > 0:
        rows = F._np(coo.rows).astype(np.int64)
        cols = F._np(coo.cols).astype(np.int64)
        blocks = np.unique(rows // bm * (m.shape[1] // bn) + cols // bn)
        fill = nnz / (len(blocks) * bm * bn)
        if fill >= 0.25:
            balances["bsr"] = balance_bsr(am, bsr_block, fill_ratio=1.0 / fill)
            kwargs["bsr"] = {"block_shape": tuple(bsr_block)}

    if allowed is not None:
        allowed = set(allowed)
        balances = {k: v for k, v in balances.items() if k in allowed}
        if not balances:
            raise ValueError(f"no candidate formats left after allowed={sorted(allowed)}")
    preds = {fmt: predict_exec(fmt, b, nnz, chip=chip, efficiency=efficiency).time_s
             for fmt, b in balances.items()}
    best = min(preds, key=preds.get)
    return FormatChoice(best, preds, kwargs[best], stats, balances=balances,
                        candidate_kwargs={f: kwargs[f] for f in balances})


def fit_efficiency_from_db(db, *, chip: ChipSpec | None = None,
                           family: str | None = None,
                           clamp: tuple = (0.01, 1.5)) -> dict:
    """Refit the ``EXEC_EFFICIENCY`` factors from tuning-DB measurements.

    Every recorded candidate achieved ``t_model_eff1_s / t_measured_s`` of
    the modelled bandwidth; per format the fitted factor is the geometric
    mean of those over matrices and backends, clamped to ``clamp``.  Only
    entries of the requested family count (``family`` wins over ``chip``;
    default: the family of ``H100``); formats with no measurement keep the
    committed value, so the table is complete.

    Returns:
        {format: efficiency} -- the committed table overlaid with the fit.
    """
    fam = family if family is not None else chip_family(chip or H100)
    ratios: dict[str, list] = {}
    for entry in db.entries.values():
        if entry.get("chip_family") != fam:
            continue
        for c in entry.get("candidates", ()):
            t, t1 = c.get("t_measured_s"), c.get("t_model_eff1_s")
            if t and t1 and t > 0 and t1 > 0:
                ratios.setdefault(c["format"], []).append(t1 / t)
    fitted = dict(EXEC_EFFICIENCY.get(fam, EXEC_EFFICIENCY[DEFAULT_CHIP_FAMILY]))
    lo, hi = clamp
    for fmt, rs in ratios.items():
        geo = float(np.exp(np.mean(np.log(rs))))
        fitted[fmt] = float(np.clip(geo, lo, hi))
    return fitted


# ---------------------------------------------------------------------------
# SpMM batching model
# ---------------------------------------------------------------------------


def matrix_stream_bytes(fmt_obj, am: AccessModel | None = None,
                        backend: str = "torch", chip: ChipSpec = H100) -> float:
    """Bytes of the *matrix* stream alone (values + indices, padding
    included): the traffic an SpMM with k right-hand sides streams once."""
    from . import formats as F

    if am is None:
        am = access_model_for(fmt_obj)
    if isinstance(fmt_obj, (F.CSR, F.JDS)):
        return float((am.value_bytes + am.index_bytes) * fmt_obj.nnz)
    if isinstance(fmt_obj, F.COO):
        return float((am.value_bytes + 2 * am.index_bytes) * fmt_obj.nnz)
    if isinstance(fmt_obj, F.ELL):
        return float((am.value_bytes + am.index_bytes) * int(fmt_obj.val.numel()))
    if isinstance(fmt_obj, F.SELL):
        stored = sell_streamed_elements(fmt_obj, backend, chip)
        am_s = sell_stream_am(fmt_obj, am, backend, chip)
        return float((am_s.value_bytes + am_s.index_bytes) * stored)
    if isinstance(fmt_obj, F.BSR):
        bm, bn = fmt_obj.block_shape
        return float((am.value_bytes * bm * bn + am.index_bytes) * fmt_obj.n_blocks)
    if isinstance(fmt_obj, F.DIA):
        nd, n = fmt_obj.data.shape
        return float(am.value_bytes * nd * n)
    if isinstance(fmt_obj, F.MatrixFreeOperator):
        return float(am.value_bytes * fmt_obj.n_stored * fmt_obj.shape[0])
    if isinstance(fmt_obj, F.HybridDIA):
        return (matrix_stream_bytes(fmt_obj.dia, am)
                + matrix_stream_bytes(fmt_obj.rest, am, backend, chip))
    raise TypeError(type(fmt_obj))


def spmm_balance_of(fmt_obj, k: int, am: AccessModel | None = None,
                    backend: str = "torch", chip: ChipSpec = H100) -> float:
    """Balance (bytes per Flop) of an SpMM at batch width ``k``: the matrix
    streamed once, the vector traffic k times::

        balance(k) = (matrix_bytes + k * vector_bytes) / (2 * nnz * k)
    """
    k = max(1, int(k))
    if am is None:
        am = access_model_for(fmt_obj)
    total1 = balance_of(fmt_obj, am, backend, chip) * 2.0 * fmt_obj.nnz
    mat = matrix_stream_bytes(fmt_obj, am, backend, chip)
    vec = max(0.0, total1 - mat)
    return (mat + k * vec) / (2.0 * fmt_obj.nnz * k)


@dataclass(frozen=True)
class BatchWidthChoice:
    """Outcome of ``select_batch_width``: the width, the candidates, the
    predicted throughput (queries/s) and balance per candidate, and the
    chosen width's share of the best throughput."""

    width: int
    widths: tuple
    throughput: dict
    balance: dict
    saturation: float


def select_batch_width(fmt_obj, *, am: AccessModel | None = None,
                       chip: ChipSpec = H100, k_max: int = 64,
                       efficiency: float = 0.9,
                       backend: str = "torch") -> BatchWidthChoice:
    """The smallest power-of-two width whose predicted throughput
    ``k / time(SpMM_k)`` reaches ``efficiency`` of the best candidate's."""
    if am is None:
        am = access_model_for(fmt_obj)
    ks = []
    k = 1
    while k < k_max:
        ks.append(k)
        k *= 2
    ks.append(k)
    qps, bal = {}, {}
    for k in ks:
        b = spmm_balance_of(fmt_obj, k, am, backend, chip)
        pred = predict("spmm", b, fmt_obj.nnz * k, chip=chip)
        bal[k] = b
        qps[k] = k / pred.time_s
    best = max(qps.values())
    width = next(k for k in ks if qps[k] >= efficiency * best)
    return BatchWidthChoice(width=width, widths=tuple(ks), throughput=qps,
                            balance=bal, saturation=qps[width] / best)


def spmv_streamed_bytes(fmt_obj, am: AccessModel | None = None,
                        backend: str = "torch",
                        generated_indices: bool = False,
                        chip: ChipSpec = H100) -> float:
    """Model-side byte count of one SpMV of a concrete container.
    ``generated_indices=True`` charges every index at 0 bytes (what a
    kernel recomputing ``col = row + offset`` would move)."""
    from . import formats as F

    if am is None:
        am = access_model_for(fmt_obj)
    if generated_indices:
        am = replace(am, index_bytes=0)
    vb = am.value_bytes
    if isinstance(fmt_obj, F.CSR):
        return (vb + am.index_bytes + am.invec_bytes_per_access()) * fmt_obj.nnz \
            + 2 * vb * fmt_obj.shape[0]
    if isinstance(fmt_obj, F.ELL):
        stored = int(fmt_obj.val.numel())
        return (vb + am.index_bytes + am.invec_bytes_per_access()) * stored \
            + 2 * vb * fmt_obj.shape[0]
    if isinstance(fmt_obj, F.JDS):
        return (vb + am.index_bytes + am.invec_bytes_per_access() + 2 * vb) * fmt_obj.nnz
    if isinstance(fmt_obj, F.SELL):
        stored = sell_streamed_elements(fmt_obj, backend, chip)
        am_s = sell_stream_am(fmt_obj, am, backend, chip)
        return (am_s.value_bytes + am_s.index_bytes
                + am_s.invec_bytes_per_access()) * stored + 2 * vb * fmt_obj.shape[0]
    if isinstance(fmt_obj, F.BSR):
        bm, bn = fmt_obj.block_shape
        return (vb * bm * bn + am.index_bytes + vb * bn + 2 * vb * bm) * fmt_obj.n_blocks
    if isinstance(fmt_obj, F.DIA):
        nd, n = fmt_obj.data.shape
        return vb * nd * n + vb * n + 2 * vb * n
    if isinstance(fmt_obj, F.MatrixFreeOperator):
        n = fmt_obj.shape[0]
        return vb * fmt_obj.n_stored * n + vb * n + 2 * vb * n
    if isinstance(fmt_obj, F.HybridDIA):
        return (spmv_streamed_bytes(fmt_obj.dia, am)
                + spmv_streamed_bytes(fmt_obj.rest, am, backend, chip=chip))
    raise TypeError(type(fmt_obj))
