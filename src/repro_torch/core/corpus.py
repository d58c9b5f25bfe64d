"""Matrix corpus: the named workloads the performance model is validated on.

Port of ``repro.core.corpus``: the same twelve deterministic specs, in the
same order, built by the port's own generators into the same arrays.  The
paper's claim is that the right storage scheme depends on the matrix --
its bandwidth, its nnz/row distribution, its cache footprint -- so the
corpus spans that range:

* physics     -- Holstein-Hubbard exact + scalable surrogate (paper Sec. 4.2)
* stencil     -- 2-D / 3-D Laplacians (narrow vs plane-wide bandwidth)
* banded      -- narrow dense band vs wide sparse band
* scalefree   -- power-law (Zipf) row lengths, the load-balance stressor
* blocked     -- dense (8,128) blocks on a sparse block grid (BSR turf)
* stripe      -- near-dense vertical stripe (constant row length)
* random      -- uniform random baseline
* mtx         -- MatrixMarket files via ``core.io.load_matrix`` (with a
                deterministic synthetic fallback when not on disk)

Every ``MatrixSpec`` names the candidate formats it is swept under;
``stats(name)`` reports the structural numbers the model reads.  Builds
are cached per name.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from . import io as mio
from .formats import CSR, DEFAULT_SELL_SIGMA, _np, matrix_stats
from .matrices import (
    HolsteinHubbardParams,
    block_sparse_dense,
    dense_stripe,
    holstein_hubbard_exact,
    holstein_hubbard_surrogate,
    laplacian_2d,
    laplacian_3d,
    power_law_rows,
    random_banded,
    random_sparse,
)
from .perfmodel import (
    ell_pad_ratio,
    select_sell_sigma,
    sell_pad_ratio,
    sell_sigma_candidates,
)

#: candidate formats every matrix is swept under unless the spec narrows it
BASE_FORMATS = ("csr", "ell", "jds", "sell", "hybrid")


@dataclass(frozen=True)
class MatrixSpec:
    """One named corpus workload.

    Attributes:
        name: registry key.
        family: regime tag ("physics", "stencil", "banded", ...).
        description: one-line provenance / what it stresses.
        build: zero-argument deterministic function returning a ``CSR``.
        formats: candidate formats (``formats.convert`` keys).
        sell_C / sell_sigma: SELL chunk geometry of the spec's conversions
            and occupancy statistic (``sell_sigma=None``: autotuned by
            ``perfmodel.select_sell_sigma``).
        convert_kwargs: per-format ``formats.convert`` overrides.
        matrix_free: the pattern is diagonal-structured enough for
            ``formats.MatrixFreeOperator``.
    """

    name: str
    family: str
    description: str
    build: Callable[[], CSR]
    formats: tuple = BASE_FORMATS
    sell_C: int = 8
    sell_sigma: int | None = None
    convert_kwargs: dict = field(default_factory=dict)
    matrix_free: bool = False

    def sell_kwargs(self) -> dict:
        return {"C": self.sell_C, "sigma": self.sell_sigma}


_REGISTRY: dict[str, MatrixSpec] = {}
_BUILD_CACHE: dict[str, CSR] = {}


def register(spec: MatrixSpec) -> MatrixSpec:
    """Add a spec to the registry (name must be unused)."""
    if spec.name in _REGISTRY:
        raise ValueError(f"corpus spec {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def names() -> list[str]:
    """Registered workload names, in registration order."""
    return list(_REGISTRY)


def get(name: str) -> MatrixSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown corpus matrix {name!r}; have {names()}") from None


def specs() -> list[MatrixSpec]:
    return list(_REGISTRY.values())


def build(name: str) -> CSR:
    """Build (or fetch the cached) CSR of a registered workload."""
    if name not in _BUILD_CACHE:
        _BUILD_CACHE[name] = get(name).build()
    return _BUILD_CACHE[name]


def clear_cache() -> None:
    _BUILD_CACHE.clear()


def matrix_free_names() -> list[str]:
    """Workloads flagged matrix-free-eligible, in registration order."""
    return [s.name for s in _REGISTRY.values() if s.matrix_free]


def matrix_free_operator(name: str, max_diags: int = 256):
    """The (cached) ``MatrixFreeOperator`` of an eligible workload; raises
    ``ValueError`` for a spec not flagged ``matrix_free``."""
    from .formats import detect_matrix_free
    if not get(name).matrix_free:
        raise ValueError(f"corpus matrix {name!r} is not matrix-free-eligible")
    op = detect_matrix_free(build(name), max_diags=max_diags)
    if op is None:
        raise ValueError(f"corpus matrix {name!r} is flagged matrix_free but "
                         "its pattern did not detect as structured")
    return op


# ---------------------------------------------------------------------------
# structural statistics (what the perfmodel sees)
# ---------------------------------------------------------------------------


def row_length_histogram(lens: np.ndarray) -> dict:
    """Power-of-two histogram of the nnz/row distribution: bin edges
    ``[0, 1, 2, 4, ..., 2^k]``, the last just above the longest row."""
    mx = int(lens.max()) if lens.size else 0
    edges = [0, 1]
    while edges[-1] <= mx:
        edges.append(edges[-1] * 2)
    counts, _ = np.histogram(lens, bins=edges)
    return {"edges": edges, "counts": counts.tolist()}


def corpus_stats(m: CSR, C: int = 8,
                 sigma: int | None = DEFAULT_SELL_SIGMA) -> dict:
    """``formats.matrix_stats`` plus the nnz/row histogram, the populated
    diagonal count, the ELL and SELL-C-sigma occupancies (useful fraction of
    streamed elements), the SELL occupancy over the autotuner's candidate
    windows and the window it picks."""
    s = dict(matrix_stats(m))
    lens = m.row_lengths()
    coo = m.to_coo()
    offs = _np(coo.cols).astype(np.int64) - _np(coo.rows).astype(np.int64)
    # SELL.from_csr's sigma=None resolution: the stats describe the packing
    # the conversion would execute
    sig = max(1, min(m.shape[0], DEFAULT_SELL_SIGMA)) if sigma is None \
        else max(1, min(m.shape[0], sigma))
    s["nnz_per_row_hist"] = row_length_histogram(lens)
    s["n_populated_diags"] = int(len(np.unique(offs)))
    s["ell_occupancy"] = 1.0 / max(1e-9, ell_pad_ratio(lens))
    s["sell_occupancy"] = 1.0 / max(1e-9, sell_pad_ratio(lens, C, sig))
    s["sell_C"] = C
    s["sell_sigma"] = sig
    s["sell_occupancy_vs_sigma"] = {
        int(cand): 1.0 / max(1e-9, sell_pad_ratio(lens, C, cand))
        for cand in sell_sigma_candidates(m.shape[0], C)}
    best_sig, _ = select_sell_sigma(lens, C)
    s["sell_best_sigma"] = int(best_sig)
    src = getattr(m, "_source", None)
    if src is not None:
        s["source"] = src
    return s


def stats(name: str) -> dict:
    """Structural statistics of a registered workload (builds if needed)."""
    spec = get(name)
    s = corpus_stats(build(name), C=spec.sell_C, sigma=spec.sell_sigma)
    s["matrix_free_eligible"] = spec.matrix_free
    return s


# ---------------------------------------------------------------------------
# the registered corpus, in the reference's order
# ---------------------------------------------------------------------------

register(MatrixSpec(
    name="holstein_exact",
    family="physics",
    description="exact Holstein-Hubbard Hamiltonian, L=4 chain (paper Sec. 4.2)",
    build=lambda: holstein_hubbard_exact(HolsteinHubbardParams()),
    matrix_free=True,
))

register(MatrixSpec(
    name="holstein_surrogate",
    family="physics",
    description="pattern-faithful Fig-5 surrogate at n=3000 (~14 nnz/row, "
                "60% of nnz in 12 secondary diagonals)",
    build=lambda: holstein_hubbard_surrogate(3000, seed=0),
))

register(MatrixSpec(
    name="laplace2d",
    family="stencil",
    description="5-point stencil on a 48x48 grid (narrow constant band)",
    build=lambda: laplacian_2d(48, 48),
    formats=BASE_FORMATS + ("dia",),
    matrix_free=True,
))

register(MatrixSpec(
    name="laplace3d",
    family="stencil",
    description="7-point stencil on a 13^3 grid (plane-wide bandwidth)",
    build=lambda: laplacian_3d(13, 13, 13),
    formats=BASE_FORMATS + ("dia",),
    matrix_free=True,
))

register(MatrixSpec(
    name="banded_narrow",
    family="banded",
    description="half-bandwidth 8, 90% occupied: DIA's home regime",
    build=lambda: random_banded(2048, 8, 0.9, seed=1),
    formats=BASE_FORMATS + ("dia",),
    matrix_free=True,
))

register(MatrixSpec(
    name="banded_wide",
    family="banded",
    description="half-bandwidth 48, 25% occupied: band too sparse for DIA",
    build=lambda: random_banded(2048, 48, 0.25, seed=2),
    formats=BASE_FORMATS + ("dia",),
    matrix_free=True,
))

register(MatrixSpec(
    name="powerlaw",
    family="scalefree",
    description="Zipf row lengths (alpha=1.5): the padding/load-balance "
                "stressor ELL collapses on",
    build=lambda: power_law_rows(2048, 2048, mean_nnz=10.0, seed=3, max_nnz=192),
))

register(MatrixSpec(
    name="blocksparse",
    family="blocked",
    description="dense (8,128) blocks at 25% block density: BSR turf "
                "(structured sparse weights)",
    build=lambda: CSR.from_dense(block_sparse_dense(1024, 1024, (8, 128), 0.25, seed=4)),
    formats=("csr", "ell", "sell", "bsr"),
))

register(MatrixSpec(
    name="stripe",
    family="stripe",
    description="near-dense vertical stripe of 24 columns + main diagonal: "
                "constant row length, fully reused gather window",
    build=lambda: dense_stripe(2048, 24, seed=5),
))

register(MatrixSpec(
    name="random_uniform",
    family="random",
    description="uniform random pattern, 12 nnz/row: the no-structure baseline",
    build=lambda: random_sparse(2048, 2048, 12, seed=6),
))

register(MatrixSpec(
    name="mtx_demo_lap",
    family="mtx",
    description="MatrixMarket file committed under data/corpus/ (gzip, "
                "symmetric header) -- exercises the .mtx load path",
    build=lambda: mio.load_matrix("demo_lap2d_24"),
    formats=("csr", "ell", "jds", "sell", "dia"),
    matrix_free=True,
))

register(MatrixSpec(
    name="mtx_fallback_band",
    family="mtx",
    description="named .mtx entry NOT on disk: deterministic synthetic "
                "fallback seeded from the name (core.io.synthetic_fallback)",
    build=lambda: mio.load_matrix("external_band_1024", fallback_n=1024),
    formats=BASE_FORMATS + ("dia",),
    matrix_free=True,
))
