"""Test matrices: the paper's Holstein-Hubbard Hamiltonian and synthetic
patterns.  Host numpy code, producing byte-for-byte the patterns of
``repro.core.matrices``.

* ``holstein_hubbard_exact`` -- the real model Hamiltonian on an L-site
  chain with a truncated phonon space; small enough for dense
  diagonalization, so it validates the eigensolver.
* ``holstein_hubbard_operator`` -- the same Hamiltonian as the tables of
  its model (``formats.ElectronPhononOperator``), built without a CSR: the
  ``mf_product`` kernels generate its entries; ``build_stats`` counts its
  builds.
* ``holstein_hubbard_surrogate`` -- the Fig. 5 statistics at any N: ~14
  nnz/row, ~60 % of nnz in 12 dense secondary diagonals, the rest scattered
  over a band, symmetric.
* ``laplacian_2d``, ``laplacian_3d`` and ``power_law_rows`` -- the 5- and
  7-point stencils and the load-imbalance stressor.
* ``random_sparse``, ``random_banded`` and ``dense_stripe`` -- the
  corpus's no-structure baseline, random bands and near-dense stripe.
* ``block_sparse_dense`` -- a dense array with random dense-block support,
  the pattern BSR stores without padding.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.spans import span
from .formats import COO, CSR, ElectronPhononOperator


def _fermion_basis(L: int, n: int) -> np.ndarray:
    """All L-bit masks with n bits set, ascending."""
    return np.asarray([m for m in range(1 << L) if bin(m).count("1") == n],
                      dtype=np.int64)


def _hop_sign(state: int, i: int, j: int) -> int:
    """Fermionic sign for c+_j c_i (i occupied, j empty), Jordan-Wigner."""
    lo, hi = (i, j) if i < j else (j, i)
    mask = ((1 << hi) - 1) ^ ((1 << (lo + 1)) - 1)  # bits strictly between
    return -1 if bin(state & mask).count("1") % 2 else 1


@dataclass(frozen=True)
class HolsteinHubbardParams:
    L: int = 4          # chain sites
    n_up: int = 1
    n_dn: int = 1
    max_phonon: int = 2  # per-site phonon cutoff
    max_total_phonon: int | None = None  # optional global cutoff
    t: float = 1.0
    U: float = 4.0
    g: float = 0.5
    omega0: float = 1.0
    periodic: bool = True


def holstein_hubbard_exact(p: HolsteinHubbardParams = HolsteinHubbardParams()) -> CSR:
    """The exact Hamiltonian in CSR (f64, symmetric)."""
    L = p.L
    ups = _fermion_basis(L, p.n_up)
    dns = _fermion_basis(L, p.n_dn)
    up_index = {int(s): k for k, s in enumerate(ups)}
    dn_index = {int(s): k for k, s in enumerate(dns)}
    phonons = [
        ph
        for ph in itertools.product(range(p.max_phonon + 1), repeat=L)
        if p.max_total_phonon is None or sum(ph) <= p.max_total_phonon
    ]
    ph_index = {ph: k for k, ph in enumerate(phonons)}
    n_dn_s, n_ph = len(dns), len(phonons)
    dim = len(ups) * n_dn_s * n_ph

    def idx(iu: int, idn: int, ip: int) -> int:
        return (iu * n_dn_s + idn) * n_ph + ip

    rows: list[int] = []
    cols: list[int] = []
    vals: list[float] = []

    def add(r: int, c: int, v: float):
        if v != 0.0:
            rows.append(r)
            cols.append(c)
            vals.append(v)

    bonds = [(i, i + 1) for i in range(L - 1)]
    if p.periodic and L > 2:
        bonds.append((L - 1, 0))

    for iu, su in enumerate(ups):
        su = int(su)
        for idn, sd in enumerate(dns):
            sd = int(sd)
            n_docc = bin(su & sd).count("1")
            n_el_site = [((su >> i) & 1) + ((sd >> i) & 1) for i in range(L)]
            for ip, ph in enumerate(phonons):
                r = idx(iu, idn, ip)
                # diagonal: U double occupancy + phonon energy
                add(r, r, p.U * n_docc + p.omega0 * sum(ph))
                # electron-phonon coupling: g*w0*(b+ + b)_i * n_i
                for i in range(L):
                    if n_el_site[i] == 0:
                        continue
                    amp = p.g * p.omega0 * n_el_site[i]
                    if ph[i] < p.max_phonon:
                        ph2 = ph[:i] + (ph[i] + 1,) + ph[i + 1:]
                        ip2 = ph_index.get(ph2)
                        if ip2 is not None:
                            add(r, idx(iu, idn, ip2), amp * np.sqrt(ph[i] + 1))
                    if ph[i] > 0:
                        ph2 = ph[:i] + (ph[i] - 1,) + ph[i + 1:]
                        ip2 = ph_index.get(ph2)
                        if ip2 is not None:
                            add(r, idx(iu, idn, ip2), amp * np.sqrt(ph[i]))
                # hopping, both spins
                for (a, b) in bonds:
                    for (src, dst) in ((a, b), (b, a)):
                        if (su >> src) & 1 and not (su >> dst) & 1:
                            s2 = su ^ (1 << src) ^ (1 << dst)
                            add(r, idx(up_index[s2], idn, ip),
                                -p.t * _hop_sign(su, src, dst))
                        if (sd >> src) & 1 and not (sd >> dst) & 1:
                            s2 = sd ^ (1 << src) ^ (1 << dst)
                            add(r, idx(iu, dn_index[s2], ip),
                                -p.t * _hop_sign(sd, src, dst))

    return CSR.from_coo(COO(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                            np.asarray(vals, np.float64), (dim, dim)))


_BUILDS = {"builds": 0, "build_s": 0.0, "table_bytes": 0}
_BUILDS_LOCK = threading.Lock()


def build_stats() -> dict:
    """{"builds": operators built by :func:`holstein_hubbard_operator`,
    "build_s": their host seconds, "table_bytes": the bytes of their tables}
    since the last :func:`reset_build_stats`."""
    with _BUILDS_LOCK:
        return dict(_BUILDS)


def reset_build_stats() -> None:
    with _BUILDS_LOCK:
        _BUILDS.update(builds=0, build_s=0.0, table_bytes=0)


def _phonon_ladder(L: int, max_phonon: int, max_total: int | None):
    """The phonon states in ``itertools.product`` order after the total cap,
    (n_ph, L), and for each state and site the rank of the state with one
    phonon more and one less, -1 outside the basis."""
    full = np.indices((max_phonon + 1,) * L, dtype=np.int64).reshape(L, -1).T
    keep = (np.ones(len(full), bool) if max_total is None
            else full.sum(axis=1) <= max_total)
    ph = full[keep]
    rank = np.full(len(full), -1, np.int64)
    rank[keep] = np.arange(len(ph))
    stride = (max_phonon + 1) ** np.arange(L - 1, -1, -1, dtype=np.int64)
    fid = np.flatnonzero(keep)[:, None]   # each kept state's place in the product
    can_up, can_dn = ph < max_phonon, ph > 0
    up = np.where(can_up, rank[np.where(can_up, fid + stride, 0)], -1)
    dn = np.where(can_dn, rank[np.where(can_dn, fid - stride, 0)], -1)
    return ph, up, dn


def holstein_hubbard_operator(
        p: HolsteinHubbardParams = HolsteinHubbardParams()) -> ElectronPhononOperator:
    """The Hamiltonian of ``holstein_hubbard_exact(p)`` as its model's tables
    (``formats.ElectronPhononOperator``): the same rows, in the same order,
    and the same values, with no CSR built.  The build is the
    ``operator.build`` span and counts in :func:`build_stats`."""
    with span("operator.build"):
        t0 = time.perf_counter()
        L = p.L
        ups, dns = _fermion_basis(L, p.n_up), _fermion_basis(L, p.n_dn)
        up_index = {int(s): k for k, s in enumerate(ups)}
        dn_index = {int(s): k for k, s in enumerate(dns)}
        n_dn_s = len(dns)
        n_el = len(ups) * n_dn_s
        bonds = [(i, i + 1) for i in range(L - 1)]
        if p.periodic and L > 2:
            bonds.append((L - 1, 0))

        docc = np.zeros(n_el, np.int64)
        el_occ = np.zeros((n_el, L), np.int32)
        hops: list[list[tuple[int, float]]] = []
        for iu, su in enumerate(ups):
            su = int(su)
            for idn, sd in enumerate(dns):
                sd = int(sd)
                e = iu * n_dn_s + idn
                docc[e] = bin(su & sd).count("1")
                el_occ[e] = [((su >> i) & 1) + ((sd >> i) & 1) for i in range(L)]
                mine = []
                # the CSR builder's order: bond by bond, both directions, up then down
                for (a, b) in bonds:
                    for (src, dst) in ((a, b), (b, a)):
                        if (su >> src) & 1 and not (su >> dst) & 1:
                            s2 = su ^ (1 << src) ^ (1 << dst)
                            mine.append((up_index[s2] * n_dn_s + idn,
                                         -p.t * _hop_sign(su, src, dst)))
                        if (sd >> src) & 1 and not (sd >> dst) & 1:
                            s2 = sd ^ (1 << src) ^ (1 << dst)
                            mine.append((iu * n_dn_s + dn_index[s2],
                                         -p.t * _hop_sign(sd, src, dst)))
                hops.append([h for h in mine if h[1] != 0.0])
        width = max((len(h) for h in hops), default=0)
        hop_target = np.full((n_el, width), -1, np.int32)
        hop_value = np.zeros((n_el, width), np.float64)
        for e, mine in enumerate(hops):
            for k, (tgt, v) in enumerate(mine):
                hop_target[e, k], hop_value[e, k] = tgt, v

        ph, up, dn = _phonon_ladder(L, p.max_phonon, p.max_total_phonon)
        n_ph = len(ph)
        el_diag = p.U * docc.astype(np.float64)
        # nonzeros of the equivalent CSR: diagonal, hops, ladder
        diag = el_diag[:, None] + p.omega0 * ph.sum(axis=1).astype(np.float64)[None, :]
        coupled = (p.g * p.omega0 * el_occ) != 0.0                   # (n_el, L)
        ladder = (up >= 0).sum(axis=0) + (dn >= 0).sum(axis=0)       # (L,)
        nnz = (int(np.count_nonzero(diag)) + int((hop_target >= 0).sum()) * n_ph
               + int((coupled * ladder[None, :]).sum()))
        dim = n_el * n_ph
        op = ElectronPhononOperator(
            shape=(dim, dim), hop_target=torch.from_numpy(hop_target),
            hop_value=torch.from_numpy(hop_value), el_diag=torch.from_numpy(el_diag),
            el_occ=torch.from_numpy(el_occ),
            ph_occ=torch.from_numpy(np.ascontiguousarray(ph, np.int32)),
            ph_up=torch.from_numpy(np.ascontiguousarray(up, np.int32)),
            ph_dn=torch.from_numpy(np.ascontiguousarray(dn, np.int32)),
            g=float(p.g), omega0=float(p.omega0), nnz=nnz)
        with _BUILDS_LOCK:
            _BUILDS["builds"] += 1
            _BUILDS["build_s"] += time.perf_counter() - t0
            _BUILDS["table_bytes"] += op.table_bytes()
        return op


def holstein_hubbard_surrogate(
    n: int,
    nnz_per_row: float = 14.0,
    n_secondary_diags: int = 12,
    frac_in_diags: float = 0.60,
    diag_occupancy: float | None = None,
    band_frac: float = 0.02,
    seed: int = 0,
    dtype=np.float32,
) -> CSR:
    """Synthetic symmetric matrix reproducing the Fig. 5 structure at size n:
    full main diagonal, ``n_secondary_diags`` dense secondary diagonals near
    the outer band edge carrying ``frac_in_diags`` of all nnz, the rest
    scattered over a band of half-width ``band_frac * n``."""
    rng = np.random.default_rng(seed)
    band = max(n_secondary_diags * 4, int(band_frac * n))
    band = min(band, n - 1)
    total_target = nnz_per_row * n
    n_pairs = n_secondary_diags // 2
    offs = np.unique(np.linspace(band // 2, band, n_pairs, dtype=np.int64))
    while len(offs) < n_pairs:  # tiny n edge case
        offs = np.unique(np.concatenate([offs, offs[-1:] + 1]))
    offs = offs[:n_pairs]
    diag_target = frac_in_diags * total_target
    if diag_occupancy is None:
        avail = 2.0 * np.sum(n - offs)
        diag_occupancy = min(0.95, diag_target / max(1.0, avail))

    i = np.arange(n, dtype=np.int64)
    rows_list, cols_list = [i], [i]
    vals_list = [rng.standard_normal(n) + 4.0]
    for off in offs:
        keep = rng.random(n - int(off)) < diag_occupancy
        ii = np.nonzero(keep)[0].astype(np.int64)
        rows_list.append(ii)
        cols_list.append(ii + off)
        vals_list.append(rng.standard_normal(len(ii)))

    used = sum(len(r) for r in rows_list[1:]) * 2 + n
    n_scatter = max(0, int(total_target) - used) // 2
    ri = rng.integers(0, n, size=n_scatter)
    ci = ri + rng.integers(1, band + 1, size=n_scatter)
    ok = ci < n
    ri, ci = ri[ok].astype(np.int64), ci[ok].astype(np.int64)
    rows_list.append(ri)
    cols_list.append(ci)
    vals_list.append(rng.standard_normal(len(ri)) * 0.5)

    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    vals = np.concatenate(vals_list).astype(dtype)
    upper = cols > rows
    rows_f = np.concatenate([rows, cols[upper]])
    cols_f = np.concatenate([cols, rows[upper]])
    vals_f = np.concatenate([vals, vals[upper]]).astype(np.float64)
    # sum duplicates in input order, in f64 (bincount adds exactly as
    # np.add.at does, without its per-element overhead)
    uniq, inv = np.unique(rows_f * n + cols_f, return_inverse=True)
    vsum = np.bincount(inv.ravel(), weights=vals_f, minlength=len(uniq))
    return CSR.from_coo(COO((uniq // n).astype(np.int32), (uniq % n).astype(np.int32),
                            vsum.astype(dtype), (n, n)))


def laplacian_2d(nx: int, ny: int, dtype=np.float64) -> CSR:
    """Standard 5-point stencil on an nx x ny grid."""
    n = nx * ny
    r = np.arange(n, dtype=np.int64)
    x, y = r % nx, r // nx
    rows_list, cols_list, vals_list = [r], [r], [np.full(n, 4.0)]
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = (x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
        rows_list.append(r[ok])
        cols_list.append(r[ok] + dy * nx + dx)
        vals_list.append(np.full(int(ok.sum()), -1.0))
    # CSR.from_coo sorts by (row, col), so the stencil order does not matter
    return CSR.from_coo(COO(np.concatenate(rows_list).astype(np.int32),
                            np.concatenate(cols_list).astype(np.int32),
                            np.concatenate(vals_list).astype(dtype), (n, n)))


def random_sparse(n_rows: int, n_cols: int, nnz_per_row: int, seed: int = 0,
                  dtype=np.float32) -> CSR:
    """Uniform random pattern with exactly ``nnz_per_row`` entries a row."""
    rng = np.random.default_rng(seed)
    k = min(nnz_per_row, n_cols)
    cols = np.stack([rng.choice(n_cols, size=k, replace=False) for _ in range(n_rows)])
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), k)
    vals = rng.standard_normal(n_rows * k).astype(dtype)
    return CSR.from_coo(COO(rows.astype(np.int32), cols.reshape(-1).astype(np.int32),
                            vals, (n_rows, n_cols)))


def random_banded(n: int, half_bandwidth: int, density: float, seed: int = 0,
                  dtype=np.float32) -> CSR:
    """Every diagonal within ``half_bandwidth`` of the main one, each entry
    kept with probability ``density``."""
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    rows_list, cols_list = [], []
    for off in range(-half_bandwidth, half_bandwidth + 1):
        lo, hi = max(0, -off), min(n, n - off)
        ii = i[lo:hi][rng.random(hi - lo) < density]
        rows_list.append(ii)
        cols_list.append(ii + off)
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    vals = rng.standard_normal(len(rows)).astype(dtype)
    return CSR.from_coo(COO(rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)))


def laplacian_3d(nx: int, ny: int, nz: int, dtype=np.float64) -> CSR:
    """Standard 7-point stencil on an nx x ny x nz grid: the +-nx*ny
    couplings put the outer diagonals a plane away."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    coords = (idx % nx, (idx // nx) % ny, idx // (nx * ny))
    rows_list, cols_list, vals_list = [idx], [idx], [np.full(n, 6.0)]
    for coord, extent, stride in zip(coords, (nx, ny, nz), (1, nx, nx * ny)):
        for sgn in (+1, -1):
            ok = (coord + sgn >= 0) & (coord + sgn < extent)
            rows_list.append(idx[ok])
            cols_list.append(idx[ok] + sgn * stride)
            vals_list.append(np.full(int(ok.sum()), -1.0))
    return CSR.from_coo(COO(np.concatenate(rows_list).astype(np.int32),
                            np.concatenate(cols_list).astype(np.int32),
                            np.concatenate(vals_list).astype(dtype), (n, n)))


def dense_stripe(n: int, stripe_width: int, stripe_start: int | None = None,
                 seed: int = 0, dtype=np.float32) -> CSR:
    """Near-dense vertical stripe of ``stripe_width`` columns plus the main
    diagonal where the stripe does not cover it: constant row length, one
    small fully reused window of x."""
    rng = np.random.default_rng(seed)
    c0 = (n - stripe_width) // 2 if stripe_start is None else stripe_start
    if not (0 <= c0 and c0 + stripe_width <= n):
        raise ValueError(f"stripe [{c0}, {c0 + stripe_width}) outside {n} columns")
    i = np.arange(n, dtype=np.int64)
    diag = i[(i < c0) | (i >= c0 + stripe_width)]
    rows = np.concatenate([diag, np.repeat(i, stripe_width)])
    cols = np.concatenate([diag, np.tile(np.arange(c0, c0 + stripe_width, dtype=np.int64), n)])
    vals = rng.standard_normal(len(rows)).astype(dtype)
    vals[: len(diag)] += 4.0
    return CSR.from_coo(COO(rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)))


def power_law_rows(n: int, n_cols: int, mean_nnz: float = 8.0, alpha: float = 1.5,
                   seed: int = 0, dtype=np.float32, max_nnz: int | None = None) -> CSR:
    """Strongly imbalanced (Zipf-ish) row lengths; ``max_nnz`` caps the
    heaviest rows."""
    rng = np.random.default_rng(seed)
    cap = n_cols if max_nnz is None else min(n_cols, max_nnz)
    raw = rng.zipf(alpha, size=n).astype(np.float64)
    lens = np.minimum(cap, np.maximum(
        1, (raw * mean_nnz / max(1e-9, raw.mean())).astype(np.int64)))
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    cols = rng.integers(0, n_cols, size=int(lens.sum()))
    vals = rng.standard_normal(len(rows)).astype(dtype)
    return CSR.from_coo(COO(rows.astype(np.int32), cols.astype(np.int32), vals,
                            (n, n_cols)))


def block_sparse_dense(m: int, n: int, block: tuple[int, int], block_density: float,
                       seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Dense (m, n) array with a random block-sparse support -- BSR's home
    turf (structured-sparse weights).  The same generator calls as the
    reference's, so the array comes out bit-equal."""
    rng = np.random.default_rng(seed)
    bm, bn = block
    assert m % bm == 0 and n % bn == 0
    mask = rng.random((m // bm, n // bn)) < block_density
    d = rng.standard_normal((m, n)).astype(dtype)
    d *= np.kron(mask, np.ones((bm, bn), dtype=dtype))
    return d
