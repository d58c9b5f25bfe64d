"""Frozen copies of the matrix generators, as numpy CSR arrays.

The benchmark makes its matrices itself and hands the same arrays to the
program and to the plain reference, so the yardstick cannot move with the
program's own generators.  Both functions return ``(row_ptr, col_idx,
val)``: int32 row pointers, int32 columns sorted within each row, and the
values, the layout a CSR built by ``CSR.from_coo`` holds.

* ``surrogate`` -- the paper's HMeP matrix statistics (Schubert, Hager and
  Fehske 2009, Sec. 4.2, Fig. 5) at any N, the same draws as the port's
  ``holstein_hubbard_surrogate``.
* ``holstein_hubbard`` -- the exact Holstein-Hubbard Hamiltonian on an
  L-site chain with a per-site phonon cutoff.  The port builds it row by row
  in Python loops; this copy loops over the electron configurations only
  and computes every phonon state of one configuration at once, giving the
  same entries and the same bits.

``tests/test_bench_gen.py`` holds both bitwise against the port's; a
configuration reaches them through its module in ``generators/``.
"""
from __future__ import annotations

import itertools

import numpy as np


def _csr_from_sorted_keys(keys: np.ndarray, vals: np.ndarray, n: int):
    """CSR arrays of entries given by unique ``row * n + col`` keys, sorted."""
    rows = keys // n
    row_ptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    return row_ptr, (keys % n).astype(np.int32), vals


def surrogate(n: int, seed: int, nnz_per_row: float = 14.0, n_secondary_diags: int = 12,
              frac_in_diags: float = 0.60, band_frac: float = 0.02, dtype=np.float32):
    """Symmetric matrix with a full main diagonal, ``n_secondary_diags``
    well-filled secondary diagonals carrying ``frac_in_diags`` of the nnz, and
    the rest scattered over a band of half-width ``band_frac * n``."""
    rng = np.random.default_rng(seed)
    band = max(n_secondary_diags * 4, int(band_frac * n))
    band = min(band, n - 1)
    total_target = nnz_per_row * n
    n_pairs = n_secondary_diags // 2
    offs = np.unique(np.linspace(band // 2, band, n_pairs, dtype=np.int64))
    while len(offs) < n_pairs:  # tiny n
        offs = np.unique(np.concatenate([offs, offs[-1:] + 1]))
    offs = offs[:n_pairs]
    avail = 2.0 * np.sum(n - offs)
    occupancy = min(0.95, frac_in_diags * total_target / max(1.0, avail))

    i = np.arange(n, dtype=np.int64)
    rows_list, cols_list = [i], [i]
    vals_list = [rng.standard_normal(n) + 4.0]
    for off in offs:
        keep = rng.random(n - int(off)) < occupancy
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
    # duplicates summed in input order, in f64, then rounded once
    uniq, inv = np.unique(rows_f * n + cols_f, return_inverse=True)
    vsum = np.bincount(inv.ravel(), weights=vals_f, minlength=len(uniq))
    return _csr_from_sorted_keys(uniq, vsum.astype(dtype), n)


def _fermion_basis(L: int, n: int) -> np.ndarray:
    """All L-bit masks with n bits set, ascending."""
    return np.asarray([m for m in range(1 << L) if bin(m).count("1") == n], dtype=np.int64)


def _hop_sign(state: int, i: int, j: int) -> int:
    """Jordan-Wigner sign of c+_j c_i: the parity of the occupied sites
    strictly between i and j."""
    lo, hi = (i, j) if i < j else (j, i)
    mask = ((1 << hi) - 1) ^ ((1 << (lo + 1)) - 1)
    return -1 if bin(state & mask).count("1") % 2 else 1


def holstein_hubbard(L: int, n_up: int = 1, n_dn: int = 1, max_phonon: int = 2,
                     max_total_phonon: int | None = None, t: float = 1.0, U: float = 4.0,
                     g: float = 0.5, omega0: float = 1.0, periodic: bool = True,
                     dtype=np.float64):
    """The Hamiltonian -t sum c+c + U sum n_up n_dn + omega0 sum b+b
    + g omega0 sum n_i (b+_i + b_i) in the basis (up state, down state,
    phonon state), row ``(iu * n_dn_states + idn) * n_ph + ip``; values
    computed in f64, exact zeros dropped, then stored as ``dtype``."""
    ups, dns = _fermion_basis(L, n_up), _fermion_basis(L, n_dn)
    up_index = {int(s): k for k, s in enumerate(ups)}
    dn_index = {int(s): k for k, s in enumerate(dns)}
    # phonon states in itertools.product order, optionally capped in total
    ph = np.asarray(list(itertools.product(range(max_phonon + 1), repeat=L)),
                    dtype=np.int64).reshape(-1, L)
    keep = (np.ones(len(ph), bool) if max_total_phonon is None
            else ph.sum(axis=1) <= max_total_phonon)
    ph = ph[keep]
    rank = np.full(len(keep), -1, dtype=np.int64)
    rank[keep] = np.arange(len(ph))
    n_ph = len(ph)
    stride = (max_phonon + 1) ** np.arange(L - 1, -1, -1, dtype=np.int64)
    full_id = ph @ stride                  # position in the unfiltered product
    ph_sum = ph.sum(axis=1)
    n_dn_s = len(dns)
    dim = len(ups) * n_dn_s * n_ph
    ip = np.arange(n_ph, dtype=np.int64)

    bonds = [(i, i + 1) for i in range(L - 1)]
    if periodic and L > 2:
        bonds.append((L - 1, 0))

    rows_l, cols_l, vals_l = [], [], []

    def add(r, c, v):
        nz = v != 0.0
        rows_l.append(r[nz])
        cols_l.append(c[nz])
        vals_l.append(v[nz])

    for iu, su in enumerate(ups):
        su = int(su)
        for idn, sd in enumerate(dns):
            sd = int(sd)
            base = (iu * n_dn_s + idn) * n_ph
            r = base + ip
            n_docc = bin(su & sd).count("1")
            add(r, r, U * n_docc + omega0 * ph_sum.astype(np.float64))
            for i in range(L):
                n_el = ((su >> i) & 1) + ((sd >> i) & 1)
                if n_el == 0:
                    continue
                amp = g * omega0 * n_el
                up_ok = ph[:, i] < max_phonon
                ip2 = rank[np.where(up_ok, full_id + stride[i], 0)]
                ok = up_ok & (ip2 >= 0)
                add(r[ok], base + ip2[ok], amp * np.sqrt(ph[ok, i] + 1.0))
                dn_ok = ph[:, i] > 0
                ip2 = rank[np.where(dn_ok, full_id - stride[i], 0)]
                ok = dn_ok & (ip2 >= 0)
                add(r[ok], base + ip2[ok], amp * np.sqrt(ph[ok, i].astype(np.float64)))
            for a, b in bonds:
                for src, dst in ((a, b), (b, a)):
                    if (su >> src) & 1 and not (su >> dst) & 1:
                        s2 = su ^ (1 << src) ^ (1 << dst)
                        c0 = (up_index[s2] * n_dn_s + idn) * n_ph
                        add(r, c0 + ip, np.full(n_ph, -t * _hop_sign(su, src, dst)))
                    if (sd >> src) & 1 and not (sd >> dst) & 1:
                        s2 = sd ^ (1 << src) ^ (1 << dst)
                        c0 = (iu * n_dn_s + dn_index[s2]) * n_ph
                        add(r, c0 + ip, np.full(n_ph, -t * _hop_sign(sd, src, dst)))

    keys = np.concatenate(rows_l) * dim + np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    if len(keys) > 1 and not np.all(keys[1:] > keys[:-1]):
        raise ValueError("holstein_hubbard: an entry was generated twice")
    return _csr_from_sorted_keys(keys, vals[order].astype(dtype), dim)


#: each function by the name of the module in ``generators/`` that calls it
GENERATORS = {"surrogate": surrogate, "holstein_hubbard": holstein_hubbard}
