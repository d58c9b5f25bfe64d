"""The plain reference against dense numpy at small sizes, and its
lower-precision controls reading above the f64 rounding."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from spmvbench import gen, reference


def dense(arrays):
    rp, col, val = arrays
    n = len(rp) - 1
    d = np.zeros((n, n))
    d[np.repeat(np.arange(n), np.diff(rp)), col] = val
    return d


@pytest.mark.parametrize("maker", [lambda: gen.surrogate(800, 5),
                                   lambda: gen.holstein_hubbard(L=3, max_phonon=2)],
                         ids=["surrogate", "exact"])
def test_spmv_against_dense(maker):
    arrays = maker()
    d = dense(arrays)
    A = reference.CsrRef(*arrays, "cpu")
    x = np.random.default_rng(0).standard_normal(len(d))
    y = A.spmv(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(y - d @ x)) <= 1e-12 * np.max(np.abs(d @ x))
    for vectors in ("float64", "float32"):
        store, sums = reference.control_precision(vectors)
        low = A.spmv(torch.from_numpy(x), sums, store).double().numpy()
        assert np.max(np.abs(low - d @ x)) > 1e-9 * np.max(np.abs(d @ x))


@pytest.mark.parametrize("reorth", [True, False])
def test_lanczos_against_dense(reorth):
    arrays = gen.holstein_hubbard(L=3, max_phonon=2)
    d = dense(arrays)
    A = reference.CsrRef(*arrays, "cpu")
    v0 = torch.from_numpy(np.random.default_rng(1).standard_normal(len(d)))
    m = 60
    alphas, betas, e0 = reference.lanczos(A, v0, m, reorth)
    e_dense = np.linalg.eigvalsh(d)[0]
    assert abs(e0 - e_dense) <= 1e-10 * abs(e_dense)
    # the coefficients are those of the Krylov basis: alpha_0 = v0' A v0 / v0' v0
    v = v0.numpy() / np.linalg.norm(v0.numpy())
    assert abs(alphas[0] - v @ d @ v) <= 1e-13 * abs(alphas[0])
    a32, _, e32 = reference.lanczos(A, v0, m, reorth, torch.float32)
    assert abs(e32 - e_dense) > 1e-12 * abs(e_dense)


def test_tridiagonal_min():
    assert reference.tridiagonal_min([2.0, 2.0], [1.0, 0.0]) == pytest.approx(1.0)
    assert np.isnan(reference.tridiagonal_min([np.nan], [0.0]))
