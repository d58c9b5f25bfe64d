"""The frozen generators give the port's matrices, bit for bit."""
from __future__ import annotations

import numpy as np
import pytest
from repro_torch.core import matrices as M

from spmvbench import gen


def same_bits(arrays, csr) -> bool:
    rp, col, val = arrays
    want = csr.val.numpy()
    return (np.array_equal(rp, csr.row_ptr.numpy()) and np.array_equal(col, csr.col_idx.numpy())
            and val.dtype == want.dtype and val.tobytes() == want.tobytes())


@pytest.mark.parametrize("params", [
    dict(L=4),
    dict(L=3, max_phonon=3),
    dict(L=4, n_up=2, n_dn=1, max_phonon=2, max_total_phonon=3, g=0.7, U=0.0),
    dict(L=5, max_phonon=2, periodic=False),
    dict(L=2, max_phonon=4),
], ids=["L4", "L3-M3", "L4-2up-capped-U0", "L5-open", "L2"])
def test_holstein_hubbard_matches_port(params):
    assert same_bits(gen.holstein_hubbard(**params),
                     M.holstein_hubbard_exact(M.HolsteinHubbardParams(**params)))


@pytest.mark.parametrize("n,seed", [(2000, 0), (5000, 123456789012), (20, 3)])
def test_surrogate_matches_port(n, seed):
    assert same_bits(gen.surrogate(n, seed), M.holstein_hubbard_surrogate(n, seed=seed))


def test_surrogate_is_symmetric_with_full_diagonal():
    rp, col, val = gen.surrogate(1500, 9)
    rows = np.repeat(np.arange(1500), np.diff(rp))
    d = np.zeros((1500, 1500), np.float32)
    d[rows, col] = val
    assert np.array_equal(d, d.T) and np.all(np.diag(d) != 0)
