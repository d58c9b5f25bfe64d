"""The SELL SpMM kernel's chunk schedule and its walk, on the CPU.

``chunk_schedule`` (the order in which ``csrc/sell_spmm.cu`` visits the
chunks) is held against a brute-force one written independently here: a
permutation of ``range(n_chunks)``, chunks by first original row, the
identity for sigma = 1; ``ChunkSchedule`` refuses an order that is not a
permutation, and the wrapper an order it did not check.  A numpy emulation
of the kernel's walk -- schedule order, K tiles of ``sell_spmm_launch``,
each row summed in slot order with a separate multiply and add, scale and
inverse permutation at the store -- is held against ``sell_spmm_plain``
and against the reference's Pallas ``sell_spmm_arrays`` run in interpret
mode, on identical containers: 1e-5 relative with an f32 accumulator, 1e-12
with f64 (the same products summed in another order).
"""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (  # noqa: E402
    VALUE_DTYPES, operand, ragged_csr_arrays, ref_matrix, ref_sell_spmm_pallas, rel_err,
    to_port, x64)
from repro.core import formats as RF  # noqa: E402
from repro_torch.core.formats import _np  # noqa: E402
from repro_torch.kernels import sell as KS  # noqa: E402
from repro_torch.kernels import sell_spmv as KP  # noqa: E402
from repro_torch.kernels.accum import acc_dtype  # noqa: E402
from repro_torch.kernels.cache import precompute_stats  # noqa: E402

#: (matrix, C, sigma): sigma None is the row count (one global sort, as the
#: surrogate's select_sell_sigma picks); "ragged" has empty rows, rows of
#: thousands of nonzeros and, with C = 7, a ragged last chunk
CONTAINERS = (("surrogate600", 8, 1), ("surrogate600", 8, 64), ("surrogate600", 8, None),
              ("powerlaw", 8, None), ("ragged", 7, 64), ("ragged", 7, None))
IDS = [f"{m}-C{c}-sigma{s}" for m, c, s in CONTAINERS]

_REF: dict = {}


def ref_sell(name: str, C: int, sigma, vd: str = "f64"):
    """Reference SELL container of a test matrix, f64 values then ``vd``."""
    key = (name, C, sigma)
    if key not in _REF:
        if name == "ragged":
            rp, col, val, shape = ragged_csr_arrays()
            r = RF.CSR(rp, col, val, shape)
        else:
            r = ref_matrix(name)
            r = RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64), r.shape)
        _REF[key] = RF.SELL.from_csr(r, C=C, sigma=r.shape[0] if sigma is None else sigma)
    c = _REF[key]
    return c if vd == "f64" else RF.with_value_dtype(c, vd)


def brute_force_order(perm, C: int, n_rows: int) -> list:
    """Chunk ids sorted by the smallest real row each holds (pad rows count
    as n_rows), ties by chunk id."""
    perm = [int(p) for p in perm]
    nc = len(perm) // C
    first = [min([r for r in perm[c * C:(c + 1) * C] if r < n_rows] or [n_rows])
             for c in range(nc)]
    return sorted(range(nc), key=lambda c: (first[c], c))


@pytest.mark.parametrize("name,C,sigma", CONTAINERS, ids=IDS)
def test_chunk_schedule_matches_brute_force(name, C, sigma):
    s = to_port(ref_sell(name, C, sigma))
    sched = KP.chunk_schedule(s.perm, C, s.shape[0])
    assert isinstance(sched, KP.ChunkSchedule) and sched.n_chunks == s.n_chunks
    assert sched.order.dtype == torch.int32
    assert sched.order.tolist() == brute_force_order(_np(s.perm), C, s.shape[0])


@pytest.mark.parametrize("name,C,sigma", CONTAINERS, ids=IDS)
def test_chunk_schedule_is_a_permutation_in_first_row_order(name, C, sigma):
    s = to_port(ref_sell(name, C, sigma))
    n = s.shape[0]
    order = KP.chunk_schedule(s.perm, C, n).order.numpy()
    assert np.array_equal(np.sort(order), np.arange(s.n_chunks))
    first = KP.chunk_first_rows(s.perm, C, n)[order]
    assert (np.diff(first) >= 0).all()
    # every real row is visited exactly once, row 0 first
    rows = _np(s.perm).reshape(-1, C)[order].reshape(-1)
    assert first[0] == 0 and np.array_equal(np.sort(rows[rows < n]), np.arange(n))


@pytest.mark.parametrize("name,C", (("surrogate600", 8), ("ragged", 7), ("powerlaw", 4)))
def test_chunk_schedule_is_the_identity_for_sigma_1(name, C):
    s = to_port(ref_sell(name, C, 1))
    assert KP.chunk_schedule(s.perm, C, s.shape[0]).order.tolist() == list(range(s.n_chunks))


def test_chunk_schedule_walks_the_length_classes_in_step():
    # sigma = N sorts the surrogate's rows by length: storage order sweeps the
    # rows once a length class, the schedule once in all
    s = to_port(ref_sell("surrogate600", 8, None))
    n = s.shape[0]
    first = KP.chunk_first_rows(s.perm, 8, n)
    sweeps = lambda f: 1 + int((np.diff(f) < 0).sum())  # noqa: E731
    assert sweeps(first) > 1
    assert sweeps(first[KP.chunk_schedule(s.perm, 8, n).order.numpy()]) == 1


@pytest.mark.parametrize("order", ([0, 0, 2], [0, 1, 3], [-1, 0, 1], [[0, 1], [2, 3]],
                                   [0.0, 1.0, 2.0], [1, 2]), ids=str)
def test_chunk_schedule_refuses_an_order_that_is_not_a_permutation(order):
    with pytest.raises(ValueError, match="permutation"):
        KP.ChunkSchedule(np.asarray(order))


def test_chunk_schedule_takes_a_checked_permutation():
    sched = KP.ChunkSchedule(torch.tensor([2, 0, 1]))
    assert sched.order.tolist() == [2, 0, 1] and sched.n_chunks == 3
    assert sched.on("cpu") is sched.on(torch.device("cpu"))


def test_wrapper_refuses_a_schedule_it_did_not_check():
    s = to_port(ref_sell("surrogate600", 8, 64))
    X = torch.ones((s.shape[1], 2), dtype=torch.float64)
    args = (s.chunk_ptr, s.chunk_width, s.col_idx, s.val, s.scale, s.perm, X, s.shape[0], s.C)
    with pytest.raises(TypeError, match="ChunkSchedule"):
        KP.sell_spmm_arrays(*args, schedule=torch.arange(s.n_chunks, dtype=torch.int32))
    with pytest.raises(ValueError, match="chunks"):
        KP.sell_spmm_arrays(*args, schedule=KP.ChunkSchedule(np.arange(s.n_chunks - 1)))
    good = KP.sell_spmm_arrays(*args, schedule=KP.chunk_schedule(s.perm, s.C, s.shape[0]))
    assert torch.equal(good, KP.sell_spmm_arrays(*args))


def test_chunk_schedule_is_built_once_per_container():
    s = to_port(ref_sell("surrogate600", 8, None))
    before = precompute_stats()["sell_chunk_schedule"]
    a, b = KS.sell_chunk_schedule(s), KS.sell_chunk_schedule(s)
    assert a is b and precompute_stats()["sell_chunk_schedule"] == before + 1
    assert a.order.tolist() == KP.chunk_schedule(s.perm, 8, s.shape[0]).order.tolist()


# --- the kernel's walk, emulated ---------------------------------------------------


def emulate_sell_spmm(s, X: torch.Tensor) -> np.ndarray:
    """``csrc/sell_spmm.cu`` step by step in numpy: chunks in schedule order,
    K tiles of ``tpr * ct`` columns, each row's slots in order (``acc +=
    val * x``, multiply and add rounded separately), the per-chunk scale,
    then the store at the row's original position."""
    acc = acc_dtype(s.val.dtype, X.dtype)
    adt = np.float64 if acc == torch.float64 else np.float32
    cp, cw, col, perm = (_np(t) for t in (s.chunk_ptr, s.chunk_width, s.col_idx, s.perm))
    val = s.val.to(acc).numpy()
    scale = None if s.scale is None else _np(s.scale).astype(adt)
    Xn = X.to(acc).numpy()
    n, K = s.shape[0], Xn.shape[1]
    C = s.C
    ct, tpr = KP.sell_spmm_launch(K, np.dtype(adt).itemsize)
    tile = ct * tpr
    Y = np.full((n, K), np.nan, adt)
    for c in KP.chunk_schedule(s.perm, C, n).order.tolist():
        rows = perm[c * C:(c + 1) * C]
        slab_c = col[cp[c]:cp[c + 1]].reshape(-1, C)
        slab_v = val[cp[c]:cp[c + 1]].reshape(-1, C)
        for k0 in range(0, K, tile):
            cols = slice(k0, min(K, k0 + tile))
            a = np.zeros((C, cols.stop - k0), adt)
            for j in range(int(cw[c])):
                a = a + slab_v[j][:, None] * Xn[slab_c[j]][:, cols]
            if scale is not None:
                a = a * scale[c]
            real = rows < n
            Y[rows[real], cols] = a[real]
    assert not np.isnan(Y).any(), "a row of Y was never written"
    return Y


@pytest.mark.parametrize("K", (1, 3, 40, 100))
@pytest.mark.parametrize("vd", VALUE_DTYPES)
@pytest.mark.parametrize("name,C,sigma", CONTAINERS, ids=IDS)
def test_kernel_walk_matches_plain(name, C, sigma, vd, K):
    s = to_port(ref_sell(name, C, sigma, vd))
    dt = torch.float64 if vd == "f64" else torch.float32
    X = torch.from_numpy(operand(s.shape[1], K, seed=K, dtype=np.float64)).to(dt)
    got = emulate_sell_spmm(s, X)
    want = KP.sell_spmm_plain(s.chunk_ptr, s.chunk_width, s.col_idx, s.val, s.scale, s.perm,
                              X, s.shape[0], C).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert rel_err(got, want) <= (1e-12 if want.dtype == np.float64 else 1e-5)


@pytest.mark.parametrize("vd", ("f64", "f32", "int8"))
@pytest.mark.parametrize("name,C,sigma", CONTAINERS, ids=IDS)
def test_kernel_walk_matches_reference_pallas(name, C, sigma, vd):
    ref_c = ref_sell(name, C, sigma, vd)
    s = to_port(ref_c)
    dt = np.float64 if vd == "f64" else np.float32
    X = operand(s.shape[1], 3, seed=31, dtype=dt)
    with x64(vd == "f64"):
        want = ref_sell_spmm_pallas(ref_c, X)
    got = emulate_sell_spmm(s, torch.from_numpy(X))
    assert got.dtype == want.dtype
    assert rel_err(got, want) <= (1e-12 if dt == np.float64 else 1e-5)
