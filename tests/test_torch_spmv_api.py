"""The reference's per-format SpMV API -- the 30 functions
``repro.core.spmv`` re-exports -- against the port's ``repro_torch.core.spmv``.

* Every name exists in the port with the reference's signature (parameter
  names, kinds and defaults), in the port's kernel module of the same name.
* ``*_spmv(m, x)`` / ``*_spmm(m, X)`` (the ``torch`` entry) against the
  reference's functions on the same containers: 1e-12 relative with f64
  values and x, 1e-5 with f32 values, ``VALUE_DTYPE_TOL`` with bf16 values;
  the ``*_loop`` oracles bitwise where they add in the reference's order
  (CSR, DIA, ELL, JDS), else 1e-12.
* The packed arrays -- ``sell_padded_views``, ``dia_gather_tables``, the row
  and segment ids -- bit for bit; ``sell_spmv_padded`` / ``sell_spmm_padded``
  take the reference's ``perm`` (the inverse permutation) and agree.
"""
import inspect

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (  # noqa: E402
    VALUE_DTYPE_TOL, as_np, operand, ref_matrix, rel_err, to_port, x64)
from repro.core import formats as RF  # noqa: E402
from repro.core import spmv as RS  # noqa: E402
from repro_torch.core import spmv as PS  # noqa: E402

#: the reference's re-exports (``src/repro/core/spmv.py``), by kernel module
API = {
    "bsr": ("bsr_block_row_ids", "bsr_spmm", "bsr_spmv"),
    "cache": ("precompute_stats",),
    "coo": ("coo_spmm", "coo_spmv"),
    "csr": ("csr_row_ids", "csr_spmm", "csr_spmv", "csr_spmv_searchsorted"),
    "dia": ("dia_gather_tables", "dia_spmm", "dia_spmv", "dia_spmv_loop"),
    "ell": ("ell_spmm", "ell_spmv", "ell_spmv_loop"),
    "hybrid": ("hybrid_spmm", "hybrid_spmv", "hybrid_spmv_loop"),
    "jds": ("jds_segment_ids", "jds_spmm", "jds_spmv", "jds_spmv_loop"),
    "sell": ("sell_padded_views", "sell_spmm", "sell_spmm_padded", "sell_spmv",
             "sell_spmv_loop", "sell_spmv_padded"),
}
NAMES = [(mod, n) for mod, names in API.items() for n in names]
FORMATS = ("coo", "csr", "ell", "jds", "sell", "dia", "hybrid", "bsr")
#: formats with a loop oracle in the API
LOOPS = {"csr": "csr_spmv_searchsorted", "ell": "ell_spmv_loop", "jds": "jds_spmv_loop",
         "sell": "sell_spmv_loop", "dia": "dia_spmv_loop", "hybrid": "hybrid_spmv_loop"}
MATRICES = ("surrogate600", "exact3", "laplace24")
TOL = {"f64": 1e-12, "f32": 1e-5, "bf16": VALUE_DTYPE_TOL["bf16"]}


def test_the_reference_exports_thirty_names():
    ref = {n for n in dir(RS) if callable(getattr(RS, n))
           and getattr(getattr(RS, n), "__module__", "").startswith("repro.kernels.")}
    assert ref == {n for _, n in NAMES} and len(ref) == 30


@pytest.mark.parametrize("mod,name", NAMES)
def test_signature_matches_reference(mod, name):
    def params(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    port = getattr(PS, name)
    assert port.__module__ == f"repro_torch.kernels.{mod}"
    assert params(port) == params(getattr(RS, name))


_CONTAINERS: dict = {}


def _padded_dense(csr) -> np.ndarray:
    """The dense matrix with zero rows and columns up to a multiple of 8."""
    d = csr.to_dense()
    return np.pad(d, [(0, -s % 8) for s in d.shape])


def _container(fmt: str, matrix: str, vd: str):
    """(reference container, port container) of ``matrix`` in ``fmt`` with
    ``vd`` values, built once."""
    key = (fmt, matrix, vd)
    if key not in _CONTAINERS:
        r = ref_matrix(matrix)
        csr = RF.CSR(np.asarray(r.row_ptr), np.asarray(r.col_idx),
                     np.asarray(r.val, np.float64), r.shape)
        c = {"coo": lambda: csr.to_coo(), "csr": lambda: csr,
             "ell": lambda: RF.ELL.from_csr(csr), "jds": lambda: RF.JDS.from_csr(csr),
             "sell": lambda: RF.SELL.from_csr(csr, C=8, sigma=64),
             "dia": lambda: RF.DIA.from_csr(csr),
             "hybrid": lambda: RF.split_dia(csr),
             "bsr": lambda: RF.BSR.from_dense(_padded_dense(csr), block_shape=(8, 8))}[fmt]()
        if vd != "f64":
            c = RF.with_value_dtype(c, vd)
        _CONTAINERS[key] = (c, to_port(c))
    return _CONTAINERS[key]


def _pad_cols(fmt: str, matrix: str) -> int:
    n = ref_matrix(matrix).shape[1]
    return -(-n // 8) * 8 if fmt == "bsr" else n


def _both(ref_fn, port_fn, r, p, x: np.ndarray, vd: str):
    import jax.numpy as jnp
    with x64(vd == "f64"):
        want = np.asarray(ref_fn(r, jnp.asarray(x)))
    got = port_fn(p, torch.from_numpy(x))
    return got, want


def _x(fmt, matrix, vd, k=None):
    dt = np.float64 if vd == "f64" else np.float32
    return operand(_pad_cols(fmt, matrix), k, seed=5, dtype=dt)


@pytest.mark.parametrize("vd", ("f64", "f32"))
@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("op", ("spmv", "spmm"))
@pytest.mark.parametrize("fmt", FORMATS)
def test_format_function_matches_reference(fmt, op, matrix, vd):
    r, p = _container(fmt, matrix, vd)
    name = f"{fmt}_{op}"
    x = _x(fmt, matrix, vd, None if op == "spmv" else 3)
    got, want = _both(getattr(RS, name), getattr(PS, name), r, p, x, vd)
    assert got.device.type == "cpu"
    assert rel_err(got.numpy(), want) <= TOL[vd]


@pytest.mark.parametrize("matrix", ("exact3", "laplace24"))
@pytest.mark.parametrize("fmt", tuple(LOOPS))
def test_loop_oracle_matches_reference(fmt, matrix):
    """The loop oracles in f64: the same products, added in the reference's
    order -- bitwise for CSR, DIA, ELL and JDS, whose loops add whole
    diagonals or columns or one product at a time; within 1e-12 for SELL
    and the hybrid, whose chunk tiles the reference sums over the width in
    XLA's reduction order.  The reference's loops run eagerly, one dispatch
    a diagonal or chunk: the two smaller matrices keep the file quick."""
    r, p = _container(fmt, matrix, "f64")
    name = LOOPS[fmt]
    got, want = _both(getattr(RS, name), getattr(PS, name), r, p,
                      _x(fmt, matrix, "f64"), "f64")
    if fmt in ("csr", "dia", "ell", "jds"):
        assert np.array_equal(got.numpy(), want)
    else:
        assert rel_err(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("fmt", ("csr", "sell", "dia", "ell"))
def test_bf16_values_within_budget(fmt):
    r, p = _container(fmt, "surrogate600", "bf16")
    x = _x(fmt, "surrogate600", "f32")
    got, want = _both(getattr(RS, f"{fmt}_spmv"), getattr(PS, f"{fmt}_spmv"), r, p, x, "f32")
    assert rel_err(got.numpy(), want) <= TOL["bf16"]


@pytest.mark.parametrize("pad", (1, 8))
@pytest.mark.parametrize("vd", ("f64", "bf16", "int8"))
def test_sell_padded_views_bitwise(vd, pad):
    r, p = _container("sell", "surrogate600", vd)
    want = RS.sell_padded_views(r, pad)
    got = PS.sell_padded_views(p, pad)
    assert len(got) == 3
    for w, g in zip(want, got):
        assert np.array_equal(as_np(g), as_np(w)) and as_np(g).dtype == as_np(w).dtype
    assert PS.sell_padded_views(p, pad) is got          # built once per pad


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("op", ("spmv", "spmm"))
def test_sell_padded_takes_the_inverse_perm(op, matrix):
    import jax.numpy as jnp
    from repro.kernels import sell as RK
    from repro_torch.kernels import sell as PK
    r, p = _container("sell", matrix, "f64")
    col3, val3, _ = RS.sell_padded_views(r)
    pcol3, pval3, _ = PS.sell_padded_views(p)
    perm, pperm = RK._perm_arg(r), PK.inverse_perm(p)
    assert (perm is None) == (pperm is None)
    if perm is not None:
        assert np.array_equal(np.asarray(perm), pperm.numpy())
    x = _x("sell", matrix, "f64", None if op == "spmv" else 4)
    ref_fn = RS.sell_spmv_padded if op == "spmv" else RS.sell_spmm_padded
    port_fn = PS.sell_spmv_padded if op == "spmv" else PS.sell_spmm_padded
    with x64(True):
        want = np.asarray(ref_fn(jnp.asarray(col3), jnp.asarray(val3), perm, jnp.asarray(x),
                                 r.shape[0]))
    got = port_fn(pcol3, pval3, pperm, torch.from_numpy(x), p.shape[0])
    assert rel_err(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "fp8_e4m3", "int8"))
@pytest.mark.parametrize("matrix", MATRICES)
def test_dia_gather_tables_bitwise(matrix, vd):
    r, p = _container("dia", matrix, vd)
    idx, data = RS.dia_gather_tables(r)
    pidx, pdata = PS.dia_gather_tables(p)
    assert pidx.dtype == torch.int32 and np.array_equal(pidx.numpy(), idx)
    assert as_np(pdata).dtype == as_np(data).dtype
    assert np.array_equal(as_np(pdata), as_np(data))


@pytest.mark.parametrize("fmt,name", (("csr", "csr_row_ids"), ("jds", "jds_segment_ids"),
                                      ("bsr", "bsr_block_row_ids")))
@pytest.mark.parametrize("matrix", MATRICES)
def test_row_and_segment_ids_equal(fmt, name, matrix):
    r, p = _container(fmt, matrix, "f64")
    assert np.array_equal(getattr(PS, name)(p).numpy(), np.asarray(getattr(RS, name)(r)))


def test_functions_build_once_per_container():
    """A second call reuses the built entry: the host preprocessing counters
    do not move (``precompute_stats``), as in the reference."""
    _, p = _container("csr", "exact3", "f64")
    x = torch.from_numpy(_x("csr", "exact3", "f64"))
    PS.csr_spmv(p, x)
    before = PS.precompute_stats()
    y1 = PS.csr_spmv(p, x)
    assert PS.precompute_stats() == before
    assert torch.equal(y1, PS.csr_spmv(p, x))
    assert ("spmv", "torch", "cpu") in p._facade_fns


def test_functions_run_on_the_operands_device():
    """No device of their own: a meta x gives a meta y (shapes only)."""
    _, p = _container("ell", "exact3", "f32")
    y = PS.ell_spmv(p, torch.empty(p.shape[1], dtype=torch.float32, device="meta"))
    assert y.device.type == "meta" and tuple(y.shape) == (p.shape[0],)
