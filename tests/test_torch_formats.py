"""Packing parity: the port's matrices and containers hold exactly the
reference's arrays (bitwise, bf16/fp8 compared as bit patterns)."""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (  # noqa: E402
    VALUE_DTYPES, assert_same_container, port_matrix, ref_matrix, to_port)
from repro.core import formats as RF  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402

MATRICES = ("surrogate600", "surrogate3000", "exact3", "exact4", "laplace24",
            "laplace48", "powerlaw")


@pytest.mark.parametrize("name", MATRICES)
def test_matrix_generators_byte_for_byte(name):
    assert_same_container(ref_matrix(name), port_matrix(name))


@pytest.mark.parametrize("name", ("surrogate1200", "exact3", "powerlaw"))
@pytest.mark.parametrize("C", (8, 128))
@pytest.mark.parametrize("sigma", ("1", "256", "n"))
def test_sell_pack_matches(name, C, sigma):
    r = ref_matrix(name)
    s = {"1": 1, "256": 256, "n": r.shape[0]}[sigma]
    assert_same_container(RF.SELL.from_csr(r, C=C, sigma=s),
                          PF.SELL.from_csr(to_port(r), C=C, sigma=s))


def test_sell_sorted_columns_and_width_padding_match():
    r = ref_matrix("powerlaw")
    assert_same_container(
        RF.SELL.from_csr(r, C=8, sigma=64, sort_cols=True, pad_width_to=4),
        PF.SELL.from_csr(to_port(r), C=8, sigma=64, sort_cols=True, pad_width_to=4))


@pytest.mark.parametrize("C", (8, 128))
def test_pack_chunks_flat_matches(C):
    r = ref_matrix("powerlaw")
    rp, ci, v = (np.asarray(a) for a in (r.row_ptr, r.col_idx, r.val))
    rows = [(ci[rp[i]:rp[i + 1]], v[rp[i]:rp[i + 1]]) for i in range(r.shape[0])]
    order = RF.sigma_sort_order(np.diff(rp), 256)
    assert np.array_equal(order, PF.sigma_sort_order(np.diff(rp), 256))
    for a, b in zip(RF.pack_chunks_flat(rows, C, order),
                    PF.pack_chunks_flat(rows, C, order)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ("surrogate1200", "exact3", "laplace24"))
def test_split_dia_matches(name):
    r = ref_matrix(name)
    assert_same_container(RF.split_dia(r), PF.split_dia(to_port(r)))


@pytest.mark.parametrize("name", ("exact3", "laplace24"))
def test_dia_pack_matches(name):
    r = ref_matrix(name)
    assert_same_container(RF.DIA.from_csr(r), PF.DIA.from_csr(to_port(r)))


@pytest.mark.parametrize("name", ("exact3", "exact4", "laplace24", "surrogate600",
                                  "powerlaw"))
def test_detect_matrix_free_descriptor_matches(name):
    r = ref_matrix(name)
    mr, mp = RF.detect_matrix_free(r), PF.detect_matrix_free(to_port(r))
    if mr is None:
        assert mp is None
        return
    assert_same_container(mr, mp)
    assert_same_container(RF.materialize(mr), PF.materialize(mp))


def _containers(fmt: str):
    """(reference, port) containers of ``fmt`` over identical f64 arrays."""
    r = ref_matrix("surrogate600" if fmt in ("csr", "sell", "hybrid") else "exact3")
    r = RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64), r.shape)
    p = to_port(r)
    if fmt == "csr":
        return r, p
    if fmt == "matrix_free":
        return RF.detect_matrix_free(r), PF.detect_matrix_free(p)
    return RF.convert(r, fmt), PF.convert(p, fmt)


@pytest.mark.parametrize("vd", VALUE_DTYPES)
@pytest.mark.parametrize("fmt", ("csr", "sell", "dia", "hybrid", "matrix_free"))
def test_with_value_dtype_matches(fmt, vd):
    r, p = _containers(fmt)
    if fmt == "matrix_free" and vd in ("int8", "fp8_e4m3"):
        with pytest.raises(TypeError):
            RF.with_value_dtype(r, vd)
        with pytest.raises(TypeError):
            PF.with_value_dtype(p, vd)
        return
    qr, qp = RF.with_value_dtype(r, vd), PF.with_value_dtype(p, vd)
    assert_same_container(qr, qp)
    assert PF.container_value_dtype(qp) == vd
    if fmt != "matrix_free":
        assert_same_container(RF.dequantize(qr), PF.dequantize(qp))


def test_interop_round_trip_is_the_port_pack():
    r = ref_matrix("surrogate600")
    p = port_matrix("surrogate600")
    assert_same_container(to_port(RF.split_dia(r)), PF.split_dia(p))
    q = to_port(RF.with_value_dtype(RF.convert(r, "sell"), "bf16"))
    assert q.val.dtype == torch.bfloat16


def test_convert_refuses_unported_formats():
    """Every format of the reference is ported now: a name outside
    ``FORMATS`` is refused, and bsr refuses a shape its block does not tile."""
    assert set(PF.FORMATS) == {"csr", "ell", "jds", "sell", "bsr", "dia", "hybrid",
                               "matrix_free"}
    with pytest.raises(ValueError, match="unknown format"):
        PF.convert(port_matrix("exact3"), "bcsr")
    with pytest.raises(ValueError, match="not divisible"):
        PF.convert(port_matrix("exact3"), "bsr")


def test_structural_conversions_refuse_quantized_sources():
    q = PF.with_value_dtype(port_matrix("exact3"), "int8")
    with pytest.raises(TypeError, match="quantized"):
        PF.SELL.from_csr(q)
    # convert() dequantizes and re-quantizes in the target's layout
    s = PF.convert(q, "sell")
    assert PF.container_value_dtype(s) == "int8" and s.scale is not None


@pytest.mark.parametrize("name", ("surrogate600", "exact3", "powerlaw", "laplace24"))
def test_ell_and_jds_packs_match(name):
    r = ref_matrix(name)
    assert_same_container(RF.ELL.from_csr(r), PF.ELL.from_csr(to_port(r)))
    assert_same_container(RF.ELL.from_csr(r, width=70, pad_to=8),
                          PF.ELL.from_csr(to_port(r), width=70, pad_to=8))
    assert_same_container(RF.JDS.from_csr(r), PF.JDS.from_csr(to_port(r)))
    assert np.array_equal(RF.JDS.from_csr(r).to_dense(), PF.JDS.from_csr(to_port(r)).to_dense())


@pytest.mark.parametrize("vd", VALUE_DTYPES)
@pytest.mark.parametrize("fmt", ("ell", "jds"))
def test_ell_jds_value_dtypes_match(fmt, vd):
    r, p = _containers("csr")
    qr, qp = RF.with_value_dtype(RF.convert(r, fmt), vd), PF.with_value_dtype(PF.convert(p, fmt), vd)
    assert_same_container(qr, qp)
    assert PF.container_value_dtype(qp) == vd
    assert_same_container(RF.dequantize(qr), PF.dequantize(qp))


@pytest.mark.parametrize("name", MATRICES)
def test_matrix_stats_match(name):
    assert RF.matrix_stats(ref_matrix(name)) == PF.matrix_stats(to_port(ref_matrix(name)))
