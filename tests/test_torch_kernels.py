"""SpMV / SpMM parity per format and value dtype: the port's ``torch`` and
``loop_reference`` entries against the reference's ``xla`` entry on the
identical container, and the kernel wrappers' CPU routing.

Tolerances are not zero only because the two sides sum the same products
in another order: 1e-5 relative in f32, 1e-12 in f64.  Narrow value dtypes
are held to the reference's per-dtype budget against the f64 oracle.
"""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (  # noqa: E402
    VALUE_DTYPE_TOL, VALUE_DTYPES, as_np, operand, port_apply, ref_apply, ref_matrix,
    ref_sell_spmm_pallas, rel_err, to_port, x64)
from repro.core import formats as RF  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.kernels import cuda_build as CB  # noqa: E402
from repro_torch.kernels import registry as PR  # noqa: E402

#: the test matrix of each format
FORMAT_MATRIX = {"csr": "exact3", "sell": "powerlaw", "dia": "laplace24",
                 "hybrid": "surrogate1200", "matrix_free": "laplace48"}
FORMATS = tuple(FORMAT_MATRIX)
PORT_BACKENDS = ("torch", "loop_reference")

_REF64: dict = {}


def ref_container(fmt: str, vd: str = "f64"):
    """Reference container of ``fmt`` with ``vd`` values, packed from the
    f64 copy of the format's test matrix (cached)."""
    if fmt not in _REF64:
        r = ref_matrix(FORMAT_MATRIX[fmt])
        r = RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64), r.shape)
        if fmt == "csr":
            c = r
        elif fmt == "dia":
            c = RF.DIA.from_csr(r)
        elif fmt == "matrix_free":
            c = RF.MatrixFreeOperator.from_csr(r)
        else:
            c = RF.convert(r, fmt)
        _REF64[fmt] = c
    c = _REF64[fmt]
    return c if vd == "f64" else RF.with_value_dtype(c, vd)


def _x(fmt: str, op: str, dtype) -> np.ndarray:
    n = ref_container(fmt).shape[1]
    return operand(n, None if op == "spmv" else 3, seed=5, dtype=dtype)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("op", ("spmv", "spmm"))
@pytest.mark.parametrize("fmt", FORMATS)
def test_f32_entry_matches_reference_xla(fmt, op, backend):
    ref_c = ref_container(fmt, "f32")
    x = _x(fmt, op, np.float32)
    want = ref_apply(ref_c, fmt, op, "xla", x)
    got = port_apply(to_port(ref_c), fmt, op, backend, x)
    assert got.dtype == np.float32
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("op", ("spmv", "spmm"))
@pytest.mark.parametrize("fmt", FORMATS)
def test_f64_entry_matches_reference_xla(fmt, op, backend):
    ref_c = ref_container(fmt)
    x = _x(fmt, op, np.float64)
    with x64():
        want = ref_apply(ref_c, fmt, op, "xla", x)
    got = port_apply(to_port(ref_c), fmt, op, backend, x)
    assert got.dtype == np.float64
    assert rel_err(got, want) <= 1e-12


def _narrow_cases():
    for fmt in FORMATS:
        for vd in VALUE_DTYPE_TOL:
            if fmt == "matrix_free" and vd in RF.QUANTIZED_DTYPES:
                continue  # generated values have no per-group scale home
            for backend in PORT_BACKENDS:
                yield pytest.param(fmt, vd, backend, id=f"{fmt}-{vd}-{backend}")


@pytest.mark.parametrize("fmt,vd,backend", list(_narrow_cases()))
def test_value_dtype_entry_within_budget_of_f64_oracle(fmt, vd, backend):
    """Narrow storage: within the reference's per-dtype budget of the f64
    oracle, and equal (up to f32 summation order) to the reference's own
    result on the same quantized container."""
    ref_c = ref_container(fmt, vd)
    x = _x(fmt, "spmv", np.float32)
    with x64():
        oracle = ref_apply(ref_container(fmt), fmt, "spmv", "xla", x.astype(np.float64))
    got = port_apply(to_port(ref_c), fmt, "spmv", backend, x)
    assert got.dtype == np.float32
    assert rel_err(got, oracle) < VALUE_DTYPE_TOL[vd]
    assert rel_err(got, ref_apply(ref_c, fmt, "spmv", "xla", x)) <= 1e-5


def test_registry_table_covers_the_slice():
    keys = {(e.format, e.op, e.backend) for e in PR.entries()}
    for fmt in FORMATS:
        for be in ("torch", "cuda", "loop_reference"):
            assert (fmt, "spmv", be) in keys
        for be in ("torch", "loop_reference"):
            assert (fmt, "spmm", be) in keys
    cuda_spmm = {k[0] for k in keys if k[1:] == ("spmm", "cuda")}
    # hybrid SpMM stays torch; the distributed slabs run kernel 5
    assert cuda_spmm == {"matrix_free", "sell", "bsr", "slab_ell", "slab_sell"}
    loops = [e for e in PR.entries() if e.backend == "loop_reference"]
    assert loops and not any(e.auto for e in loops)


@pytest.mark.parametrize("fmt", FORMATS)
def test_auto_backend_is_torch_on_cpu_and_cuda_refuses_with_reason(fmt):
    obj = to_port(ref_container(fmt, "f32"))
    ctx = PR.KernelContext(device=torch.device("cpu"))
    backend, costs = PR.select_backend(obj, fmt, "spmv", ctx)
    assert backend == "torch" and set(costs) == {"torch"}
    cap = PR.get(fmt, "spmv", "cuda").probe(obj, ctx)
    assert not cap.ok and "CUDA device" in cap.reason


# --- the kernel wrappers on CPU tensors ---------------------------------------


def _wrapper_cases():
    """(name, wrapper call, plain call with derived tables) per kernel."""
    from repro_torch.kernels import csr_spmv, dia, dia_spmv, matrix_free, sell_spmv
    x = torch.from_numpy(operand(1200, seed=7))
    s = to_port(ref_container("hybrid", "int8")).rest
    yield ("sell_spmv",
           lambda: sell_spmv.sell_spmv_arrays(s.chunk_ptr, s.chunk_width, s.col_idx,
                                              s.val, s.scale, s.perm, x, 1200, s.C),
           lambda: sell_spmv.sell_spmv_plain(s.chunk_ptr, s.chunk_width, s.col_idx,
                                             s.val, s.scale, s.perm, x, 1200, s.C,
                                             seg=None))
    d = to_port(ref_container("hybrid", "fp8_e4m3")).dia
    pad0, pad1, n = dia.dia_layout(d)
    xp = dia_spmv.pad_x(x, pad0, pad1, torch.float32)
    yield ("dia_spmv",
           lambda: dia_spmv.dia_spmv_arrays(d.data, d.offsets, d.scale, xp, pad0, n),
           lambda: dia_spmv.dia_spmv_plain(d.data, d.offsets, d.scale, xp, pad0, n,
                                           dia.dia_gather_index(d)))
    c = to_port(RF.with_value_dtype(ref_matrix("surrogate1200"), "int8"))
    yield ("csr_spmv",
           lambda: csr_spmv.csr_spmv_arrays(c.row_ptr, c.col_idx, c.val, c.scale, x),
           lambda: csr_spmv.csr_spmv_plain(c.row_ptr, c.col_idx, c.val, c.scale, x))
    op = to_port(ref_container("matrix_free", "bf16"))
    desc, gen = matrix_free.mf_pack_descriptor(matrix_free.mf_tables(op))
    p0, p1 = matrix_free.mf_pads(op)
    xu = torch.from_numpy(operand(op.shape[0], seed=8))
    xm = dia_spmv.pad_x(xu, p0, p1, torch.float32)
    data = matrix_free.mf_data(op)
    launch = matrix_free.mf_launch(op)
    yield ("mf_spmv",
           lambda: matrix_free.mf_spmv_arrays(data, launch, xu),
           lambda: matrix_free.mf_spmv_plain(data, desc, gen, xm, p0, op.shape[0]))
    X = torch.from_numpy(operand(1200, 5, seed=9, dtype=np.float64))
    yield ("sell_spmm",
           lambda: sell_spmv.sell_spmm_arrays(s.chunk_ptr, s.chunk_width, s.col_idx,
                                              s.val, s.scale, s.perm, X, 1200, s.C),
           lambda: sell_spmv.sell_spmm_plain(s.chunk_ptr, s.chunk_width, s.col_idx,
                                             s.val, s.scale, s.perm, X, 1200, s.C))
    from repro_torch.kernels import gather_bench
    ta, tb, tc = (torch.from_numpy(operand(1000, seed=i)) for i in (10, 11, 12))
    yield ("stream_triad", lambda: gather_bench.stream_triad(ta, tb, tc),
           lambda: gather_bench.stream_triad_plain(ta, tb, tc))
    idx = torch.from_numpy(np.random.default_rng(13).integers(0, 1200, 1000).astype(np.int32))
    yield ("gather_scp", lambda: gather_bench.gather_scp(ta, idx, x),
           lambda: gather_bench.gather_scp_plain(ta, idx, x))
    from repro_torch.core.matrices import block_sparse_dense
    from repro_torch.kernels import bsr_spmm, moe_gemm
    b = PF.with_value_dtype(PF.BSR.from_dense(
        block_sparse_dense(64, 256, (8, 128), 0.5, seed=1)), "fp8_e4m3")
    bc, sl = bsr_spmm.bsr_to_bell(b)
    sc, ln = bsr_spmm.bell_scale(b), bsr_spmm.bell_row_nblocks(b)
    Xb = torch.from_numpy(operand(256, 3, seed=14))
    yield ("bell_spmm", lambda: bsr_spmm.bell_spmm_arrays(bc, sl, Xb, sc, ln, 64),
           lambda: bsr_spmm.bell_spmm_plain(bc, sl, Xb, sc, 64))
    te = torch.tensor([0, 2, 1, 1], dtype=torch.int32)
    Xg = torch.from_numpy(operand(32, 12, seed=15))
    Wg = torch.from_numpy(operand(36, 10, seed=16).reshape(3, 12, 10))
    yield ("grouped_gemm", lambda: moe_gemm.grouped_gemm_arrays(te, Xg, Wg, bt=8),
           lambda: moe_gemm.grouped_gemm_plain(te, Xg, Wg, 8))
    from repro_torch.core.matrices import HolsteinHubbardParams, holstein_hubbard_operator
    from repro_torch.kernels import mf_product
    ep = holstein_hubbard_operator(HolsteinHubbardParams(L=4, n_up=2, n_dn=1, max_phonon=2,
                                                         max_total_phonon=3))
    pl = mf_product.product_launch(ep)
    xe = torch.from_numpy(operand(ep.shape[0], seed=17, dtype=np.float64))
    yield ("mf_product", lambda: mf_product.mf_product_arrays(pl, xe),
           lambda: mf_product.mf_product_plain(pl.tables, xe))


@pytest.mark.parametrize("idx", range(len(CB.KERNELS)), ids=CB.KERNELS)
def test_wrapper_on_cpu_tensor_runs_the_plain_version_and_counts_nothing(idx):
    name, wrapper, plain = list(_wrapper_cases())[idx]
    assert name == CB.KERNELS[idx]
    before = CB.launch_counts()
    got = wrapper()
    assert CB.launch_counts() == before  # a launch is counted only on the card
    assert torch.equal(got, plain())


# --- ELL and JDS: composite entries only (no TPU kernel, so no CUDA one) -------

_EJ: dict = {}


def ell_jds_container(fmt: str, vd: str = "f64"):
    if fmt not in _EJ:
        r = ref_matrix("surrogate600")
        r = RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64), r.shape)
        _EJ[fmt] = RF.convert(r, fmt)
    c = _EJ[fmt]
    return c if vd == "f64" else RF.with_value_dtype(c, vd)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("op", ("spmv", "spmm"))
@pytest.mark.parametrize("vd", ("f64", "f32"))
@pytest.mark.parametrize("fmt", ("ell", "jds"))
def test_ell_jds_entry_matches_reference_xla(fmt, vd, op, backend):
    ref_c = ell_jds_container(fmt, vd)
    dt = np.float64 if vd == "f64" else np.float32
    x = operand(600, None if op == "spmv" else 3, seed=5, dtype=dt)
    with x64(vd == "f64"):
        want = ref_apply(ref_c, fmt, op, "xla", x)
    got = port_apply(to_port(ref_c), fmt, op, backend, x)
    assert got.dtype == dt
    assert rel_err(got, want) <= (1e-12 if vd == "f64" else 1e-5)


@pytest.mark.parametrize("vd", tuple(VALUE_DTYPE_TOL))
@pytest.mark.parametrize("fmt", ("ell", "jds"))
def test_ell_jds_narrow_dtypes_within_budget(fmt, vd):
    ref_c = ell_jds_container(fmt, vd)
    x = operand(600, seed=6)
    with x64():
        oracle = ref_apply(ell_jds_container(fmt), fmt, "spmv", "xla", x.astype(np.float64))
    got = port_apply(to_port(ref_c), fmt, "spmv", "torch", x)
    assert rel_err(got, oracle) < VALUE_DTYPE_TOL[vd]
    assert rel_err(got, ref_apply(ref_c, fmt, "spmv", "xla", x)) <= 1e-5


# --- SELL SpMM: the kernel's plain version against the Pallas kernel ----------


@pytest.mark.parametrize("vd", VALUE_DTYPES)
def test_sell_spmm_plain_matches_reference_pallas_and_xla(vd):
    from repro_torch.kernels import sell_spmv as KP
    ref_c = ref_container("sell", vd)
    dt = np.float64 if vd == "f64" else np.float32
    X = operand(ref_c.shape[1], 4, seed=21, dtype=dt)
    with x64(vd == "f64"):
        want_pallas = ref_sell_spmm_pallas(ref_c, X)
        want_xla = ref_apply(ref_c, "sell", "spmm", "xla", X)
    with x64():
        oracle = ref_apply(ref_container("sell"), "sell", "spmm", "xla", X.astype(np.float64))
    s = to_port(ref_c)
    got = KP.sell_spmm_arrays(s.chunk_ptr, s.chunk_width, s.col_idx, s.val, s.scale,
                              s.perm, torch.from_numpy(X), s.shape[0], s.C).numpy()
    assert got.dtype == dt
    tol = 1e-12 if vd == "f64" else 1e-5
    assert rel_err(got, want_pallas) <= tol and rel_err(got, want_xla) <= tol
    assert rel_err(got, oracle) < VALUE_DTYPE_TOL.get(vd, 1e-12)


@pytest.mark.parametrize("op", ("spmv", "spmm"))
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "int8"))
def test_sell_padded_form_matches_reference_padded_form(vd, op):
    import jax.numpy as jnp
    from repro.kernels import sell as RS
    from repro_torch.kernels import sell as KS
    ref_c = RF.with_value_dtype(RF.SELL.from_csr(
        RF.CSR(*(np.asarray(a) for a in (ref_matrix("surrogate600").row_ptr,
                                          ref_matrix("surrogate600").col_idx)),
               np.asarray(ref_matrix("surrogate600").val, np.float64), (600, 600)),
        C=8, sigma=64), vd)
    s = to_port(ref_c)
    col3, val3 = KS.padded_views(s)
    rcol3, rval3, _ = ref_c.padded_views()
    assert np.array_equal(col3.numpy(), rcol3)
    assert np.array_equal(as_np(val3), as_np(rval3))
    dt = np.float64 if vd == "f64" else np.float32
    X = operand(600, None if op == "spmv" else 3, seed=8, dtype=dt)
    scale = None if ref_c.scale is None else jnp.asarray(ref_c.scale)
    fn_r = RS.sell_spmv_padded if op == "spmv" else RS.sell_spmm_padded
    fn_p = KS.sell_spmv_padded if op == "spmv" else KS.sell_spmm_padded
    with x64(vd == "f64"):
        want = np.asarray(fn_r(jnp.asarray(rcol3), jnp.asarray(rval3), RS._perm_arg(ref_c),
                               jnp.asarray(X), 600, scale))
    got = fn_p(col3, val3, KS.inverse_perm(s), torch.from_numpy(X), 600, s.scale).numpy()
    assert rel_err(got, want) <= (1e-12 if vd == "f64" else 1e-5)


@pytest.mark.parametrize("sigma", (1, 64, 600))
def test_sell_torch_entry_runs_the_form_the_model_picks(sigma):
    from repro_torch.core import perfmodel as PM
    from repro_torch.kernels import sell as KS
    for name in ("surrogate600", "powerlaw"):
        r = ref_matrix(name)
        s = to_port(RF.SELL.from_csr(r, C=8, sigma=min(sigma, r.shape[0])))
        # port_apply's context prices the default chip, the H100
        flat = PM.sell_xla_uses_flat(s, PM.chip_family(PM.H100))
        port_apply(s, "sell", "spmv", "torch", operand(r.shape[1]))
        assert hasattr(s, "_segment_ids") == flat
        assert hasattr(s, "_padded_views") == (not flat)
        assert KS.inverse_perm(s) is None if sigma == 1 else True
