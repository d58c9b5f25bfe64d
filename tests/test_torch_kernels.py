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
    VALUE_DTYPE_TOL, operand, port_apply, ref_apply, ref_matrix, rel_err,
    to_port, x64)
from repro.core import formats as RF  # noqa: E402
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
    assert cuda_spmm == {"matrix_free"}  # SELL SpMM kernel: next slice


@pytest.mark.parametrize("fmt", FORMATS)
def test_auto_backend_is_torch_on_cpu_and_cuda_refuses_with_reason(fmt):
    obj = to_port(ref_container(fmt, "f32"))
    ctx = PR.KernelContext(device=torch.device("cpu"))
    assert PR.select_backend(obj, fmt, "spmv", ctx) == "torch"
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
    xm = dia_spmv.pad_x(torch.from_numpy(operand(op.shape[0], seed=8)), p0, p1,
                        torch.float32)
    data = matrix_free.mf_data(op)
    yield ("mf_spmv",
           lambda: matrix_free.mf_spmv_arrays(data, desc, gen, xm, p0, op.shape[0]),
           lambda: matrix_free.mf_spmv_plain(data, desc, gen, xm, p0, op.shape[0]))


@pytest.mark.parametrize("idx", range(4), ids=CB.KERNELS)
def test_wrapper_on_cpu_tensor_runs_the_plain_version_and_counts_nothing(idx):
    name, wrapper, plain = list(_wrapper_cases())[idx]
    before = CB.launch_counts()
    got = wrapper()
    assert CB.launch_counts() == before  # a launch is counted only on the card
    assert torch.equal(got, plain())
