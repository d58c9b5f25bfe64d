"""The port's COO entries (``repro_torch.kernels.coo``) and the
type-dispatching façade (``repro_torch.core.spmv``), held against the
reference's ``coo_spmv`` / ``coo_spmm`` / ``coo_spmv_scatter`` and its
``core.spmv`` on identical containers.

Tolerances, relative to the reference's max magnitude: 1e-5 with f32
values (the same products summed in another order), 1e-12 with f64; a
narrow value dtype is held to ``VALUE_DTYPE_TOL`` against the reference's
output on the same stored values.  ``flops_of`` is exact.
"""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (  # noqa: E402
    VALUE_DTYPE_TOL, operand, ref_matrix, rel_err, to_port, x64)
from repro.core import formats as RF  # noqa: E402
from repro.core import spmv as RS  # noqa: E402
from repro.kernels import coo as RK  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core import spmv as PS  # noqa: E402
from repro_torch.core.plan import SpMVPlan  # noqa: E402
from repro_torch.core.planconfig import PlanConfig  # noqa: E402
from repro_torch.kernels import coo as PK  # noqa: E402
from repro_torch.kernels import registry as PR  # noqa: E402

TOL = {"f64": 1e-12, "f32": 1e-5}
CPU = torch.device("cpu")


def _coo(vd: str):
    """Reference COO of the L = 3 Holstein matrix with ``vd`` values."""
    r = ref_matrix("exact3")
    c = RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64), r.shape).to_coo()
    return c if vd == "f64" else RF.with_value_dtype(c, vd)


def _ref(fn, m, x, vd):
    import jax.numpy as jnp
    with x64(vd == "f64" or x.dtype == np.float64):
        return np.asarray(fn(m, jnp.asarray(x)))


def _tol(vd: str) -> float:
    return TOL.get(vd, VALUE_DTYPE_TOL.get(vd))


@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "f16", "int8"))
@pytest.mark.parametrize("op", ("spmv", "spmm", "scatter"))
def test_coo_functions_match_reference(op, vd):
    r = _coo(vd)
    p = to_port(r)
    dt = np.float64 if vd == "f64" else np.float32
    x = operand(r.shape[1], None if op != "spmm" else 5, seed=3, dtype=dt)
    ref_fn = {"spmv": RK.coo_spmv, "spmm": RK.coo_spmm, "scatter": RK.coo_spmv_scatter}[op]
    port_fn = {"spmv": PK.coo_spmv, "spmm": PK.coo_spmm, "scatter": PK.coo_spmv_scatter}[op]
    want = _ref(ref_fn, r, x, vd)
    got = port_fn(p, torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype
    assert rel_err(got, want) <= _tol(vd)


@pytest.mark.parametrize("vd", ("f64", "f32"))
@pytest.mark.parametrize("backend", ("torch", "loop_reference"))
@pytest.mark.parametrize("op", ("spmv", "spmm"))
def test_coo_registry_entries_match_reference(op, backend, vd):
    r = _coo(vd)
    p = to_port(r)
    dt = np.float64 if vd == "f64" else np.float32
    x = operand(r.shape[1], None if op == "spmv" else 4, seed=4, dtype=dt)
    want = _ref(RK.coo_spmv if op == "spmv" else RK.coo_spmm, r, x, vd)
    ctx = PR.KernelContext(device=CPU)
    ck = PR.build(p, "coo", op, backend, ctx)
    assert ck.label == ("torch" if backend == "torch" else "loop")
    assert rel_err(ck.fn(torch.from_numpy(x)).numpy(), want) <= TOL[vd]


def test_coo_entries_and_plan_on_the_host():
    """No cuda entry (the reference has no COO kernel): auto picks torch;
    the loop entry is never auto-picked; the coo plan runs from a COO and
    from a CSR converted with format="coo"."""
    assert not PR.has("coo", "spmv", "cuda") and not PR.has("coo", "spmm", "cuda")
    assert not PR.get("coo", "spmv", "loop_reference").auto
    p = to_port(_coo("f64"))
    be, costs = PR.select_backend(p, "coo", "spmv", PR.KernelContext(device=CPU))
    assert be == "torch" and set(costs) == {"torch"}
    x = torch.from_numpy(operand(p.shape[1], seed=6, dtype=np.float64))
    plan = SpMVPlan.compile(p, PlanConfig(device="cpu"))
    assert plan.report.format == "coo" and plan.report.kernel == "torch"
    csr = PF.CSR.from_coo(p)
    via_csr = SpMVPlan.compile(csr, PlanConfig(device="cpu", format="coo"))
    assert via_csr.report.format == "coo" and via_csr.matrix._tune_src is csr
    want = SpMVPlan.compile(csr, PlanConfig(device="cpu", format="csr"))(x)
    assert rel_err(plan(x).numpy(), want.numpy()) <= 1e-12
    assert rel_err(via_csr(x).numpy(), want.numpy()) <= 1e-12
    X = torch.from_numpy(operand(p.shape[1], 3, seed=7, dtype=np.float64))
    assert rel_err(plan.spmm(X).numpy(), (torch.from_numpy(p.to_dense()) @ X).numpy()) <= 1e-12


def test_coo_is_never_a_format_candidate():
    from repro_torch.core import perfmodel as PM
    assert "coo" not in PM.EXEC_EFFICIENCY["h100"]
    from repro_torch.utils.hw import H100, ChipSpec
    m = PF.CSR.from_coo(to_port(_coo("f32")))
    for spec in (H100, ChipSpec("tpu_v5e", 1.97e14, 1e12, 8.19e11),
                 ChipSpec("host_cpu", 1e12, 5e11, 20e9)):
        assert "coo" not in PM.select_format(m, chip=spec, device="cpu").predicted_time_s


# --- the façade ------------------------------------------------------------------

def _containers():
    """Every container type the façade dispatches, from one f64 matrix (the
    reference's), with the port's twin of each."""
    base = ref_matrix("laplace24")
    csr = RF.CSR(base.row_ptr, base.col_idx, np.asarray(base.val, np.float64), base.shape)
    bsr_src = RF.CSR.from_dense(np.kron(np.eye(6), np.ones((8, 8))) *
                                np.random.default_rng(2).standard_normal((48, 48)))
    return {"coo": csr.to_coo(), "csr": csr, "ell": RF.convert(csr, "ell"),
            "jds": RF.convert(csr, "jds"), "sell": RF.convert(csr, "sell"),
            "bsr": RF.convert(bsr_src, "bsr", block_shape=(8, 8)),
            "dia": RF.convert(csr, "dia"), "hybrid": RF.convert(csr, "hybrid")}


_REFS: dict = {}


def _pair(fmt: str, vd: str):
    if not _REFS:
        _REFS.update(_containers())
    r = _REFS[fmt]
    if vd != "f64":
        r = RF.with_value_dtype(r, vd)
    return r, to_port(r)


@pytest.mark.parametrize("vd", ("f64", "f32", "bf16"))
@pytest.mark.parametrize("fn", ("spmv", "spmm", "naive_spmv"))
@pytest.mark.parametrize("fmt", ("coo", "csr", "ell", "jds", "sell", "bsr", "dia", "hybrid"))
def test_facade_matches_reference(fmt, fn, vd):
    r, p = _pair(fmt, vd)
    dt = np.float64 if vd == "f64" else np.float32
    x = operand(r.shape[1], 3 if fn == "spmm" else None, seed=8, dtype=dt)
    want = _ref(getattr(RS, fn), r, x, vd)
    got = getattr(PS, fn)(p, x, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device == CPU
    assert rel_err(got.numpy(), want) <= _tol(vd)


def test_facade_runs_on_the_device_of_x_and_caches_its_executors():
    _, p = _pair("sell", "f64")
    x = torch.from_numpy(operand(p.shape[1], seed=9, dtype=np.float64))
    y = PS.spmv(p, x)
    assert y.device == CPU and torch.equal(PS.make_spmv(p)(x), y)
    assert set(p._facade_fns) == {("spmv", "torch", "cpu")}
    assert torch.equal(PS.make_naive_spmv(p, device="cpu")(x.numpy()), PS.naive_spmv(p, x))
    with pytest.raises(ValueError, match="not on the requested"):
        PS.spmv(p, x, device="meta")


def test_facade_numpy_goes_to_the_card_unless_asked(monkeypatch):
    """A numpy x with no device asks for the card: without one the call
    raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, p = _pair("csr", "f64")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.spmv(p, np.ones(p.shape[1]))
    assert PS.spmv(p, np.ones(p.shape[1]), device="cpu").device == CPU


def test_facade_refuses_unknown_containers():
    op = PF.detect_matrix_free(to_port(ref_matrix("laplace24")))
    for fn in (PS.spmv, PS.spmm, PS.naive_spmv):
        with pytest.raises(TypeError, match="MatrixFreeOperator"):
            fn(op, np.ones(op.shape[1]), device="cpu")


@pytest.mark.parametrize("fmt", ("coo", "csr", "ell", "jds", "sell", "bsr", "dia", "hybrid"))
def test_flops_of_is_exact(fmt):
    r, p = _pair(fmt, "f32")
    assert PS.flops_of(p) == RS.flops_of(r) == 2 * r.nnz
