"""The port's input validation (``repro_torch.core.validate``) and
``PlanConfig`` coercion, held against the reference's.  Reports, repaired
arrays and verdicts must be equal: the same problems in the same words,
the repaired container bitwise, the same exception class and message.
Vector checks run on torch tensors (here on the host; the card's in
``test_torch_on_card.py``) and numpy arrays."""
import warnings

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import assert_same_container  # noqa: E402
from repro.core import formats as RF  # noqa: E402
from repro.core import planconfig as RPC  # noqa: E402
from repro.core import validate as RV  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core import planconfig as PPC  # noqa: E402
from repro_torch.core import validate as PV  # noqa: E402
from repro_torch.core.plan import SpMVPlan  # noqa: E402


def _csr(pkg, rp, col, val, shape):
    if pkg is RF:
        return RF.CSR(np.asarray(rp, np.int32), np.asarray(col, np.int32),
                      np.asarray(val), shape)
    return PF.CSR(torch.from_numpy(np.asarray(rp, np.int32)),
                  torch.from_numpy(np.asarray(col, np.int32)),
                  torch.from_numpy(np.asarray(val)), shape)


def _coo(pkg, rows, cols, vals, shape):
    return pkg.COO(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                   np.asarray(vals), shape)


def _clean(pkg, n=9, dtype=np.float32):
    rng = np.random.default_rng(3)
    dense = (rng.random((n, n)) < 0.4) * rng.standard_normal((n, n))
    rows, cols = np.nonzero(dense)
    return pkg.CSR.from_coo(_coo(pkg, rows, cols, dense[rows, cols].astype(dtype), (n, n)))


#: (kind, rows/row_ptr, cols, vals, shape): one case per check
CASES = {
    "clean": None,
    "oob_col": ("csr", [0, 2, 3], [0, 99, 1], [1.0, 2.0, 3.0], (2, 4)),
    "oob_negative_coo": ("coo", [0, -1, 1], [0, 1, 1], [1.0, 2.0, 3.0], (2, 2)),
    "row_ptr_not_monotone": ("csr", [0, 2, 1], [0, 1], [1.0, 2.0], (2, 2)),
    "row_ptr_wrong_length": ("csr", [0, 2], [0, 1], [1.0, 2.0], (2, 2)),
    "row_ptr_nnz_mismatch": ("csr", [0, 1, 1], [0, 1], [1.0, 2.0], (2, 2)),
    "duplicates_coo": ("coo", [0, 0, 1, 1, 1], [1, 1, 0, 2, 2], [2.0, 3.0, 1.0, 4.0, 5.0],
                       (2, 3)),
    "duplicates_csr": ("csr", [0, 2, 3], [1, 1, 0], [2.0, 3.0, 1.0], (2, 2)),
    "unsorted_cols": ("csr", [0, 3, 4], [3, 1, 2, 0], [1.0, 2.0, 3.0, 4.0], (2, 4)),
    "unsorted_coo": ("coo", [1, 0, 0], [0, 2, 1], [1.0, 2.0, 3.0], (2, 3)),
    "nan": ("coo", [0, 1, 1], [0, 1, 0], [np.nan, 2.0, 3.0], (2, 2)),
    "inf": ("csr", [0, 1, 3], [0, 0, 1], [1.0, -np.inf, np.inf], (2, 2)),
    "nan_and_oob_and_dup": ("coo", [0, 0, 0, 5, 1], [0, 0, 1, 0, 1],
                            [1.0, np.nan, 2.0, 3.0, 4.0], (2, 2)),
}


def _case(pkg, name, dtype=np.float32):
    if CASES[name] is None:
        return _clean(pkg, dtype=dtype)
    kind, a, b, v, shape = CASES[name]
    v = np.asarray(v, dtype)
    return _csr(pkg, a, b, v, shape) if kind == "csr" else _coo(pkg, a, b, v, shape)


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
@pytest.mark.parametrize("name", sorted(CASES))
def test_inspect_repair_validate_match_reference(name, dtype):
    r, p = _case(RF, name, dtype), _case(PF, name, dtype)
    rep_r, rep_p = RV.inspect_matrix(r), PV.inspect_matrix(p)
    assert rep_p.problems == rep_r.problems and rep_p.ok == rep_r.ok
    if name == "clean":
        assert rep_p.ok and PV.validate_matrix(p) is p
        assert PV.repair_matrix(p) == (p, [])
    # strict: the same class and message, or the same container back
    try:
        want = RV.validate_matrix(r, "strict")
    except RV.ValidationError as e:
        want = e
    try:
        got = PV.validate_matrix(p, "strict")
    except PV.ValidationError as e:
        got = e
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__ and str(got) == str(want)
    else:
        assert want is r and got is p
    assert PV.validate_matrix(p, "off") is p
    if name.startswith("row_ptr"):
        return                        # not repairable: its rows cannot be recovered
    fixed_r, log_r = RV.repair_matrix(r)
    fixed_p, log_p = PV.repair_matrix(p)
    assert log_p == log_r
    assert_same_container(fixed_r, fixed_p)
    assert getattr(fixed_p, "_repairs", ()) == getattr(fixed_r, "_repairs", ())
    assert_same_container(RV.validate_matrix(r, "repair"), PV.validate_matrix(p, "repair"))
    assert PV.inspect_matrix(fixed_p).ok


def test_repair_keeps_the_source_and_plan_compile_validates():
    bad = _csr(PF, [0, 1], [99], np.asarray([1.0], np.float32), (1, 4))
    object.__setattr__(bad, "_source", "here.mtx")
    fixed = PV.validate_matrix(bad, "repair")
    assert fixed._source == "here.mtx" and fixed.nnz == 0
    with pytest.raises(PV.MatrixValidationError, match="out of range"):
        SpMVPlan.compile(bad, PPC.PlanConfig(device="cpu", validate="strict"))
    plan = SpMVPlan.compile(bad, PPC.PlanConfig(device="cpu", validate="repair"))
    assert plan.report.nnz == 0
    # validation is off at the plan layer by default
    assert SpMVPlan.compile(_clean(PF), PPC.PlanConfig(device="cpu")).report.nnz > 0


def test_packed_containers_pass_through_and_policies_are_checked():
    s = PF.SELL.from_csr(_clean(PF))
    assert PV.validate_matrix(s, "strict") is s
    with pytest.raises(ValueError, match="unknown validation policy"):
        PV.validate_matrix(_clean(PF), policy="lenient")
    with pytest.raises(TypeError, match="CSR or COO"):
        PV.inspect_matrix(s)


@pytest.mark.parametrize("target", ("f32", "f16", "f64"))
def test_dtype_overflow_matches_reference(target):
    vals = np.array([1.0, 1e300, -4e38, 7e4, np.inf, np.nan, 6e4], np.float64)
    np_dt = {"f32": np.float32, "f16": np.float16, "f64": np.float64}[target]
    want = RV.dtype_overflow_count(vals, np_dt)
    for t in (np_dt, target, {"f32": torch.float32, "f16": torch.float16,
                              "f64": torch.float64}[target]):
        assert PV.dtype_overflow_count(vals, t) == want
    r = _coo(RF, np.arange(7), np.arange(7), vals, (7, 7))
    p = _coo(PF, np.arange(7), np.arange(7), vals, (7, 7))
    assert PV.inspect_matrix(p, value_dtype=np_dt).problems == \
        RV.inspect_matrix(r, value_dtype=np_dt).problems


def test_bf16_overflow_is_counted():
    """bf16's largest finite value is 3.39e38: 1e300 and -4e38 overflow.
    The reference's table has no bf16 row and counts 0 (a value that
    becomes Inf passes its check); the port counts them."""
    import ml_dtypes
    vals = np.array([1.0, 1e300, -4e38, 3e38], np.float64)
    assert RV.dtype_overflow_count(vals, ml_dtypes.bfloat16) == 0
    assert PV.dtype_overflow_count(vals, "bf16") == 2
    assert PV.dtype_overflow_count(vals, torch.bfloat16) == 2
    big = _coo(PF, np.arange(4), np.arange(4), vals, (4, 4))
    with pytest.raises(PV.MatrixValidationError, match="overflow to Inf when cast to bf16"):
        PV.validate_matrix(big, value_dtype="bf16")
    assert PV.dtype_overflow_count(vals, np.int32) == 0          # no finite limit here


def test_error_hierarchy_and_format_error_provenance():
    assert issubclass(PV.MatrixValidationError, PV.ValidationError)
    assert issubclass(PV.VectorValidationError, PV.ValidationError)
    assert issubclass(PV.MatrixFormatError, PV.ValidationError)
    assert issubclass(PV.ValidationError, ValueError)
    for kw in (dict(path="a.mtx", line=3), dict(path="a.mtx"), {}):
        r, p = RV.MatrixFormatError("bad", **kw), PV.MatrixFormatError("bad", **kw)
        assert (str(p), p.path, p.line) == (str(r), r.path, r.line)


@pytest.mark.parametrize("kind", ("tensor", "numpy"))
def test_validate_vector_policies(kind):
    import jax.numpy as jnp

    def mk(v, dtype=np.float32):
        a = np.asarray(v, dtype)
        return torch.from_numpy(a) if kind == "tensor" else a

    for policy in ("strict", "repair", "off"):
        with pytest.raises(PV.VectorValidationError, match="expected") as e:
            PV.validate_vector(mk(np.zeros(3)), 4, policy=policy)
        with pytest.raises(RV.VectorValidationError) as f:
            RV.validate_vector(jnp.zeros(3), 4, policy=policy)
        assert str(e.value) == str(f.value)
    x = mk([1.0, 2.0, 3.0])
    assert PV.validate_vector(x, 3) is x
    with pytest.raises(PV.VectorValidationError, match="non-finite"):
        PV.validate_vector(mk([1.0, np.nan, 3.0]), 3)
    deferred = mk([1.0, np.inf])
    assert PV.validate_vector(deferred, 2, defer_finite=True) is deferred
    rep = PV.validate_vector(mk([1.0, np.nan, -np.inf]), 3, policy="repair")
    assert type(rep) is type(x) and np.array_equal(np.asarray(rep), [1.0, 0.0, 0.0])
    off = mk([np.nan])
    assert PV.validate_vector(off, 1, policy="off") is off
    with pytest.raises(PV.VectorValidationError, match="floating dtype"):
        PV.validate_vector(mk([1, 2], np.int32), 2)
    with pytest.raises(ValueError, match="unknown validation policy"):
        PV.validate_vector(x, 3, policy="lenient")


@pytest.mark.parametrize("rows", (6, 0))
@pytest.mark.parametrize("dtype", (np.float16, np.float32, np.float64))
def test_check_finite_columns_matches_reference(dtype, rows):
    import jax.numpy as jnp
    Y = np.random.default_rng(0).standard_normal((rows, 5)).astype(dtype)
    if rows:
        Y[2, 1], Y[5, 3], Y[0, 4], Y[3, 4] = np.nan, np.inf, -np.inf, np.nan
    want = RV.check_finite_columns(jnp.asarray(Y))
    got_t = PV.check_finite_columns(torch.from_numpy(Y))
    assert got_t.dtype == torch.bool and got_t.device == torch.device("cpu")
    assert np.array_equal(got_t.numpy(), want)
    assert np.array_equal(PV.check_finite_columns(Y), want)


def test_coerce_config_contract_matches_reference():
    pairs = []
    for mod in (RPC, PPC):
        out = {}
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out["kw"] = mod.coerce_config(None, {"format": "csr"}, api="X.compile")
        out["warn"] = [(x.category, str(x.message)) for x in w]
        for name, args in (("both", (mod.PlanConfig(), {"format": "csr"})),
                           ("unknown", (None, {"formatt": "csr"})),
                           ("notconfig", ("csr", {}))):
            with pytest.raises((ValueError, TypeError)) as e:
                mod.coerce_config(*args, api="X.compile")
            out[name] = (e.type, str(e.value).split(";")[0])
        pairs.append(out)
    r, p = pairs
    assert p["kw"] == PPC.PlanConfig(format="csr") and r["kw"].format == "csr"
    assert p["warn"] == r["warn"] and p["warn"][0][0] is DeprecationWarning
    assert p["both"] == r["both"] and p["both"][0] is ValueError
    assert p["unknown"] == r["unknown"] and p["unknown"][0] is TypeError
    assert p["notconfig"] == r["notconfig"] and p["notconfig"][0] is TypeError
    cfg = PPC.PlanConfig(format="sell")
    assert PPC.coerce_config(cfg, {}, api="X") is cfg
    assert PPC.coerce_config(None, {}, api="X") == PPC.PlanConfig()


def test_plan_compile_takes_bare_kwargs_with_a_warning():
    m = _clean(PF)
    with pytest.warns(DeprecationWarning, match="SpMVPlan.compile"):
        plan = SpMVPlan.compile(m, format="csr", device="cpu")
    assert plan is SpMVPlan.compile(m, PPC.PlanConfig(format="csr", device="cpu"))
    with pytest.raises(ValueError, match="not both"):
        SpMVPlan.compile(m, PPC.PlanConfig(device="cpu"), format="csr")


@pytest.mark.parametrize("sigma,permute,n_rows", [
    (None, True, None), (None, True, 100), (64, True, None), (64, True, 10),
    (0, True, None), (None, False, 50), (32, False, None)])
def test_sigma_helpers_match_reference(sigma, permute, n_rows):
    r = RPC.PlanConfig(sigma=sigma, permute=permute)
    p = PPC.PlanConfig(sigma=sigma, permute=permute)
    assert p.effective_sigma(n_rows) == r.effective_sigma(n_rows)
    assert p.sigma_is_default() == r.sigma_is_default()
    assert p.sell_kwargs() == r.sell_kwargs()
    assert PPC.default_sell_sigma() == RPC.default_sell_sigma()
