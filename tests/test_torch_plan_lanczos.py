"""The slice end to end: ``SpMVPlan.compile`` -> ``lanczos`` in the port,
held against the reference's plan and Lanczos on the same matrix and the
same numpy start vector (f64).  The recurrences agree to 1e-8 relative;
summation order is the only difference."""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import port_matrix, ref_matrix, to_port, x64  # noqa: E402
from repro.core import formats as RF  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core.eigensolver import (  # noqa: E402
    LanczosBreakdown, ground_state_energy, lanczos, spectral_extent)
from repro_torch.core.plan import SpMVPlan  # noqa: E402
from repro_torch.core.planconfig import PlanConfig  # noqa: E402
from repro_torch.kernels.cache import precompute_stats  # noqa: E402

CPU = PlanConfig(device="cpu")


def _ref_lanczos(matrix, fmt: str, n: int, m: int, v0: np.ndarray):
    import jax.numpy as jnp
    from repro.core.eigensolver import lanczos as ref_lanczos
    from repro.core.plan import PlanConfig as RefConfig
    from repro.core.plan import SpMVPlan as RefPlan
    with x64():
        plan = RefPlan.compile(matrix, RefConfig(format=fmt, backend="xla"))
        return ref_lanczos(plan, n, m=m, v0=jnp.asarray(v0))


@pytest.mark.parametrize("fmt,name", [("csr", "surrogate1200"),
                                      ("sell", "surrogate1200"),
                                      ("hybrid", "surrogate1200"),
                                      ("dia", "exact3"),
                                      ("matrix_free", "exact3")])
def test_lanczos_matches_reference(fmt, name):
    r = ref_matrix(name)
    n = r.shape[0]
    v0 = np.random.default_rng(11).standard_normal(n)
    want = _ref_lanczos(r, fmt, n, 48, v0)
    plan = SpMVPlan.compile(to_port(r), CPU.replace(format=fmt))
    assert plan.report.format == fmt and plan.report.kernel == "torch"
    got = lanczos(plan, n, m=48, v0=v0)
    assert got.n_iterations == want.n_iterations and got.n_spmv == want.n_spmv
    for a, b in ((got.alphas, want.alphas), (got.betas, want.betas)):
        assert np.max(np.abs(a - b) / np.maximum(1e-300, np.abs(b))) <= 1e-8
    assert np.allclose(got.eigenvalues, want.eigenvalues, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("fmt", ("csr", "hybrid", "matrix_free"))
def test_exact_ground_state_matches_dense(fmt):
    m = to_port(ref_matrix("exact3"))
    e_dense = float(np.linalg.eigvalsh(m.to_dense())[0])
    plan = SpMVPlan.compile(m, CPU.replace(format=fmt))
    e0 = ground_state_energy(plan, m.shape[0], m=48,
                             v0=np.random.default_rng(3).standard_normal(m.shape[0]))
    assert abs(e0 - e_dense) <= 1e-8 * max(1.0, abs(e_dense))


def test_container_compiles_on_entry_and_spectral_extent():
    m = to_port(ref_matrix("exact3"))
    dense = np.linalg.eigvalsh(m.to_dense())
    lo, hi = spectral_extent(m, m.shape[0], m=80, config=CPU)
    assert abs(lo - dense[0]) < 1e-8 and abs(hi - dense[-1]) < 1e-8


def test_breakdown_on_poisoned_operator_and_restart():
    plan = SpMVPlan.compile(to_port(ref_matrix("exact3")), CPU.replace(format="csr"))
    n = plan.report.shape[0]

    def poisoned(x):
        y = plan(x)
        y[0] = float("nan")
        return y

    with pytest.raises(LanczosBreakdown) as e:
        lanczos(poisoned, n, m=8, device="cpu")
    assert e.value.iteration == 0

    calls = {"n": 0}

    def transient(x):  # NaN once, then healthy
        calls["n"] += 1
        y = plan(x)
        if calls["n"] == 3:
            y[1] = float("inf")
        return y

    res = lanczos(transient, n, m=8, device="cpu", on_breakdown="restart")
    assert res.n_iterations == 8 and res.n_spmv == 8 + 3
    with pytest.raises(ValueError):
        lanczos(plan, n, on_breakdown="ignore")


def test_plan_memoized_and_preprocessing_built_once():
    m = port_matrix("surrogate600")
    cfg = CPU.replace(format="hybrid")
    p1 = SpMVPlan.compile(m, cfg)
    before = precompute_stats()
    p2 = SpMVPlan.compile(m, cfg)
    assert p1 is p2 and precompute_stats() == before
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(600))
    assert torch.equal(p1(x), p2(x))
    assert precompute_stats() == before


def test_report_fields_and_fallbacks():
    m = to_port(ref_matrix("surrogate600"))
    plan = SpMVPlan.compile(m, CPU.replace(format="sell", backend="cuda"))
    # an explicit backend whose probe refuses the operand falls back to torch
    assert plan.report.kernel == "torch" and plan.report.spmm_kernel == "torch"
    assert plan.report.device == "cpu"
    # the model's fields price the kernel that runs: torch streams its form
    from repro_torch.core import perfmodel as PM
    b = PM.balance_of(plan.matrix, backend="torch")
    assert plan.report.balance_bytes_per_flop == b and plan.report.bound == "memory"
    assert plan.report.predicted_time_s == PM.predict("sell", b, m.nnz).time_s
    loop = SpMVPlan.compile(m, CPU.replace(format="sell", backend="loop_reference"))
    assert loop.report.kernel == "loop"
    assert loop.report.balance_bytes_per_flop == PM.balance_of(plan.matrix,
                                                               backend="loop_reference")


def test_plan_rejects_bad_operands():
    plan = SpMVPlan.compile(to_port(ref_matrix("exact3")), CPU.replace(format="csr"))
    n = plan.report.shape[0]
    with pytest.raises(ValueError, match="shape"):
        plan(torch.zeros(n + 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        plan.spmm(torch.zeros(n, dtype=torch.float64))
    with pytest.raises(ValueError, match="runs on cpu"):
        plan(torch.zeros(n, dtype=torch.float64, device="meta"))
    y = plan(np.ones(n))  # numpy input lands on the plan's device
    assert y.device.type == "cpu"


def test_format_auto_names_the_perfmodel_slice():
    """``format="auto"`` converts to ``perfmodel.select_format``'s pick for
    the plan's chip and backend, with the selector's own sigma."""
    from repro_torch.core import perfmodel as PM
    m = port_matrix("surrogate600")
    plan = SpMVPlan.compile(m, CPU.replace(format="auto"))
    choice = PM.select_format(m, device="cpu")
    assert plan.report.format == choice.format
    assert plan.report.predicted_time_s > 0 and plan.report.bound == "memory"
    again = SpMVPlan.compile(m, CPU.replace(format="auto", backend="torch"))
    assert again.matrix is plan.matrix  # one conversion, cached on the source
    with pytest.raises(ValueError, match="backend"):
        SpMVPlan.compile(to_port(ref_matrix("exact3")), CPU.replace(backend="xla"))


def test_value_dtype_plan_runs_quantized_container():
    r = ref_matrix("surrogate600")
    plan = SpMVPlan.compile(to_port(r), CPU.replace(format="hybrid", value_dtype="int8"))
    assert PF.container_value_dtype(plan.matrix) == "int8"
    x = np.random.default_rng(1).standard_normal(600).astype(np.float32)
    dense = RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64),
                   r.shape).to_dense()
    want = dense @ x.astype(np.float64)
    got = plan(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-2
