"""The Holstein-Hubbard Hamiltonian as a generated electron x phonon
operator (``core.matrices.holstein_hubbard_operator``, format
``mf_product``) against the CSR that ``holstein_hubbard_exact`` stores: the
same rows, nonzeros and entries, its products to f64 rounding (the sums run
in another order), Lanczos as on the CSR plan, the build counter and span.

The ``cuda`` tests hold the kernel to the composite entry at HMeP's N =
1,201,200 and its CUDA-graph Lanczos bitwise to the eager loop; they need
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mf_product.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import matrices as M
from repro_torch.core import eigensolver as E
from repro_torch.core.eigensolver import lanczos
from repro_torch.core.formats import ElectronPhononOperator
from repro_torch.core.plan import SpMVPlan
from repro_torch.core.planconfig import PlanConfig
from repro_torch.kernels import cuda_build as CB
from repro_torch.kernels import mf_product as MP
from repro_torch.kernels import registry as R
from repro_torch.utils import spans

CPU = PlanConfig(device="cpu", format="mf_product")
#: the paper's HMeP: 400 electron states x 3003 phonon states
HMEP = M.HolsteinHubbardParams(L=6, n_up=3, n_dn=3, max_phonon=8, max_total_phonon=8)
CASES = {
    "L4-2+2-cap3": M.HolsteinHubbardParams(L=4, n_up=2, n_dn=2, max_phonon=3,
                                           max_total_phonon=3),
    "L6-3+3-cap2": M.HolsteinHubbardParams(L=6, n_up=3, n_dn=3, max_phonon=2,
                                           max_total_phonon=2),
    "L4-1+1-M2": M.HolsteinHubbardParams(L=4, n_up=1, n_dn=1, max_phonon=2),
    "L5-2+1-cap3-open": M.HolsteinHubbardParams(L=5, n_up=2, n_dn=1, max_phonon=2,
                                                max_total_phonon=3, g=0.7, periodic=False),
}
_CSR: dict = {}


def csr_of(name: str) -> torch.Tensor:
    """The CSR of ``holstein_hubbard_exact`` as a torch sparse tensor (cached)."""
    if name not in _CSR:
        c = M.holstein_hubbard_exact(CASES[name])
        _CSR[name] = (c, torch.sparse_csr_tensor(c.row_ptr.long(), c.col_idx.long(), c.val,
                                                 size=c.shape))
    return _CSR[name]


def rel(y, want) -> float:
    return float((y - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", CASES)
def test_rows_and_nonzeros_are_the_csr_s(name):
    c, _ = csr_of(name)
    op = M.holstein_hubbard_operator(CASES[name])
    assert isinstance(op, ElectronPhononOperator)
    assert op.shape == c.shape and op.nnz == c.nnz
    assert op.n_el * op.n_ph == op.shape[0]


@pytest.mark.parametrize("backend", ("torch", "loop_reference"))
@pytest.mark.parametrize("name", CASES)
def test_spmv_matches_the_csr_product(name, backend):
    _, A = csr_of(name)
    plan = SpMVPlan.compile(M.holstein_hubbard_operator(CASES[name]),
                            CPU.replace(backend=backend))
    assert plan.report.format == "mf_product"
    assert plan.report.kernel == ("loop" if backend == "loop_reference" else "torch")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(A.shape[0]))
    assert rel(plan(x), A @ x) <= 1e-14


@pytest.mark.parametrize("name", CASES)
def test_spmm_at_k4_matches_the_csr_product(name):
    _, A = csr_of(name)
    plan = SpMVPlan.compile(M.holstein_hubbard_operator(CASES[name]), CPU)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((A.shape[0], 4)))
    Y = plan.spmm(X)
    assert Y.shape == (A.shape[0], 4) and rel(Y, A @ X) <= 1e-14
    assert torch.equal(Y[:, 2], plan(X[:, 2].contiguous()))


def test_entries_equal_the_csr_s_bitwise():
    """Each column of the identity picks one entry a row out of the sums:
    the generated values are the stored ones, bit for bit."""
    c, _ = csr_of("L4-1+1-M2")
    plan = SpMVPlan.compile(M.holstein_hubbard_operator(CASES["L4-1+1-M2"]), CPU)
    n = c.shape[0]
    assert torch.equal(plan.spmm(torch.eye(n, dtype=torch.float64)).T,
                       torch.from_numpy(c.to_dense()))


def test_plain_version_is_the_kernel_wrapper_on_the_host():
    op = M.holstein_hubbard_operator(CASES["L4-2+2-cap3"])
    launch = MP.product_launch(op)
    assert MP.product_launch(op) is launch
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(op.shape[0]))
    before = CB.launch_counts()
    assert torch.equal(MP.mf_product_arrays(launch, x), MP.mf_product_plain(launch.tables, x))
    assert CB.launch_counts() == before
    with pytest.raises(ValueError, match="columns"):
        MP.mf_product_arrays(launch, x[:-1])
    with pytest.raises(TypeError, match="ProductLaunch"):
        MP.mf_product_arrays(op, x)


def emulate_kernel(launch, x: np.ndarray) -> np.ndarray:
    """csrc/mf_product.cu's walk in numpy, from the kernel's own tables: the
    records decoded as the kernel decodes them, c_i(e) * sqrt(n) formed as
    its shared table, each row summed in its order (a site with no electron
    and the hop padding skipped for the whole electron state)."""
    k = {name: t.numpy() for name, t in launch.kernel.items()}
    rec = k["ph_record"].view(np.uint32).astype(np.int64)
    n_el, n_ph, L = launch.n_el, launch.n_ph, launch.n_sites
    occ = np.stack([(rec[:, 6 + i // 4] >> (8 * (i % 4))) & 0xFF for i in range(L)], 1)
    up, dn = rec[:, :L] & 0xFFFF, rec[:, :L] >> 16
    X = x.reshape(n_el, n_ph)
    y = np.empty_like(X)
    for e in range(n_el):
        xe = X[e]
        d = k["el_diag"][e] + launch.omega0 * occ.sum(axis=1).astype(np.float64)
        acc = np.where(d != 0, d * xe, 0.0)
        for i in range(L):
            cs = k["el_coup"][e, i] * k["sqrt_n"]
            if cs[1] == 0.0:
                continue
            for rank, o in ((up[:, i], occ[:, i] + 1), (dn[:, i], occ[:, i])):
                acc = acc + np.where(rank != 0xFFFF, cs[o] * xe[np.minimum(rank, n_ph - 1)], 0.0)
        for t, v in zip(k["hop_target"][e], k["hop_value"][e]):
            if t < 0:
                break
            acc = acc + v * X[t]
        y[e] = acc
    return y.reshape(-1)


@pytest.mark.parametrize("name", CASES)
def test_kernel_walk_gives_the_plain_version_s_values(name):
    launch = MP.ProductLaunch(M.holstein_hubbard_operator(CASES[name]))
    x = np.random.default_rng(8).standard_normal(launch.shape[0])
    want = MP.mf_product_plain(launch.tables, torch.from_numpy(x)).numpy()
    assert np.array_equal(emulate_kernel(launch, x), want)


@pytest.mark.parametrize("name", ("L4-2+2-cap3", "L5-2+1-cap3-open"))
def test_lanczos_matches_the_csr_plan(name):
    c, _ = csr_of(name)
    n = c.shape[0]
    v0 = np.random.default_rng(4).standard_normal(n)
    got = lanczos(SpMVPlan.compile(M.holstein_hubbard_operator(CASES[name]), CPU), n, m=40,
                  v0=v0, reorthogonalize=False)
    want = lanczos(SpMVPlan.compile(c, PlanConfig(device="cpu", format="csr")), n, m=40,
                   v0=v0, reorthogonalize=False)
    assert got.n_iterations == want.n_iterations == 40
    for a, b in ((got.alphas, want.alphas), (got.betas, want.betas)):
        assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b))
    assert abs(got.eigenvalues[0] - want.eigenvalues[0]) <= 1e-12 * abs(want.eigenvalues[0])


def test_hmep_size_and_tables():
    op = M.holstein_hubbard_operator(HMEP)
    assert op.shape == (1_201_200, 1_201_200) and op.nnz == 16_027_420
    assert (op.n_el, op.n_ph, op.n_sites) == (400, 3003, 6)
    assert int(op.ph_occ.sum(dim=1).max()) == 8 and int(op.el_occ.max()) == 2
    assert op.table_bytes() < 1 << 20


def test_build_stats_count_each_build():
    M.reset_build_stats()
    op = M.holstein_hubbard_operator(CASES["L4-2+2-cap3"])
    s = M.build_stats()
    assert s["builds"] == 1 and s["build_s"] > 0 and s["table_bytes"] == op.table_bytes()
    M.holstein_hubbard_operator(CASES["L4-1+1-M2"])
    assert M.build_stats()["builds"] == 2
    M.reset_build_stats()
    assert M.build_stats() == {"builds": 0, "build_s": 0.0, "table_bytes": 0}


def test_build_is_the_operator_build_span():
    assert "operator.build" in spans.NAMES
    spans.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        M.holstein_hubbard_operator(CASES["L4-1+1-M2"])
    assert spans.totals()["operator.build"]["n"] == 1
    spans.reset()


def test_csr_source_is_refused_for_mf_product():
    c, _ = csr_of("L4-1+1-M2")
    with pytest.raises(ValueError, match="holstein_hubbard_operator"):
        SpMVPlan.compile(c, CPU)


def test_registry_holds_the_entries():
    keys = {e.key for e in R.entries("mf_product")}
    assert keys == {("mf_product", op, b) for op in ("spmv", "spmm")
                    for b in ("torch", "loop_reference")} | {("mf_product", "spmv", "cuda")}
    assert "mf_product" in CB.KERNELS and CB.SOURCE_OF["mf_product"] == "mf_product"


def test_launch_refuses_what_the_kernel_cannot_hold():
    wide = M.holstein_hubbard_operator(M.HolsteinHubbardParams(
        L=MP.MAX_SITES + 1, n_up=1, n_dn=0, max_phonon=1, max_total_phonon=1))
    with pytest.raises(ValueError, match="sites"):
        MP.ProductLaunch(wide)
    big = M.holstein_hubbard_operator(M.HolsteinHubbardParams(
        L=2, n_up=1, n_dn=1, max_phonon=MP.SQRT_TABLE - 1))
    with pytest.raises(ValueError, match="sqrt table"):
        MP.ProductLaunch(big)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_entry_matches_the_composite_at_hmep_size(cuda_device):
    op = M.holstein_hubbard_operator(HMEP)
    cuda = SpMVPlan.compile(op, PlanConfig(device=cuda_device, format="mf_product"))
    plain = SpMVPlan.compile(op, PlanConfig(device=cuda_device, format="mf_product",
                                            backend="torch"))
    assert cuda.report.kernel == "cuda" and plain.report.kernel == "torch"
    assert cuda.report.spmm_kernel == "torch"  # an SpMM runs the composite entry
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(op.shape[0])).to(cuda_device)
    before = CB.launch_counts()["mf_product"]
    y = cuda(x)
    torch.cuda.synchronize()
    assert CB.launch_counts()["mf_product"] == before + 1
    assert torch.equal(y, plain(x))           # the same sums in the same order
    X = torch.from_numpy(np.random.default_rng(6).standard_normal((op.shape[0], 3)))
    X = X.to(cuda_device)
    assert torch.equal(cuda.spmm(X)[:, 1], cuda(X[:, 1].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", (16, 96))
def test_cuda_graph_lanczos_bitwise_the_eager_loop(cuda_device, steps):
    plan = SpMVPlan.compile(M.holstein_hubbard_operator(HMEP),
                            PlanConfig(device=cuda_device, format="mf_product"))
    n = plan.report.shape[0]
    v0 = torch.from_numpy(np.random.default_rng(7).standard_normal(n)).to(cuda_device)
    c0 = E.graph_counts()
    got = lanczos(plan, n, m=steps, v0=v0, reorthogonalize=False)
    assert E.graph_counts()["replayed_solves"] == c0["replayed_solves"] + 1
    before = CB.launch_counts()["mf_product"]
    want = lanczos(lambda x: plan(x), n, m=steps, v0=v0, reorthogonalize=False)
    assert CB.launch_counts()["mf_product"] == before + steps
    for a, b in ((got.alphas, want.alphas), (got.betas, want.betas),
                 (got.eigenvalues, want.eigenvalues)):
        assert np.array_equal(a, b)
    assert got.n_spmv == want.n_spmv == steps
