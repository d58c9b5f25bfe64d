"""The CUDA kernels on the card, each held against its plain PyTorch
version through the plan layer.  Every test is marked ``cuda`` and skips
without a CUDA device.  The file needs no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_on_card.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import port_matrix
from repro_torch.core import formats as PF
from repro_torch.core.plan import SpMVPlan
from repro_torch.core.planconfig import PlanConfig
from repro_torch.kernels import cuda_build as CB


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "f16", "fp8_e4m3", "int8"))
@pytest.mark.parametrize("fmt", ("csr", "sell", "dia", "hybrid"))
def test_cuda_plan_matches_torch_plan_on_the_card(cuda_device, fmt, vd):
    m = PF.convert(port_matrix("surrogate3000"), fmt) if fmt != "dia" else \
        PF.DIA.from_csr(port_matrix("laplace48"))
    m = PF.with_value_dtype(m, vd)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(m.shape[1])).to(
        cuda_device, torch.float64 if vd == "f64" else torch.float32)
    kern = SpMVPlan.compile(m, PlanConfig(device=cuda_device))
    plain = SpMVPlan.compile(m, PlanConfig(device=cuda_device, backend="torch"))
    assert kern.report.kernel == "cuda" and plain.report.kernel == "torch"
    before = CB.launch_counts()
    got, want = kern(x), plain(x)
    torch.cuda.synchronize()
    assert sum(CB.launch_counts().values()) > sum(before.values())
    tol = 1e-12 if x.dtype == torch.float64 else 1e-5
    assert float((got - want).abs().max() / want.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "f16"))
def test_cuda_matrix_free_matches_torch_on_the_card(cuda_device, vd):
    op = PF.with_value_dtype(PF.detect_matrix_free(port_matrix("exact4")), vd)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal((op.shape[0], 3))).to(
        cuda_device)
    kern = SpMVPlan.compile(op, PlanConfig(device=cuda_device))
    plain = SpMVPlan.compile(op, PlanConfig(device=cuda_device, backend="torch"))
    assert kern.report.kernel == "cuda" and kern.report.spmm_kernel == "cuda"
    assert torch.allclose(kern(X[:, 0]), plain(X[:, 0]), rtol=0, atol=1e-12)
    assert torch.allclose(kern.spmm(X), plain.spmm(X), rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("K", (1, 3, 16, 40))
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "f16", "fp8_e4m3", "int8"))
def test_cuda_sell_spmm_matches_torch_on_the_card(cuda_device, vd, K):
    m = PF.with_value_dtype(PF.convert(port_matrix("surrogate3000"), "sell"), vd)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((m.shape[1], K))).to(
        cuda_device, torch.float64 if vd == "f64" else torch.float32)
    kern = SpMVPlan.compile(m, PlanConfig(device=cuda_device))
    plain = SpMVPlan.compile(m, PlanConfig(device=cuda_device, backend="torch"))
    assert kern.report.spmm_kernel == "cuda"
    before = CB.launch_counts()["sell_spmm"]
    got, want = kern.spmm(X), plain.spmm(X)
    torch.cuda.synchronize()
    assert CB.launch_counts()["sell_spmm"] == before + 1
    tol = 1e-12 if X.dtype == torch.float64 else 1e-5
    assert float((got - want).abs().max() / want.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n", (4096, 4097, 1 << 20))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_cuda_triad_and_gather_match_plain_on_the_card(cuda_device, dtype, n):
    from repro_torch.kernels import gather_bench as GB
    g = torch.Generator(device="cpu").manual_seed(0)
    a, b, c = (torch.randn(n, generator=g, dtype=dtype).to(cuda_device) for _ in range(3))
    before = CB.launch_counts()
    assert torch.equal(GB.stream_triad(a, b, c), GB.stream_triad_plain(a, b, c))
    # an unaligned view takes the scalar path and still agrees
    assert torch.equal(GB.stream_triad(a[1:], b[1:], c[1:]),
                       GB.stream_triad_plain(a[1:], b[1:], c[1:]))
    idx = torch.randint(0, n, (n,), generator=g, dtype=torch.int32).to(cuda_device)
    assert torch.equal(GB.gather_scp(a, idx, c), GB.gather_scp_plain(a, idx, c))
    torch.cuda.synchronize()
    after = CB.launch_counts()
    assert after["stream_triad"] == before["stream_triad"] + 2
    assert after["gather_scp"] == before["gather_scp"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("chip", ("tpu_v5e", "host_cpu", "other_gpu"))
@pytest.mark.parametrize("fmt", ("csr", "sell", "dia", "hybrid", "matrix_free"))
def test_cuda_kernel_runs_whatever_chip_the_plan_prices(cuda_device, fmt, chip):
    from repro_torch.utils.hw import ChipSpec
    src = port_matrix("laplace48") if fmt in ("dia", "matrix_free") else \
        port_matrix("surrogate3000")
    m = PF.convert(src, fmt)
    spec = ChipSpec(chip, 1e13, 5e12, 1e12)
    plan = SpMVPlan.compile(m, PlanConfig(device=cuda_device, chip=spec))
    assert plan.report.kernel == "cuda"
    assert plan.report.spmm_kernel == ("cuda" if fmt in ("sell", "matrix_free") else "torch")


# --- kernel 6 (BELL block SpMM) and kernel 7 (grouped MoE GEMM) -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("N", (1, 3, 8, 40, 64))
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "f16", "fp8_e4m3", "int8"))
@pytest.mark.parametrize("blk", ((8, 128), (16, 128), (8, 8)), ids=str)
def test_cuda_bell_spmm_matches_plain_on_the_card(cuda_device, blk, vd, N):
    from repro_torch.core.matrices import block_sparse_dense
    from repro_torch.kernels import bsr_spmm as KB
    m, n = (96, 512) if blk[1] == 128 else (96, 64)
    b = PF.with_value_dtype(PF.BSR.from_dense(block_sparse_dense(m, n, blk, 0.4, seed=1),
                                              blk), vd)
    bc, sl = KB.bsr_to_bell(b)
    sc, ln = KB.bell_scale(b), KB.bell_row_nblocks(b)
    bc, sl, ln = bc.to(cuda_device), sl.to(cuda_device), ln.to(cuda_device)
    sc = None if sc is None else sc.to(cuda_device)
    X = torch.from_numpy(np.random.default_rng(3).standard_normal((n, N))).to(
        cuda_device, torch.float64 if vd == "f64" else torch.float32)
    before = CB.launch_counts()["bell_spmm"]
    got = KB.bell_spmm_arrays(bc, sl, X, sc, ln, m - blk[0])
    want = KB.bell_spmm_plain(bc, sl, X, sc, m - blk[0])
    torch.cuda.synchronize()
    assert CB.launch_counts()["bell_spmm"] == before + 1
    assert got.shape == want.shape == (m - blk[0], N) and got.dtype == want.dtype
    tol = 1e-12 if X.dtype == torch.float64 else 1e-5
    assert float((got - want).abs().max() / want.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "int8"))
def test_cuda_bsr_plan_and_sparse_linear_on_the_card(cuda_device, vd):
    from repro_torch.core.matrices import block_sparse_dense
    from repro_torch.models.sparse import SparseLinear
    d = block_sparse_dense(256, 512, (8, 128), 0.3, seed=2)
    m = PF.with_value_dtype(PF.convert(PF.CSR.from_dense(d), "bsr"), vd)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(512)).to(
        cuda_device, torch.float64 if vd == "f64" else torch.float32)
    kern = SpMVPlan.compile(m, PlanConfig(device=cuda_device))
    plain = SpMVPlan.compile(m, PlanConfig(device=cuda_device, backend="torch"))
    assert kern.report.kernel == kern.report.spmm_kernel == "cuda"
    before = CB.launch_counts()["bell_spmm"]
    got, want = kern(x), plain(x)
    torch.cuda.synchronize()
    assert CB.launch_counts()["bell_spmm"] == before + 1
    tol = 1e-12 if x.dtype == torch.float64 else 1e-5
    assert float((got - want).abs().max() / want.abs().max()) <= tol
    lin = SparseLinear("bsr", PF.with_value_dtype(PF.BSR.from_dense(d), vd),
                       device=cuda_device)
    xb = x.float().reshape(1, -1).repeat(4, 1)
    y = lin(xb)
    ref = xb.double() @ torch.from_numpy(d).to(cuda_device).double().T
    budget = {"f64": 1e-5, "f32": 1e-5, "bf16": 3e-2, "int8": 5e-2}[vd]
    assert float((y - ref).abs().max() / ref.abs().max()) < budget


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", ("f32", "bf16", "f32-bf16", "bf16-f32"))
@pytest.mark.parametrize("bt,E", [(8, 2), (32, 5), (128, 4), (96, 3)])
def test_cuda_grouped_gemm_matches_plain_on_the_card(cuda_device, bt, E, dtypes):
    from repro_torch.kernels import moe_gemm as KM
    from repro_torch.kernels import ops
    xd, wd = (dtypes.split("-") * 2)[:2]
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    rng = np.random.default_rng(bt + E)
    T, D, F = 300, 100, 72                # ragged D and F edges
    X = torch.from_numpy(rng.standard_normal((T, D))).to(cuda_device, dt[xd])
    W = torch.from_numpy(rng.standard_normal((E, D, F))).to(cuda_device, dt[wd])
    eot = rng.integers(0, E, T)
    before = CB.launch_counts()["grouped_gemm"]
    got = ops.grouped_gemm(X, eot, W, bt=bt)
    want = ops.grouped_gemm(X, eot, W, bt=bt, backend="torch")
    torch.cuda.synchronize()
    assert CB.launch_counts()["grouped_gemm"] == before + 1
    assert got.dtype == want.dtype == torch.promote_types(dt[xd], dt[wd])
    tol = 1e-2 if got.dtype == torch.bfloat16 else 1e-5
    assert float((got.double() - want.double()).abs().max() / want.double().abs().max()) <= tol
    # the padded product, padding rows included, equals the plain version's
    _, inv, te, T_pad = KM.plan_groups(eot, E, bt)
    te = torch.from_numpy(te).to(cuda_device)
    Xp = torch.zeros((T_pad, D), dtype=X.dtype, device=cuda_device)
    Xp[torch.from_numpy(inv).long().to(cuda_device)] = X
    yp, yq = KM.grouped_gemm_arrays(te, Xp, W, bt=bt), KM.grouped_gemm_plain(te, Xp, W, bt)
    assert float((yp.double() - yq.double()).abs().max() / yq.double().abs().max()) <= tol
