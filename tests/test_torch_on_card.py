"""The CUDA kernels on the card, each held against its plain PyTorch
version through the plan layer.  Every test is marked ``cuda`` and skips
without a CUDA device.  The file needs no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_on_card.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import port_matrix, ragged_csr_arrays
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


def _sell(name: str, sigma):
    """A SELL container on the host: the surrogate (C = 8) at sigma 1, 64 or
    N (None), or the ragged matrix (empty rows, rows of thousands of
    nonzeros; C = 7 leaves a ragged last chunk)."""
    if name == "ragged":
        rp, col, val, shape = ragged_csr_arrays()
        m, C = PF.CSR(*map(torch.from_numpy, (rp, col, val)), shape), 7
    else:
        m, C = port_matrix(name), 8
    return PF.SELL.from_csr(m, C=C, sigma=m.shape[0] if sigma is None else sigma)


_SELL_CASES = [("surrogate3000", 1), ("surrogate3000", 64), ("surrogate3000", None),
               ("ragged", None)]


@pytest.mark.cuda
@pytest.mark.parametrize("K", (1, 3, 16, 40, 64, 100))
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "f16", "fp8_e4m3", "int8"))
@pytest.mark.parametrize("name,sigma", _SELL_CASES, ids=str)
def test_cuda_sell_spmm_matches_torch_on_the_card(cuda_device, name, sigma, vd, K):
    m = PF.with_value_dtype(_sell(name, sigma), vd)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((m.shape[1], K))).to(
        cuda_device, torch.float64 if vd == "f64" else torch.float32)
    kern = SpMVPlan.compile(m, PlanConfig(device=cuda_device))
    plain = SpMVPlan.compile(m, PlanConfig(device=cuda_device, backend="torch"))
    assert kern.report.spmm_kernel == "cuda"
    before = CB.launch_counts()["sell_spmm"]
    got, again, want = kern.spmm(X), kern.spmm(X), plain.spmm(X)
    torch.cuda.synchronize()
    assert CB.launch_counts()["sell_spmm"] == before + 2
    # rows in slot order, no atomics: the same bits on every call
    assert torch.equal(got, again) and torch.isfinite(got).all()
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-12 if X.dtype == torch.float64 else 1e-5
    assert _rel(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("K", (1, 4, 16))
def test_cuda_sell_spmm_unaligned_operands_on_the_card(cuda_device, K):
    from repro_torch.kernels import sell_spmv as KP
    m = _sell("surrogate3000", None)
    ops = [None if t is None else t.to(cuda_device) for t in
           (m.chunk_ptr, m.chunk_width, m.col_idx, m.val, m.scale, m.perm)]
    base = torch.from_numpy(np.random.default_rng(4).standard_normal(m.shape[1] * K + 1)).to(
        cuda_device)
    X = base[1:].view(m.shape[1], K)   # contiguous, 8 bytes past a 16-byte boundary
    assert X.data_ptr() % 16 == 8
    got = KP.sell_spmm_arrays(*ops, X, m.shape[0], m.C)
    want = KP.sell_spmm_plain(*ops, X, m.shape[0], m.C)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-12


@pytest.mark.cuda
def test_cuda_sell_spmm_refuses_a_schedule_it_did_not_check(cuda_device):
    from repro_torch.kernels import sell_spmv as KP
    m = _sell("surrogate3000", None)
    ops = [None if t is None else t.to(cuda_device) for t in
           (m.chunk_ptr, m.chunk_width, m.col_idx, m.val, m.scale, m.perm)]
    X = torch.ones((m.shape[1], 4), dtype=torch.float64, device=cuda_device)
    before = CB.launch_counts()["sell_spmm"]
    with pytest.raises(TypeError, match="ChunkSchedule"):
        KP.sell_spmm_arrays(*ops, X, m.shape[0], m.C,
                            schedule=torch.zeros(m.n_chunks, dtype=torch.int32,
                                                 device=cuda_device))
    with pytest.raises(ValueError, match="permutation"):
        KP.ChunkSchedule(np.zeros(m.n_chunks, np.int32))
    with pytest.raises(ValueError, match="chunks"):
        KP.sell_spmm_arrays(*ops, X, m.shape[0], m.C,
                            schedule=KP.ChunkSchedule(np.arange(m.n_chunks + 1)))
    assert CB.launch_counts()["sell_spmm"] == before


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


def _bell(blk, vd, m, n, cuda_device):
    from repro_torch.core.matrices import block_sparse_dense
    from repro_torch.kernels import bsr_spmm as KB
    b = PF.with_value_dtype(PF.BSR.from_dense(block_sparse_dense(m, n, blk, 0.4, seed=1),
                                              blk), vd)
    bc, sl = KB.bsr_to_bell(b)
    sc, ln = KB.bell_scale(b), KB.bell_row_nblocks(b)
    return (bc.to(cuda_device), sl.to(cuda_device),
            None if sc is None else sc.to(cuda_device), ln.to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("lens", ("row_nblocks", "all_slots"))
@pytest.mark.parametrize("N", (1, 3, 8, 40, 64, 128, 256))
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "f16", "fp8_e4m3", "int8"))
@pytest.mark.parametrize("blk", ((8, 128), (16, 128), (8, 8), (32, 256)), ids=str)
def test_cuda_bell_spmm_matches_plain_on_the_card(cuda_device, blk, vd, N, lens):
    from repro_torch.kernels import bsr_spmm as KB
    m, n = (96, 512) if blk[1] >= 128 else (96, 64)
    bc, sl, sc, ln = _bell(blk, vd, m, n, cuda_device)
    ln = ln if lens == "row_nblocks" else None   # padding slots hold zero blocks
    X = torch.from_numpy(np.random.default_rng(3).standard_normal((n, N))).to(
        cuda_device, torch.float64 if vd == "f64" else torch.float32)
    before = CB.launch_counts()["bell_spmm"]
    got = KB.bell_spmm_arrays(bc, sl, X, sc, ln, m - blk[0])
    again = KB.bell_spmm_arrays(bc, sl, X, sc, ln, m - blk[0])
    want = KB.bell_spmm_plain(bc, sl, X, sc, m - blk[0])
    torch.cuda.synchronize()
    assert CB.launch_counts()["bell_spmm"] == before + 2
    assert torch.equal(got, again) and torch.isfinite(got).all()
    assert got.shape == want.shape == (m - blk[0], N) and got.dtype == want.dtype
    tol = 1e-12 if X.dtype == torch.float64 else 1e-5
    assert _rel(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("N", (1, 3, 8, 13))
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16"))
@pytest.mark.parametrize("offset", (0, 1))
def test_cuda_bell_spmm_odd_shapes_and_unaligned_x_on_the_card(cuda_device, offset, vd, N):
    """(3, 5) blocks: neither a block nor an X row is a 16-byte multiple, so
    the producer's lanes copy them; an X 4 or 8 bytes off a 16-byte boundary
    takes the same path."""
    from repro_torch.kernels import bsr_spmm as KB
    m, n = 96, 65
    bc, sl, sc, ln = _bell((3, 5), vd, m, n, cuda_device)
    dt = torch.float64 if vd == "f64" else torch.float32
    base = torch.from_numpy(np.random.default_rng(5).standard_normal(n * N + 1)).to(
        cuda_device, dt)
    X = base[offset:offset + n * N].view(n, N)
    got = KB.bell_spmm_arrays(bc, sl, X, sc, ln, m)
    want = KB.bell_spmm_plain(bc, sl, X, sc, m)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= (1e-12 if dt == torch.float64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N", (1, 8, 40))
@pytest.mark.parametrize("vd", ("f64", "f32", "int8"))
def test_cuda_bell_spmm_tall_blocks_on_the_card(cuda_device, vd, N):
    """(128, 16) blocks: more rows than the 8 warps own at 8 rows a thread;
    N = 40 runs on tiles of 8 columns (X read as zero-padded panels)."""
    from repro_torch.kernels import bsr_spmm as KB
    L = KB.bell_launch(128, 16, N, 4)
    assert L.rm < KB.WIDE_ROWS and L.ntile == {1: 1, 8: 8, 40: 8}[N]
    m, n = 384, 64
    bc, sl, sc, ln = _bell((128, 16), vd, m, n, cuda_device)
    X = torch.from_numpy(np.random.default_rng(6).standard_normal((n, N))).to(
        cuda_device, torch.float64 if vd == "f64" else torch.float32)
    got = KB.bell_spmm_arrays(bc, sl, X, sc, ln, m)
    want = KB.bell_spmm_plain(bc, sl, X, sc, m)
    torch.cuda.synchronize()
    assert _rel(got, want) <= (1e-12 if X.dtype == torch.float64 else 1e-5)


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
    # D = 100 is no multiple of 8, so every case runs the SIMT kernel
    assert KM.gemm_plan(bt, D, F, X.dtype, W.dtype)[0] == "simt"
    before = CB.launch_counts()
    got = ops.grouped_gemm(X, eot, W, bt=bt)
    want = ops.grouped_gemm(X, eot, W, bt=bt, backend="torch")
    torch.cuda.synchronize()
    after = CB.launch_counts()
    assert after["grouped_gemm"] == before["grouped_gemm"] + 1
    assert after["grouped_gemm_simt"] == before["grouped_gemm_simt"] + 1
    assert after["grouped_gemm_wgmma"] == before["grouped_gemm_wgmma"]
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


def _grouped_case(cuda_device, bt, E, D, F, xd, wd, seed, experts=None, T=300):
    """Inputs of one grouped-GEMM case on the card, routed over ``experts``
    (default all E)."""
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((T, D))).to(cuda_device, xd)
    W = torch.from_numpy(rng.standard_normal((E, D, F))).to(cuda_device, wd)
    eot = rng.choice(np.arange(E) if experts is None else np.asarray(experts), T)
    return X, W, eot


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bt,E,D,F,experts", [
    (128, 4, 256, 256, None),
    (64, 4, 256, 256, None),          # 64-row tiles, one consumer warpgroup
    (128, 3, 200, 72, None),          # ragged D and F tile edges (TMA zero fill)
    (64, 3, 200, 72, None),
    (128, 5, 136, 200, (0, 2, 4)),    # experts 1 and 3 get no token
    (128, 4, 128, 128, None),         # a 2-stage K (the ring is 6 deep)
    (256, 2, 1024, 384, None),        # 128-row tiles, two per group
], ids=str)
def test_cuda_grouped_gemm_wgmma_path_on_the_card(cuda_device, bt, E, D, F, experts):
    from repro_torch.kernels import moe_gemm as KM
    from repro_torch.kernels import ops
    X, W, eot = _grouped_case(cuda_device, bt, E, D, F, torch.bfloat16, torch.bfloat16,
                              bt + D + F, experts)
    assert KM.gemm_plan(bt, D, F, X.dtype, W.dtype)[0] == "wgmma"
    before = CB.launch_counts()
    got = ops.grouped_gemm(X, eot, W, bt=bt)
    torch.cuda.synchronize()
    after = CB.launch_counts()
    assert after["grouped_gemm"] == before["grouped_gemm"] + 1
    assert after["grouped_gemm_wgmma"] == before["grouped_gemm_wgmma"] + 1
    assert after["grouped_gemm_simt"] == before["grouped_gemm_simt"]
    want = ops.grouped_gemm(X, eot, W, bt=bt, backend="torch")
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    # bf16 output: each side rounds its f32 sum once
    assert _rel(got, want) <= 1e-2
    exact = torch.stack([X[t].double() @ W[int(e)].double() for t, e in enumerate(eot)])
    assert _rel(got, exact) <= 1e-2
    # the padded product, padding rows included, against the plain version
    _, inv, te, T_pad = KM.plan_groups(eot, E, bt)
    te = torch.from_numpy(te).to(cuda_device)
    Xp = torch.zeros((T_pad, D), dtype=X.dtype, device=cuda_device)
    Xp[torch.from_numpy(inv).long().to(cuda_device)] = X
    yp = KM.grouped_gemm_arrays(te, Xp, W, bt=bt)
    assert _rel(yp, KM.grouped_gemm_plain(te, Xp, W, bt)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", ("f32", "bf16", "f32-bf16", "bf16-f32"))
@pytest.mark.parametrize("bt,D,F", [(128, 256, 256), (200, 101, 70), (7, 33, 5),
                                    (64, 96, 130), (256, 2048, 136)], ids=str)
def test_cuda_grouped_gemm_tiles_and_edges_on_the_card(cuda_device, bt, D, F, dtypes):
    """Every register-tile height of the SIMT kernel (bm = 128, 100, 7, 64),
    its 16-byte and element paths (D % 4, F % 4), and the path gemm_plan
    names for each case."""
    from repro_torch.kernels import moe_gemm as KM
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    xd, wd = (dtypes.split("-") * 2)[:2]
    X, W, eot = _grouped_case(cuda_device, bt, 3, D, F, dt[xd], dt[wd], bt + D, T=2 * bt + 5)
    _, inv, te, T_pad = KM.plan_groups(eot, 3, bt)
    te = torch.from_numpy(te).to(cuda_device)
    Xp = torch.zeros((T_pad, D), dtype=X.dtype, device=cuda_device)
    Xp[torch.from_numpy(inv).long().to(cuda_device)] = X
    path = KM.gemm_plan(bt, D, F, X.dtype, W.dtype)[0]
    before = CB.launch_counts()[f"grouped_gemm_{path}"]
    got = KM.grouped_gemm_arrays(te, Xp, W, bt=bt)
    want = KM.grouped_gemm_plain(te, Xp, W, bt)
    torch.cuda.synchronize()
    assert CB.launch_counts()[f"grouped_gemm_{path}"] == before + 1
    assert got.dtype == want.dtype
    assert _rel(got, want) <= (1e-2 if got.dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_grouped_gemm_bad_expert_id_gives_nan_rows(cuda_device, dtype):
    from repro_torch.kernels import moe_gemm as KM
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.standard_normal((256, 128))).to(cuda_device, dtype)
    W = torch.from_numpy(rng.standard_normal((2, 128, 64))).to(cuda_device, dtype)
    te = torch.tensor([1, 7], dtype=torch.int32, device=cuda_device)   # expert 7 of 2
    y = KM.grouped_gemm_arrays(te, X, W, bt=128)
    torch.cuda.synchronize()
    assert torch.isfinite(y[:128]).all() and torch.isnan(y[128:]).all()
    assert _rel(y[:128], X[:128].double() @ W[1].double()) <= 1e-2


# --- kernel 3, CSR SpMV on row blocks ------------------------------------------


def _csr(name):
    from repro_torch.core.matrices import power_law_rows
    if name == "ragged":
        rp, col, val, shape = ragged_csr_arrays()
        return PF.CSR(*map(torch.from_numpy, (rp, col, val)), shape)
    if name == "power_law":
        return power_law_rows(20000, 20000, mean_nnz=10.0, seed=3, max_nnz=192)
    return port_matrix(name)


#: (value dtype, x dtype): f64 values take an f64 x (the acc_dtype rule)
_CSR_CASES = [("f64", torch.float64)] + [
    (vd, xdt) for vd in ("f32", "bf16", "f16", "fp8_e4m3", "int8")
    for xdt in (torch.float64, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("vd,xdt", _CSR_CASES, ids=str)
@pytest.mark.parametrize("name", ("ragged", "power_law", "surrogate3000", "blocksparse"))
def test_cuda_csr_row_blocks_on_the_card(cuda_device, name, vd, xdt):
    from repro_torch.kernels import csr as KC
    from repro_torch.kernels import csr_spmv as KP
    m = PF.with_value_dtype(_csr(name), vd)
    rp, col, val = (t.to(cuda_device) for t in (m.row_ptr, m.col_idx, m.val))
    scale = None if m.scale is None else m.scale.to(cuda_device)
    blocks = KC.csr_row_blocks(m)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(m.shape[1])).to(
        cuda_device, xdt)
    before = CB.launch_counts()["csr_spmv"]
    y1 = KP.csr_spmv_arrays(rp, col, val, scale, x, blocks)
    y2 = KP.csr_spmv_arrays(rp, col, val, scale, x, blocks)
    y3 = KP.csr_spmv_arrays(rp, col, val, scale, x)   # the partition computed here
    want = KP.csr_spmv_plain(rp, col, val, scale, x)
    torch.cuda.synchronize()
    assert CB.launch_counts()["csr_spmv"] == before + 3
    # no atomics: the same bits on every call
    assert torch.equal(y1, y2) and torch.equal(y1, y3)
    assert y1.dtype == want.dtype and torch.isfinite(y1).all()
    tol = 1e-12 if y1.dtype == torch.float64 else 1e-5
    assert _rel(y1, want) <= tol


@pytest.mark.cuda
def test_cuda_csr_row_blocks_over_the_budget_give_nan_rows(cuda_device):
    from repro_torch.kernels import csr_spmv as KP
    m = port_matrix("surrogate3000")
    rp, col, val = (t.to(cuda_device) for t in (m.row_ptr, m.col_idx, m.val))
    x = torch.ones(m.shape[1], dtype=torch.float64, device=cuda_device)
    n = m.shape[0]
    # the partition of an empty matrix with as many rows: blocks of 1024
    # rows, each holding far more than the budget of nonzeros here
    blocks = KP.csr_row_blocks(np.zeros(n + 1, np.int32))
    assert blocks.n_blocks == -(-n // KP.CSR_BUDGET)
    y = KP.csr_spmv_arrays(rp, col, val, None, x, blocks)
    torch.cuda.synchronize()
    assert m.nnz > KP.CSR_BUDGET and torch.isnan(y).all()


@pytest.mark.cuda
def test_cuda_csr_refuses_a_partition_it_did_not_check(cuda_device):
    from repro_torch.kernels import csr_spmv as KP
    m = port_matrix("surrogate3000")
    rp, col, val = (t.to(cuda_device) for t in (m.row_ptr, m.col_idx, m.val))
    x = torch.ones(m.shape[1], dtype=torch.float64, device=cuda_device)
    before = CB.launch_counts()["csr_spmv"]
    # a partition with a gap (rows 10.. in no block) never reaches the kernel
    with pytest.raises(TypeError, match="RowBlocks"):
        KP.csr_spmv_arrays(rp, col, val, None, x,
                           torch.tensor([0, 10], dtype=torch.int32, device=cuda_device))
    # nor does the partition of a matrix with other rows
    with pytest.raises(ValueError, match="rows"):
        KP.csr_spmv_arrays(rp, col, val, None, x, KP.csr_row_blocks(m.row_ptr[:11]))
    assert CB.launch_counts()["csr_spmv"] == before


# --- kernel 1, SELL SpMV on chunk blocks, and the hybrid's fused add -------------


def _sell_c(name: str, C: int, sigma):
    """``_sell`` at any chunk height C."""
    if name == "ragged":
        rp, col, val, shape = ragged_csr_arrays()
        m = PF.CSR(*map(torch.from_numpy, (rp, col, val)), shape)
    else:
        m = port_matrix(name)
    return PF.SELL.from_csr(m, C=C, sigma=m.shape[0] if sigma is None else sigma)


def _sell_ops(m, dev):
    return [None if t is None else t.to(dev) for t in
            (m.chunk_ptr, m.chunk_width, m.col_idx, m.val, m.scale, m.perm)]


#: (value dtype, x dtype): f64 values take an f64 x (the acc_dtype rule)
_SELL_VX = [("f64", torch.float64)] + [
    (vd, xdt) for vd in ("f32", "bf16", "f16", "fp8_e4m3", "int8")
    for xdt in (torch.float64, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("add", (False, True), ids=("store", "add_to"))
@pytest.mark.parametrize("vd,xdt", _SELL_VX, ids=str)
@pytest.mark.parametrize("sigma", (1, 64, None), ids=("sigma1", "sigma64", "sigmaN"))
@pytest.mark.parametrize("name,C", (("surrogate3000", 8), ("surrogate3000", 128),
                                    ("ragged", 7), ("ragged", 8)), ids=str)
def test_cuda_sell_spmv_chunk_blocks_on_the_card(cuda_device, name, C, sigma, vd, xdt, add):
    from repro_torch.kernels import sell as KS
    from repro_torch.kernels import sell_spmv as KP
    m = PF.with_value_dtype(_sell_c(name, C, sigma), vd)
    ops = _sell_ops(m, cuda_device)
    n = m.shape[0]
    blocks = KS.sell_chunk_blocks(m)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(m.shape[1])).to(
        cuda_device, xdt)
    acc = torch.float64 if torch.float64 in (xdt, m.val.dtype) else torch.float32
    base = torch.from_numpy(np.random.default_rng(8).standard_normal(n)).to(cuda_device, acc)
    before = CB.launch_counts()["sell_spmv"]
    y1 = KP.sell_spmv_arrays(*ops, x, n, C, blocks)
    y2 = KP.sell_spmv_arrays(*ops, x, n, C, blocks)
    y3 = KP.sell_spmv_arrays(*ops, x, n, C)   # the partition built here
    want = KP.sell_spmv_plain(*ops, x, n, C)
    if add:
        into = base.clone()
        got = KP.sell_spmv_arrays(*ops, x, n, C, blocks, add_to=into)
        # in place, and the same sum as adding the kernel's own output
        assert got is into and torch.equal(got, base + y1)
        assert _rel(got, KP.sell_spmv_plain(*ops, x, n, C, add_to=base.clone())) <= (
            1e-12 if acc == torch.float64 else 1e-5)
    torch.cuda.synchronize()
    assert CB.launch_counts()["sell_spmv"] == before + 3 + add
    # no atomics: the same bits on every call
    assert torch.equal(y1, y2) and torch.equal(y1, y3)
    assert y1.dtype == want.dtype == acc and torch.isfinite(y1).all()
    assert _rel(y1, want) <= (1e-12 if acc == torch.float64 else 1e-5)


@pytest.mark.cuda
def test_cuda_sell_spmv_lone_chunks_and_tall_chunks_on_the_card(cuda_device):
    from repro_torch.kernels import sell_spmv as KP
    # ragged C = 7: chunks of rows with thousands of nonzeros lie alone in
    # their blocks; C = 300 is taller than a CUDA block (a thread a row)
    for name, C in (("ragged", 7), ("surrogate3000", 300), ("ragged", 300)):
        m = _sell_c(name, C, None)
        blocks = KP.sell_chunk_blocks(m.chunk_ptr, m.chunk_width, C)
        slots = np.diff(m.chunk_ptr.numpy()[blocks.starts.numpy()])
        assert (np.diff(blocks.starts.numpy()) == 1).any()
        assert C > 256 or (slots > KP.SELL_BUDGET).any()
        ops = _sell_ops(m, cuda_device)
        x = torch.from_numpy(np.random.default_rng(9).standard_normal(m.shape[1])).to(
            cuda_device)
        got = KP.sell_spmv_arrays(*ops, x, m.shape[0], C, blocks)
        again = KP.sell_spmv_arrays(*ops, x, m.shape[0], C, blocks)
        want = KP.sell_spmv_plain(*ops, x, m.shape[0], C)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and _rel(got, want) <= 1e-12


@pytest.mark.cuda
def test_cuda_sell_spmv_blocks_over_the_budget_give_nan_rows(cuda_device):
    from repro_torch.kernels import sell_spmv as KP
    m = _sell_c("surrogate3000", 8, None)
    ops = _sell_ops(m, cuda_device)
    x = torch.ones(m.shape[1], dtype=torch.float64, device=cuda_device)
    # the partition of as many empty chunks: budget // 8 chunks a block, each
    # holding far more than the budget of slots here
    blocks = KP.sell_chunk_blocks(np.zeros(m.n_chunks + 1, np.int64),
                                  np.zeros(m.n_chunks, np.int32), 8)
    assert blocks.n_blocks == -(-m.n_chunks // (KP.SELL_BUDGET // 8))
    y = KP.sell_spmv_arrays(*ops, x, m.shape[0], 8, blocks)
    torch.cuda.synchronize()
    assert torch.isnan(y).all()


@pytest.mark.cuda
def test_cuda_sell_spmv_refuses_a_partition_it_did_not_check(cuda_device):
    from repro_torch.kernels import sell_spmv as KP
    m = _sell_c("surrogate3000", 8, 64)
    ops = _sell_ops(m, cuda_device)
    x = torch.ones(m.shape[1], dtype=torch.float64, device=cuda_device)
    n = m.shape[0]
    before = CB.launch_counts()["sell_spmv"]
    with pytest.raises(TypeError, match="ChunkBlocks"):
        KP.sell_spmv_arrays(*ops, x, n, 8, torch.tensor([0, 10], dtype=torch.int32,
                                                        device=cuda_device))
    with pytest.raises(ValueError, match="chunks"):
        KP.sell_spmv_arrays(*ops, x, n, 8, KP.sell_chunk_blocks(
            m.chunk_ptr[:11], m.chunk_width[:10], 8))
    with pytest.raises(TypeError, match="add_to"):
        KP.sell_spmv_arrays(*ops, x, n, 8, add_to=torch.zeros(n, device=cuda_device))
    with pytest.raises(ValueError, match="add_to"):
        KP.sell_spmv_arrays(*ops, x, n, 8, add_to=torch.zeros(
            n, dtype=torch.float64, device=cuda_device)[::2])
    assert CB.launch_counts()["sell_spmv"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("vd,xdt", _SELL_VX, ids=str)
def test_cuda_hybrid_fused_add_is_bitwise_the_composition(cuda_device, vd, xdt):
    from repro_torch.kernels import registry as R
    from repro_torch.core.formats import split_dia
    m = PF.with_value_dtype(split_dia(port_matrix("surrogate3000")), vd)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(m.shape[1])).to(
        cuda_device, xdt)
    plan = SpMVPlan.compile(m, PlanConfig(device=cuda_device))
    assert plan.report.kernel == "cuda"
    ctx = R.KernelContext(device=cuda_device)
    fd = R.build(m.dia, "dia", "spmv", "cuda", ctx).fn
    fs = R.build(m.rest, "sell", "spmv", "cuda", ctx).fn
    before = CB.launch_counts()
    got = plan(x)
    after = CB.launch_counts()
    # the reference's Pallas hybrid: the DIA kernel's output plus the SELL kernel's
    want = fd(x) + fs(x)
    torch.cuda.synchronize()
    assert after["dia_spmv"] == before["dia_spmv"] + 1
    assert after["sell_spmv"] == before["sell_spmv"] + 1
    assert torch.equal(got, want) and torch.isfinite(got).all()


@pytest.mark.cuda
def test_cuda_hybrid_plan_call_spans_on_the_card(cuda_device):
    """Under the profiler a hybrid plan call is one ``plan.operand`` span,
    one ``kernel.check`` (x against the entry's launch record) and one
    ``kernel.launch`` range (the record's C call, both kernels), which counts
    as many launches as the launch counters add, two; its output is the
    composition of the two kernels bit for bit, as unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.formats import split_dia
    from repro_torch.kernels import registry as R
    from repro_torch.utils import spans
    m = PF.with_value_dtype(split_dia(port_matrix("surrogate3000")), "f32")
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(m.shape[1])).to(
        cuda_device)
    plan = SpMVPlan.compile(m, PlanConfig(device=cuda_device))
    plain = SpMVPlan.compile(m, PlanConfig(device=cuda_device, backend="torch"))
    assert plan.report.kernel == "cuda"
    ctx = R.KernelContext(device=cuda_device)
    fd = R.build(m.dia, "dia", "spmv", "cuda", ctx).fn
    fs = R.build(m.rest, "sell", "spmv", "cuda", ctx).fn
    unprofiled = plan(x)
    spans.reset()
    before = sum(CB.launch_counts().values())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = plan(x)
        torch.cuda.synchronize()
    launched = sum(CB.launch_counts().values()) - before
    tot = spans.totals()
    spans.reset()
    assert tot["plan.operand"]["n"] == 1
    assert tot["kernel.check"]["n"] == 1 and tot["kernel.launch"]["n"] == launched == 2
    names = [e.name for e in prof.events()]
    assert names.count("kernel.launch") == 1 and names.count("kernel.check") == 1
    want = fd(x) + fs(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, unprofiled)
    ref = plain(x)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-12


# --- every kernel family through ``cuda_build.launch`` ---------------------------

#: the launch counter each family's call raises by one: kernels 1-9, mf_product
_FAMILIES = ("sell_spmv", "dia_spmv", "csr_spmv", "mf_spmv", "sell_spmm", "bell_spmm",
             "grouped_gemm", "stream_triad", "gather_scp", "mf_product")


def _one_call(family: str, dev):
    """A call that launches ``family``'s kernel once, its operands and plan
    built on ``dev`` beforehand."""
    from repro_torch.core import matrices as PM
    from repro_torch.kernels import gather_bench as GB
    from repro_torch.kernels import moe_gemm as KM
    rng = np.random.default_rng(12)

    def plan_of(m, fmt):
        plan = SpMVPlan.compile(m, PlanConfig(device=dev, format=fmt))
        assert plan.report.kernel == "cuda"
        x = torch.from_numpy(rng.standard_normal(m.shape[1])).to(dev)
        return lambda: plan(x)

    if family == "sell_spmv":
        return plan_of(PF.convert(port_matrix("surrogate3000"), "sell"), "sell")
    if family == "dia_spmv":
        return plan_of(PF.DIA.from_csr(port_matrix("laplace48")), "dia")
    if family == "csr_spmv":
        return plan_of(port_matrix("surrogate3000"), "csr")
    if family == "mf_spmv":
        return plan_of(PF.detect_matrix_free(port_matrix("exact4")), "matrix_free")
    if family == "mf_product":
        return plan_of(PM.holstein_hubbard_operator(PM.HolsteinHubbardParams(
            L=4, n_up=2, n_dn=2, max_phonon=3, max_total_phonon=3)), "mf_product")
    if family == "sell_spmm":
        m = PF.convert(port_matrix("surrogate3000"), "sell")
        plan = SpMVPlan.compile(m, PlanConfig(device=dev, format="sell"))
        assert plan.report.spmm_kernel == "cuda"
        X = torch.from_numpy(rng.standard_normal((m.shape[1], 16))).to(dev)
        return lambda: plan.spmm(X)
    if family == "bell_spmm":
        d = PM.block_sparse_dense(256, 512, (8, 128), 0.3, seed=2)
        return plan_of(PF.convert(PF.CSR.from_dense(d), "bsr"), "bsr")
    if family == "grouped_gemm":
        X, W, eot = _grouped_case(dev, 128, 4, 256, 256, torch.bfloat16, torch.bfloat16, 13)
        return lambda: KM.grouped_gemm(X, eot, W, bt=128)
    a, b, c = (torch.from_numpy(rng.standard_normal(4097)).to(dev) for _ in range(3))
    if family == "stream_triad":
        return lambda: GB.stream_triad(a, b, c)
    idx = torch.from_numpy(rng.integers(0, 4097, 4097, dtype=np.int32)).to(dev)
    return lambda: GB.gather_scp(a, idx, c)


@pytest.mark.cuda
@pytest.mark.parametrize("family", _FAMILIES)
def test_kernel_launch_span_counts_the_launches_on_the_card(cuda_device, family):
    """Every kernel launches through ``cuda_build.launch``: under the
    profiler one call is one ``kernel.launch`` range, whose count is the
    rise of the launch counters (the kernel's, and the path's where it has
    one)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.utils import spans
    call = _one_call(family, cuda_device)
    call()                                 # the libraries built and loaded
    torch.cuda.synchronize()
    spans.reset()
    before = CB.launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
        torch.cuda.synchronize()
    rise = {k: v - before[k] for k, v in CB.launch_counts().items() if v != before[k]}
    tot = spans.totals()
    spans.reset()
    assert rise[family] == 1 and set(rise) <= {family, *CB.PATH_COUNTERS}
    assert tot["kernel.launch"]["n"] == sum(rise.values())
    assert [e.name for e in prof.events()].count("kernel.launch") == 1


# --- kernel 8, the STREAM triad: tiles and tails --------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1, 2), ids=("aligned", "off1", "off2"))
@pytest.mark.parametrize("tiles_n", ("1", "3", "below_tile", "tile+1", "3tiles+5"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_cuda_triad_tiles_and_tails_on_the_card(cuda_device, dtype, tiles_n, offset):
    from repro_torch.kernels import gather_bench as GB
    tile = GB.TRIAD_UNROLL * 256 * (16 // torch.empty(0, dtype=dtype).element_size())
    n = {"1": 1, "3": 3, "below_tile": tile - 7, "tile+1": tile + 1,
         "3tiles+5": 3 * tile + 5}[tiles_n]
    g = torch.Generator(device="cpu").manual_seed(n)
    a, b, c = (torch.randn(n + offset, generator=g, dtype=dtype).to(cuda_device)[offset:]
               for _ in range(3))
    before = CB.launch_counts()["stream_triad"]
    got = GB.stream_triad(a, b, c)
    torch.cuda.synchronize()
    assert CB.launch_counts()["stream_triad"] == before + 1
    assert got.shape == (n,) and torch.equal(got, GB.stream_triad_plain(a, b, c))


# --- kernel 4 (matrix-free SpMV on its MfLaunch) ----------------------------------


def _mf_op(name: str, vd: str):
    """A matrix-free operator: laplacian_2d(48, 48) (generated diagonals
    only, two masked) or the exact L = 6, max_phonon = 2 Holstein-Hubbard
    operator (13 stored lanes, 8 generated diagonals, 4 masked)."""
    from repro_torch.core import matrices as PM
    src = port_matrix("laplace48") if name == "laplace48" else PM.holstein_hubbard_exact(
        PM.HolsteinHubbardParams(L=6, max_phonon=2))
    return PF.with_value_dtype(PF.MatrixFreeOperator.from_csr(src), vd)


_MF_VX = [("f64", torch.float64), ("f32", torch.float64), ("f32", torch.float32),
          ("bf16", torch.float32), ("bf16", torch.float64), ("f16", torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("vd,xdt", _MF_VX, ids=str)
@pytest.mark.parametrize("name,form", (("laplace48", "lanes"), ("exact6", "lanes"),
                                       ("exact6", "codes")))
def test_cuda_mf_spmv_matches_plain_on_the_card(cuda_device, name, form, vd, xdt):
    from repro_torch.kernels import matrix_free as MF
    from repro_torch.kernels.dia_spmv import pad_x
    op = _mf_op(name, vd)
    launch = MF.mf_launch(op)
    data = MF.mf_data(op).to(cuda_device)
    lanes = MF.mf_encode(data, launch) if form == "codes" else data
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(op.shape[1])).to(
        cuda_device, xdt)
    before = CB.launch_counts()["mf_spmv"]
    got, again = MF.mf_spmv_arrays(lanes, launch, x), MF.mf_spmv_arrays(lanes, launch, x)
    acc = got.dtype
    p0, p1 = launch.pads
    want = MF.mf_spmv_plain(data, launch.desc, launch.gen, pad_x(x, p0, p1, acc), p0,
                            op.shape[0])
    torch.cuda.synchronize()
    assert CB.launch_counts()["mf_spmv"] == before + 2
    assert acc == (torch.float64 if torch.float64 in (xdt, data.dtype) else torch.float32)
    assert torch.equal(got, again) and torch.isfinite(got).all()
    assert _rel(got, want) <= (1e-12 if acc == torch.float64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "f16"))
@pytest.mark.parametrize("name", ("laplace48", "exact6"))
def test_cuda_mf_plan_matches_torch_entry_and_counts_one_launch(cuda_device, name, vd):
    op = _mf_op(name, vd)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(op.shape[1])).to(
        cuda_device)
    kern = SpMVPlan.compile(op, PlanConfig(device=cuda_device))
    plain = SpMVPlan.compile(op, PlanConfig(device=cuda_device, backend="torch"))
    assert kern.report.kernel == "cuda" and plain.report.kernel == "torch"
    before = CB.launch_counts()
    got = kern(x)
    torch.cuda.synchronize()
    after = CB.launch_counts()
    # one mf_spmv launch a call and no other counted launch (chip_smoke.py's
    # profiler line shows that no pad copy runs either), its lanes as codes
    # where they have any
    rise = {k: v - before[k] for k, v in after.items() if v != before[k]}
    assert rise == ({"mf_spmv": 1} if name == "laplace48" else
                    {"mf_spmv": 1, "mf_spmv_coded": 1})
    assert torch.equal(got, kern(x))
    assert _rel(got, plain(x)) <= 1e-12


@pytest.mark.cuda
def test_cuda_mf_spmv_refuses_before_any_launch(cuda_device):
    from repro_torch.kernels import matrix_free as MF
    op = _mf_op("laplace48", "f64")
    launch = MF.mf_launch(op)
    data = MF.mf_data(op).to(cuda_device)
    x = torch.ones(op.shape[1], dtype=torch.float64, device=cuda_device)
    before = CB.launch_counts()["mf_spmv"]
    with pytest.raises(TypeError, match="MfLaunch"):
        MF.mf_spmv_arrays(data, launch.on(cuda_device), x)
    other = MF.mf_launch(_mf_op("exact6", "f64"))
    with pytest.raises(ValueError, match="descriptor"):
        MF.mf_spmv_arrays(data, other, x)
    with pytest.raises(ValueError, match="columns"):
        MF.mf_spmv_arrays(data, launch, x[1:])
    assert CB.launch_counts()["mf_spmv"] == before


@pytest.fixture(scope="module")
def hh_exact_l6():
    """The benchmark's ``hh_exact_l6`` operator (exact Holstein-Hubbard, L = 6,
    5 phonons a site: 1,679,616 rows, 13 stored lanes of 41 distinct nonzero
    values)
    from ``spmvbench/gen.py`` at ``spmvbench/configs/hh_exact_l6.json``."""
    import json
    from pathlib import Path

    from spmvbench import gen
    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "spmvbench" / "configs" / "hh_exact_l6.json").read_text())
    row_ptr, col, val = gen.GENERATORS[cfg["generator"]](**cfg["params"], dtype=np.float64)
    n = len(row_ptr) - 1
    return PF.MatrixFreeOperator.from_csr(PF.CSR(row_ptr, col, val, (n, n)))


def _values_op(distinct: int):
    """A 70,000-row operator: a stored main diagonal holding ``distinct``
    values, a stored lane at +1 holding two of them, generated diagonals of
    0.5 at -3 and +300."""
    rng = np.random.default_rng(distinct)
    n = 70_000
    pool = rng.standard_normal(distinct)
    rows, cols, vals = [], [], []
    for off in (-3, 0, 1, 300):
        r = np.arange(max(0, -off), min(n, n - off))
        v = {0: pool[rng.permutation(r.size) % distinct], 1: pool[rng.integers(0, 2, r.size)]}
        rows.append(r)
        cols.append(r + off)
        vals.append(v.get(off, np.full(r.size, 0.5)))
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    order = np.lexsort((cols, rows))
    rp = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=rp[1:])
    op = PF.MatrixFreeOperator.from_csr(PF.CSR(rp, cols[order], vals[order], (n, n)))
    assert op.n_stored == 2 and op.n_generated == 2
    return op


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    ints = {8: torch.int64, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("hh_exact_l6-f64", "hh_exact_l6-f32", "values255",
                                  "values256"))
def test_cuda_mf_coded_kernel_gives_the_streamed_bits_on_the_card(cuda_device, case, request):
    """Kernel 4 on 1-byte codes gives kernel 4 on the streamed lanes bit for
    bit, for an x with infinities and NaNs too, on the benchmark's exact
    L = 6 operator (f64 and f32 lanes) and on lanes of 255 values; lanes of
    256 values stay streamed.  Each launch counts under its form."""
    from repro_torch.kernels import matrix_free as MF
    if case.startswith("hh_exact_l6"):
        op = PF.with_value_dtype(request.getfixturevalue("hh_exact_l6"), case.split("-")[1])
    else:
        op = _values_op(int(case[len("values"):]))
    launch = MF.mf_launch(op)
    data = MF.mf_data(op).to(cuda_device)
    codes = MF.mf_encode(data, launch)
    if case == "values256":
        assert codes is None
        plan = SpMVPlan.compile(op, PlanConfig(device=cuda_device))
        x = torch.randn(op.shape[1], dtype=torch.float64, device=cuda_device)
        before = MF.lane_code_counts()
        got = plan(x)
        assert MF.lane_code_counts() == {"coded": before["coded"],
                                         "streamed": before["streamed"] + 1}
        assert _same_bits(got, MF.mf_spmv_arrays(data, launch, x))
        return
    assert codes is not None and codes.codes.device == cuda_device
    if case.startswith("hh_exact_l6"):
        assert codes.values.numel() == 42 and op.n_stored == 13   # +0.0 and 41 values
    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(op.shape[1], generator=g, dtype=torch.float64)
    x[7], x[1000], x[-2] = float("inf"), -float("inf"), float("nan")
    for xv in (x.clamp(-5, 5).nan_to_num(0.0), x):
        xd = xv.to(cuda_device)
        before = MF.lane_code_counts()
        coded, streamed = MF.mf_spmv_arrays(codes, launch, xd), MF.mf_spmv_arrays(data, launch, xd)
        torch.cuda.synchronize()
        assert MF.lane_code_counts() == {"coded": before["coded"] + 1,
                                         "streamed": before["streamed"] + 1}
        assert _same_bits(coded, streamed)
    assert torch.equal(codes.lanes().view(torch.uint8),
                       data[:, :op.shape[0]].contiguous().view(torch.uint8))


@pytest.mark.cuda
def test_cuda_graph_over_the_coded_launch_replays_its_bits_on_the_card(cuda_device):
    from repro_torch.kernels import matrix_free as MF
    op = _mf_op("exact6", "f64")
    launch = MF.mf_launch(op)
    data = MF.mf_data(op).to(cuda_device)
    codes = MF.mf_encode(data, launch)
    assert codes is not None
    n = op.shape[1]
    x1, x2 = (torch.from_numpy(np.random.default_rng(s).standard_normal(n)).to(cuda_device)
              for s in (11, 12))
    static_x = x1.clone()
    MF.mf_spmv_arrays(codes, launch, static_x)          # warm, outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        static_y = MF.mf_spmv_arrays(codes, launch, static_x)
    for x in (x2, x1):
        static_x.copy_(x)
        g.replay()
        eager = MF.mf_spmv_arrays(data, launch, x)
        torch.cuda.synchronize()
        assert _same_bits(static_y, eager)


@pytest.mark.cuda
def test_mf_coded_pct_reads_100_for_hh_exact_l6_on_the_card(cuda_device, hh_exact_l6):
    """The benchmark's ``mf_coded_pct.e0`` over Lanczos solves on the cell's
    operator, replayed from CUDA graphs: every kernel-4 launch read codes."""
    import types

    from repro_torch.core.eigensolver import lanczos
    from spmvbench import run
    plan = SpMVPlan.compile(hh_exact_l6, PlanConfig(device=cuda_device,
                                                    format="matrix_free"))
    assert plan.report.kernel == "cuda"
    n = hh_exact_l6.shape[0]
    v0 = torch.randn(n, dtype=torch.float64, device=cuda_device)
    lanczos(plan, n, m=32, v0=v0)                       # captures the graphs
    CB.reset_launch_counts()
    res = lanczos(plan, n, m=32, v0=v0)
    counts = CB.launch_counts()
    assert counts["mf_spmv"] == counts["mf_spmv_coded"] == res.n_spmv == 32
    ctx = types.SimpleNamespace(traced={"solves": 1}, trace={}, result={}, bench=None,
                                setup_s=1.0)
    assert run.metric_reader("mf_coded_pct.e0")(ctx) == 100.0


# --- slice 8: COO, validation, faults and the tuning DB on the card --------------

@pytest.mark.cuda
@pytest.mark.parametrize("vd", ("f64", "f32", "int8"))
def test_coo_torch_entry_on_the_card(cuda_device, vd):
    """The coo ``torch`` entry runs on the card (``index_add_``: atomics, so
    within tolerance of the host's product, not bitwise)."""
    m = PF.with_value_dtype(port_matrix("surrogate3000").to_coo(), vd)
    plan = SpMVPlan.compile(m, PlanConfig(device=cuda_device))
    assert plan.report.format == "coo" and plan.report.kernel == "torch"
    host = SpMVPlan.compile(m, PlanConfig(device="cpu"))
    dt = torch.float64 if vd == "f64" else torch.float32
    X = torch.from_numpy(np.random.default_rng(4).standard_normal((m.shape[1], 4))).to(dt)
    y = plan(X[:, 0].to(cuda_device))
    Y = plan.spmm(X.to(cuda_device))
    assert y.device == cuda_device and Y.device == cuda_device
    tol = 1e-12 if vd == "f64" else 1e-5
    assert _rel(y.cpu(), host(X[:, 0])) <= tol and _rel(Y.cpu(), host.spmm(X)) <= tol


@pytest.mark.cuda
def test_vector_checks_stay_on_the_card(cuda_device):
    from repro_torch.core.validate import (
        VectorValidationError, check_finite_columns, validate_vector)
    x = torch.arange(1.0, 6.0, device=cuda_device)
    assert validate_vector(x, 5) is x
    bad = x.clone()
    bad[2] = float("nan")
    with pytest.raises(VectorValidationError, match="non-finite"):
        validate_vector(bad, 5)
    fixed = validate_vector(bad, 5, policy="repair")
    assert fixed.device == cuda_device and float(fixed[2]) == 0.0
    Y = torch.ones((7, 3), device=cuda_device)
    Y[4, 1] = float("inf")
    ok = check_finite_columns(Y)
    assert ok.device == cuda_device and ok.tolist() == [True, False, True]


@pytest.mark.cuda
def test_faults_poison_a_card_tensor(cuda_device):
    from repro_torch.testing import faults
    y = torch.ones((6, 4), device=cuda_device)
    got = faults.poison(y, faults.FaultSpec("plan.spmm", nonfinite=True, column=3))
    assert got.device == cuda_device and bool(torch.isnan(got[0, 3]))
    assert int(torch.isnan(got).sum()) == 1 and not bool(torch.isnan(y).any())
    plan = SpMVPlan.compile(port_matrix("laplace48"), PlanConfig(device=cuda_device))
    x = torch.ones(plan.report.shape[1], dtype=torch.float64, device=cuda_device)
    with faults.inject("plan.spmv", nonfinite=True):
        poisoned = plan(x)
    assert poisoned.device == cuda_device and bool(torch.isnan(poisoned[0]))
    assert torch.isfinite(plan(x)).all()


@pytest.mark.cuda
def test_tunedb_warms_a_pick_on_the_card_only_for_its_platform(cuda_device):
    from repro_torch.core import perfmodel as PM
    from repro_torch.core import tunedb as TDB
    from repro_torch.utils.hw import H100
    m = port_matrix("powerlaw")
    cold = PM.select_format(m, device=cuda_device)
    other = next(f for f in ("jds", "ell", "csr") if f != cold.format)
    for platform, warm in (("cpu", False), ("cuda", True)):
        db = TDB.TuneDB()
        db.record(m, chip=H100, platform=platform,
                  candidates=[TDB.Candidate(other, "torch", 1e-7)])
        fresh = PF.CSR(m.row_ptr.clone(), m.col_idx.clone(), m.val.clone(), m.shape)
        plan = SpMVPlan.compile(fresh, PlanConfig(format="auto", tuning=db,
                                                  device=cuda_device))
        assert plan.report.format == (other if warm else cold.format), platform


def _card_requests(n: int, k: int, device, seed: int = 3) -> list:
    gen = torch.Generator(device=device).manual_seed(seed)
    return list(torch.randn((k, n), generator=gen, device=device, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("name,fmt,kernel", [("surrogate3000", "sell", "sell_spmm"),
                                             ("exact4", "matrix_free", "mf_spmv")])
def test_serving_flush_runs_the_spmm_kernel_on_the_card(cuda_device, name, fmt, kernel):
    """A width-4 flush of 3 requests launches kernel 5 once on a padded
    operand (SELL) or kernel 4 once a real column, unpadded (matrix-free),
    and every future agrees with the ``torch`` plan."""
    from repro_torch.serve import BatchingSpMVServer
    m = port_matrix(name)
    m = PF.detect_matrix_free(m) if fmt == "matrix_free" else PF.convert(m, fmt)
    srv = BatchingSpMVServer(max_batch=4, deadline_s=60.0)
    report = srv.register("A", m)
    assert srv.device == cuda_device and report.spmm_kernel == "cuda"
    assert srv.stats()["A"]["ladder"] == ()
    xs = _card_requests(m.shape[1], 3, cuda_device)
    before = CB.launch_counts()
    futs = srv.submit_many("A", xs)
    assert srv.flush("A") == 3
    ys = [f.result() for f in futs]
    after = CB.launch_counts()
    assert after[kernel] - before[kernel] == (1 if kernel == "sell_spmm" else 3)
    plain = SpMVPlan.compile(m, PlanConfig(device=cuda_device, backend="torch"))
    for x, y in zip(xs, ys):
        want = plain(x)
        assert y.device == cuda_device
        assert float((y - want).abs().max() / want.abs().max()) <= 1e-12
    st = srv.stats()["A"]
    assert st["padding_ratio"] == (0.25 if kernel == "sell_spmm" else 0.0)
    assert st["degraded"] == st["failed"] == 0


@pytest.mark.cuda
def test_serving_persistent_kernel_failure_is_a_kernel_fault_on_the_card(cuda_device):
    """A ``cuda`` plan has no plain rung to fall to: a persistent kernel
    failure fails each request with ``KernelFault`` and no degrade, and the
    operator serves the clean bits again once the fault is gone."""
    from repro_torch.serve import BatchingSpMVServer, KernelFault, ResiliencePolicy
    from repro_torch.testing import faults
    m = PF.convert(port_matrix("surrogate3000"), "sell")
    srv = BatchingSpMVServer(max_batch=4, deadline_s=60.0,
                             resilience=ResiliencePolicy(max_retries=0, breaker_threshold=1))
    srv.register("A", m)
    xs = _card_requests(m.shape[1], 4, cuda_device, seed=4)
    clean = [f.result() for f in srv.submit_many("A", xs)]
    try:
        with faults.inject("plan.spmm", error=RuntimeError("cuda broken"), times=None,
                           when=lambda ctx: ctx.get("kernel") == "cuda"):
            errs = [f.error() for f in srv.submit_many("A", xs)]
    finally:
        faults.reset()
    assert all(isinstance(e, KernelFault) and e.kernel == "cuda" for e in errs)
    st = srv.stats()["A"]
    assert st["degraded"] == 0 and st["failed"] == 4 and st["kernel"] == "cuda"
    assert st["ladder"] == ()
    again = [f.result() for f in srv.submit_many("A", xs)]
    assert all(torch.equal(a, b) for a, b in zip(clean, again))


@pytest.mark.cuda
@pytest.mark.parametrize("pack", ("sell", "ell"))
@pytest.mark.parametrize("local_cols", (False, True), ids=("allgather", "ring"))
def test_cuda_slab_entries_match_torch_on_the_card(cuda_device, pack, local_cols):
    """Every block of a 4-shard packing through kernels 1 and 5 (the cuda
    slab entries, on the derived descriptors) against the torch slab entry
    on the host arrays; an empty block has no operand."""
    from repro_torch.core import distributed as D
    from repro_torch.core import distributed_plan as DP
    from repro_torch.kernels import registry as R
    from repro_torch.kernels import slab as S
    m = port_matrix("laplace48") if local_cols else port_matrix("surrogate3000")
    b = DP.pack_shard_slabs(m, 4, pack=pack, local_cols=local_cols)
    lens = D.block_lengths(m, b.bounds, local_cols)
    ops = S.slab_operands(b, lens, "cuda", (cuda_device,) * 4, 8, m.val.dtype)
    ref = S.slab_operands(b, lens, "torch", (cuda_device,) * 4, 8, m.val.dtype)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(4 * b.col_shard)).to(cuda_device)
    X = torch.from_numpy(rng.standard_normal((4 * b.col_shard, 5))).to(cuda_device)
    ctx = R.KernelContext(device=cuda_device)
    spmv, spmm, tv, tm = (S.slab_mult(pack, b.rows_pp, be, op, ctx) for be, op in (
        ("cuda", "spmv"), ("cuda", "spmm"), ("torch", "spmv"), ("torch", "spmm")))
    for p in range(4):
        for q in range(b.q_blocks):
            xs = x[q * b.col_shard:(q + 1) * b.col_shard] if local_cols else x
            Xs = X[q * b.col_shard:(q + 1) * b.col_shard] if local_cols else X
            want, want_mm = tv(ref[p][q], xs), tm(ref[p][q], Xs)
            if ops[p][q] is None:
                assert lens[p, q].sum() == 0 and not want.any()
                continue
            before = CB.launch_counts()
            got, got_mm = spmv(ops[p][q], xs), spmm(ops[p][q], Xs)
            torch.cuda.synchronize()
            after = CB.launch_counts()
            assert after["sell_spmv"] - before["sell_spmv"] == 1
            assert after["sell_spmm"] - before["sell_spmm"] == 1
            scale = max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= 1e-12 * scale
            assert float((got_mm - want_mm).abs().max()) <= 1e-12 * max(
                1.0, float(want_mm.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ("allgather", "ring", "overlap"))
def test_cuda_distributed_plan_launch_counts_on_the_card(cuda_device, variant):
    """A 4-shard plan on the card: kernel 1 once a non-empty slab per SpMV,
    kernel 5 once a slab per SpMM, nothing else; results against the torch
    slab backend and bitwise between two calls."""
    from repro_torch.core import distributed as D
    from repro_torch.core import distributed_plan as DP
    m = port_matrix("surrogate3000")
    mesh = D.make_mesh_1d(n_devices=4, device=cuda_device)
    plan = DP.compile_distributed_spmv_plan(m, mesh, variant=variant)
    plain = DP.compile_distributed_spmv_plan(m, mesh, variant=variant,
                                             config=PlanConfig(backend="torch"))
    assert plan.slab_backend == "cuda" and plain.slab_backend == "torch"
    blocks = sum(op is not None for row in plan.operands for op in row)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(m.shape[1])).to(cuda_device)
    X = torch.from_numpy(np.random.default_rng(8).standard_normal((m.shape[1], 4))).to(
        cuda_device)
    before = CB.launch_counts()
    y = plan(x)
    mid = CB.launch_counts()
    Y = plan.spmm(X)
    torch.cuda.synchronize()
    after = CB.launch_counts()
    assert mid["sell_spmv"] - before["sell_spmv"] == blocks
    assert sum(mid.values()) - sum(before.values()) == blocks
    assert after["sell_spmm"] - mid["sell_spmm"] == blocks
    assert sum(after.values()) - sum(mid.values()) == blocks
    want, want_mm = plain(x), plain.spmm(X)
    assert float((y - want).abs().max() / want.abs().max()) <= 1e-12
    assert float((Y - want_mm).abs().max() / want_mm.abs().max()) <= 1e-12
    assert torch.equal(plan(x), y) and y.device == cuda_device


@pytest.mark.cuda
def test_lm_engine_wave_at_full_width_on_the_card(cuda_device):
    """Qwen3-0.6B at full width (bf16 compute) served through the Engine on
    the card: one prefill and decode wave, the same tokens twice, no counted
    kernel launched (the dense LM path runs on torch ops)."""
    from repro_torch.models.registry import get
    from repro_torch.serve.engine import Engine, GenerationConfig
    model = get("qwen3-0.6b")
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0),
                        device=cuda_device)
    assert model.total_params() == 596_049_920
    eng = Engine(model, params, batch_size=4, max_len=128, device=cuda_device)
    prompts = np.random.default_rng(0).integers(0, model.cfg.vocab, (4, 16))
    before = CB.launch_counts()
    out1 = eng.generate(prompts, GenerationConfig(max_new_tokens=24))
    out2 = eng.generate(prompts, GenerationConfig(max_new_tokens=24))
    assert CB.launch_counts() == before
    assert out1 == out2 and all(len(o) == 24 for o in out1)
    assert all(0 <= t < model.cfg.vocab for o in out1 for t in o)


@pytest.mark.cuda
def test_lm_sparse_ffn_weight_launches_its_kernel_once_a_call(cuda_device):
    """Layer 0's FFN gate of Qwen3-0.6B (3072 x 1024), pruned to 25 % in
    (8, 128) blocks, as a SparseLinear on the card: its kernel (BELL for
    bsr, SELL SpMM for sell) once a call and nothing else, against dense."""
    from repro_torch.models.registry import get
    from repro_torch.models.sparse import SparseLinear, magnitude_prune
    model = get("qwen3-0.6b")
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0),
                        device=cuda_device)
    w = magnitude_prune(params.units[0].mlp.wi_gate.detach().T.contiguous().cpu().numpy(),
                        0.25, structured=(8, 128))
    lin = SparseLinear.from_dense(w, fmt="auto", device=cuda_device)
    kernel = "bell_spmm" if lin.fmt == "bsr" else "sell_spmm"
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 1024), dtype=np.float32)).to(cuda_device)
    for _ in range(2):
        before = CB.launch_counts()
        y = lin(x)
        torch.cuda.synchronize()
        after = CB.launch_counts()
        assert after[kernel] == before[kernel] + 1
        assert {k for k in after if after[k] != before[k]} <= {
            kernel, f"{kernel}_decode", f"{kernel}_wide"}
    want = x @ torch.from_numpy(w).to(cuda_device).T
    assert float((y - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("qwen3-0.6b", "jamba-1.5-large-398b"))
def test_train_step_on_the_card_matches_the_host(cuda_device, name):
    """One reduced train step (f32 compute, TF32 off) on the card against the
    same step on the host: loss and grad_norm 1e-5 relative, parameters
    within 2 * lr (AdamW's first step is about lr * sign(g)); no counted
    kernel is launched (the training path runs on torch ops)."""
    from repro_torch.configs import reduced, smoke_batch
    from repro_torch.models.registry import Model, get_config
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(reduced(get_config(name), compute_dtype=torch.float32))
    host = model.init(torch.Generator().manual_seed(0), device="cpu")
    card = model.build(cuda_device)
    card.load_state_dict(host.state_dict())
    batch = smoke_batch(model.cfg, torch.Generator().manual_seed(1))
    step = T.make_train_step(model, O.OptimizerConfig(lr=1e-2, warmup_steps=1, schedule="const"))
    before = CB.launch_counts()
    _, opt_c, m_c = step(card, O.init_opt_state(card), {k: v.to(cuda_device)
                                                       for k, v in batch.items()})
    torch.cuda.synchronize()
    assert CB.launch_counts() == before
    _, _, m_h = step(host, O.init_opt_state(host), batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m_c[k]) - float(m_h[k])) <= 1e-5 * abs(float(m_h[k])), k
    hp = dict(host.named_parameters())
    for k, p in card.named_parameters():
        assert p.device == cuda_device
        assert float((p.detach().cpu().double() - hp[k].detach().double()).abs().max()) <= 2e-2
    assert opt_c["step"].device == cuda_device and int(opt_c["step"]) == 1


@pytest.mark.cuda
def test_checkpoint_save_and_restore_on_the_card(cuda_device, tmp_path):
    """A reduced model and its AdamW state on the card, after two steps:
    saved, restored into a fresh module and opt state on the card and on
    the host, bit for bit (bf16 leaves included: jamba's parameters)."""
    from repro_torch.configs import reduced, smoke_batch
    from repro_torch.models.registry import Model, get_config
    from repro_torch.train import checkpoint as C
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as T
    model = Model(reduced(get_config("jamba-1.5-large-398b")))
    card = model.init(torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    opt = O.init_opt_state(card)
    step = T.make_train_step(model, O.OptimizerConfig(lr=1e-2, warmup_steps=1))
    for i in range(2):
        batch = smoke_batch(model.cfg, torch.Generator(device=cuda_device).manual_seed(i))
        step(card, opt, batch)
    C.save(str(tmp_path), 2, params=card, opt_state=opt, keep=1)
    for dev in (cuda_device, torch.device("cpu")):
        fresh = model.build(dev)
        fresh_opt = O.init_opt_state(fresh)
        out = C.restore(str(tmp_path), 2, like={"params": fresh, "opt_state": fresh_opt})
        assert out["step"] == 2 and int(fresh_opt["step"]) == 2
        fp = dict(fresh.named_parameters())
        for k, p in card.named_parameters():
            assert fp[k].device == dev and fp[k].dtype == p.dtype
            assert torch.equal(fp[k].cpu(), p.detach().cpu()), k
            assert torch.equal(fresh_opt["m"][k].cpu(), opt["m"][k].cpu()), k
            assert torch.equal(fresh_opt["v"][k].cpu(), opt["v"][k].cpu()), k
