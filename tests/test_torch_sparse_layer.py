"""The sparse-weight layer and the grouped MoE GEMM: ``SparseLinear``, the
pruning and advisor helpers, ``kernels.ops`` and ``plan_groups`` /
``grouped_gemm`` held against the reference on identical numpy inputs.

Pruned weights and routing tables are compared bitwise.  Layer outputs
agree with the reference's ``SparseLinear(backend="ref")`` at rtol / atol
2e-4, the reference's own tolerance against the dense product
(``tests/test_infra.py``); kernel-level outputs agree to 1e-5 relative in
f32 (the same products summed in another order).
"""
import pytest

pytest.importorskip("jax")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (  # noqa: E402
    VALUE_DTYPE_TOL, _arrays, _meta, as_np, assert_same_array, operand, ref_matrix, rel_err,
    to_port)
from repro.core import formats as RF  # noqa: E402
from repro.core import perfmodel as RPM  # noqa: E402
from repro.kernels import moe_gemm as RMOE  # noqa: E402
from repro.kernels import ops as ROPS  # noqa: E402
from repro.models import sparse as RS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.kernels import cuda_build as CB  # noqa: E402
from repro_torch.kernels import moe_gemm as PMOE  # noqa: E402
from repro_torch.kernels import ops as POPS  # noqa: E402
from repro_torch.models import sparse as PS  # noqa: E402

CPU = torch.device("cpu")


def weight(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --- pruning and the advisor ---------------------------------------------------


@pytest.mark.parametrize("density,structured", [(0.25, (8, 128)), (0.5, (16, 128)),
                                                (0.1, None), (0.3, None)])
def test_magnitude_prune_is_bitwise_the_reference(density, structured):
    w = weight((64, 512), seed=3)
    want = RS.magnitude_prune(w, density, structured=structured)
    got = PS.magnitude_prune(w, density, structured=structured)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_advise_weight_format_and_sparsity_report_match():
    w = weight((64, 512), seed=2)
    cases = [RS.magnitude_prune(w, 0.2, structured=(8, 128)), RS.magnitude_prune(w, 0.05),
             weight((60, 100), seed=4)]          # does not tile: sell
    for wc in cases:
        for blk in ((8, 128), (16, 128)):
            assert PS.advise_weight_format(wc, blk) == RS.advise_weight_format(wc, blk)
        assert PS.sparsity_report(wc) == RS.sparsity_report(wc)
    assert PS.advise_weight_format(cases[0], (8, 128)) == "bsr"
    assert PS.advise_weight_format(cases[1], (8, 128)) == "sell"


# --- SparseLinear against the reference's --------------------------------------


def _ref_and_port(fmt, w):
    """The reference's layer and the port's over the reference's arrays."""
    ref = RS.SparseLinear.from_dense(w, fmt=fmt, backend="ref")
    m = ref.matrix
    port = interop.sparse_linear_from_arrays(fmt, _arrays(m), {"shape": m.shape, **_meta(m)},
                                             density=ref.density, device="cpu")
    return ref, port


@pytest.mark.parametrize("lead", [(4,), (2, 3)], ids=("2d", "3d"))
@pytest.mark.parametrize("fmt", ("bsr", "sell"))
def test_sparse_linear_matches_reference_on_its_arrays(fmt, lead):
    rng = np.random.default_rng(0 if fmt == "bsr" else 1)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    w = RS.magnitude_prune(w, 0.25, structured=(8, 128)) if fmt == "bsr" else \
        RS.magnitude_prune(w, 0.1)
    ref, port = _ref_and_port(fmt, w)
    assert (port.fmt, port.d_in, port.d_out) == (fmt, 256, 64)
    assert port.density == ref.density
    x = rng.standard_normal(lead + (256,)).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(x)))
    got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == lead + (64,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, x @ w.T, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fmt", ("bsr", "sell"))
def test_sparse_linear_from_dense_packs_the_reference_container(fmt):
    w = weight((64, 256), seed=5)
    w = PS.magnitude_prune(w, 0.25, structured=(8, 128)) if fmt == "bsr" else \
        PS.magnitude_prune(w, 0.1)
    ref = RS.SparseLinear.from_dense(w, fmt="auto", backend="ref")
    port = PS.SparseLinear.from_dense(w, fmt="auto", device="cpu")
    assert port.fmt == ref.fmt == fmt and port.density == ref.density
    for f in dataclasses.fields(ref.matrix):
        rv = getattr(ref.matrix, f.name)
        if f.name != "shape" and hasattr(rv, "shape"):
            assert_same_array(rv, getattr(port.matrix, f.name), f.name)
    # the kernels' stream regime: the reference's pallas, the port's cuda
    assert np.isclose(port.streamed_bytes(backend="cuda"),
                      RPM.spmv_streamed_bytes(ref.matrix, backend="pallas"), rtol=1e-12)


@pytest.mark.parametrize("vd", tuple(VALUE_DTYPE_TOL))
@pytest.mark.parametrize("fmt", ("bsr", "sell"))
def test_sparse_linear_value_dtypes_within_budget_of_dense(fmt, vd):
    w = weight((64, 256), seed=6)
    w = PS.magnitude_prune(w, 0.25, structured=(8, 128)) if fmt == "bsr" else \
        PS.magnitude_prune(w, 0.1)
    m = PF.BSR.from_dense(w) if fmt == "bsr" else PF.SELL.from_csr(PF.CSR.from_dense(w))
    lin = PS.SparseLinear(fmt, PF.with_value_dtype(m, vd), device="cpu")
    x = operand(256, 5, seed=7).T.copy()
    got = lin(torch.from_numpy(x)).numpy()
    want = x.astype(np.float64) @ w.astype(np.float64).T
    assert rel_err(got, want) < VALUE_DTYPE_TOL[vd]


def test_sparse_linear_is_a_module_with_its_arrays_as_buffers():
    w = PS.magnitude_prune(weight((64, 256), seed=8), 0.25, structured=(8, 128))
    lin = PS.SparseLinear("bsr", PF.with_value_dtype(PF.BSR.from_dense(w), "int8"),
                          device="cpu")
    assert isinstance(lin, torch.nn.Module) and lin.fmt == "bsr"
    names = dict(lin.named_buffers())
    assert set(names) == {"block_row_ptr", "block_col_idx", "blocks", "scale"}
    assert names["blocks"] is lin.matrix.blocks and names["blocks"].dtype == torch.int8
    assert all(t.device == CPU for t in names.values())
    assert "fmt=bsr" in repr(lin)
    with pytest.raises(ValueError, match="fmt"):
        PS.SparseLinear("csr", lin.matrix, device="cpu")
    with pytest.raises(TypeError, match="SELL"):
        PS.SparseLinear("sell", lin.matrix, device="cpu")


def test_sparse_linear_without_a_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = PS.magnitude_prune(weight((64, 256), seed=9), 0.25, structured=(8, 128))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.SparseLinear.from_dense(w)


# --- kernels.ops against the reference's ops --------------------------------------


def test_ops_entry_points_match_reference_ref_backend():
    r = ref_matrix("surrogate1200")
    x = operand(1200, seed=11)
    xj = jnp.asarray(x)
    hyb = RF.split_dia(r)
    cases = [(RF.convert(r, "sell"), "make_sell_spmv"), (hyb.dia, "make_dia_spmv"),
             (hyb, "make_hybrid_spmv"), (hyb, "make_kernel_spmv"),
             (RF.convert(r, "sell"), "make_kernel_spmv")]
    for m, name in cases:
        want = np.asarray(getattr(ROPS, name)(m, backend="ref")(xj))
        for be in ("ref", "torch", "auto", "pallas"):
            got = getattr(POPS, name)(to_port(m), backend=be, device="cpu")(
                torch.from_numpy(x)).numpy()
            assert rel_err(got, want) <= 1e-5, (name, be)
    b = RF.BSR.from_dense(ref_matrix("blocksparse").to_dense(), (8, 128))
    X = operand(1024, 3, seed=12)
    want = np.asarray(ROPS.make_bsr_spmm(b, backend="ref")(jnp.asarray(X)))
    for be in ("ref", "auto"):
        got = POPS.make_bsr_spmm(to_port(b), backend=be, device="cpu")(torch.from_numpy(X))
        assert rel_err(got.numpy(), want) <= 1e-5
    got = POPS.make_kernel_spmv(to_port(b), device="cpu")(torch.from_numpy(X[:, 0].copy()))
    assert rel_err(got.numpy(), want[:, 0]) <= 1e-5
    with pytest.raises(TypeError, match="no kernel path"):
        POPS.make_kernel_spmv(to_port(r), device="cpu")


# --- grouped GEMM ----------------------------------------------------------------


@pytest.mark.parametrize("eot", [[2, 0, 1, 1, 2, 2, 0], [0, 0, 0], [4, 4, 1], []],
                         ids=("mixed", "one-expert", "empty-experts", "no-tokens"))
@pytest.mark.parametrize("bt", (1, 4, 8))
def test_plan_groups_is_the_reference(eot, bt):
    eot = np.asarray(eot, dtype=np.int64)
    want = RMOE.plan_groups(eot, 5, bt)
    got = PMOE.plan_groups(eot, 5, bt)
    for w, g in zip(want[:3], got[:3]):
        assert np.asarray(w).dtype == g.dtype and np.array_equal(np.asarray(w), g)
    assert want[3] == got[3]


def _moe_inputs(bt, E, seed, T=70, D=48, F=40, eot=None):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((T, D)).astype(np.float32)
    W = rng.standard_normal((E, D, F)).astype(np.float32)
    return X, W, rng.integers(0, E, T) if eot is None else np.asarray(eot)


@pytest.mark.parametrize("bt", (8, 32))
@pytest.mark.parametrize("E", (2, 5))
def test_grouped_gemm_matches_reference_interpret(bt, E):
    X, W, eot = _moe_inputs(bt, E, seed=bt + E)
    want = np.asarray(RMOE.grouped_gemm(jnp.asarray(X), eot, jnp.asarray(W), bt=bt,
                                        interpret=True))
    for be in ("auto", "torch", "cuda"):
        got = POPS.grouped_gemm(torch.from_numpy(X), eot, interop.expert_weights(W, "cpu"),
                                backend=be, bt=bt)
        assert got.dtype == torch.float32 and rel_err(got.numpy(), want) <= 1e-5
    per_token = np.stack([X[t] @ W[eot[t]] for t in range(len(eot))])
    assert rel_err(want, per_token) <= 1e-5


def test_grouped_gemm_with_an_empty_expert_and_numpy_inputs():
    eot = np.random.default_rng(3).choice([0, 1, 3], size=70)   # experts 2, 4 unused
    X, W, _ = _moe_inputs(8, 5, seed=4, eot=eot)
    want = np.asarray(ROPS.grouped_gemm(jnp.asarray(X), eot, jnp.asarray(W), bt=8,
                                        backend="ref"))
    got = POPS.grouped_gemm(X, eot, W, bt=8, device="cpu")
    assert got.device == CPU and rel_err(got.numpy(), want) <= 1e-5
    # the padded product is the reference's, padding rows included
    _, inv, te, T_pad = PMOE.plan_groups(eot, 5, 8)
    Xp = np.zeros((T_pad, 48), np.float32)
    Xp[inv] = X
    yp_ref = np.asarray(RMOE.grouped_gemm_arrays(jnp.asarray(te), jnp.asarray(Xp),
                                                 jnp.asarray(W), bt=8, interpret=True))
    yp = PMOE.grouped_gemm_arrays(torch.from_numpy(te), torch.from_numpy(Xp),
                                  torch.from_numpy(W), bt=8)
    assert yp.shape == (T_pad, 40) and rel_err(yp.numpy(), yp_ref) <= 1e-5


def test_grouped_gemm_keeps_the_reference_contract():
    te = torch.zeros(2, dtype=torch.int32)
    X, W = torch.zeros(16, 4), torch.zeros(1, 4, 6)
    with pytest.raises(ValueError, match="F % bf"):
        PMOE.grouped_gemm_arrays(te, X, W, bt=8, bf=4)
    with pytest.raises(ValueError, match="T % bt"):
        PMOE.grouped_gemm_arrays(te, X[:12], W, bt=8)
    assert PMOE.grouped_gemm_arrays(te, X, W, bt=8, bf=3).shape == (16, 6)
    # result_type(X, W): bf16 only when both are bf16
    Wb = W.to(torch.bfloat16)
    assert PMOE.grouped_gemm_arrays(te, X, Wb, bt=8).dtype == torch.float32
    assert PMOE.grouped_gemm_arrays(te, X.to(torch.bfloat16), Wb, bt=8).dtype == \
        torch.bfloat16
    before = CB.launch_counts()
    PMOE.grouped_gemm_arrays(te, X, W, bt=8)
    assert CB.launch_counts() == before   # CPU tensors: the plain version


@pytest.mark.parametrize("bt,rows", [(128, 64), (64, 64), (32, 32), (8, 8), (96, 48),
                                     (7, 7), (200, 50)])
def test_gemm_rows_never_straddle_a_tile(bt, rows):
    assert PMOE.gemm_rows(bt) == rows and bt % rows == 0 and rows <= 64


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("x,w,bt,D,F,plan", [
    (BF, BF, 128, 2048, 1408, ("wgmma", 128)),   # DeepSeek-V2-Lite experts
    (BF, BF, 64, 2048, 1408, ("wgmma", 64)),     # bt % 128 != 0: 64-row tiles
    (BF, BF, 256, 200, 72, ("wgmma", 128)),      # ragged tile edges, 16-byte rows
    (BF, BF, 192, 128, 8, ("wgmma", 64)),
    (BF, BF, 128, 100, 72, ("simt", 128)),       # D % 8 != 0: no tensor map
    (BF, BF, 128, 2048, 1404, ("simt", 128)),    # F % 8 != 0
    (BF, BF, 96, 2048, 1408, ("simt", 96)),      # bt % 64 != 0
    (BF, BF, 32, 64, 64, ("simt", 32)),
    (F32, F32, 128, 2048, 1408, ("simt", 128)),  # f32: the f32 pipes
    (F32, BF, 128, 2048, 1408, ("simt", 128)),   # mixed: widened on the way in
    (BF, F32, 64, 2048, 1408, ("simt", 64)),
    (F32, F32, 8, 48, 40, ("simt", 8)),
    (F32, F32, 200, 48, 40, ("simt", 100)),      # two 50-row sub-tiles
    (F32, F32, 7, 48, 40, ("simt", 7)),
    (F32, F32, 256, 48, 40, ("simt", 128)),
])
def test_gemm_plan_picks_the_path_and_tile(x, w, bt, D, F, plan):
    got = PMOE.gemm_plan(bt, D, F, x, w)
    assert got == plan
    path, bm = got
    # a CTA never straddles two experts, and covers one or two gemm_rows sub-tiles
    assert bt % bm == 0 and bm <= 128
    assert bm in (PMOE.gemm_rows(bt), 2 * PMOE.gemm_rows(bt)) or path == "wgmma"
    assert path == "simt" or (x == w == BF and bm % 64 == 0 and D % 8 == 0 and F % 8 == 0)


def test_grouped_gemm_path_counters_rise_only_on_the_card():
    assert {c for c in CB.PATH_COUNTERS if c.startswith("grouped_gemm_")} == {
        f"grouped_gemm_{p}" for p in PMOE.PATHS}
    assert set(CB.PATH_COUNTERS) <= set(CB.launch_counts())
    te = torch.zeros(2, dtype=torch.int32)
    X, W = torch.ones(256, 16, dtype=BF), torch.ones(1, 16, 8, dtype=BF)
    assert PMOE.gemm_plan(128, 16, 8, X.dtype, W.dtype)[0] == "wgmma"
    before = CB.launch_counts()
    y = PMOE.grouped_gemm_arrays(te, X, W, bt=128)
    assert CB.launch_counts() == before and y.dtype == BF and float(y[0, 0]) == 16.0


def test_expert_weights_take_bf16_bits():
    import ml_dtypes
    W = np.random.default_rng(5).standard_normal((2, 3, 4)).astype(ml_dtypes.bfloat16)
    t = interop.expert_weights(W, "cpu")
    assert t.dtype == torch.bfloat16 and np.array_equal(as_np(t), as_np(W))
    with pytest.raises(ValueError, match="E, D, F"):
        interop.expert_weights(np.zeros((2, 3), np.float32), "cpu")
