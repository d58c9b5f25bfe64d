"""Blocked storage: the port's BSR container, BELL pack, block SpMM entries,
perfmodel terms and bsr plans held against the reference on identical
inputs made from numpy seeds.

Arrays are compared bitwise (bf16 / fp8 as their bits).  Products agree to
1e-5 relative in f32 and 1e-12 in f64 (the same products summed in another
order); narrow value dtypes stay within the reference's per-dtype budget
of the f64 oracle; model terms agree to 1e-12 relative.
"""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (  # noqa: E402
    VALUE_DTYPE_TOL, VALUE_DTYPES, as_np, assert_same_array, assert_same_container,
    operand, port_apply, port_matrix, ref_apply, ref_matrix, rel_err, to_port, x64)
from repro.core import formats as RF  # noqa: E402
from repro.core import matrices as RM  # noqa: E402
from repro.core import perfmodel as RPM  # noqa: E402
from repro.kernels import bsr_spmm as RK  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro.utils import hw as RHW  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core import matrices as PMAT  # noqa: E402
from repro_torch.core import perfmodel as PM  # noqa: E402
from repro_torch.core.plan import SpMVPlan, plan_all_formats  # noqa: E402
from repro_torch.core.planconfig import PlanConfig  # noqa: E402
from repro_torch.kernels import bsr_spmm as KB  # noqa: E402
from repro_torch.kernels import cuda_build as CB  # noqa: E402
from repro_torch.kernels import registry as PR  # noqa: E402
from repro_torch.utils.hw import ChipSpec  # noqa: E402

BLOCKS = ((8, 128), (16, 128), (8, 8))
#: a dense shape per block shape, small enough for the Pallas interpreter
SHAPE = {(8, 128): (64, 384), (16, 128): (64, 256), (8, 8): (32, 64)}


def dense(blk, density=0.3, seed=2):
    return RM.block_sparse_dense(*SHAPE[blk], blk, density, seed=seed)


@pytest.mark.parametrize("blk", BLOCKS, ids=str)
def test_block_sparse_dense_is_bit_equal(blk):
    for seed, dens in ((2, 0.3), (4, 0.25)):
        want = RM.block_sparse_dense(*SHAPE[blk], blk, dens, seed=seed)
        got = PMAT.block_sparse_dense(*SHAPE[blk], blk, dens, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("blk", BLOCKS, ids=str)
def test_bsr_from_dense_and_convert_arrays_equal(blk):
    d = dense(blk)
    want = RF.BSR.from_dense(d, blk)
    assert_same_container(want, PF.BSR.from_dense(d, blk))
    # convert builds straight from the CSR; the arrays are from_dense(to_dense)
    assert_same_container(RF.convert(RF.CSR.from_dense(d), "bsr", block_shape=blk),
                          PF.convert(PF.CSR.from_dense(d), "bsr", block_shape=blk))
    got = PF.BSR.from_dense(d, blk)
    assert np.array_equal(got.to_dense(), want.to_dense())
    assert got.density() == want.density() and got.nnz == want.nnz
    assert got.n_blocks == want.n_blocks


def test_bsr_from_csr_sums_duplicates_and_drops_zero_blocks():
    """power_law_rows repeats columns within a row; an all-zero tile of
    explicit entries is dropped, as ``from_dense`` drops it."""
    r = ref_matrix("powerlaw")
    want = RF.BSR.from_dense(r.to_dense(), (8, 128))
    assert_same_container(want, PF.BSR.from_csr(port_matrix("powerlaw"), (8, 128)))
    zeros = PF.CSR(np.array([0, 2] + [2] * 7, np.int32), np.array([0, 200], np.int32),
                   np.array([0.0, 1.5], np.float32), (8, 256))
    b = PF.BSR.from_csr(zeros, (8, 128))
    assert b.n_blocks == 1 and b.block_col_idx.tolist() == [1]
    with pytest.raises(ValueError, match="not divisible"):
        PF.BSR.from_csr(port_matrix("exact3"), (8, 128))


@pytest.mark.parametrize("vd", VALUE_DTYPES)
@pytest.mark.parametrize("blk", BLOCKS, ids=str)
def test_bsr_value_dtype_blocks_and_scales_equal(blk, vd):
    r = RF.BSR.from_dense(dense(blk), blk)
    qr, qp = RF.with_value_dtype(r, vd), PF.with_value_dtype(to_port(r), vd)
    assert_same_container(qr, qp)
    assert PF.container_value_dtype(qp) == vd
    assert_same_container(RF.dequantize(qr), PF.dequantize(qp))


@pytest.mark.parametrize("vd", ("f32", "bf16", "int8"))
@pytest.mark.parametrize("blk", BLOCKS, ids=str)
def test_bsr_to_bell_and_fill_ratio_equal(blk, vd):
    r = RF.with_value_dtype(RF.BSR.from_dense(dense(blk, 0.4, seed=3), blk), vd)
    p = to_port(r)
    rb, rs = RK.bsr_to_bell(r)
    pb, ps = KB.bsr_to_bell(p)
    assert_same_array(rb, pb, "bcols")
    assert_same_array(rs, ps, "slab")
    assert KB.bell_fill_ratio(p) == RK.bell_fill_ratio(r)
    lens = np.diff(np.asarray(r.block_row_ptr))
    assert KB.bell_row_nblocks(p).tolist() == lens.tolist()
    sc = KB.bell_scale(p)
    if r.scale is None:
        assert sc is None
    else:  # the per-block scale, slot by slot, padding 0
        mask = np.arange(pb.shape[1])[None, :] < lens[:, None]
        assert np.array_equal(sc.numpy()[mask], np.asarray(r.scale))
        assert not sc.numpy()[~mask].any()


@pytest.mark.parametrize("N", (1, 5))
@pytest.mark.parametrize("blk", BLOCKS, ids=str)
def test_bell_spmm_plain_matches_reference_pallas_and_ref(blk, N):
    r = RF.BSR.from_dense(dense(blk), blk)
    bcols, slab = RK.bsr_to_bell(r)
    X = operand(SHAPE[blk][1], N, seed=6)
    want = np.asarray(RK.bell_spmm_arrays(bcols, slab, X, interpret=True))
    want_ref = np.asarray(RREF.bell_spmm_ref(bcols, slab, X))
    pb, ps = KB.bsr_to_bell(to_port(r))
    got = KB.bell_spmm_plain(pb, ps, torch.from_numpy(X)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert rel_err(got, want) <= 1e-5 and rel_err(got, want_ref) <= 1e-5
    # the wrapper on CPU tensors is the plain version and counts nothing
    before = CB.launch_counts()
    via = KB.bell_spmm_arrays(pb, ps, torch.from_numpy(X), None,
                              KB.bell_row_nblocks(to_port(r)), SHAPE[blk][0] - 8)
    assert CB.launch_counts() == before
    assert np.array_equal(via.numpy(), got[:SHAPE[blk][0] - 8])


def test_bell_spmm_plain_applies_the_slot_scale():
    r = RF.with_value_dtype(RF.BSR.from_dense(dense((8, 128)), (8, 128)), "int8")
    p = to_port(r)
    bc, sl = KB.bsr_to_bell(p)
    X = torch.from_numpy(operand(SHAPE[(8, 128)][1], 3, seed=7))
    got = KB.bell_spmm_plain(bc, sl, X, KB.bell_scale(p))
    want = ref_apply(r, "bsr", "spmm", "xla", X.numpy())
    assert rel_err(got.numpy(), want) <= 1e-5


# --- the registry entries -----------------------------------------------------


_REF64: dict = {}


def bsr_container(vd: str = "f64"):
    """Reference BSR of the blocksparse spec (1024^2, (8, 128) blocks at
    25 %), packed from its f64 copy."""
    if "c" not in _REF64:
        r = ref_matrix("blocksparse")
        r = RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64), r.shape)
        _REF64["c"] = RF.BSR.from_dense(r.to_dense(), (8, 128))
    c = _REF64["c"]
    return c if vd == "f64" else RF.with_value_dtype(c, vd)


@pytest.mark.parametrize("backend", ("torch", "loop_reference"))
@pytest.mark.parametrize("op", ("spmv", "spmm"))
@pytest.mark.parametrize("dtype", ("f32", "f64"))
def test_bsr_entry_matches_reference_xla(dtype, op, backend):
    ref_c = bsr_container(dtype)
    npd = np.float64 if dtype == "f64" else np.float32
    x = operand(1024, None if op == "spmv" else 3, seed=5, dtype=npd)
    with x64(dtype == "f64"):
        want = ref_apply(ref_c, "bsr", op, "xla", x)
    got = port_apply(to_port(ref_c), "bsr", op, backend, x)
    assert got.dtype == npd
    assert rel_err(got, want) <= (1e-12 if dtype == "f64" else 1e-5)


@pytest.mark.parametrize("backend", ("torch", "loop_reference"))
@pytest.mark.parametrize("vd", tuple(VALUE_DTYPE_TOL))
def test_bsr_narrow_dtypes_within_budget_of_f64_oracle(vd, backend):
    ref_c = bsr_container(vd)
    x = operand(1024, seed=5)
    with x64():
        oracle = ref_apply(bsr_container(), "bsr", "spmv", "xla", x.astype(np.float64))
    got = port_apply(to_port(ref_c), "bsr", "spmv", backend, x)
    assert got.dtype == np.float32
    assert rel_err(got, oracle) < VALUE_DTYPE_TOL[vd]
    assert rel_err(got, ref_apply(ref_c, "bsr", "spmv", "xla", x)) <= 1e-5


def test_bsr_registry_entries_and_cpu_routing():
    keys = {e.key for e in PR.entries("bsr")}
    assert keys == {("bsr", op, be) for op in ("spmv", "spmm")
                    for be in ("torch", "cuda", "loop_reference")}
    assert not any(e.auto for e in PR.entries("bsr", backend="loop_reference"))
    obj = to_port(bsr_container("int8"))
    ctx = PR.KernelContext(device=torch.device("cpu"))
    assert PR.select_backend(obj, "bsr", "spmm", ctx)[0] == "torch"
    cap = PR.get("bsr", "spmm", "cuda").probe(obj, ctx)
    assert not cap.ok and "CUDA device" in cap.reason


def test_bsr_cuda_entry_wins_whatever_chip_is_priced(monkeypatch):
    import dataclasses
    for e in PR.entries("bsr", backend="cuda"):
        monkeypatch.setitem(PR._TABLE, e.key, dataclasses.replace(e, probe=PR._probe_ok))
    obj = to_port(bsr_container("f32"))
    for chip in (ChipSpec("tpu_v5e", 1e13, 5e12, 1e12), ChipSpec("other_gpu", 1e13, 5e12, 1e12)):
        ctx = PR.KernelContext(device="cpu", chip=chip)
        for op in ("spmv", "spmm"):
            assert PR.select_backend(obj, "bsr", op, ctx)[0] == "cuda"


@pytest.mark.parametrize("N", (1, 3, 7, 8, 16, 31, 32, 40, 64, 100, 256, 1000))
@pytest.mark.parametrize("blk,acc_bytes", [((8, 128), 4), ((8, 128), 8), ((16, 128), 4),
                                           ((16, 128), 8), ((8, 8), 4), ((32, 256), 4)])
def test_bell_launch_geometry_fits_the_block(blk, acc_bytes, N):
    bm, bk = blk
    L = KB.bell_launch(bm, bk, N, acc_bytes, acc_bytes)
    n_tiles = -(-N // L.ntile)
    n_cg = L.ntile // L.cw
    assert L.ntile % L.cw == 0 and (n_tiles - 1) * L.ntile < N
    # a thread's accumulators: at most 32 registers' worth (8 x 16 bytes)
    assert L.rm * L.cw * acc_bytes <= KB.WIDE_ROWS * 16
    if L.path == "decode":   # an output a thread
        assert N < 8 and (L.cw, L.rm) == (1, 1) and L.ntile <= N
    else:   # 16 bytes of outputs a thread, <= 256 bytes of an X row an item
        assert N >= 8 and L.cw == 16 // acc_bytes and L.ntile * acc_bytes <= KB.TILE_BYTES
        assert L.rm in (2, KB.WIDE_ROWS)
    if L.rm < KB.WIDE_ROWS:   # G lanes of one warp along bk
        assert 1 <= L.G <= 32 and 32 % L.G == 0
        assert -(-bm // L.rm) * n_cg * L.G <= KB.THREADS and (L.cl, L.uh, L.gw) == (0, 0, 0)
        red = 0
    else:
        # a quarter-warp's cl lanes read distinct 16-byte pieces of an X row;
        # the 2-8 (row group, column chunk) units fit the uh warps, gw warps split bk
        assert L.cl == min(8, 1 << (n_cg - 1).bit_length())
        units = -(-bm // KB.WIDE_ROWS) * -(-n_cg // L.cl)
        assert n_cg >= 4 and units <= L.uh and L.uh * L.gw == KB.WARPS
        assert L.G == 32 // L.cl * L.gw
        red = KB.WARPS * L.cl * KB.WIDE_ROWS * L.cw * acc_bytes
    # the ring in shared memory: a block (rows padded to rm) and its X panel a stage
    r16 = lambda b: -(-b // 16) * 16  # noqa: E731
    rows = -(-bm // L.rm) * L.rm
    assert L.stage_bytes == r16(rows * bk * acc_bytes) + r16(bk * L.ntile * acc_bytes)
    assert 1 <= L.stages <= KB.MAX_STAGES
    assert L.smem == KB.SMEM_BARRIERS + red + L.stages * L.stage_bytes <= KB.SMEM_MAX
    if N == 1:  # decode: the CTA's threads run along bk of the block's rows
        assert L.ntile == 1 and L.G == min(32, KB.THREADS // bm, bk)


def test_bell_launch_at_the_sparse_layers_widths():
    # Gemma-7B gate, (8, 128) f32 blocks: at B = 64 8 x 4 outputs a thread,
    # 8 lanes along the 16 column groups, 4 along bk, 2 x 4 warps
    L64 = KB.bell_launch(8, 128, 64, 4)
    assert (L64.path, L64.rm, L64.ntile, L64.cl, L64.uh, L64.gw, L64.G) == (
        "wide", 8, 64, 8, 2, 4, 16)
    assert L64.stages >= 2 and 2 * L64.smem <= KB.SMEM_MAX   # two CTAs an SM
    # at B = 8 2 x 4 outputs a thread, a warp's lanes along bk
    L8 = KB.bell_launch(8, 128, 8, 4)
    assert (L8.path, L8.rm, L8.ntile, L8.G) == ("wide", 2, 8, 32)
    L1 = KB.bell_launch(8, 128, 1, 4)
    assert (L1.path, L1.ntile, L1.G, L1.stages) == ("decode", 1, 32, KB.MAX_STAGES)
    # narrow values keep their width in the ring
    assert KB.bell_launch(8, 128, 1, 4, 1).stage_bytes == 8 * 128 + 128 * 4


def test_bell_panels_tile_x_for_the_kernel():
    X = torch.arange(5 * 7, dtype=torch.float32).view(5, 7)
    assert KB.bell_panels(X, 7) is X
    P = KB.bell_panels(X, 3)
    assert P.shape == (3, 5, 3) and P.is_contiguous()
    assert torch.equal(P.permute(1, 0, 2).reshape(5, 9)[:, :7], X)
    assert not P[2, :, 1:].any()


def test_bell_spmm_path_counters_rise_only_on_the_card():
    assert {c for c in CB.PATH_COUNTERS if c.startswith("bell_spmm_")} == {
        "bell_spmm_decode", "bell_spmm_wide"}
    assert [KB.bell_launch(8, 128, N, 4).path for N in (1, 7, 8, 64)] == [
        "decode", "decode", "wide", "wide"]
    b = PF.BSR.from_dense(np.eye(16, 256, dtype=np.float32), (8, 128))
    bc, sl = KB.bsr_to_bell(b)
    before = CB.launch_counts()
    y = KB.bell_spmm_arrays(bc, sl, torch.ones(256, 8), None, KB.bell_row_nblocks(b))
    assert CB.launch_counts() == before and torch.equal(y, torch.ones(16, 8))


def test_bell_launch_refuses_a_block_too_large():
    with pytest.raises(ValueError, match="does not fit"):
        KB.bell_launch(512, 128, 1, 4)
    with pytest.raises(ValueError, match="does not fit"):   # rows past 256 threads x 2
        KB.bell_launch(600, 8, 64, 4)
    with pytest.raises(ValueError, match="does not fit"):   # one stage over shared memory
        KB.bell_launch(256, 256, 8, 8, 8)


# --- the perfmodel's BSR terms and the bsr plans ---------------------------------


@pytest.mark.parametrize("vd", ("f32", "bf16", "int8"))
def test_bsr_model_terms_match_reference(vd):
    ref = bsr_container(vd)
    port = to_port(ref)
    for vb, ib in ((8, 4), (4, 4), (2, 4)):
        ram = RPM.AccessModel(vb, ib, 128 // vb, 1.5, 0.75)
        pam = PM.AccessModel(vb, ib, 128 // vb, 1.5, 0.75)
        for blk, fill in (((8, 128), 1.0), ((16, 128), 1.3), ((1, 1), 2.0)):
            assert np.isclose(RPM.balance_bsr(ram, blk, fill), PM.balance_bsr(pam, blk, fill),
                              rtol=1e-12, atol=0)
    for rb, pb in (("xla", "torch"), ("pallas", "cuda")):
        pairs = [(RPM.balance_of(ref, backend=rb), PM.balance_of(port, backend=pb)),
                 (RPM.matrix_stream_bytes(ref, backend=rb),
                  PM.matrix_stream_bytes(port, backend=pb))]
        for gen in (False, True):
            pairs.append((RPM.spmv_streamed_bytes(ref, backend=rb, generated_indices=gen),
                          PM.spmv_streamed_bytes(port, backend=pb, generated_indices=gen)))
        for k in (1, 8, 64):
            pairs.append((RPM.spmm_balance_of(ref, k, backend=rb),
                          PM.spmm_balance_of(port, k, backend=pb)))
        for r, p in pairs:
            assert np.isclose(r, p, rtol=1e-12, atol=0), (r, p)


def _port_chip(ref_chip):
    return ChipSpec(ref_chip.name, ref_chip.peak_flops_fp32, ref_chip.peak_flops_fp32 / 2,
                    ref_chip.hbm_bytes_per_s)


REF_CHIPS = {"tpu": RHW.TPU_V5E,
             "cpu": RHW.ChipSpec("host_cpu", 1e12, 5e11, 20e9, 8 << 30, 0.0, 0, 32 << 20)}


@pytest.mark.parametrize("family", ("tpu", "cpu"))
def test_bsr_plan_and_auto_pick_match_reference(monkeypatch, family):
    from repro.core.plan import PlanConfig as RefConfig
    from repro.core.plan import SpMVPlan as RefPlan
    own = RPM.sell_flat_overhead
    monkeypatch.setattr(RPM, "sell_flat_overhead",
                        lambda fam=None: own(family if fam is None else fam))
    r = ref_matrix("blocksparse")
    chip = REF_CHIPS[family]
    want = RPM.select_format(r, chip=chip, backend="xla")
    got = PM.select_format(to_port(r), chip=_port_chip(chip), backend="torch")
    assert "bsr" in got.predicted_time_s and got.format == want.format
    assert got.convert_kwargs == want.convert_kwargs
    for f, t in want.predicted_time_s.items():
        assert np.isclose(t, got.predicted_time_s[f], rtol=1e-12, atol=0)
    x = operand(1024, seed=3)
    for fmt in ("bsr", "auto"):
        rp = RefPlan.compile(r, RefConfig(format=fmt, chip=chip, backend="xla"))
        pp = SpMVPlan.compile(to_port(r), PlanConfig(format=fmt, chip=_port_chip(chip),
                                                     device="cpu"))
        assert pp.report.format == rp.report.format and pp.report.kernel == "torch"
        for f in ("balance_bytes_per_flop", "predicted_gflops", "predicted_time_s"):
            assert np.isclose(getattr(rp.report, f), getattr(pp.report, f),
                              rtol=1e-12, atol=0), f
        y = pp(torch.from_numpy(x)).numpy()
        assert rel_err(y, np.asarray(rp.apply(x))) <= 1e-5


def test_plan_all_formats_takes_bsr_when_the_shape_tiles():
    m = port_matrix("blocksparse")
    plans = plan_all_formats(m, PlanConfig(device="cpu"))
    assert set(plans) == {"csr", "ell", "jds", "sell", "hybrid", "bsr"}
    x = torch.from_numpy(operand(1024, seed=4, dtype=np.float64))
    want = plans["csr"](x)
    for fmt, p in plans.items():
        assert p.report.format == fmt
        assert torch.allclose(p(x), want, rtol=1e-12, atol=1e-12), fmt
    # a shape that does not tile plans without bsr
    assert "bsr" not in plan_all_formats(port_matrix("exact3"), PlanConfig(device="cpu"))


def test_bsr_spmv_and_spmm_helpers_match_dense():
    d = dense((8, 128), seed=5)
    p = PF.BSR.from_dense(d, (8, 128))
    x = operand(d.shape[1], seed=1)
    X = operand(d.shape[1], 4, seed=2)
    assert np.allclose(KB.bsr_spmv(p, torch.from_numpy(x)).numpy(), d @ x,
                       rtol=1e-5, atol=1e-5)
    assert np.allclose(KB.bsr_spmm(p, torch.from_numpy(X)).numpy(), d @ X,
                       rtol=1e-5, atol=1e-5)
    assert as_np(p.blocks).dtype == np.float32
