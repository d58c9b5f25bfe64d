"""The matrix-free SpMV kernel's launch object and its walk, on the CPU.

``MfLaunch`` (the only form of the descriptor ``csrc/mf_spmv.cu`` takes) is
held against ``mf_tables``; it refuses more diagonals than the kernel's
cap, rows or columns of 2^31 or more, quantized storage and lanes or an x
of another operator, and the wrapper refuses a raw descriptor.  The
divisor magic of every period gives ``row % p`` for every row of the
operators below and at sampled rows up to 2^31 - 1.  A numpy emulation of
the kernel's walk -- CTAs of ``kBlock`` threads, ``kRows`` rows a thread
``kBlock`` apart, the phase from the divisor magic, columns outside the
matrix read as zeros from an unpadded x, one accumulator a row summed in
ascending offset order -- is held against ``mf_spmv_plain`` and against
the reference's Pallas ``mf_spmv_arrays`` run in interpret mode, on
identical operators and every storage dtype the kernel takes: 1e-12
relative with an f64 accumulator, 1e-5 with f32.
"""
import dataclasses
import re
from pathlib import Path

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import operand, ref_matrix, rel_err, to_port, x64  # noqa: E402
from repro.core import formats as RF  # noqa: E402
from repro.core import matrices as RM  # noqa: E402
from repro.kernels import matrix_free as RK  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.kernels import cuda_build as CB  # noqa: E402
from repro_torch.kernels import matrix_free as MF  # noqa: E402
from repro_torch.kernels.dia_spmv import pad_x  # noqa: E402

OPS = ("laplace48", "laplace24", "exact3", "exact4", "exact6", "rect")
#: (storage, x dtype) pairs the kernel takes
VX = (("f64", np.float64), ("f32", np.float64), ("f32", np.float32), ("bf16", np.float32),
      ("bf16", np.float64), ("f16", np.float32), ("f16", np.float64))
VX_IDS = [f"{v}-{np.dtype(x).name}" for v, x in VX]

_REF: dict = {}


def _rect_csr():
    """A 500 x 530 operator: generated diagonals (one cut by the right
    edge, one under a periodic rule) beside a stored one."""
    rng = np.random.default_rng(17)
    n, ncols = 500, 530
    rows, cols, vals = [], [], []
    for off, val in ((-7, 2.0), (0, None), (3, -1.5), (40, 0.25)):
        r = np.arange(max(0, -off), min(n, ncols - off))
        if off == 3:
            r = r[r % 10 < 6]
        rows.append(r)
        cols.append(r + off)
        vals.append(rng.standard_normal(r.size) if val is None else np.full(r.size, val))
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    order = np.lexsort((cols, rows))
    rp = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=rp[1:])
    return RF.CSR(rp.astype(np.int32), cols[order].astype(np.int32), vals[order], (n, ncols))


def ref_op(name: str, vd: str = "f64"):
    """Reference matrix-free operator of a test matrix, f64 values then ``vd``."""
    if name not in _REF:
        if name == "exact6":
            r = RM.holstein_hubbard_exact(RM.HolsteinHubbardParams(L=6, max_phonon=2))
        elif name == "rect":
            r = _rect_csr()
        else:
            r = ref_matrix(name)
            r = RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64), r.shape)
        _REF[name] = RF.MatrixFreeOperator.from_csr(r)
    op = _REF[name]
    return op if vd == "f64" else RF.with_value_dtype(op, vd)


def kernel_geometry() -> tuple[int, int, int]:
    """(threads a CTA, rows a thread on streamed lanes, rows a thread on
    coded lanes) as the kernel's sources set them."""
    src = CB.source_path("mf_spmv").read_text()
    rows = re.search(r"constexpr int kRows = (\d+);", src)
    code_rows = re.search(r"constexpr int kCodeRows = (\d+);", src)
    block = re.search(r"constexpr int kBlock = (\d+);", (CB.CSRC / "common.cuh").read_text())
    return int(block.group(1)), int(rows.group(1)), int(code_rows.group(1))


def emulate_mf_spmv(launch: MF.MfLaunch, lanes, x: torch.Tensor) -> np.ndarray:
    """The walk of ``csrc/mf_spmv.cu`` in numpy, on the lanes as values
    (``kRows`` rows a thread) or as ``MfCodes`` (``kCodeRows`` rows a
    thread, each lane's codes of a thread one word of its tile, a value
    read from the widened table)."""
    block, rows_streamed, rows_coded = kernel_geometry()
    coded = isinstance(lanes, MF.MfCodes)
    R = rows_coded if coded else rows_streamed
    n, ncols = launch.shape
    wide = torch.float64 if torch.float64 in (launch.storage, x.dtype) else torch.float32
    adt = np.float64 if wide == torch.float64 else np.float32
    xa = x.to(wide).numpy()   # widening is exact
    if coded:
        table, codes = lanes.values.to(wide).numpy(), lanes.codes.numpy()
    else:
        vals = lanes.to(wide).numpy()
    n_cta = -(-n // (block * R))
    thread = (np.arange(n_cta, dtype=np.uint64)[:, None] * block
              + np.arange(block, dtype=np.uint64)[None, :]).ravel()
    base = (np.arange(n_cta, dtype=np.uint64)[:, None] * (block * R)
            + np.arange(block, dtype=np.uint64)[None, :]).ravel()
    word = (thread * R).astype(np.int64)
    rows = [base + r * block for r in range(R)]
    live = [rw < n for rw in rows]
    accs = [np.zeros(base.shape, adt) for _ in range(R)]
    offs = launch.table["off"].astype(np.int64)
    assert (np.diff(offs) > 0).all(), "the walk sums in ascending offset order"
    for d in launch.table:
        for r in range(R):
            c = (rows[r] + (int(d["off"]) & 0xFFFFFFFF)) & 0xFFFFFFFF   # uint32 wrap
            ok = live[r] & (c < ncols)
            xv = np.zeros(base.shape, adt)
            xv[ok] = xa[c[ok].astype(np.int64)]
            if d["lane"] >= 0:
                if coded:   # byte r of the thread's word; padded rows read code 0
                    v = table[codes[d["lane"], word + r]]
                else:
                    v = np.zeros(base.shape, adt)
                    v[live[r]] = vals[d["lane"], rows[r][live[r]].astype(np.int64)]
                accs[r] = accs[r] + v * xv
                continue
            contrib = adt(d["gen"]) * xv
            if d["p"]:
                ph = MF.mf_phase(rows[r], int(d["p"]), int(d["magic"]), int(d["shift"]))
                contrib = np.where((ph < d["lo"]) | (ph >= d["hi"]), adt(0), contrib)
            accs[r] = accs[r] + contrib
    y = np.full(n, np.nan, adt)
    written = np.zeros(n, bool)
    for r in range(R):
        idx = rows[r][live[r]].astype(np.int64)
        assert not written[idx].any(), "a row was written twice"
        y[idx], written[idx] = accs[r][live[r]], True
    assert written.all(), "a row of y was never written"
    return y


# --- the launch object ------------------------------------------------------------


@pytest.mark.parametrize("name", OPS)
def test_launch_table_agrees_with_mf_tables(name):
    op = to_port(ref_op(name))
    launch = MF.mf_launch(op)
    diags = MF.mf_tables(op)
    t = launch.table
    assert t.dtype.itemsize == 40 and launch.n_diags == len(diags)
    assert launch.shape == op.shape and launch.n_stored == op.n_stored
    assert MF.mf_launch(op) is launch   # built once per operator
    ks = 0
    for row, (off, spec) in zip(t, diags):
        assert row["off"] == off
        if spec is None:
            assert row["lane"] == ks and row["p"] == 0 and row["gen"] == 0
            ks += 1
            continue
        p, lo, hi, gvr = spec
        assert row["lane"] == -1 and (row["p"], row["lo"], row["hi"]) == (p, lo, hi)
        assert row["gen"] == gvr
        assert (row["magic"], row["shift"]) == (MF.divisor_magic(p) if p else (0, 0))
    assert ks == op.n_stored
    desc, gen = MF.mf_pack_descriptor(diags)
    assert torch.equal(launch.desc, desc) and torch.equal(launch.gen, gen)


def _generated(n: int, ncols: int, offsets, vd: str = "f64"):
    """An operator of generated diagonals only, with no storage behind it."""
    k = len(offsets)
    return PF.MatrixFreeOperator(
        data=None, shape=(n, ncols), offsets=tuple(offsets), periods=(1,) * k,
        los=(0,) * k, his=(1,) * k, gen_values=(1.0,) * k, nnz=k, stored_nnz=0,
        value_dtype=vd)


def test_launch_takes_its_cap_and_refuses_more_diagonals():
    assert MF.MfLaunch(_generated(1000, 1000, range(-128, 128))).n_diags == MF.MAX_DIAGS
    with pytest.raises(ValueError, match="MAX_DIAGS"):
        MF.MfLaunch(_generated(1000, 1000, range(-128, 129)))


@pytest.mark.parametrize("shape", ((1 << 31, 8), (8, 1 << 31), (1 << 31, 1 << 31)),
                         ids=str)
def test_launch_refuses_rows_or_columns_of_2_31(shape):
    with pytest.raises(ValueError, match="2\\^31"):
        MF.MfLaunch(_generated(*shape, (0,)))


def test_launch_takes_rows_and_columns_just_below_2_31():
    top = (1 << 31) - 1
    launch = MF.MfLaunch(_generated(top, top, (-top + 1, 0, top - 1)))
    assert launch.shape == (top, top) and launch.n_diags == 3


@pytest.mark.parametrize("vd", ("int8", "fp8_e4m3"))
def test_launch_refuses_quantized_storage(vd):
    op = to_port(ref_op("exact3"))
    q = dataclasses.replace(op, data=torch.zeros(op.data.shape, dtype=PF.VALUE_DTYPES[vd]),
                            value_dtype=vd)
    with pytest.raises(TypeError, match="quantized"):
        MF.MfLaunch(q)


def test_wrapper_refuses_another_operators_lanes_and_x_and_a_raw_descriptor():
    op, other = to_port(ref_op("exact4")), to_port(ref_op("laplace48"))
    data = MF.mf_data(op)
    x = torch.from_numpy(operand(op.shape[1], seed=2, dtype=np.float64))
    launch = MF.mf_launch(op)
    with pytest.raises(ValueError, match="descriptor"):
        MF.mf_spmv_arrays(MF.mf_data(other), launch, x)
    with pytest.raises(ValueError, match="descriptor"):
        MF.mf_spmv_arrays(data, MF.mf_launch(other), x)
    with pytest.raises(ValueError, match="descriptor"):
        MF.mf_spmv_arrays(data.float(), launch, x)
    with pytest.raises(ValueError, match="columns"):
        MF.mf_spmv_arrays(data, launch, x[1:])
    with pytest.raises(TypeError, match="MfLaunch"):
        MF.mf_spmv_arrays(data, launch.desc, x)
    with pytest.raises(TypeError, match="MfLaunch"):
        MF.mf_spmv_arrays(data, torch.from_numpy(launch.table.view(np.uint8)), x)


# --- the divisor magic ------------------------------------------------------------


@pytest.mark.parametrize("name", ("laplace48", "exact3", "exact4", "exact6", "rect"))
def test_divisor_magic_gives_every_rows_phase(name):
    op = to_port(ref_op(name))
    periods = {p for _, spec in MF.mf_tables(op) if spec is not None for p in [spec[0]] if p}
    assert periods, "the operator has a masked diagonal"
    rows = np.arange(op.shape[0], dtype=np.uint64)
    for p in periods:
        assert np.array_equal(MF.mf_phase(rows, p, *MF.divisor_magic(p)), rows % p)


def test_divisor_magic_at_sampled_rows_up_to_2_31():
    rng = np.random.default_rng(3)
    top = (1 << 31) - 1
    periods = sorted({1, 2, 3, 7, 48, 81, 324, 1100, 4374, 46656, 1 << 20, 1 << 30, top - 1,
                      top} | set(rng.integers(1, top, 200).tolist()))
    for p in periods:
        q = np.arange(1, 4, dtype=np.uint64)
        near = np.concatenate([q * p - 1, q * p, q * p + 1, top // p * p - q, [0, top, top - 1]])
        rows = np.concatenate([rng.integers(0, top + 1, 2000).astype(np.uint64),
                               near[near <= top].astype(np.uint64)])
        magic, shift = MF.divisor_magic(p)
        assert 0 < magic < 1 << 32
        assert np.array_equal(MF.mf_phase(rows, p, magic, shift), rows % p), p


def test_divisor_magic_refuses_periods_outside_32_bits():
    for p in (0, -3, 1 << 31):
        with pytest.raises(ValueError):
            MF.divisor_magic(p)


# --- the kernel's walk --------------------------------------------------------------


@pytest.mark.parametrize("vd,xdt", VX, ids=VX_IDS)
@pytest.mark.parametrize("name", OPS)
def test_kernel_walk_matches_plain(name, vd, xdt):
    op = to_port(ref_op(name, vd))
    launch, data = MF.mf_launch(op), MF.mf_data(op)
    x = torch.from_numpy(operand(op.shape[1], seed=3, dtype=np.float64)).to(
        torch.float64 if xdt == np.float64 else torch.float32)
    got = emulate_mf_spmv(launch, data, x)
    p0, p1 = launch.pads
    acc = torch.float64 if torch.float64 in (x.dtype, data.dtype) else torch.float32
    want = MF.mf_spmv_plain(data, launch.desc, launch.gen, pad_x(x, p0, p1, acc), p0,
                            op.shape[0]).numpy()
    assert torch.equal(MF.mf_spmv_arrays(data, launch, x), torch.from_numpy(want))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert rel_err(got, want) <= (1e-12 if want.dtype == np.float64 else 1e-5)


def ref_mf_spmv_pallas(ref_o, x: np.ndarray) -> np.ndarray:
    """The reference's Pallas matrix-free SpMV (interpreted, as the
    reference's own tests run it) on its padded grid, accumulating in the
    port's accumulator type of the storage and x."""
    data, pad0, pad1, diags, n, n_pad = RK.mf_prepare(ref_o)
    st = np.dtype(RK._storage_dtype(ref_o))
    odt = np.float64 if np.float64 in (st, x.dtype) else np.float32
    x_pad = jnp.pad(jnp.asarray(x), (pad0, pad1))
    y = RK.mf_spmv_arrays(None if data is None else jnp.asarray(data), x_pad, diags=diags,
                          n_pad=n_pad, pad0=pad0, interpret=True, out_dtype=odt)
    return np.asarray(y)[:n]


@pytest.mark.parametrize("vd,xdt", VX, ids=VX_IDS)
@pytest.mark.parametrize("name", OPS)
def test_kernel_walk_matches_reference_pallas(name, vd, xdt):
    ref_o = ref_op(name, vd)
    op = to_port(ref_o)
    x = operand(op.shape[1], seed=31, dtype=xdt)
    with x64(xdt == np.float64 or vd == "f64"):
        want = ref_mf_spmv_pallas(ref_o, x)
    got = emulate_mf_spmv(MF.mf_launch(op), MF.mf_data(op), torch.from_numpy(x))
    assert got.dtype == want.dtype
    assert rel_err(got, want) <= (1e-12 if got.dtype == np.float64 else 1e-5)


def test_ablation_edits_apply_to_the_kernel_source():
    # the ablation (repro_torch.testing.mf_ablation, run on the card) changes
    # one suspect of csrc/mf_spmv.cu at a time by text edits: each must apply
    from repro_torch.testing import mf_ablation as MA
    variants = MA._variants(CB.source_path("mf_spmv").read_text())
    names = [v[0] for v in variants]
    assert names[:4] == ["kernel", "masks_off", "rem64", "desc_global"]
    assert {"x_padded", "x_evict_last", "first_design", "first_design_with_pad"} <= set(names)
    assert len([n for n in names if n.startswith("rows_")]) == 3
    assert {f"code_rows_{r}" for r in (1, 2, 8)} <= set(names)
    assert "code_rows_consecutive" in names
    for name, src, edits, checked, _, forms, rows in variants:
        assert checked == (name != "masks_off")
        if name.startswith(("rows_", "first_design")):
            assert forms == (MA.LANES,), name
        elif name == "code_rows_consecutive":
            assert forms == (MA.CODES_IN_ROW_ORDER,) and rows == kernel_geometry()[2]
        elif name.startswith("code_rows_"):
            assert forms == (MA.CODES,) and rows == int(name[len("code_rows_"):])
        else:
            assert forms == (MA.LANES, MA.CODES) and rows == kernel_geometry()[2], name
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name


# --- the lanes as 1-byte codes ---------------------------------------------------


def test_code_constants_agree_with_the_kernel_source():
    src = CB.source_path("mf_spmv").read_text()
    block, _, code_rows = kernel_geometry()
    assert (MF.BLOCK, MF.CODE_ROWS) == (block, code_rows)
    assert f"constexpr int kMaxValues = {MF.MAX_CODES + 1};" in src


_SPECIAL = {"negzero": (-0.0, 0.0, 1.5), "zeros": (0.0,), "infs": (float("inf"), -float("inf"),
                                                                  2.0)}


def _stored(lanes: torch.Tensor):
    """A square operator whose diagonals 0 .. s - 1 are all stored, its
    lanes exactly ``lanes`` (s, n)."""
    s, n = lanes.shape
    vd = next(k for k, v in PF.VALUE_DTYPES.items() if v == lanes.dtype)
    return PF.MatrixFreeOperator(
        data=lanes, shape=(n, n), offsets=tuple(range(s)), periods=(1,) * s, los=(0,) * s,
        his=(1,) * s, gen_values=(None,) * s, nnz=s * n, stored_nnz=s * n, value_dtype=vd)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(MF._BITS[t.dtype]).numpy()


def _lanes_case(case: str, vd: str) -> torch.Tensor:
    """Three lanes of 1000 rows in storage ``vd``: a few dozen values, half
    the rows +0.0, and in lane 1 the case's values (-0.0 beside +0.0; a
    lane of +0.0 alone; infinities), or two NaNs of other payloads."""
    rng = np.random.default_rng(4)
    dt = PF.VALUE_DTYPES[vd]
    pool = rng.standard_normal(30) * 4
    v = np.where(rng.random((3, 1000)) < 0.5, 0.0, rng.choice(pool, (3, 1000)))
    if case in _SPECIAL:
        v[1] = rng.choice(np.asarray(_SPECIAL[case]), 1000)
    lanes = torch.from_numpy(v).to(dt)
    if case == "nan_payloads":
        nan = torch.tensor([float("nan")], dtype=dt).view(MF._BITS[dt])
        lanes.view(MF._BITS[dt])[1, ::7] = nan | 1
        lanes.view(MF._BITS[dt])[1, 3::7] = nan | 2
    return lanes


@pytest.mark.parametrize("vd", MF.KERNEL_VALUE_DTYPES)
@pytest.mark.parametrize("case", ("exact4", "negzero", "zeros", "infs", "nan_payloads"))
def test_encoding_round_trips_every_lane_bit(case, vd):
    if case == "exact4":
        op = to_port(ref_op("exact4", vd))
        data = MF.mf_data(op)
    else:
        data = _lanes_case(case, vd)
        op = _stored(data)
    launch = MF.mf_launch(op)
    codes = MF.mf_encode(data, launch)
    n = op.shape[0]
    assert isinstance(codes, MF.MfCodes) and codes.launch is launch
    assert codes.codes.dtype == torch.uint8 and codes.values.dtype == data.dtype
    tile = MF.BLOCK * MF.CODE_ROWS
    assert codes.codes.shape == (op.n_stored, -(-n // tile) * tile)
    want = _bits(data[:, :n])
    assert np.array_equal(_bits(codes.lanes()), want)
    table = _bits(codes.values)
    assert table[0] == 0 and len(set(table.tolist())) == table.size <= MF.MAX_CODES + 1
    assert set(table[1:].tolist()) == set(want[want != 0].tolist())
    natural = MF.untile_codes(codes.codes)
    assert not natural[:, n:].any(), "padded rows read code 0"
    assert torch.equal(MF.tile_codes(natural[:, :n]), codes.codes)
    if case == "zeros":
        assert not natural[1].any()


@pytest.mark.parametrize("distinct,coded", ((255, True), (256, False)))
def test_lanes_of_more_than_255_values_stay_streamed(distinct, coded):
    v = np.zeros((2, 600))
    v[0, :distinct] = np.arange(1, distinct + 1) * 0.5
    v[1, ::3] = 0.5                              # among lane 0's values
    data = torch.from_numpy(v)
    op = _stored(data)
    codes = MF.mf_encode(data, MF.mf_launch(op))
    assert (codes is not None) == coded
    lanes = MF.mf_lanes(op, "cpu")
    assert MF.mf_lanes(op, "cpu") is lanes     # built once per container and device
    if coded:
        assert isinstance(lanes, MF.MfCodes) and lanes.values.numel() == distinct + 1
    else:
        assert isinstance(lanes, torch.Tensor) and torch.equal(lanes, data)
    x = torch.from_numpy(operand(600, seed=8, dtype=np.float64))
    assert torch.equal(MF.mf_spmv_arrays(lanes, MF.mf_launch(op), x),
                       MF.mf_spmv_arrays(data, MF.mf_launch(op), x))


def test_lanes_without_a_stored_diagonal_do_not_code():
    op = _generated(500, 500, (-3, 0, 2))
    assert MF.mf_encode(MF.mf_data(op), MF.mf_launch(op)) is None
    assert torch.equal(MF.mf_lanes(op, "cpu"), MF.mf_data(op))


def test_launch_refuses_codes_of_another_operator():
    op, other = to_port(ref_op("exact4")), to_port(ref_op("exact4", "f32"))
    launch = MF.mf_launch(op)
    x = torch.from_numpy(operand(op.shape[1], seed=2, dtype=np.float64))
    mine = MF.mf_encode(MF.mf_data(op), launch)
    launch.check(mine, x)
    theirs = MF.mf_encode(MF.mf_data(other), MF.mf_launch(other))
    with pytest.raises(ValueError, match="another operator"):
        launch.check(theirs, x)
    with pytest.raises(ValueError, match="another operator"):
        MF.mf_spmv_arrays(theirs, launch, x)
    twin = to_port(ref_op("exact4"))            # equal values, another container
    assert twin is not op
    with pytest.raises(ValueError, match="another operator"):
        MF.mf_spmv_arrays(MF.mf_encode(MF.mf_data(twin), MF.mf_launch(twin)), launch, x)
    wide = MF.mf_encode(MF.mf_data(op), launch, rows=8)
    with pytest.raises(ValueError, match="tiled for 8 rows"):
        MF.mf_spmv_arrays(wide, launch, x)


@pytest.mark.parametrize("vd,xdt", VX, ids=VX_IDS)
@pytest.mark.parametrize("name", ("exact3", "exact4", "exact6"))
def test_coded_walk_equals_streamed_walk_bitwise(name, vd, xdt):
    op = to_port(ref_op(name, vd))
    launch, data = MF.mf_launch(op), MF.mf_data(op)
    codes = MF.mf_encode(data, launch)
    assert codes is not None, "the Holstein-Hubbard lanes hold few values"
    x = torch.from_numpy(operand(op.shape[1], seed=41, dtype=np.float64)).to(
        torch.float64 if xdt == np.float64 else torch.float32)
    x[5] = float("inf")                         # a non-finite x propagates on both walks
    streamed, coded = emulate_mf_spmv(launch, data, x), emulate_mf_spmv(launch, codes, x)
    assert coded.dtype == streamed.dtype
    assert np.array_equal(coded.view(f"u{coded.itemsize}"), streamed.view(f"u{coded.itemsize}"))
    assert np.array_equal(_bits(MF.mf_spmv_arrays(codes, launch, x)),
                          _bits(MF.mf_spmv_arrays(data, launch, x)))


def test_lane_code_counts_follow_the_launch_counters():
    """Kernel 4 counts a launch over stored lanes under its form
    (``cuda_build.PATH_COUNTERS``); a replayed CUDA graph adds the launches
    its capture counted through ``add_launch_counts``, and the benchmark's
    ``mf_coded_pct`` reads the share."""
    import importlib.util
    import types
    assert {"mf_spmv_coded", "mf_spmv_streamed"} <= set(CB.PATH_COUNTERS)
    before = MF.lane_code_counts()
    CB.add_launch_counts({"mf_spmv": 4, "mf_spmv_coded": 3, "mf_spmv_streamed": 1})
    try:
        after = MF.lane_code_counts()
        assert (after["coded"] - before["coded"], after["streamed"] - before["streamed"]) == (3, 1)
        path = Path(__file__).resolve().parents[1] / "spmvbench" / "metrics" / "mf_coded_pct.py"
        spec = importlib.util.spec_from_file_location("mf_coded_pct", path)
        reader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(reader)
        ctx = types.SimpleNamespace(traced={}, trace={}, result={}, bench=None, setup_s=1.0)
        c = MF.lane_code_counts()
        assert reader.read(ctx) == pytest.approx(100.0 * c["coded"] / (c["coded"] + c["streamed"]))
    finally:
        CB.add_launch_counts({"mf_spmv": -4, "mf_spmv_coded": -3, "mf_spmv_streamed": -1})
