"""The ``cuda`` SpMV of ``dia``, ``sell`` and ``hybrid`` containers on the
card in one C call (``kernels.plan_launch``): the launch records their
entries build, and the plan call through them.

On the host: the entries' refusal off the card, the fault point and the
operand checks of the plan call, the parts the entries hand to a record,
the checks a record runs when it is built, the record a call picks for its
x (a stand-in launch), and the record's C struct against
``csrc/plan_launch.cu``.  On the card (``cuda``-marked, skipped without
one): y against the padded path of ``dia_spmv_arrays`` and
``sell_spmv_arrays`` bit for bit, eager and under graph capture (beside
the generated operators' kernels, which launch through the same
``cuda_build.launch``), the casts of other x and the launch counts.  The
file needs no JAX:

    python -m pytest --noconftest tests/test_torch_plan_onecall.py
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from _torch_parity import port_matrix
from repro_torch.core import formats as PF
from repro_torch.core.plan import SpMVPlan
from repro_torch.core.planconfig import PlanConfig
from repro_torch.kernels import cuda_build as CB
from repro_torch.kernels import dia as KD
from repro_torch.kernels import dia_spmv as KDS
from repro_torch.kernels import hybrid as KH
from repro_torch.kernels import plan_launch as PL
from repro_torch.kernels import registry as R
from repro_torch.kernels import sell as KS
from repro_torch.kernels import sell_spmv as KSS
from repro_torch.kernels.accum import acc_dtype
from repro_torch.testing import faults

CPU = torch.device("cpu")


def _matrix(fmt: str, vd: str = "f32"):
    """dia: the 2-D Laplacian (diagonals +-1 and +-48 run off both edges);
    sell and hybrid: the Holstein-Hubbard surrogate."""
    if fmt == "dia":
        m = PF.DIA.from_csr(port_matrix("laplace48"))
    elif fmt == "csr":
        m = port_matrix("surrogate3000")
    else:
        m = PF.convert(port_matrix("surrogate3000"), fmt)
    return PF.with_value_dtype(m, vd)


def _x(n: int, dtype=torch.float64, device=CPU, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(device, dtype)


@pytest.fixture(autouse=True)
def _faults():
    faults.reset()
    yield
    faults.reset()


def _parts(fmt: str, m, device=CPU):
    ctx = R.KernelContext(device=device)
    if fmt == "hybrid":
        return (KD.spmv_part(m.dia, ctx), KS.spmv_part(m.rest, ctx))
    return ((KD if fmt == "dia" else KS).spmv_part(m, ctx),)


# --- the host -------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ("dia", "sell", "hybrid"))
def test_cuda_spmv_entries_refuse_the_host(fmt):
    """The entries build on the card only: the registry refuses them on the
    host, and a plan that asks for them runs the ``torch`` entry."""
    m = _matrix(fmt)
    ctx = R.KernelContext(device=CPU)
    with pytest.raises(R.BackendUnavailable, match="CUDA device"):
        R.build(m, fmt, "spmv", "cuda", ctx)
    plan = SpMVPlan.compile(m, PlanConfig(backend="cuda", device="cpu"))
    x = _x(m.shape[1])
    assert plan.report.format == fmt and plan.report.kernel == "torch"
    assert torch.equal(plan(x), R.build(m, fmt, "spmv", "torch", ctx).fn(x))


@pytest.mark.parametrize("fmt", ("dia", "sell", "hybrid", "csr"))
def test_fault_point_fires_and_poisons_on_a_plan(fmt):
    plan = SpMVPlan.compile(_matrix(fmt), PlanConfig(device=CPU))
    x = _x(plan.report.shape[1])
    clean = plan(x)
    assert torch.isfinite(clean).all()
    with faults.inject("plan.spmv", nonfinite=True) as spec:
        y = plan(x)
    assert spec.fired == 1 and torch.isnan(y[0]) and torch.equal(y[1:], clean[1:])
    with faults.inject("plan.spmv", error=RuntimeError("kernel died")):
        with pytest.raises(RuntimeError, match="kernel died"):
            plan(x)


def test_bad_x_raises_as_before():
    plan = SpMVPlan.compile(_matrix("hybrid"), PlanConfig(device=CPU))
    n = plan.report.shape[1]
    with pytest.raises(ValueError, match="this plan runs on cpu"):
        plan(torch.empty(n, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="expected"):
        plan(_x(n + 1))
    with pytest.raises(ValueError, match="expected"):
        plan(_x(n).reshape(1, n))
    with pytest.raises(TypeError, match="tensor or numpy"):
        plan([0.0] * n)


@pytest.mark.parametrize("fmt,kinds", [("dia", ("DiaPart",)), ("sell", ("SellPart",)),
                                       ("hybrid", ("DiaPart", "SellPart"))])
def test_entries_hand_a_record_the_operands_they_launch_on(fmt, kinds):
    m = _matrix(fmt)
    parts = _parts(fmt, m)
    assert tuple(type(p).__name__ for p in parts) == kinds
    assert all(p.n_rows == m.shape[0] for p in parts)
    dia = next((p for p in parts if isinstance(p, PL.DiaPart)), None)
    if dia is not None:
        assert dia.n_cols == m.shape[1] and dia.offsets.dtype == torch.int32
    sell = next((p for p in parts if isinstance(p, PL.SellPart)), None)
    if sell is not None:
        rest = m.rest if fmt == "hybrid" else m
        assert sell.chunk_blocks is KS.sell_chunk_blocks(rest) and sell.C == rest.C


@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "int8"))
def test_record_freezes_the_checked_operands(vd):
    m = _matrix("hybrid", vd)
    dia, sell = _parts("hybrid", m)
    accs = (torch.float64,) if vd == "f64" else (torch.float32, torch.float64)
    for acc in accs:
        rec = PL.LaunchRecord((dia, sell), acc, CPU)
        s = rec._struct
        assert (s.acc64, s.parts, s.n_rows, s.n_x) == (int(acc == torch.float64), 3,
                                                       m.shape[0], m.shape[1])
        assert (s.dia_vcode, s.sell_vcode) == (CB.value_code(dia.data, ""),
                                               CB.value_code(sell.val, ""))
        assert (s.nd, s.ld) == tuple(dia.data.shape)
        assert s.dia_data == dia.data.data_ptr() and s.offsets == dia.offsets.data_ptr()
        assert s.dia_scales == (None if dia.scales is None else dia.scales.data_ptr())
        assert (s.C, s.n_chunks, s.n_blocks) == (sell.C, sell.chunk_width.shape[0],
                                                 sell.chunk_blocks.n_blocks)
        assert s.col == sell.col_idx.data_ptr() and s.perm == sell.perm.data_ptr()
        assert s.blocks == sell.chunk_blocks.on(CPU).data_ptr()
        assert rec.kernels == ("dia_spmv", "sell_spmv")
    if vd == "f64":
        with pytest.raises(TypeError, match="accumulator"):
            PL.LaunchRecord((dia, sell), torch.float32, CPU)
    only = PL.LaunchRecord((sell,), torch.float64, CPU)
    assert (only._struct.parts, only.kernels) == (2, ("sell_spmv",))


def test_record_runs_the_wrappers_checks_once():
    dia, sell = _parts("hybrid", _matrix("hybrid"))
    f64 = torch.float64
    bad = [
        ((dia._replace(offsets=dia.offsets.long()), sell), TypeError, "offsets"),
        ((dia._replace(data=dia.data[:, :10].contiguous()), sell), ValueError, "does not fit"),
        ((dia._replace(data=dia.data.t().contiguous().t()), sell), ValueError, "contiguous"),
        ((dia._replace(scales=torch.ones(3)), sell), ValueError, "scales"),
        ((dia, sell._replace(col_idx=sell.col_idx.long())), TypeError, "col_idx"),
        ((dia, sell._replace(perm=sell.perm[:-8])), ValueError, "perm"),
        ((dia, sell._replace(chunk_blocks=object())), TypeError, "ChunkBlocks"),
        ((dia, sell._replace(C=4)), ValueError, "chunk"),
        ((dia, sell._replace(val=sell.val.to(torch.complex64))), TypeError, "no CUDA kernel"),
        ((dia, sell._replace(n_rows=sell.n_rows + 1)), ValueError, "rows"),
        ((sell, dia), ValueError, "DiaPart then a SellPart"),
        ((), ValueError, "parts"),
    ]
    for parts, exc, match in bad:
        with pytest.raises(exc, match=match):
            PL.LaunchRecord(parts, f64, CPU)
    with pytest.raises(ValueError, match="is on cpu"):
        PL.LaunchRecord((dia, sell), f64, torch.device("meta"))
    # an entry whose operands a check refuses is not built at all
    with pytest.raises(ValueError, match="is on cpu"):
        PL.spmv_fn((dia, sell), torch.device("cuda", 0))


@pytest.mark.parametrize("vd", ("f64", "f32"))
def test_a_call_picks_the_record_of_its_accumulator(monkeypatch, vd):
    """A stand-in launch on the host: the x each record receives."""
    seen = []
    monkeypatch.setattr(PL.LaunchRecord, "launch",
                        lambda rec, x: seen.append((rec.acc, x)) or x)
    m = _matrix("hybrid", vd)
    fn = PL.spmv_fn(_parts("hybrid", m), CPU)
    n = m.shape[1]
    x64 = _x(n)
    wide = _x(2 * n)
    for x in (x64, x64.float(), x64.half(), wide[::2]):
        fn(x)
    accs = [acc for acc, _ in seen]
    f32, f64 = torch.float32, torch.float64
    assert accs == ([f64] * 4 if vd == "f64" else [f64, f32, f32, f64])
    assert seen[0][1] is x64                      # in the accumulator, contiguous: as is
    assert all(x.is_contiguous() for _, x in seen)
    assert torch.equal(seen[3][1], wide[::2]) and seen[3][1].data_ptr() != wide.data_ptr()
    assert all(x.dtype == acc for acc, x in seen)
    with pytest.raises(ValueError, match="is on meta, expected cpu"):
        fn(torch.empty(n, dtype=torch.float64, device="meta"))
    assert len(seen) == 4


_C_TYPES = {"int32_t": ctypes.c_int32, "int64_t": ctypes.c_int64, "const void*": ctypes.c_void_p}


def test_record_struct_mirrors_the_c_struct():
    src = CB.source_path("plan_spmv").read_text()
    body = re.search(r"struct PlanSpmv \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*((?:const )?\w+\*?)\s+(\w+);", body, re.M)
    assert [(n, _C_TYPES[t]) for t, n in fields] == list(PL._PlanSpmv._fields_)
    assert CB.SOURCE_OF["plan_spmv"] == "plan_launch" and "plan_spmv" not in CB.KERNELS
    assert f'extern "C" int {PL.ENTRY}(' in src and "cudaGetLastError()" in src
    # one host launcher a kernel, called by its own entry point and by the record's
    for header, launcher in (("dia_spmv.cuh", "launch_dia_spmv"),
                             ("sell_spmv.cuh", "launch_sell_spmv")):
        entry = CB.source_path(header.split(".")[0]).read_text()
        assert f"static inline int {launcher}(" in (CB.CSRC / header).read_text()
        for text in (src, entry):
            assert f'#include "{header}"' in text and f"{launcher}(" in text
            assert "<<<" not in text.split("#include")[-1]


# --- the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _card_plan(fmt: str, vd: str, dev):
    m = _matrix(fmt, vd)
    plan = SpMVPlan.compile(m, PlanConfig(device=dev))
    assert plan.report.kernel == "cuda"
    return plan, m


def _padded_path(fmt: str, m, dev):
    """The entries' path without a record: ``dia_spmv_arrays`` on a padded
    x, then ``sell_spmv_arrays`` adding its rows into that output."""
    ctx = R.KernelContext(device=dev)
    fd = fs = None
    if fmt in ("dia", "hybrid"):
        d = m.dia if fmt == "hybrid" else m
        data, offsets, scale, (pad0, pad1, n) = KD._dia_operands(d, ctx)
        fd = (lambda x: KDS.dia_spmv_arrays(
            data, offsets, scale, KDS.pad_x(x, pad0, pad1, acc_dtype(data.dtype, x.dtype)),
            pad0, n))
    if fmt in ("sell", "hybrid"):
        s = m.rest if fmt == "hybrid" else m
        ops, blocks = KS._operands(s, ctx), KS.sell_chunk_blocks(s)
        fs = (lambda x, add_to=None: KSS.sell_spmv_arrays(
            *ops, x, s.shape[0], s.C, chunk_blocks=blocks, add_to=add_to))
    if fd is None:
        return fs
    return fd if fs is None else (lambda x: fs(x, add_to=fd(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("xd", (torch.float64, torch.float32), ids=("x64", "x32"))
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "int8"))
@pytest.mark.parametrize("fmt", ("dia", "sell", "hybrid"))
def test_record_equals_the_padded_path_bit_for_bit_on_the_card(cuda_device, fmt, vd, xd):
    plan, m = _card_plan(fmt, vd, cuda_device)
    x = _x(plan.report.shape[1], xd, cuda_device, seed=3)
    before = CB.launch_counts()
    got = plan(x)
    after = CB.launch_counts()
    want = _padded_path(fmt, m, cuda_device)(x)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert launched == {"dia": {"dia_spmv": 1}, "sell": {"sell_spmv": 1},
                        "hybrid": {"dia_spmv": 1, "sell_spmv": 1}}[fmt]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ("dia", "sell", "hybrid"))
def test_other_x_is_cast_and_matches_on_the_card(cuda_device, fmt):
    plan, m = _card_plan(fmt, "f32", cuda_device)
    padded = _padded_path(fmt, m, cuda_device)
    n = plan.report.shape[1]
    x = _x(n, torch.float64, cuda_device, seed=4)
    want = plan(x)
    wide = torch.empty(2 * n, dtype=torch.float64, device=cuda_device)
    wide[::2] = x
    assert torch.equal(plan(wide[::2]), want)          # not contiguous
    f16 = x.half()                                      # not an accumulator dtype
    assert torch.equal(plan(f16), padded(f16)) and plan(f16).dtype == torch.float32
    f64_plan, m64 = _card_plan(fmt, "f64", cuda_device)
    x32 = x.float()                                     # f64 values: an f32 x is cast
    got = f64_plan(x32)
    assert got.dtype == torch.float64
    assert torch.equal(got, _padded_path(fmt, m64, cuda_device)(x32))


@pytest.mark.cuda
def test_two_launches_a_hybrid_call_on_the_card(cuda_device):
    plan, _ = _card_plan("hybrid", "f32", cuda_device)
    x = _x(plan.report.shape[1], torch.float64, cuda_device, seed=5)
    before = sum(CB.launch_counts().values())
    for _ in range(5):
        plan(x)
    torch.cuda.synchronize()
    assert sum(CB.launch_counts().values()) - before == 10


def _generated(fmt: str):
    """matrix_free: the exact L = 4 Holstein-Hubbard operator (kernel 4);
    mf_product: its electron x phonon form at half filling (``mf_product``)."""
    from repro_torch.core import matrices as M
    if fmt == "matrix_free":
        return PF.detect_matrix_free(port_matrix("exact4"))
    return M.holstein_hubbard_operator(M.HolsteinHubbardParams(
        L=4, n_up=2, n_dn=2, max_phonon=3, max_total_phonon=3))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ("hybrid", "matrix_free", "mf_product"))
def test_hybrid_record_replays_from_a_cuda_graph_on_the_card(cuda_device, fmt):
    """A plan call captured into a CUDA graph replays the eager call bit for
    bit: the hybrid's launch record, and kernel 4 and ``mf_product``, whose
    wrappers launch through the same ``cuda_build.launch``."""
    if fmt == "hybrid":
        plan, m = _card_plan(fmt, "f32", cuda_device)
        ref = _padded_path(fmt, m, cuda_device)
    else:
        plan = ref = SpMVPlan.compile(_generated(fmt), PlanConfig(device=cuda_device,
                                                                  format=fmt))
        assert plan.report.kernel == "cuda"
    n = plan.report.shape[1]
    x1, x2 = (_x(n, torch.float64, cuda_device, seed=s) for s in (6, 7))
    static_x = x1.clone()
    plan(static_x)                                    # warm, outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        static_y = plan(static_x)
    for x in (x2, x1):
        static_x.copy_(x)
        g.replay()
        eager = plan(x)
        torch.cuda.synchronize()
        assert torch.equal(static_y, eager) and torch.equal(eager, ref(x))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ("dia", "sell", "hybrid"))
def test_each_call_returns_a_fresh_y_on_the_card(cuda_device, fmt):
    plan, _ = _card_plan(fmt, "f32", cuda_device)
    x = _x(plan.report.shape[1], torch.float64, cuda_device, seed=8)
    y1, y2 = plan(x), plan(x)
    torch.cuda.synchronize()
    assert y1.data_ptr() != y2.data_ptr() and y1.data_ptr() != x.data_ptr()
    assert torch.equal(y1, y2)
    y1.zero_()
    assert torch.equal(plan(x), y2)


@pytest.mark.cuda
def test_x_on_another_device_raises_on_the_card(cuda_device):
    plan, m = _card_plan("hybrid", "f32", cuda_device)
    fn = KH._build_spmv_cuda(m, R.KernelContext(device=cuda_device)).fn
    before = CB.launch_counts()
    with pytest.raises(ValueError, match="is on cpu"):
        fn(_x(m.shape[1]))
    assert CB.launch_counts() == before
