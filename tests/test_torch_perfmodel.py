"""The perfmodel slice: the port's balance model, selectors and plan
reports held against the reference's on identical containers.

Model functions agree to 1e-12 relative (the same arithmetic in another
package); picks are equal.  The reference's stream regimes map to the
port's: ``xla`` (its composite backend) -> ``torch``, ``pallas`` (its
kernels) -> ``cuda``.  Picks are compared on ``cpu`` and ``tpu`` chips,
where both packages use the reference's efficiency tables, over every
candidate the reference scores, BSR included.
"""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import ref_matrix, to_port  # noqa: E402
from repro.core import formats as RF  # noqa: E402
from repro.core import perfmodel as RPM  # noqa: E402
from repro.utils import hw as RHW  # noqa: E402
from repro_torch.core import perfmodel as PM  # noqa: E402
from repro_torch.core.plan import SpMVPlan, plan_all_formats  # noqa: E402
from repro_torch.core.planconfig import PlanConfig  # noqa: E402
from repro_torch.kernels import registry as PR  # noqa: E402
from repro_torch.utils.hw import H100, ChipSpec  # noqa: E402

REGIMES = (("xla", "torch"), ("pallas", "cuda"), ("loop_reference", "loop_reference"))
#: the port's select_format candidates: every one the reference scores
PORT_FORMATS = ("csr", "jds", "ell", "sell", "hybrid", "dia", "matrix_free", "bsr")
HOST = RHW.ChipSpec("host_cpu", 1e12, 5e11, 20e9, 8 << 30, 0.0, 0, 32 << 20)
REF_CHIPS = {"tpu": RHW.TPU_V5E, "cpu": HOST}


def port_chip(ref_chip) -> ChipSpec:
    return ChipSpec(name=ref_chip.name, peak_flops_fp32=ref_chip.peak_flops_fp32,
                    peak_flops_fp64=ref_chip.peak_flops_fp32 / 2,
                    hbm_bytes_per_s=ref_chip.hbm_bytes_per_s)


#: the reference prices its composite SELL form for the platform it runs
#: on (here the CPU); the port for the chip it is given: the host chip
#: puts both on the ``cpu`` family
PORT_HOST = port_chip(HOST)


def ref_runs_on(monkeypatch, family: str) -> None:
    """Make the reference price its composite SELL form as it would when
    running on ``family`` (it reads its runtime platform; the port reads
    the chip it prices)."""
    own = RPM.sell_flat_overhead
    monkeypatch.setattr(RPM, "sell_flat_overhead",
                        lambda fam=None: own(family if fam is None else fam))


def close(a, b, rtol=1e-12):
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-300)


_CONT: dict = {}


def containers(kind: str):
    """(reference, port) containers of ``kind`` over identical arrays."""
    if kind not in _CONT:
        name, build = {
            "csr": ("surrogate600", lambda r: r),
            "ell": ("powerlaw", lambda r: RF.ELL.from_csr(r)),
            "jds": ("surrogate600", lambda r: RF.JDS.from_csr(r)),
            "sell": ("powerlaw", lambda r: RF.SELL.from_csr(r, C=8, sigma=64)),
            "sell_regular": ("laplace24", lambda r: RF.SELL.from_csr(r, C=8)),
            "dia": ("laplace24", lambda r: RF.DIA.from_csr(r)),
            "hybrid": ("surrogate600", lambda r: RF.split_dia(r)),
            "matrix_free": ("exact3", lambda r: RF.MatrixFreeOperator.from_csr(r)),
            "bf16_sell": ("surrogate600", lambda r: RF.with_value_dtype(
                RF.SELL.from_csr(r), "bf16")),
            "int8_csr": ("surrogate600", lambda r: RF.with_value_dtype(r, "int8")),
        }[kind]
        ref = build(ref_matrix(name))
        _CONT[kind] = (ref, to_port(ref))
    return _CONT[kind]


KINDS = ("csr", "ell", "jds", "sell", "sell_regular", "dia", "hybrid",
         "matrix_free", "bf16_sell", "int8_csr")


def test_paper_balances_crs_10_and_jds_18():
    assert PM.balance_csr(PM.PAPER_FP64) == 10.0
    assert PM.balance_jds(PM.PAPER_FP64) == 18.0
    # blocked JDS reaches CRS balance with full amortization
    assert PM.balance_blocked_jds(PM.PAPER_FP64, 8, np.inf) == 10.0


@pytest.mark.parametrize("vb,ib,waste", [(8, 4, 1.0), (4, 4, 3.5), (2, 4, 8.0)])
def test_balance_functions_match(vb, ib, waste):
    ram = RPM.AccessModel(vb, ib, 128 // vb, waste, 0.75)
    pam = PM.AccessModel(vb, ib, 128 // vb, waste, 0.75)
    pairs = [
        (RPM.balance_csr(ram, 13.9), PM.balance_csr(pam, 13.9)),
        (RPM.balance_jds(ram), PM.balance_jds(pam)),
        (RPM.balance_blocked_jds(ram, 8, 5.5), PM.balance_blocked_jds(pam, 8, 5.5)),
        (RPM.balance_ell(ram, 1.7, 4.0), PM.balance_ell(pam, 1.7, 4.0)),
        (RPM.balance_sell(ram, 1.2, 9.0), PM.balance_sell(pam, 1.2, 9.0)),
        (RPM.balance_dia(ram, 13, 0.8), PM.balance_dia(pam, 13, 0.8)),
        (RPM.balance_dia(ram, 5, 0.5, False), PM.balance_dia(pam, 5, 0.5, False)),
        (RPM.balance_matrix_free(ram, 3, 1000, 4500),
         PM.balance_matrix_free(pam, 3, 1000, 4500)),
        (RPM.waste_from_stride(17.0, 8), PM.waste_from_stride(17.0, 8)),
    ]
    for r, p in pairs:
        assert close(r, p)
    fr, fp = RPM.flat_sell_access_model(ram, 4.5), PM.flat_sell_access_model(pam, 4.5)
    assert (fr.value_bytes, fr.index_bytes) == (fp.value_bytes, fp.index_bytes)


@pytest.mark.parametrize("kind", KINDS)
def test_container_byte_model_matches(kind):
    ref, port = containers(kind)
    ram, pam = RPM.access_model_for(ref), PM.access_model_for(port)
    assert (ram.value_bytes, ram.index_bytes, ram.line_elems) == \
        (pam.value_bytes, pam.index_bytes, pam.line_elems)
    for rb, pb in REGIMES:
        assert close(RPM.balance_of(ref, backend=rb),
                     PM.balance_of(port, backend=pb, chip=PORT_HOST))
        assert close(RPM.matrix_stream_bytes(ref, backend=rb),
                     PM.matrix_stream_bytes(port, backend=pb, chip=PORT_HOST))
        for gen in (False, True):
            assert close(RPM.spmv_streamed_bytes(ref, backend=rb, generated_indices=gen),
                         PM.spmv_streamed_bytes(port, backend=pb, generated_indices=gen,
                                                chip=PORT_HOST))
        for k in (1, 3, 16, 64):
            assert close(RPM.spmm_balance_of(ref, k, backend=rb),
                         PM.spmm_balance_of(port, k, backend=pb, chip=PORT_HOST))


@pytest.mark.parametrize("family", ("tpu", "cpu"))
@pytest.mark.parametrize("kind", ("sell", "hybrid", "matrix_free", "csr"))
def test_select_batch_width_matches(monkeypatch, kind, family):
    ref, port = containers(kind)
    ref_runs_on(monkeypatch, family)
    for rb, pb in REGIMES[:2]:
        r = RPM.select_batch_width(ref, chip=REF_CHIPS[family], backend=rb)
        p = PM.select_batch_width(port, chip=port_chip(REF_CHIPS[family]), backend=pb)
        assert r.width == p.width and r.widths == p.widths
        for k in r.widths:
            assert close(r.throughput[k], p.throughput[k])
            assert close(r.balance[k], p.balance[k])


@pytest.mark.parametrize("name", ("surrogate600", "powerlaw", "exact3", "laplace24"))
@pytest.mark.parametrize("C", (8, 32))
def test_sell_padding_and_sigma_selection_match(name, C):
    lens = np.diff(np.asarray(ref_matrix(name).row_ptr))
    assert RPM.sell_sigma_candidates(len(lens), C) == PM.sell_sigma_candidates(len(lens), C)
    assert RPM.select_sell_sigma(lens, C) == PM.select_sell_sigma(lens, C)
    for s in (1, 64, len(lens)):
        assert close(RPM.sell_pad_ratio(lens, C, s), PM.sell_pad_ratio(lens, C, s))
    assert close(RPM.sell_padded_view_ratio(lens, C), PM.sell_padded_view_ratio(lens, C))
    assert close(RPM.ell_pad_ratio(lens), PM.ell_pad_ratio(lens))


@pytest.mark.parametrize("kind", ("sell", "sell_regular", "bf16_sell"))
def test_torch_sell_form_pick_matches_reference(kind):
    ref, port = containers(kind)
    for fam in ("cpu", "tpu"):
        assert RPM.sell_xla_uses_flat(ref, fam) == PM.sell_xla_uses_flat(port, fam)
    assert RPM.sell_streamed_elements(ref, "xla") == \
        PM.sell_streamed_elements(port, "torch", PORT_HOST)
    assert RPM.sell_streamed_elements(ref, "pallas") == PM.sell_streamed_elements(port, "cuda")


@pytest.mark.parametrize("name", ("surrogate600", "surrogate3000", "powerlaw",
                                  "exact3", "laplace48", "blocksparse"))
@pytest.mark.parametrize("family", ("tpu", "cpu"))
@pytest.mark.parametrize("regime", REGIMES[:2], ids=("torch", "cuda"))
def test_select_format_matches_reference(name, family, regime):
    r = ref_matrix(name)
    rb, pb = regime
    want = RPM.select_format(r, chip=REF_CHIPS[family], backend=rb)
    got = PM.select_format(to_port(r), chip=port_chip(REF_CHIPS[family]), backend=pb)
    assert got.format == want.format
    assert got.convert_kwargs == want.convert_kwargs
    assert set(got.predicted_time_s) == set(want.predicted_time_s)
    for f, t in want.predicted_time_s.items():
        assert close(t, got.predicted_time_s[f])
    assert got.stats == want.stats


def test_advise_and_predict_match():
    r = ref_matrix("surrogate600")
    stats = RF.matrix_stats(r)
    lens = np.diff(np.asarray(r.row_ptr))
    want = RPM.advise(stats, lens, chip=RHW.TPU_V5E)
    got = PM.advise(stats, lens, chip=port_chip(RHW.TPU_V5E))
    assert got["_best"] == want["_best"]
    for f in want:
        if f != "_best":
            assert close(want[f].time_s, got[f].time_s)
            assert want[f].bound == got[f].bound


def test_chip_family_gives_the_h100_its_own_table():
    assert PM.chip_family(H100) == "h100"
    assert PM.chip_family(H100.with_bandwidth(3.0e12)) == "h100"
    for name in ("tpu_v5e", "host_cpu", "nehalem", "some_accelerator"):
        assert PM.chip_family(ChipSpec(name, 1.0, 1.0, 1.0)) == \
            RPM.chip_family(RHW.ChipSpec(name, 1, 1, 1, 1, 0.0, 0, 1))
    table = PM.EXEC_EFFICIENCY["h100"]
    assert set(PORT_FORMATS) <= set(table) and all(0 < v <= 1.5 for v in table.values())


def test_h100_with_bandwidth_is_marked_measured():
    c = H100.with_bandwidth(2.9e12)
    assert c.measured and not H100.measured and c.hbm_bytes_per_s == 2.9e12
    assert (c.name, c.peak_flops_fp32) == (H100.name, H100.peak_flops_fp32)


def test_select_format_refuses_tuning_and_passes_concrete_containers(tmp_path):
    _, port = containers("sell")
    assert PM.select_format(port).format == "sell"
    # the tuning DB is ported (core/tunedb.py): a DB file that does not exist
    # is an empty DB, so the pick is the cold path's, from the model
    m = to_port(ref_matrix("exact3"))
    cold = PM.select_format(m, device="cpu")
    warm = PM.select_format(m, tuning=tmp_path / "db.json", device="cpu")
    assert (warm.format, warm.predicted_time_s, warm.source) == \
        (cold.format, cold.predicted_time_s, "model")


@pytest.mark.parametrize("K,acc_bytes,ct,tpr", [
    (1, 8, 1, 1), (2, 8, 2, 1), (3, 8, 1, 4), (16, 8, 4, 4), (32, 8, 4, 8), (64, 8, 4, 8),
    (100, 8, 4, 8), (1, 4, 1, 1), (3, 4, 1, 4), (16, 4, 8, 2), (64, 4, 8, 8), (100, 4, 4, 8)])
def test_sell_spmm_launch(K, acc_bytes, ct, tpr):
    from repro_torch.kernels.sell_spmv import SPMM_TILE_BYTES, SPMM_THREAD_BYTES, sell_spmm_launch
    assert sell_spmm_launch(K, acc_bytes) == (ct, tpr)
    # a thread's columns are one power-of-two run inside K, at most a 32-byte
    # sector; a K tile is at most 256 bytes of an X row, tpr threads a row
    assert K % ct == 0 and ct & (ct - 1) == 0 and ct * acc_bytes <= SPMM_THREAD_BYTES
    assert tpr & (tpr - 1) == 0 and tpr <= 8 and tpr * ct * acc_bytes <= SPMM_TILE_BYTES
    # unaligned X or Y: one column a thread, the same tile width or narrower
    ct1, tpr1 = sell_spmm_launch(K, acc_bytes, aligned=False)
    assert ct1 == 1 and tpr1 <= 8 and tpr1 * acc_bytes <= SPMM_TILE_BYTES


# --- the registry's cost ranking and the plan reports --------------------------


@pytest.mark.parametrize("kind", ("csr", "sell", "dia", "hybrid", "matrix_free"))
def test_torch_entry_cost_equals_reference_xla_cost(monkeypatch, kind):
    from repro.kernels import registry as RR
    ref, port = containers(kind)
    ref_runs_on(monkeypatch, "tpu")
    fmt = "sell" if kind.endswith("sell") else kind
    want = RR.get(fmt, "spmv", "xla").cost(ref, RR.KernelContext(chip=RHW.TPU_V5E))
    ctx = PR.KernelContext(device="cpu", chip=port_chip(RHW.TPU_V5E))
    assert close(want, PR.get(fmt, "spmv", "torch").cost(port, ctx))
    backend, costs = PR.select_backend(port, fmt, "spmv", ctx)
    assert backend == "torch" and close(costs["torch"], want)
    assert PR.select_backend(port, fmt, "spmv", ctx)[1] is costs  # memoized


def _cuda_probe_accepts(monkeypatch, fmt):
    """Let the ``cuda`` entries of ``fmt`` accept a CPU operand, so the
    ranking can be watched without a card."""
    import dataclasses
    for e in PR.entries(fmt, backend="cuda"):
        monkeypatch.setitem(PR._TABLE, e.key, dataclasses.replace(e, probe=PR._probe_ok))


def test_cuda_entry_outranks_torch_on_the_h100_family(monkeypatch):
    _cuda_probe_accepts(monkeypatch, "csr")
    port = to_port(ref_matrix("surrogate600"))
    backend, costs = PR.select_backend(port, "csr", "spmv", PR.KernelContext(device="cpu"))
    assert backend == "cuda" and set(costs) == {"torch", "cuda"}


@pytest.mark.parametrize("chip", ("tpu", "cpu", "other_gpu"))
@pytest.mark.parametrize("kind", ("csr", "sell", "dia", "hybrid", "matrix_free"))
def test_cuda_entry_wins_whatever_chip_is_priced(monkeypatch, kind, chip):
    """The two entries' costs tie for csr, dia and matrix_free, on any
    chip; a kernel that can run is taken all the same."""
    ref, _ = containers(kind)
    _cuda_probe_accepts(monkeypatch, kind)
    spec = ChipSpec(chip, 1e13, 5e12, 1e12) if chip == "other_gpu" else \
        port_chip(REF_CHIPS[chip])
    ctx = PR.KernelContext(device="cpu", chip=spec)
    for op in ("spmv", "spmm"):
        want = "cuda" if PR.has(kind, op, "cuda") else "torch"
        assert PR.select_backend(to_port(ref), kind, op, ctx)[0] == want


@pytest.mark.parametrize("chip", ("h100", "cpu", "tpu"))
def test_torch_sell_entry_runs_the_form_its_plan_prices(chip):
    """The plan's chip alone decides the composite SELL form: the entry
    builds it, and the report's balance prices it."""
    spec = {"h100": H100, "cpu": PORT_HOST, "tpu": port_chip(RHW.TPU_V5E)}[chip]
    ref = RF.SELL.from_csr(ref_matrix("powerlaw"), C=8, sigma=64)
    port = to_port(ref)
    flat = PM.sell_xla_uses_flat(port, PM.chip_family(spec))
    plan = SpMVPlan.compile(port, PlanConfig(device="cpu", backend="torch", chip=spec))
    assert hasattr(port, "_segment_ids") == flat and hasattr(port, "_padded_views") != flat
    assert plan.report.balance_bytes_per_flop == PM.balance_of(port, backend="torch",
                                                               chip=spec)
    if chip == "cpu":  # the reference's own pick on the CPU it runs on
        assert flat == RPM.sell_xla_uses_flat(ref)


def test_kernel_context_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.KernelContext()
    ctx = PR.KernelContext(device="cpu")
    assert ctx.device == torch.device("cpu") and ctx.chip == H100
    _, port = containers("csr")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.select_backend(port, "csr", "spmv")
    assert PR.select_backend(port, "csr", "spmv", ctx)[0] == "torch"


@pytest.mark.parametrize("name", ("surrogate1200", "powerlaw", "laplace48", "exact3"))
@pytest.mark.parametrize("family", ("tpu", "cpu"))
def test_format_auto_plan_matches_reference(monkeypatch, name, family):
    from repro.core.plan import PlanConfig as RefConfig
    from repro.core.plan import SpMVPlan as RefPlan
    r = ref_matrix(name)
    ref_runs_on(monkeypatch, family)
    want = RefPlan.compile(r, RefConfig(format="auto", chip=REF_CHIPS[family],
                                        backend="xla"))
    got = SpMVPlan.compile(to_port(r), PlanConfig(format="auto", device="cpu",
                                                  chip=port_chip(REF_CHIPS[family])))
    assert got.report.format == want.report.format
    assert got.report.kernel == "torch" and got.report.bound == want.report.bound
    for f in ("balance_bytes_per_flop", "predicted_gflops", "predicted_time_s"):
        assert close(getattr(want.report, f), getattr(got.report, f)), f


def test_plan_all_formats_reports_every_format():
    r = ref_matrix("surrogate600")
    plans = plan_all_formats(to_port(r), PlanConfig(device="cpu"))
    assert set(plans) == {"csr", "ell", "jds", "sell", "hybrid"}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(600))
    want = plans["csr"](x)
    for fmt, p in plans.items():
        assert p.report.format == fmt and p.report.predicted_time_s > 0
        assert torch.allclose(p(x), want, rtol=1e-12, atol=1e-12)
