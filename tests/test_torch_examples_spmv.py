"""The port's SpMV examples (``repro_torch.examples``: quickstart,
eigensolver_holstein, matrix_free_laplacian, distributed_spmv, serving_load)
on the host at small sizes, each held against the reference's library
functions on the same inputs.  The reference's ``examples/*.py`` are
scripts that run on import and draw from ``jax.random``, so they are not
run: the checks rebuild what they compute from ``repro``'s functions, with
the port's numpy ``x`` and Lanczos start vector."""
import importlib
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import assert_same_container, to_port, x64  # noqa: E402
from _torch_serve import PORT_HOST, REF_HOST  # noqa: E402
from repro.core import distributed as RD  # noqa: E402
from repro.core import distributed_plan as RDP  # noqa: E402
from repro.core import eigensolver as RE  # noqa: E402
from repro.core import formats as RF  # noqa: E402
from repro.core import matrices as RM  # noqa: E402
from repro.core import perfmodel as RPM  # noqa: E402
from repro.core import spmv as RS  # noqa: E402
from repro.core.plan import SpMVPlan as RefPlan  # noqa: E402
from repro.core.planconfig import PlanConfig as RefPlanConfig  # noqa: E402
from repro.utils import hw as RHW  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import formats as F  # noqa: E402
from repro_torch.core import matrices as PMAT  # noqa: E402
from repro_torch.core import microbench as MB  # noqa: E402
from repro_torch.core.eigensolver import ground_state_energy  # noqa: E402
from repro_torch.core.planconfig import PlanConfig  # noqa: E402
from repro_torch.examples import distributed_spmv as EX_DIST  # noqa: E402
from repro_torch.examples import eigensolver_holstein as EX_EIG  # noqa: E402
from repro_torch.examples import matrix_free_laplacian as EX_MF  # noqa: E402
from repro_torch.examples import quickstart as EX_QS  # noqa: E402
from repro_torch.examples import serving_load as EX_LOAD  # noqa: E402
from repro_torch.utils.hw import ChipSpec  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

#: SpMV results of the two packages on the same f32 inputs: the same
#: products summed in another order
SPMV_TOL = 1e-5
#: f32 Lanczos E0 of the two packages from the same start vector
E0_TOL = 1e-6

EXAMPLES = ("quickstart", "eigensolver_holstein", "matrix_free_laplacian",
            "distributed_spmv", "serve_sparse", "serving_load", "train_lm")


def rel(got, want) -> float:
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(1e-300, np.max(np.abs(w))))


def start_vector(n: int) -> np.ndarray:
    """The port's Lanczos start vector (``lanczos(seed=0)``)."""
    return np.random.default_rng(0).standard_normal(n)


def ref_e0(apply_A, n: int, m: int, dtype=jnp.float32) -> float:
    v0 = start_vector(n)
    return float(RE.lanczos(apply_A, n, m=m, v0=jnp.asarray(v0, dtype),
                            dtype=dtype).eigenvalues[0])


def ref_host_chip(bw: float):
    """The reference benchmarks' ``host_chip`` at the bandwidth ``bw``."""
    import benchmarks.common as BC
    with mock.patch.object(BC, "_CAL", {}), \
            mock.patch.object(BC, "stream_triad_bandwidth", lambda: bw):
        return BC.host_chip()


def ref_chip_like(chip: ChipSpec):
    """The reference's ChipSpec with the port chip's rates."""
    return RHW.ChipSpec(chip.name, chip.peak_flops_bf16, chip.peak_flops_fp32,
                        chip.hbm_bytes_per_s, int(chip.hbm_bytes), 0.0, 0, 32 << 20)


# --- every example: the card unless told, python -m ----------------------------


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_the_card_unless_told(name, monkeypatch):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_example_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart",
                          "--n", "600", "--device", "cpu"], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Lanczos: E0 =" in out.stdout and "after 48 SpMVs on cpu" in out.stdout


# --- quickstart ------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart():
    return EX_QS.main(["--n", "2000", "--device", "cpu"])


def test_quickstart_stats_and_advice_match_reference(quickstart):
    rm = RM.holstein_hubbard_surrogate(2000, seed=0)
    stats = RF.matrix_stats(rm)
    assert quickstart["stats"] == stats
    chip = MB.host_chip()          # the chip main priced on (measured once)
    want = RPM.advise(stats, rm.row_lengths(), am=RPM.TPU_FP32,
                      chip=ref_host_chip(chip.hbm_bytes_per_s))
    got = quickstart["advice"]
    assert got["_best"] == want["_best"] == quickstart["best"]
    assert set(got) == set(want)
    for name in (k for k in want if k != "_best"):
        assert got[name].balance_bytes_per_flop == want[name].balance_bytes_per_flop, name
        assert np.isclose(got[name].time_s, want[name].time_s, rtol=1e-12, atol=0), name


def test_quickstart_spmv_and_e0_match_reference(quickstart):
    n, best = 2000, quickstart["best"]
    rm = RM.holstein_hubbard_surrogate(n, seed=0)
    obj = RF.convert(rm, best if best != "csr" else "sell", C=8)
    assert_same_container(obj, quickstart["plan"].matrix)
    plan = RefPlan.compile(obj)
    x = quickstart["x"]
    assert torch.equal(x, torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                                           .astype(np.float32)))
    assert rel(quickstart["y"], plan(jnp.asarray(x.numpy()))) <= SPMV_TOL
    res = quickstart["lanczos"]
    assert res.n_spmv == 48
    want = ref_e0(plan, n, 48)
    assert abs(quickstart["e0"] - want) <= E0_TOL * abs(want)


# --- eigensolver_holstein -------------------------------------------------------


@pytest.fixture(scope="module")
def eigensolver():
    return EX_EIG.main(["--n", "3000", "--lanczos-steps", "24", "--device", "cpu"])


def test_eigensolver_exact_chain_against_dense(eigensolver):
    ex = eigensolver["exact"]
    p = RM.HolsteinHubbardParams(L=3, n_up=1, n_dn=1, max_phonon=2, g=0.5, U=4.0)
    assert ex["dim"] == RM.holstein_hubbard_exact(p).shape[0]
    assert abs(ex["e0"] - ex["e_dense"]) <= 1e-5


def test_eigensolver_formats_match_reference_csr(eigensolver):
    rm = RM.holstein_hubbard_surrogate(3000, seed=0)
    x = eigensolver["x"]
    y_ref = np.asarray(RS.csr_spmv(rm, jnp.asarray(x.numpy())))
    shoot = eigensolver["shootout"]
    assert tuple(shoot) == ("csr", "ell", "jds", "sell", "hybrid")
    for name, row in shoot.items():
        assert rel(row["plan"](x), y_ref) <= SPMV_TOL, name
        assert row["kernel"] == "torch" and row["seconds"] > 0
    assert eigensolver["best"] == min(shoot, key=lambda k: shoot[k]["seconds"])


def test_eigensolver_winner_e0_and_distributed(eigensolver):
    best = eigensolver["best"]
    rm = RM.holstein_hubbard_surrogate(3000, seed=0)
    conv = {"csr": lambda m: m, "ell": RF.ELL.from_csr, "jds": RF.JDS.from_csr,
            "sell": lambda m: RF.SELL.from_csr(m, C=8, sigma=1024),
            "hybrid": RF.split_dia}[best]
    obj = conv(rm)
    assert_same_container(obj, eigensolver["shootout"][best]["plan"].matrix)
    want = ref_e0(RefPlan.compile(obj), 3000, 24)
    assert eigensolver["lanczos"].n_spmv == 24
    assert abs(eigensolver["e0"] - want) <= E0_TOL * abs(want)
    assert 0 < eigensolver["spmv_share"]
    dist = eigensolver["dist"]
    assert dist.parts == 1 and dist.strategy == "allgather" and dist.balance == "nnz"
    assert eigensolver["dist_rel_err"] <= SPMV_TOL


# --- matrix_free_laplacian ------------------------------------------------------


@pytest.fixture(scope="module")
def matrix_free():
    # 32 steps, not the default 64: each step of the reference's recurrence
    # compiles its growing basis anew (~0.2 s a step here)
    return EX_MF.main(["--nx", "8", "--lanczos-steps", "32", "--device", "cpu"])


def _ref_laplacian(nx: int):
    return RF.with_value_dtype(RM.laplacian_3d(nx, nx, nx), "f32")


def test_matrix_free_descriptor_and_bytes_match_reference(matrix_free):
    rm = _ref_laplacian(8)
    rop = RF.detect_matrix_free(rm)
    op = matrix_free["op"]
    assert (op.n_diags, op.n_generated, op.n_stored) == (
        rop.n_diags, rop.n_generated, rop.n_stored)
    assert_same_container(rop, op)
    back = F.materialize(op)
    assert torch.equal(back.val, matrix_free["matrix"].val)
    assert_same_container(RF.materialize(rop), back)
    want = {"csr": RPM.spmv_streamed_bytes(rm) / rm.nnz,
            "matrix_free": RPM.spmv_streamed_bytes(rop) / rm.nnz}
    assert matrix_free["bytes_per_nnz"] == want
    assert matrix_free["chip"] is MB.host_chip()


def test_matrix_free_plans_and_e0_match_reference(matrix_free):
    assert matrix_free["parity_rel_err"] <= SPMV_TOL
    plans = matrix_free["plans"]
    assert (plans["csr"].report.format, plans["matrix_free"].report.format) == (
        "csr", "matrix_free")
    n = matrix_free["matrix"].shape[0]
    rplan = RefPlan.compile(_ref_laplacian(8), RefPlanConfig(format="matrix_free"))
    want = ref_e0(rplan, n, 32)
    # the Laplacian's E0 (0.36) is small beside its spectral range (~12):
    # the two f32 recurrences' rounding is relative to the range, not to E0
    assert abs(matrix_free["e0"] - want) <= E0_TOL * 12.0


# --- distributed_spmv -----------------------------------------------------------


N_DIST = 1200


@pytest.fixture(scope="module")
def distributed():
    """The port's own surrogate (bitwise the reference's, checked below) on a
    mesh of four host shards, through the example's variant table."""
    pm = PMAT.holstein_hubbard_surrogate(N_DIST, seed=0)
    mesh = D.make_mesh_1d(n_devices=4, device="cpu")
    x = EX_QS.draw_x(N_DIST, torch.device("cpu"))
    return pm, mesh, x, EX_DIST.compare_variants(pm, mesh, x)


def test_distributed_main_runs_on_one_host_shard():
    res = EX_DIST.main(["--n", "600", "--device", "cpu"])
    assert len(res["mesh"].devices) == 1
    assert all(v["rel_err"] <= SPMV_TOL for v in res["variants"].values())
    assert np.isfinite(res["e0"])


def test_distributed_variants_match_reference(distributed):
    pm, mesh, x, variants = distributed
    rm = RM.holstein_hubbard_surrogate(N_DIST, seed=0)
    assert_same_container(rm, pm)
    y_ref = np.asarray(RS.csr_spmv(rm, jnp.asarray(x.numpy())))
    ref_chip = ref_chip_like(PlanConfig().chip)
    bounds = RD.nnz_balanced_partition(rm, 4)
    reports = RDP.plan_shard_formats(rm, bounds, chip=ref_chip)
    pack = RDP.select_slab_format(reports)
    assert tuple(variants) == RDP.VARIANTS
    for variant, row in variants.items():
        plan = row["plan"]
        assert rel(row["y"], y_ref) <= SPMV_TOL and row["rel_err"] <= SPMV_TOL, variant
        assert plan.parts == 4 and plan.slab_format == pack
        for r, p in zip(reports, plan.shard_reports, strict=True):
            assert (r.rows, r.nnz, r.local_nnz, r.format) == (
                p.rows, p.nnz, p.local_nnz, p.format), variant
        assert plan.local_fraction == sum(r.local_nnz for r in reports) / sum(
            r.nnz for r in reports)
        blocks = RDP.pack_shard_slabs(rm, 4, balance="nnz", pack=pack,
                                      local_cols=variant != "allgather")
        stored = (np.asarray(blocks.val) != 0).reshape(4, -1).sum(axis=1)
        assert plan.imbalance == float(stored.max() / max(1.0, stored.mean()))
        assert plan.traffic["collective"] == RDP.slab_traffic_bytes(
            blocks, variant, 4)["collective"]


def test_distributed_ground_state_matches_reference(distributed):
    """The example's sharded solve (``ground_state_energy`` through the
    overlap plan, f64 vectors) at 30 steps, not its 60: each step of the
    reference's recurrence compiles its growing basis anew."""
    _, _, _, variants = distributed
    e0 = ground_state_energy(variants["overlap"]["plan"], N_DIST, m=30)
    rm = RM.holstein_hubbard_surrogate(N_DIST, seed=0)
    with x64():
        want = ref_e0(RS.make_spmv(rm), N_DIST, 30, dtype=jnp.float64)
    # f64 recurrences on the same f32 values: only the summation order differs
    assert abs(e0 - want) <= 1e-10 * abs(want)


# --- serving_load ---------------------------------------------------------------


N_LOAD = 300


def _ref_run_load(rate_qps, n_requests, deadline_s, matrix, xs):
    """The reference example's loop (``examples/serving_load.py:42-86``) on
    the reference's server, priced on ``REF_HOST``."""
    import repro.serve as RSRV

    clock = EX_LOAD.VirtualClock()
    srv = RSRV.BatchingSpMVServer(deadline_s=deadline_s, clock=clock, chip=REF_HOST)
    srv.register("op", matrix)
    arrivals = np.cumsum(np.random.default_rng(42).exponential(1.0 / rate_qps, n_requests))
    inflight, latencies, futures = [], [], []

    def drain():
        for t0, _ in [(t0, f) for t0, f in inflight if f.done()]:
            latencies.append(clock.t - t0)
        inflight[:] = [(t0, f) for t0, f in inflight if not f.done()]

    for t_arr, x in zip(arrivals, xs[:n_requests]):
        clock.t = float(t_arr)
        srv.pump()
        drain()
        fut = srv.submit("op", x)
        futures.append(fut)
        inflight.append((clock.t, fut))
        drain()
    clock.t = float(arrivals[-1]) + deadline_s
    srv.pump()
    srv.flush("op")
    drain()
    return srv.stats()["op"], np.array(latencies), [np.asarray(f.result()) for f in futures]


@pytest.mark.parametrize("traffic", (("heavy", 50_000, 240), ("thin", 500, 60)),
                         ids=("heavy", "thin"))
def test_serving_load_matches_reference_queue(traffic):
    name, rate, count = traffic
    rm = RM.holstein_hubbard_surrogate(N_LOAD, seed=0)
    rsell = RF.convert(rm, "sell", C=8)
    rng = np.random.default_rng(0)
    xs_np = [np.asarray(rng.standard_normal(N_LOAD), np.float32) for _ in range(240)]
    xs = [torch.from_numpy(x) for x in xs_np]
    st_ref, lat_ref, ys_ref = _ref_run_load(rate, count, 2e-3, rsell, xs_np)
    got = EX_LOAD.run_load(name, rate, count, 2e-3, to_port(rsell), xs, device="cpu",
                           chip=PORT_HOST)
    st = got["stats"]
    for k in ("requests", "batches", "mean_batch_width", "padding_ratio", "batch_width"):
        assert st[k] == st_ref[k], k
    assert got["p50"] == np.percentile(lat_ref, 50)
    assert got["p95"] == np.percentile(lat_ref, 95)
    assert len(got["futures"]) == len(ys_ref) == count
    for f, y in zip(got["futures"], ys_ref):
        assert rel(f.result(), y) <= SPMV_TOL


def test_serving_load_main_assertions_hold():
    res = EX_LOAD.main(["--n", str(N_LOAD), "--device", "cpu"])
    heavy, thin = res["heavy"]["stats"], res["thin"]["stats"]
    assert heavy["mean_batch_width"] > thin["mean_batch_width"]
    assert thin["padding_ratio"] > heavy["padding_ratio"]
    rng = np.random.default_rng(0)
    want = [rng.standard_normal(N_LOAD).astype(np.float32) for _ in range(240)]
    assert all(np.array_equal(x.numpy(), w) for x, w in zip(res["xs"], want))
    plan = res["heavy"]["server"].plan("heavy")
    for i, f in enumerate(res["heavy"]["futures"]):
        assert rel(f.result(), plan(res["xs"][i]).numpy()) <= SPMV_TOL
