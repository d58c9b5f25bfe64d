"""The port's distributed SpMV (``repro_torch.core.distributed*``,
``kernels.slab``) held against the reference's (``repro.core.distributed*``)
on the CPU.

Every case of ``tests/test_distributed.py``: partition bounds, the legacy
``RowBlockELL`` / ``RingBlockELL`` and the plan layer's ``ShardSlabs``
arrays bitwise; ``ShardReport``s and traffic dicts equal with the chip
pinned to the reference's default; the three variants in SpMV and SpMM
form on CPU meshes of 1, 4 and 8 shards against the reference's results
(its 4- and 8-device results from one emulated-device run per mesh size)
within f32 rounding, and in f64 within 1e-12 of a numpy product; the
bad-shape errors, ``report``, memoization and ``pack_stats``;
``lanczos(mesh=)`` from one ``v0``; the slab registry entries; and the
partitioners' hypothesis properties.
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import ref_matrix, to_port, x64  # noqa: E402
from repro.core import distributed as RD  # noqa: E402
from repro.core import distributed_plan as RDP  # noqa: E402
from repro.core import formats as RF  # noqa: E402
from repro.core import matrices as RM  # noqa: E402
from repro.utils import hw as RHW  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import distributed_plan as DP  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core.planconfig import PlanConfig  # noqa: E402
from repro_torch.kernels import registry as PR  # noqa: E402
from repro_torch.utils.hw import ChipSpec  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: port results against the reference's on the same f32 inputs: the same
#: products summed in another order (f32 rounding of ~30-term sums)
F32_TOL = 2e-5
#: f64 results against a numpy f64 product
F64_TOL = 1e-12


def port_chip(ref_chip) -> ChipSpec:
    return ChipSpec(name=ref_chip.name, peak_flops_fp32=ref_chip.peak_flops_fp32,
                    peak_flops_fp64=ref_chip.peak_flops_fp32 / 2,
                    hbm_bytes_per_s=ref_chip.hbm_bytes_per_s)


#: the reference's default chip, priced identically by the port
TPU = port_chip(RHW.TPU_V5E)


def cpu_mesh(parts: int):
    return D.make_mesh_1d(n_devices=parts, device="cpu")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1e-300, np.max(np.abs(b))))


def dense_product(m, x):
    return m.to_dense().astype(np.float64) @ np.asarray(x, np.float64)


def assert_bitwise(a, b, what=""):
    a = np.asarray(a)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


# --- the reference's multi-device results (one subprocess per mesh size) ------

_N_MESH = 1200

_MESH_WORKER = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core.distributed_plan import VARIANTS, compile_distributed_spmv_plan
from repro.core.matrices import holstein_hubbard_surrogate

m = holstein_hubbard_surrogate(%(n)d, seed=2)
rng = np.random.default_rng(0)
x = jnp.asarray(rng.standard_normal(%(n)d).astype(np.float32))
X = jnp.asarray(rng.standard_normal((%(n)d, 8)).astype(np.float32))
out = {}
for variant in VARIANTS:
    for balance in ("nnz", "rows"):
        for slab in ("ell", "sell", "auto"):
            p = compile_distributed_spmv_plan(m, variant=variant, balance=balance,
                                              slab_format=slab)
            key = f"{variant}/{balance}/{slab}"
            out[key + "/stats"] = np.asarray([p.imbalance, p.local_fraction,
                                              p.slab_format == "sell"])
            if slab != "auto":  # auto runs the plan of the pack it picks
                out[key + "/y"] = np.asarray(p(x))
                out[key + "/Y"] = np.asarray(p.spmm(X))
np.savez(%(path)r, **out)
print(json.dumps({"devices": len(jax.devices())}))
"""


def _mesh_results(emulated_devices_run, path: str, n_devices: int) -> dict:
    info = emulated_devices_run(n_devices, _MESH_WORKER % {"n": _N_MESH, "path": path})
    assert info["devices"] == n_devices
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="session")
def ref_meshes(emulated_devices_run, tmp_path_factory):
    """{4: ..., 8: ...}: the two runs side by side, one each."""
    from concurrent.futures import ThreadPoolExecutor

    # the temporary directories are made here: pytest's are not thread-safe
    paths = {n: str(tmp_path_factory.mktemp(f"ref{n}") / "ref.npz") for n in (4, 8)}
    with ThreadPoolExecutor(2) as pool:
        futs = {n: pool.submit(_mesh_results, emulated_devices_run, paths[n], n)
                for n in (4, 8)}
        return {n: f.result() for n, f in futs.items()}


@pytest.fixture(scope="module")
def mesh_matrix():
    """The reference's and the port's CSR of the multi-device runs' matrix."""
    rm = RM.holstein_hubbard_surrogate(_N_MESH, seed=2)
    return rm, to_port(rm)


@pytest.fixture(scope="module")
def hh():
    rm = ref_matrix("surrogate600")
    return rm, to_port(rm)


# --- partitioners -------------------------------------------------------------


def _partition_matrices():
    return {"surrogate600": ref_matrix("surrogate600"),
            "powerlaw": RM.power_law_rows(2000, 2000, mean_nnz=8, seed=0, alpha=2.5)}


@pytest.mark.parametrize("parts", range(1, 9))
def test_partition_bounds_bitwise(parts):
    for name, rm in _partition_matrices().items():
        pm = to_port(rm)
        assert_bitwise(RD.nnz_balanced_partition(rm, parts), D.nnz_balanced_partition(pm, parts),
                       name)
        assert_bitwise(RD.row_balanced_partition(rm.n_rows, parts),
                       D.row_balanced_partition(pm.n_rows, parts), name)
        for cut in (D.nnz_balanced_partition(pm, parts),
                    D.row_balanced_partition(pm.n_rows, parts)):
            assert RD.partition_imbalance(rm, cut) == D.partition_imbalance(pm, cut)


def test_nnz_balance_beats_row_balance():
    pm = to_port(RM.power_law_rows(2000, 2000, mean_nnz=8, seed=0, alpha=2.5))
    rows = D.partition_imbalance(pm, D.row_balanced_partition(pm.n_rows, 8))
    nnz = D.partition_imbalance(pm, D.nnz_balanced_partition(pm, 8))
    assert nnz <= rows * 1.001 and nnz < 1.2
    hh = to_port(RM.holstein_hubbard_surrogate(1500, seed=0))
    assert (D.partition_imbalance(hh, D.nnz_balanced_partition(hh, 8))
            <= D.partition_imbalance(hh, D.row_balanced_partition(hh.n_rows, 8)))


def test_partition_bounds_cover_all_rows(hh):
    _, pm = hh
    for parts in (1, 3, 8):
        b = D.nnz_balanced_partition(pm, parts)
        assert b[0] == 0 and b[-1] == pm.n_rows and (np.diff(b) >= 0).all()


# --- the legacy uniform-ELL blocks and executors ------------------------------


@pytest.mark.parametrize("parts", (1, 3, 4, 8))
@pytest.mark.parametrize("balance", ("nnz", "rows"))
def test_legacy_blocks_bitwise(hh, parts, balance):
    rm, pm = hh
    for pad in (1, 4):
        a = RD.build_row_blocks(rm, parts, balance, pad_width_to=pad)
        b = D.build_row_blocks(pm, parts, balance, pad_width_to=pad)
        for f in ("col", "val", "row_map"):
            assert_bitwise(getattr(a, f), getattr(b, f), f"RowBlockELL.{f}")
        assert (a.n_rows, a.n_cols, a.nnz, a.parts) == (b.n_rows, b.n_cols, b.nnz, b.parts)
    a, b = RD.build_ring_blocks(rm, parts, balance), D.build_ring_blocks(pm, parts, balance)
    for f in ("col", "val", "row_map"):
        assert_bitwise(getattr(a, f), getattr(b, f), f"RingBlockELL.{f}")
    assert a.col_shard == b.col_shard
    assert RD.allgather_traffic_bytes(RD.build_row_blocks(rm, parts, balance)) == \
        D.allgather_traffic_bytes(D.build_row_blocks(pm, parts, balance))
    assert RD.ring_traffic_bytes(a) == D.ring_traffic_bytes(b)


@pytest.mark.parametrize("parts", (1, 4))
def test_legacy_executors_match_reference(hh, parts):
    """Both legacy executors on a CPU mesh against the reference's on its
    one-device session mesh and a numpy product."""
    rm, pm = hh
    x = np.random.default_rng(0).standard_normal(pm.shape[1]).astype(np.float32)
    mesh_r = RD.make_mesh_1d()
    nr = len(mesh_r.devices.flat)
    for build, make, rbuild, rmake in (
            (D.build_row_blocks, D.make_allgather_spmv, RD.build_row_blocks,
             RD.make_allgather_spmv),
            (D.build_ring_blocks, D.make_ring_spmv, RD.build_ring_blocks, RD.make_ring_spmv)):
        y = make(build(pm, parts), cpu_mesh(parts))(torch.from_numpy(x)).numpy()
        y_ref = np.asarray(jax.jit(rmake(rbuild(rm, nr), mesh_r))(jnp.asarray(x)))
        assert y.dtype == np.float32
        assert rel(y, y_ref) <= F32_TOL and rel(y, dense_product(pm, x)) <= F32_TOL
        y64 = make(build(pm, parts), cpu_mesh(parts))(torch.from_numpy(x.astype(np.float64)))
        assert rel(y64.numpy(), dense_product(pm, x)) <= F64_TOL


def test_legacy_traffic_models(hh):
    _, pm = hh
    t_ag = D.allgather_traffic_bytes(D.build_row_blocks(pm, 4))
    t_ring = D.ring_traffic_bytes(D.build_ring_blocks(pm, 4))
    assert t_ring["per_chip_x"] < t_ag["per_chip_x"]


# --- the plan layer: slabs, reports, traffic -----------------------------------


def _f64(rm):
    return RF.CSR(np.asarray(rm.row_ptr), np.asarray(rm.col_idx),
                  np.asarray(rm.val).astype(np.float64), rm.shape)


@pytest.mark.parametrize("parts", (1, 4, 8))
@pytest.mark.parametrize("dtype", ("f32", "f64"))
@pytest.mark.parametrize("local_cols", (False, True), ids=("Q1", "QP"))
@pytest.mark.parametrize("pack", ("ell", "sell"))
def test_shard_slabs_bitwise(hh, pack, local_cols, dtype, parts):
    rm = hh[0] if dtype == "f32" else _f64(hh[0])
    pm = to_port(rm)
    for balance in ("nnz", "rows"):
        a = RDP.pack_shard_slabs(rm, parts, balance=balance, pack=pack, local_cols=local_cols)
        b = DP.pack_shard_slabs(pm, parts, balance=balance, pack=pack, local_cols=local_cols)
        for f in ("col", "val", "rid", "row_map", "bounds"):
            if getattr(a, f) is None:
                assert getattr(b, f) is None
            else:
                assert_bitwise(getattr(a, f), getattr(b, f), f"{balance} ShardSlabs.{f}")
        for f in ("pack", "col_shard", "rows_pp", "n_rows", "n_cols", "nnz", "parts",
                  "q_blocks", "stored"):
            assert getattr(a, f) == getattr(b, f), f


def test_shard_slabs_reconstruct(hh):
    """Both packings of both layouts scatter back to the dense matrix."""
    _, pm = hh
    dense = pm.to_dense()
    for pack in DP.SLAB_FORMATS:
        for local_cols in (False, True):
            b = DP.pack_shard_slabs(pm, 4, pack=pack, local_cols=local_cols)
            d = np.zeros(pm.shape)
            for p in range(b.parts):
                for q in range(b.q_blocks):
                    base = q * b.col_shard if local_cols else 0
                    if pack == "ell":
                        rows = np.broadcast_to(b.row_map[p][:, None], b.col[p, q].shape)
                        keep = (b.val[p, q] != 0) & (rows < pm.n_rows)
                        np.add.at(d, (rows[keep], base + b.col[p, q][keep]), b.val[p, q][keep])
                    else:
                        keep = (b.rid[p, q] < b.rows_pp) & (b.val[p, q] != 0)
                        rows = b.row_map[p][b.rid[p, q][keep]]
                        np.add.at(d, (rows, base + b.col[p, q][keep]), b.val[p, q][keep])
            np.testing.assert_allclose(d, dense, atol=1e-6)


@pytest.mark.parametrize("chip", ("tpu", "host"))
@pytest.mark.parametrize("parts", (1, 4, 8))
def test_shard_reports_equal(hh, parts, chip):
    rm, pm = hh
    ref_chip = RHW.TPU_V5E if chip == "tpu" else RHW.ChipSpec(
        "host_cpu", 1e12, 5e11, 20e9, 8 << 30, 0.0, 0, 32 << 20)
    for balance in ("nnz", "rows"):
        bounds = D.partition_bounds(pm, parts, balance)
        want = RDP.plan_shard_formats(rm, bounds, chip=ref_chip)
        got = DP.plan_shard_formats(pm, bounds, chip=port_chip(ref_chip))
        assert len(got) == parts
        for r, p in zip(want, got):
            for f in ("part", "rows", "nnz", "local_nnz", "remote_nnz", "format"):
                assert getattr(r, f) == getattr(p, f), f
            assert set(r.times) == set(p.times)
            for k in r.times:
                assert np.isclose(r.times[k], p.times[k], rtol=1e-12, atol=0), k
        assert RDP.select_slab_format(want) == DP.select_slab_format(got)


def test_shard_format_selection(hh):
    _, pm = hh
    reports = DP.plan_shard_formats(pm, D.nnz_balanced_partition(pm, 4))
    assert sum(r.rows for r in reports) == pm.n_rows and sum(r.nnz for r in reports) == pm.nnz
    for r in reports:
        assert r.format in DP.SLAB_FORMATS and set(r.times) == set(DP.SLAB_FORMATS)
        assert r.local_nnz + r.remote_nnz == r.nnz
        assert r.predicted_time_s == min(r.times.values())
    chosen = DP.select_slab_format(reports)
    worst = {f: max(r.times[f] for r in reports) for f in DP.SLAB_FORMATS}
    assert worst[chosen] == min(worst.values())


@pytest.mark.parametrize("variant", DP.VARIANTS)
def test_traffic_dicts_equal(hh, variant):
    rm, pm = hh
    for pack in DP.SLAB_FORMATS:
        for vb in (4, 8):
            a = RDP.pack_shard_slabs(rm, 4, pack=pack, local_cols=variant != "allgather")
            b = DP.pack_shard_slabs(pm, 4, pack=pack, local_cols=variant != "allgather")
            assert RDP.slab_traffic_bytes(a, variant, vb) == DP.slab_traffic_bytes(b, variant, vb)


# --- the plan layer: results ----------------------------------------------------


def _inputs(n: int, dtype=np.float32):
    rng = np.random.default_rng(0)
    return (rng.standard_normal(n).astype(dtype),
            rng.standard_normal((n, 8)).astype(dtype))


@pytest.mark.parametrize("variant", DP.VARIANTS)
def test_plans_one_shard_match_reference(hh, variant):
    """On one shard, in process: the reference's session mesh (one device)."""
    rm, pm = hh
    x, X = _inputs(pm.shape[1])
    for balance in ("nnz", "rows"):
        for slab in ("ell", "sell", "auto"):
            rp = RDP.compile_distributed_spmv_plan(rm, variant=variant, balance=balance,
                                                   slab_format=slab)
            pp = DP.compile_distributed_spmv_plan(
                pm, cpu_mesh(1), variant=variant, balance=balance, slab_format=slab,
                config=PlanConfig(chip=TPU))
            assert (pp.slab_format, pp.parts, pp.slab_backend) == (rp.slab_format, 1, "torch")
            assert rel(pp(torch.from_numpy(x)).numpy(), np.asarray(rp(jnp.asarray(x)))) <= F32_TOL
            assert rel(pp.spmm(torch.from_numpy(X)).numpy(),
                       np.asarray(rp.spmm(jnp.asarray(X)))) <= F32_TOL


def _check_mesh_results(ref, parts, mesh_matrix):
    """Every variant x cut x slab of the port on a ``parts``-shard CPU mesh
    against the reference's ``parts``-device results; f64 against numpy."""
    _, pm = mesh_matrix
    x, X = _inputs(pm.shape[1])
    d = pm.to_dense().astype(np.float64)
    for variant in DP.VARIANTS:
        for balance in ("nnz", "rows"):
            for slab in ("ell", "sell", "auto"):
                key = f"{variant}/{balance}/{slab}"
                p = DP.compile_distributed_spmv_plan(
                    pm, cpu_mesh(parts), variant=variant, balance=balance, slab_format=slab,
                    config=PlanConfig(chip=TPU))
                assert p.parts == parts and p.imbalance >= 1.0
                imb, loc, is_sell = ref[key + "/stats"]
                assert (p.imbalance, p.local_fraction) == (imb, loc), key
                assert (p.slab_format == "sell") == bool(is_sell), key
                key = f"{variant}/{balance}/{p.slab_format}"
                assert rel(p(torch.from_numpy(x)).numpy(), ref[key + "/y"]) <= F32_TOL, key
                assert rel(p.spmm(torch.from_numpy(X)).numpy(), ref[key + "/Y"]) <= F32_TOL, key
                y64 = p(torch.from_numpy(x.astype(np.float64))).numpy()
                Y64 = p.spmm(torch.from_numpy(X.astype(np.float64))).numpy()
                assert rel(y64, d @ x.astype(np.float64)) <= F64_TOL, key
                assert rel(Y64, d @ X.astype(np.float64)) <= F64_TOL, key


def test_plans_four_shards_match_reference(ref_meshes, mesh_matrix):
    _check_mesh_results(ref_meshes[4], 4, mesh_matrix)


def test_plans_eight_shards_match_reference(ref_meshes, mesh_matrix):
    _check_mesh_results(ref_meshes[8], 8, mesh_matrix)


def test_sell_container_plan(mesh_matrix):
    """A SELL container compiles through its CSR view (bitwise the
    reference's view), as do COO and ELL."""
    rm, pm = mesh_matrix
    x, _ = _inputs(pm.shape[1])
    d = pm.to_dense().astype(np.float64)
    for fmt in ("sell", "coo", "ell"):
        rc = RF.convert(rm, fmt) if fmt != "coo" else rm.to_coo()
        pc = to_port(rc)
        rv, pv = RDP._as_csr(rc), DP._as_csr(pc)
        for f in ("row_ptr", "col_idx", "val"):
            assert_bitwise(getattr(rv, f), getattr(pv, f).numpy(), f"{fmt} CSR view .{f}")
        assert DP._as_csr(pc) is pv  # cached on the container
        p = DP.compile_distributed_spmv_plan(pc, cpu_mesh(4), variant="overlap")
        assert rel(p(torch.from_numpy(x.astype(np.float64))).numpy(),
                   d @ x.astype(np.float64)) <= F64_TOL


def test_quantized_container_refused(hh):
    _, pm = hh
    with pytest.raises(ValueError, match="unquantized"):
        DP.compile_distributed_spmv_plan(PF.with_value_dtype(PF.convert(pm, "sell"), "int8"),
                                         cpu_mesh(2))


def test_plan_rejects_bad_shapes(hh):
    _, pm = hh
    plan = DP.compile_distributed_spmv_plan(pm, cpu_mesh(4), variant="allgather")
    with pytest.raises(ValueError):
        plan(torch.zeros(pm.shape[1] + 1))
    with pytest.raises(ValueError):
        plan.spmm(torch.zeros((pm.shape[1] + 1, 2)))
    with pytest.raises(ValueError):
        DP.compile_distributed_spmv_plan(pm, cpu_mesh(4), variant="nope")
    with pytest.raises(ValueError):
        DP.compile_distributed_spmv_plan(pm, cpu_mesh(4), config=PlanConfig(backend="xla"))
    with pytest.raises(ValueError, match="axis"):
        DP.compile_distributed_spmv_plan(pm, cpu_mesh(4), axis="model")


def test_plan_report_and_traffic_match_reference(hh):
    rm, pm = hh
    for variant in ("allgather", "overlap"):
        rp = RDP.compile_distributed_spmv_plan(rm, variant=variant)
        pp = DP.compile_distributed_spmv_plan(pm, cpu_mesh(1), variant=variant,
                                              config=PlanConfig(chip=TPU))
        assert pp.traffic == rp.traffic and pp.strategy == variant
        r, p = rp.report, pp.report
        assert (p.format, p.kernel, p.spmm_kernel, p.nnz, tuple(p.shape), p.bound) == (
            r.format, r.kernel, variant, r.nnz, tuple(r.shape), r.bound)
        assert p.device == "cpu"
        for f in ("balance_bytes_per_flop", "predicted_gflops", "predicted_time_s"):
            assert np.isclose(getattr(p, f), getattr(r, f), rtol=1e-12, atol=0), f
    ag = DP.compile_distributed_spmv_plan(pm, cpu_mesh(4), variant="allgather")
    ov = DP.compile_distributed_spmv_plan(pm, cpu_mesh(4), variant="overlap")
    assert ov.traffic["per_chip_x"] <= ag.traffic["per_chip_x"]
    assert 0.0 <= ov.local_fraction <= 1.0 and ov.report.predicted_gflops > 0


def test_plan_memoized_and_packs_once():
    """Compile is idempotent and each shard is packed once per key: the
    port's counters move exactly as the reference's on the same calls."""
    rm = RM.holstein_hubbard_surrogate(500, seed=9)
    pm = to_port(rm)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(500).astype(np.float32))
    mesh = cpu_mesh(1)

    def deltas(stats, compile_, run):
        out, before = [], stats()
        p1 = compile_("overlap")
        for _ in range(3):
            run(p1)
            assert compile_("overlap") is p1
        after = stats()
        out.append({k: after[k] - before[k] for k in after})
        p2 = compile_("allgather")
        assert p2 is not p1
        out.append(stats()["shard_packs"] - after["shard_packs"])
        before_ring = stats()
        p3 = compile_("ring")
        assert p3 is not p1 and p3.blocks is p1.blocks
        out.append(stats()["shard_packs"] - before_ring["shard_packs"])
        return out

    want = deltas(RDP.pack_stats, lambda v: RDP.compile_distributed_spmv_plan(rm, variant=v),
                  lambda p: p(jnp.asarray(x.numpy())))
    got = deltas(DP.pack_stats, lambda v: DP.compile_distributed_spmv_plan(pm, mesh, variant=v),
                 lambda p: p(x))
    assert got == want == [{"shard_packs": 1, "format_selections": 1}, 1, 0]
    p4 = DP.compile_distributed_spmv_plan(pm, cpu_mesh(4), variant="ring")
    p5 = DP.compile_distributed_spmv_plan(pm, cpu_mesh(4), variant="overlap")
    assert p4.operands is p5.operands  # one upload for both ring layouts


# --- the mesh and the slab backend -------------------------------------------------


def test_mesh_rules(monkeypatch):
    m4 = D.make_mesh_1d(n_devices=4, device="cpu")
    assert m4.devices == (torch.device("cpu"),) * 4 and m4.shape == {"data": 4}
    assert D.make_mesh_1d("model", device="cpu").shape == {"model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            D.make_mesh_1d()  # no default ever lands on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert D.make_mesh_1d().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert D.make_mesh_1d(n_devices=1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="device="):
        D.make_mesh_1d(n_devices=3)
    assert D.make_mesh_1d(n_devices=3, device="cuda:0").devices == (torch.device("cuda", 0),) * 3


def test_slab_backend_rules(hh):
    _, pm = hh
    assert DP.compile_distributed_spmv_plan(pm, cpu_mesh(2)).slab_backend == "torch"
    with pytest.raises(PR.BackendUnavailable, match="CUDA device"):
        DP.compile_distributed_spmv_plan(pm, cpu_mesh(2), config=PlanConfig(backend="cuda"))
    lp = DP.compile_distributed_spmv_plan(pm, cpu_mesh(2), variant="ring",
                                          config=PlanConfig(backend="loop_reference"))
    tp = DP.compile_distributed_spmv_plan(pm, cpu_mesh(2), variant="ring")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(pm.shape[1]))
    assert lp.slab_backend == "loop_reference"
    assert rel(lp(x).numpy(), tp(x).numpy()) <= F64_TOL
    # the back-compat entry point is the plan layer's
    assert D.compile_distributed_plan(pm, cpu_mesh(2), strategy="ring") is tp


# --- the slab registry entries -------------------------------------------------------


@pytest.mark.parametrize("pack", ("ell", "sell"))
@pytest.mark.parametrize("op", ("spmv", "spmm"))
def test_slab_entries_match_loop_reference_and_reference(pack, op):
    """The torch entry against the loop oracle and the reference's xla entry
    on the same random slab (the reference's registry test)."""
    from repro.kernels import registry as RR
    from repro.kernels.slab import SlabMeta as RMeta
    from repro_torch.kernels.slab import SlabArrays, SlabMeta

    rng = np.random.default_rng(7)
    rows_pp, W, n, L, k = 16, 5, 64, 160, 3
    if pack == "ell":
        colb = rng.integers(0, n, (rows_pp, W)).astype(np.int32)
        valb = rng.standard_normal((rows_pp, W)).astype(np.float32)
        ridb = np.zeros((1, 1), np.int32)
    else:
        colb = rng.integers(0, n, (L,)).astype(np.int32)
        valb = rng.standard_normal((L,)).astype(np.float32)
        ridb = rng.integers(0, rows_pp + 1, (L,)).astype(np.int32)
    x = rng.standard_normal((n,) if op == "spmv" else (n, k)).astype(np.float32)
    ctx = PR.KernelContext(device="cpu")
    operand = SlabArrays(torch.from_numpy(colb), torch.from_numpy(valb),
                         None if pack == "ell" else torch.from_numpy(ridb))
    out = PR.build(SlabMeta(pack, rows_pp), f"slab_{pack}", op, "torch", ctx).fn(
        operand, torch.from_numpy(x))
    loop = PR.build(SlabMeta(pack, rows_pp), f"slab_{pack}", op, "loop_reference", ctx).fn(
        operand, torch.from_numpy(x))
    ref = RR.build(RMeta(pack, rows_pp), f"slab_{pack}", op, "xla").fn(
        jnp.asarray(colb), jnp.asarray(valb), jnp.asarray(ridb), jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), loop.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # add_to: the product added into the running result in place
    acc = torch.ones_like(out)
    got = PR.build(SlabMeta(pack, rows_pp), f"slab_{pack}", op, "torch", ctx).fn(
        operand, torch.from_numpy(x), add_to=acc)
    assert got is acc and torch.equal(acc, torch.ones_like(out) + out)


def test_slab_entries_registered():
    keys = {e.key for e in PR.entries() if e.format.startswith("slab_")}
    assert keys == {(f"slab_{p}", op, be) for p in ("ell", "sell") for op in ("spmv", "spmm")
                    for be in ("torch", "cuda", "loop_reference")}
    assert not any(e.auto for e in PR.entries(backend="loop_reference")
                   if e.format.startswith("slab_"))


# --- consumers --------------------------------------------------------------------


def test_lanczos_mesh_matches_reference(hh):
    """``lanczos(mesh=)`` from one ``v0``: the port on a 4-shard CPU mesh
    against the reference on its session mesh, f64."""
    from repro.core.eigensolver import lanczos as rlanczos
    from repro_torch.core.eigensolver import lanczos

    rm, pm = hh
    v0 = np.random.default_rng(4).standard_normal(pm.shape[0])
    with x64():
        want = rlanczos(_f64(rm), pm.shape[0], m=24, mesh=RD.make_mesh_1d(),
                        v0=jnp.asarray(v0))
    got = lanczos(to_port(_f64(rm)), pm.shape[0], m=24,
                  mesh=cpu_mesh(4), v0=v0)
    assert got.alphas.shape == want.alphas.shape
    assert np.max(np.abs(got.alphas - want.alphas) / np.abs(want.alphas)) <= 1e-8
    assert np.max(np.abs(got.betas - want.betas) / np.abs(want.betas)) <= 1e-8


def test_eigensolver_with_distributed_plan(hh):
    """The reference's consumer test: E0 of 80 steps through a compiled
    distributed plan and through ``lanczos(mesh=)`` against dense."""
    from repro_torch.core.eigensolver import ground_state_energy, lanczos

    _, pm = hh
    ev0 = float(np.linalg.eigvalsh(pm.to_dense())[0])
    plan = DP.compile_distributed_spmv_plan(pm, cpu_mesh(4), variant="overlap")
    assert ground_state_energy(plan, pm.shape[0], m=80) == pytest.approx(ev0, abs=5e-3)
    r = lanczos(pm, pm.shape[0], m=80, mesh=cpu_mesh(4))
    assert float(r.eigenvalues[0]) == pytest.approx(ev0, abs=5e-3)


def test_as_apply_mesh_refusals(hh):
    from repro_torch.core.eigensolver import as_apply

    _, pm = hh
    for cfg in (PlanConfig(format="csr"), PlanConfig(value_dtype="bf16")):
        with pytest.raises(ValueError, match="local plans only"):
            as_apply(pm, cfg, mesh=cpu_mesh(2))
    plan = as_apply(pm, None, mesh=cpu_mesh(2), variant="ring")
    assert isinstance(plan, DP.DistributedSpMVPlan) and plan.variant == "ring"
    assert plan.device == torch.device("cpu") and as_apply(plan) is plan


def test_selftest_subprocess():
    """The module selftest on 8 CPU shards."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.core.distributed", "2000",
                          "--parts", "8", "--device", "cpu"], capture_output=True,
                         text=True, env=env, cwd=REPO_ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SELFTEST PASS" in out.stdout and "shards=8" in out.stdout


# --- the partitioners' properties (tests/test_property.py) ----------------------------

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # the property tests need hypothesis (requirements: test)
    def given(**_):
        return lambda f: pytest.mark.skip(reason="needs hypothesis")(f)

    def settings(**_):
        return lambda f: f

    class st:  # noqa: N801 - stands in for hypothesis.strategies
        composite = staticmethod(lambda f: f)
        integers = booleans = sampled_from = staticmethod(lambda *a, **k: None)


@st.composite
def _csr_matrices(draw):
    """Random CSR incl. degenerate shapes: empty rows, single rows, heavily
    skewed row lengths."""
    n = draw(st.integers(1, 60))
    nnz = draw(st.integers(0, 4 * n))
    rng = np.random.default_rng(draw(st.integers(0, 10_000)))
    if nnz and draw(st.booleans()):
        hot = rng.choice(n, size=max(1, n // 8), replace=False)
        rows = rng.choice(hot, size=nnz).astype(np.int32)
    else:
        rows = rng.integers(0, n, size=nnz).astype(np.int32)
    cols = rng.integers(0, n, size=nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32) + 0.1
    return PF.CSR.from_coo(PF.COO(rows, cols, vals, (n, n)))


@settings(max_examples=60, deadline=None)
@given(m=_csr_matrices(), parts=st.integers(1, 80))
def test_property_partition_bounds_valid(m, parts):
    for bounds in (D.row_balanced_partition(m.n_rows, parts), D.nnz_balanced_partition(m, parts)):
        assert len(bounds) == parts + 1
        assert bounds[0] == 0 and bounds[-1] == m.n_rows
        assert (np.diff(bounds) >= 0).all()


@settings(max_examples=60, deadline=None)
@given(m=_csr_matrices(), parts=st.integers(1, 80))
def test_property_nnz_cut_never_loses(m, parts):
    imb_rows = D.partition_imbalance(m, D.row_balanced_partition(m.n_rows, parts))
    imb_nnz = D.partition_imbalance(m, D.nnz_balanced_partition(m, parts))
    assert imb_nnz <= imb_rows + 1e-12
    if m.nnz:
        assert imb_nnz >= 1.0 - 1e-12


@settings(max_examples=30, deadline=None)
@given(m=_csr_matrices(), parts=st.integers(1, 16))
def test_property_partition_parts_sum(m, parts):
    rp = PF._np(m.row_ptr).astype(np.int64)
    for bounds in (D.row_balanced_partition(m.n_rows, parts), D.nnz_balanced_partition(m, parts)):
        per_part = rp[bounds[1:]] - rp[bounds[:-1]]
        assert (per_part >= 0).all() and int(per_part.sum()) == m.nnz


@settings(max_examples=30, deadline=None)
@given(m=_csr_matrices(), parts=st.integers(1, 12), local=st.booleans(),
       pack=st.sampled_from(("ell", "sell")))
def test_property_shard_slabs_match_reference(m, parts, local, pack):
    """Degenerate patterns (empty rows and blocks, more shards than rows)
    pack bitwise as the reference packs them."""
    rm = RF.CSR(PF._np(m.row_ptr), PF._np(m.col_idx), PF._np(m.val), m.shape)
    a = RDP.pack_shard_slabs(rm, parts, pack=pack, local_cols=local)
    b = DP.pack_shard_slabs(m, parts, pack=pack, local_cols=local)
    for f in ("col", "val", "rid", "row_map"):
        if getattr(a, f) is not None:
            assert_bitwise(getattr(a, f), getattr(b, f), f)
