"""The slice end to end: ``SpMVPlan.compile`` -> ``lanczos`` in the port,
held against the reference's plan and Lanczos on the same matrix and the
same numpy start vector (f64).  The recurrences agree to 1e-8 relative;
summation order is the only difference.

The Lanczos recurrence's two paths: the host tests hold the chunked scan of
the coefficients to the step-by-step loop's stopping rules, the choice of
path, the counters, and the graph path's control flow with each chunk run
eagerly in place of its CUDA graph; the ``cuda`` tests hold the CUDA graphs
on the card bitwise to the eager loop on the same plan.  The ``cuda`` tests
need no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_plan_lanczos.py
"""
import contextlib
import gc
import types

import numpy as np
import pytest
import torch

from _torch_parity import port_matrix, ref_matrix, to_port, x64
from repro_torch.core import eigensolver as E
from repro_torch.core import formats as PF
from repro_torch.core.eigensolver import (
    LanczosBreakdown, ground_state_energy, lanczos, spectral_extent)
from repro_torch.core.plan import SpMVPlan
from repro_torch.core.planconfig import PlanConfig
from repro_torch.kernels import cuda_build as CB
from repro_torch.kernels.cache import precompute_stats
from repro_torch.testing import faults


@pytest.fixture(autouse=True)
def _reference(request):
    """Every host test may hold the port to the JAX reference; the card's
    tests run where only PyTorch is installed."""
    if request.node.get_closest_marker("cuda") is None:
        pytest.importorskip("jax")


CPU = PlanConfig(device="cpu")


def _ref_lanczos(matrix, fmt: str, n: int, m: int, v0: np.ndarray):
    import jax.numpy as jnp
    from repro.core.eigensolver import lanczos as ref_lanczos
    from repro.core.plan import PlanConfig as RefConfig
    from repro.core.plan import SpMVPlan as RefPlan
    with x64():
        plan = RefPlan.compile(matrix, RefConfig(format=fmt, backend="xla"))
        return ref_lanczos(plan, n, m=m, v0=jnp.asarray(v0))


@pytest.mark.parametrize("fmt,name", [("csr", "surrogate1200"),
                                      ("sell", "surrogate1200"),
                                      ("hybrid", "surrogate1200"),
                                      ("dia", "exact3"),
                                      ("matrix_free", "exact3")])
def test_lanczos_matches_reference(fmt, name):
    r = ref_matrix(name)
    n = r.shape[0]
    v0 = np.random.default_rng(11).standard_normal(n)
    want = _ref_lanczos(r, fmt, n, 48, v0)
    plan = SpMVPlan.compile(to_port(r), CPU.replace(format=fmt))
    assert plan.report.format == fmt and plan.report.kernel == "torch"
    got = lanczos(plan, n, m=48, v0=v0)
    assert got.n_iterations == want.n_iterations and got.n_spmv == want.n_spmv
    for a, b in ((got.alphas, want.alphas), (got.betas, want.betas)):
        assert np.max(np.abs(a - b) / np.maximum(1e-300, np.abs(b))) <= 1e-8
    assert np.allclose(got.eigenvalues, want.eigenvalues, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("fmt", ("csr", "hybrid", "matrix_free"))
def test_exact_ground_state_matches_dense(fmt):
    m = to_port(ref_matrix("exact3"))
    e_dense = float(np.linalg.eigvalsh(m.to_dense())[0])
    plan = SpMVPlan.compile(m, CPU.replace(format=fmt))
    e0 = ground_state_energy(plan, m.shape[0], m=48,
                             v0=np.random.default_rng(3).standard_normal(m.shape[0]))
    assert abs(e0 - e_dense) <= 1e-8 * max(1.0, abs(e_dense))


def test_container_compiles_on_entry_and_spectral_extent():
    m = to_port(ref_matrix("exact3"))
    dense = np.linalg.eigvalsh(m.to_dense())
    lo, hi = spectral_extent(m, m.shape[0], m=80, config=CPU)
    assert abs(lo - dense[0]) < 1e-8 and abs(hi - dense[-1]) < 1e-8


def test_breakdown_on_poisoned_operator_and_restart():
    plan = SpMVPlan.compile(to_port(ref_matrix("exact3")), CPU.replace(format="csr"))
    n = plan.report.shape[0]

    def poisoned(x):
        y = plan(x)
        y[0] = float("nan")
        return y

    with pytest.raises(LanczosBreakdown) as e:
        lanczos(poisoned, n, m=8, device="cpu")
    assert e.value.iteration == 0

    calls = {"n": 0}

    def transient(x):  # NaN once, then healthy
        calls["n"] += 1
        y = plan(x)
        if calls["n"] == 3:
            y[1] = float("inf")
        return y

    res = lanczos(transient, n, m=8, device="cpu", on_breakdown="restart")
    assert res.n_iterations == 8 and res.n_spmv == 8 + 3
    with pytest.raises(ValueError):
        lanczos(plan, n, on_breakdown="ignore")


def test_plan_memoized_and_preprocessing_built_once():
    m = port_matrix("surrogate600")
    cfg = CPU.replace(format="hybrid")
    p1 = SpMVPlan.compile(m, cfg)
    before = precompute_stats()
    p2 = SpMVPlan.compile(m, cfg)
    assert p1 is p2 and precompute_stats() == before
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(600))
    assert torch.equal(p1(x), p2(x))
    assert precompute_stats() == before


def test_report_fields_and_fallbacks():
    m = to_port(ref_matrix("surrogate600"))
    plan = SpMVPlan.compile(m, CPU.replace(format="sell", backend="cuda"))
    # an explicit backend whose probe refuses the operand falls back to torch
    assert plan.report.kernel == "torch" and plan.report.spmm_kernel == "torch"
    assert plan.report.device == "cpu"
    # the model's fields price the kernel that runs: torch streams its form
    from repro_torch.core import perfmodel as PM
    b = PM.balance_of(plan.matrix, backend="torch")
    assert plan.report.balance_bytes_per_flop == b and plan.report.bound == "memory"
    assert plan.report.predicted_time_s == PM.predict("sell", b, m.nnz).time_s
    loop = SpMVPlan.compile(m, CPU.replace(format="sell", backend="loop_reference"))
    assert loop.report.kernel == "loop"
    assert loop.report.balance_bytes_per_flop == PM.balance_of(plan.matrix,
                                                               backend="loop_reference")


def test_plan_rejects_bad_operands():
    plan = SpMVPlan.compile(to_port(ref_matrix("exact3")), CPU.replace(format="csr"))
    n = plan.report.shape[0]
    with pytest.raises(ValueError, match="shape"):
        plan(torch.zeros(n + 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        plan.spmm(torch.zeros(n, dtype=torch.float64))
    with pytest.raises(ValueError, match="runs on cpu"):
        plan(torch.zeros(n, dtype=torch.float64, device="meta"))
    y = plan(np.ones(n))  # numpy input lands on the plan's device
    assert y.device.type == "cpu"


def test_format_auto_names_the_perfmodel_slice():
    """``format="auto"`` converts to ``perfmodel.select_format``'s pick for
    the plan's chip and backend, with the selector's own sigma."""
    from repro_torch.core import perfmodel as PM
    m = port_matrix("surrogate600")
    plan = SpMVPlan.compile(m, CPU.replace(format="auto"))
    choice = PM.select_format(m, device="cpu")
    assert plan.report.format == choice.format
    assert plan.report.predicted_time_s > 0 and plan.report.bound == "memory"
    again = SpMVPlan.compile(m, CPU.replace(format="auto", backend="torch"))
    assert again.matrix is plan.matrix  # one conversion, cached on the source
    with pytest.raises(ValueError, match="backend"):
        SpMVPlan.compile(to_port(ref_matrix("exact3")), CPU.replace(backend="xla"))


def test_value_dtype_plan_runs_quantized_container():
    from repro.core import formats as RF
    r = ref_matrix("surrogate600")
    plan = SpMVPlan.compile(to_port(r), CPU.replace(format="hybrid", value_dtype="int8"))
    assert PF.container_value_dtype(plan.matrix) == "int8"
    x = np.random.default_rng(1).standard_normal(600).astype(np.float32)
    dense = RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64),
                   r.shape).to_dense()
    want = dense @ x.astype(np.float64)
    got = plan(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-2


# -- the recurrence's two paths -------------------------------------------


def _steps_loop(seq):
    """The step-by-step loop's rules on a recorded (alpha, beta) sequence:
    the kept pairs and SpMVs, or the breakdown's iteration and SpMVs."""
    kept = []
    for j, (a, b) in enumerate(seq):
        if not (np.isfinite(a) and np.isfinite(b)):
            return "breakdown", j, j + 1
        kept.append([a, b])
        if b < 1e-12 * max(1.0, abs(a)):
            break
    return kept, len(kept), len(kept)


def _recorded(m: int, stop=None, bad=None):
    """m finite (alpha, beta) pairs; beta 0 at step ``stop``; ``bad`` maps a
    step to the non-finite (alpha, beta) it reads."""
    rng = np.random.default_rng(m)
    seq = [[float(a), float(b)] for a, b in zip(rng.normal(size=m),
                                                1.0 + rng.random(m))]
    if stop is not None:
        seq[stop][1] = 1e-14 * max(1.0, abs(seq[stop][0]))
    for j, pair in (bad or {}).items():
        seq[j] = list(pair)
    return seq


NAN, INF = float("nan"), float("inf")
RECORDED = {
    "finite": _recorded(40),
    "stop0": _recorded(40, stop=0),
    "stop15": _recorded(40, stop=15),
    "stop16": _recorded(40, stop=16),
    "stop_last": _recorded(40, stop=39),
    "stop_last_of_16": _recorded(16, stop=15),
    "nan_before_stop": _recorded(40, stop=20, bad={17: (NAN, 1.0)}),
    "inf_after_stop": _recorded(40, stop=20, bad={22: (1.0, INF)}),
    "inf_beta_same_chunk_after_stop": _recorded(40, stop=3, bad={4: (INF, INF)}),
    "nan_at_0": _recorded(40, bad={0: (0.5, NAN)}),
    "nan_at_31": _recorded(40, bad={31: (NAN, NAN)}),
}


@pytest.mark.parametrize("name", RECORDED)
@pytest.mark.parametrize("chunked", (False, True), ids=("steps", "chunks"))
def test_coefficient_scan_keeps_the_step_loops_rules(name, chunked):
    """The scan of the coefficients, one step or a chunk of K at a time,
    keeps the pairs, the count and the breakdown step of the step-by-step
    loop; a chunk's SpMVs run to its end."""
    seq = RECORDED[name]
    m = len(seq)
    st = types.SimpleNamespace(coefs=torch.tensor(seq, dtype=torch.float64))
    chunks = E.chunk_bounds(m) if chunked else [(j, j + 1) for j in range(m)]
    ran = []
    want, n_it, n_spmv = _steps_loop(seq)
    end = min(m, -(-n_spmv // E.K) * E.K) if chunked else n_spmv
    if want == "breakdown":
        with pytest.raises(LanczosBreakdown) as e:
            E._recur(st, chunks, lambda j0, j1: ran.append((j0, j1)))
        assert e.value.iteration == n_it and e.value.n_spmv == end
        assert np.array_equal([e.value.alpha, e.value.beta], seq[n_it], equal_nan=True)
        return
    kept, got_spmv = E._recur(st, chunks, lambda j0, j1: ran.append((j0, j1)))
    assert kept == want and len(kept) == n_it
    assert got_spmv == end == sum(j1 - j0 for j0, j1 in ran)


def test_chunk_bounds_and_scan_edges():
    assert E.K == 16
    assert E.chunk_bounds(96) == [(j, j + 16) for j in range(0, 96, 16)]
    assert E.chunk_bounds(40) == [(0, 16), (16, 32), (32, 40)]
    assert E.chunk_bounds(16) == [(0, 16)] and E.chunk_bounds(0) == []
    assert E.scan_coefficients([]) == (0, False)
    assert E.scan_coefficients([(0.0, 0.0)]) == (1, True)       # |alpha| < 1 floors at 1
    assert E.scan_coefficients([(1e20, 1e7)]) == (1, True)      # relative to |alpha|
    assert E.scan_coefficients([(1e20, 1e9)]) == (1, False)
    with pytest.raises(LanczosBreakdown) as e:
        E.scan_coefficients([(1.0, 1.0), (-INF, 1.0)], start=32)
    assert e.value.iteration == 33 and e.value.n_spmv == 34


def _tiny_csr(n: int = 90, distinct: int | None = None) -> PF.CSR:
    """A symmetric pentadiagonal f64 matrix, or (``distinct``) a diagonal
    one with that many distinct values: its Krylov space has that size."""
    if distinct is not None:
        d = 1.0 + np.arange(n) % distinct
        return PF.CSR(np.arange(n + 1, dtype=np.int32), np.arange(n, dtype=np.int32), d,
                      (n, n))
    dense = np.diag(2.0 + np.arange(n) % 7) + np.diag(-np.ones(n - 1), 1) + \
        np.diag(-np.ones(n - 1), -1) + np.diag(0.25 * np.ones(n - 3), 3) + \
        np.diag(0.25 * np.ones(n - 3), -3)
    return PF.CSR.from_dense(dense)


def test_graph_fallback_names_why_the_eager_loop_runs():
    from repro_torch.core.distributed import make_mesh_1d
    from repro_torch.core.distributed_plan import compile_distributed_spmv_plan

    m = _tiny_csr()
    plan = SpMVPlan.compile(m, CPU.replace(format="csr"))
    assert E.graph_fallback(plan, 8) == "not on a CUDA device"
    assert E.graph_fallback(lambda x: plan(x), 8) == "not a local plan"
    dist = compile_distributed_spmv_plan(m, make_mesh_1d(n_devices=2, device="cpu"))
    assert E.graph_fallback(dist, 8) == "not a local plan"
    with faults.inject("plan.spmv", error=RuntimeError, when=lambda ctx: False):
        assert E.graph_fallback(plan, 8) == "fault point plan.spmv armed"
    cuda_plan = SpMVPlan.__new__(SpMVPlan)  # a local plan on the card
    cuda_plan.device = torch.device("cuda", 0)
    assert E.graph_fallback(cuda_plan, 8) is None
    assert E.graph_fallback(cuda_plan, 0) == "no steps"
    with faults.inject("plan.spmv", nonfinite=True, when=lambda ctx: False):
        assert E.graph_fallback(cuda_plan, 8) == "fault point plan.spmv armed"


def test_graph_counts_count_eager_solves_on_the_host():
    from repro_torch.core.distributed import make_mesh_1d

    m = _tiny_csr()
    n = m.shape[0]
    plan = SpMVPlan.compile(m, CPU.replace(format="csr"))
    E.reset_graph_counts()
    lanczos(plan, n, m=20)
    lanczos(lambda x: plan(x), n, m=20, device="cpu")
    with faults.inject("plan.spmv", error=RuntimeError, when=lambda ctx: False):
        lanczos(plan, n, m=20)
    lanczos(m, n, m=20, mesh=make_mesh_1d(n_devices=2, device="cpu"))
    with pytest.raises(LanczosBreakdown):
        lanczos(lambda x: plan(x) * float("nan"), n, m=20, device="cpu")
    assert E.graph_counts() == {"captured": 0, "replayed_solves": 0, "eager_solves": 4}
    E.reset_graph_counts()
    assert E.graph_counts() == {"captured": 0, "replayed_solves": 0, "eager_solves": 0}


@pytest.fixture
def eager_graphs(monkeypatch):
    """The graph path on the host: a CPU plan takes it as a plan on the card
    would, each chunk's 'graph' running the chunk eagerly when replayed."""
    fallback = E.graph_fallback

    def on_the_card(apply_A, m):
        why = fallback(apply_A, m)
        return None if why == "not on a CUDA device" else why

    monkeypatch.setattr(E, "graph_fallback", on_the_card)

    def capture(self, plan):
        self.graphs = [types.SimpleNamespace(replay=lambda a=(plan, j0, j1):
                                             self.run_chunk(*a))
                       for j0, j1 in self.chunks]
        self.launches = [{} for _ in self.chunks]
        E._count("captured", len(self.graphs))

    monkeypatch.setattr(E._GraphEntry, "capture", capture)
    E.reset_graph_counts()


def _same(got, want):
    assert np.array_equal(got.alphas, want.alphas) and np.array_equal(got.betas, want.betas)
    assert np.array_equal(got.eigenvalues, want.eigenvalues)
    assert np.array_equal(got.residuals, want.residuals)
    assert got.n_iterations == want.n_iterations


@pytest.mark.parametrize("steps", (16, 40, 96))
@pytest.mark.parametrize("reorth", (False, True), ids=("plain", "reorth"))
@pytest.mark.parametrize("fmt", ("matrix_free", "hybrid"))
def test_graph_path_control_flow_on_the_host(eager_graphs, fmt, reorth, steps):
    """Chunked replays, one read a chunk, give the eager loop's bits: the
    exact L = 3 operator (243 rows) and the surrogate."""
    m = port_matrix("exact3") if fmt == "matrix_free" else port_matrix("surrogate600")
    n = m.shape[0]
    plan = SpMVPlan.compile(m, CPU.replace(format=fmt))
    v0 = np.random.default_rng(5).standard_normal(n)
    want = lanczos(lambda x: plan(x), n, m=steps, v0=v0, reorthogonalize=reorth,
                   device="cpu")
    for _ in range(2):
        got = lanczos(plan, n, m=steps, v0=v0, reorthogonalize=reorth)
        _same(got, want)
        assert got.n_spmv == want.n_spmv == steps
    assert E.graph_counts() == {"captured": len(E.chunk_bounds(steps)),
                                "replayed_solves": 2, "eager_solves": 1}


def test_graph_path_stops_and_breaks_down_where_the_eager_loop_does(eager_graphs):
    # diagonal operators with 5, 12, 16 distinct values: the recurrence
    # stops at step 4, 11, 15 (the last of the first chunk)
    for distinct in (5, 12, 16):
        plan = SpMVPlan.compile(_tiny_csr(3000, distinct=distinct),
                                CPU.replace(format="csr"))
        v0 = np.random.default_rng(2).standard_normal(3000)
        want = lanczos(lambda x: plan(x), 3000, m=40, v0=v0, device="cpu")
        got = lanczos(plan, 3000, m=40, v0=v0)
        _same(got, want)
        assert got.n_iterations == distinct == want.n_spmv and got.n_spmv == 16
    # a value past f64's range on the path's 40th edge: v_j = e_j from e_0,
    # so beta overflows at step 40, in the third chunk
    path = np.diag(np.ones(95), 1) + np.diag(np.ones(95), -1)
    path[40, 41] = path[41, 40] = 1e200
    plan = SpMVPlan.compile(PF.CSR.from_dense(path), CPU.replace(format="csr"))
    e0 = np.eye(96)[0]
    with pytest.raises(LanczosBreakdown) as want:
        lanczos(lambda x: plan(x), 96, m=64, v0=e0, device="cpu")
    with pytest.raises(LanczosBreakdown) as got:
        lanczos(plan, 96, m=64, v0=e0)
    assert got.value.iteration == want.value.iteration == 40
    assert (want.value.n_spmv, got.value.n_spmv) == (41, 48)
    # restarts run the eager loop from reseeded start vectors
    res = lanczos(plan, 96, m=8, v0=e0, on_breakdown="restart")
    assert res.n_iterations == 8


def test_graph_entries_are_cached_per_shape_and_bounded(eager_graphs):
    m = _tiny_csr()
    plan = SpMVPlan.compile(m, CPU.replace(format="csr"))
    for steps in (8, 9, 10, 11, 12, 8):
        lanczos(plan, 90, m=steps)
    lanczos(plan, 90, m=8, dtype=torch.float32)
    entries = plan._lanczos_graphs.entries
    assert len(entries) == E.MAX_GRAPH_ENTRIES
    assert list(entries)[-2:] == [(90, 8, True, torch.float64), (90, 8, True, torch.float32)]
    # 8 was dropped by 12 and captured again; one chunk a graph
    assert E.graph_counts() == {"captured": 7, "replayed_solves": 7, "eager_solves": 0}


def test_busy_graph_entry_falls_back_to_the_eager_loop(eager_graphs):
    m = _tiny_csr()
    plan = SpMVPlan.compile(m, CPU.replace(format="csr"))
    lanczos(plan, 90, m=8)
    cache = plan._lanczos_graphs
    assert cache.lock.acquire(blocking=False)
    try:
        r = lanczos(plan, 90, m=8)
    finally:
        cache.lock.release()
    assert r.n_iterations == 8
    assert E.graph_counts() == {"captured": 1, "replayed_solves": 1, "eager_solves": 1}


class _Launching:
    """A host plan that counts a launch of kernel 4 a call, as the card's
    matrix-free plan does."""

    device = torch.device("cpu")

    def __init__(self, plan):
        self.plan = plan

    def __call__(self, x):
        CB.count_launch("mf_spmv")
        return self.plan(x)


def test_capture_keeps_the_collector_off_and_takes_back_its_launches(monkeypatch):
    """``_GraphEntry.capture`` with CUDA's graph and stream objects stood in
    for: one warm-up step, then one capture a chunk into one shared pool,
    the collector off throughout (destroying a garbage graph inside a
    capture invalidates it); the launches counted meanwhile are taken back
    and each replay adds its chunk's."""
    seen = []

    class Graph:
        def capture_begin(self, pool=None, capture_error_mode="global"):
            seen.append(("begin", pool, capture_error_mode, gc.isenabled()))

        def capture_end(self):
            seen.append(("end", gc.isenabled()))

        def pool(self):
            return ("pool", id(self))

        def replay(self):
            seen.append("replay")

    side = types.SimpleNamespace(wait_stream=lambda s: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: side)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: side)
    plan = _Launching(SpMVPlan.compile(port_matrix("exact3"), CPU.replace(format="matrix_free")))
    entry = E._GraphEntry(plan, 243, 40, False, torch.float64)
    entry.x0.copy_(torch.from_numpy(np.random.default_rng(4).standard_normal(243)))
    E.reset_graph_counts()
    before = CB.launch_counts()
    assert gc.isenabled()
    entry.capture(plan)
    assert gc.isenabled() and CB.launch_counts() == before
    assert entry.launches == [{"mf_spmv": 16}, {"mf_spmv": 16}, {"mf_spmv": 8}]
    first = ("pool", id(entry.graphs[0]))
    assert seen == [("begin", None, "thread_local", False), ("end", False),
                    ("begin", first, "thread_local", False), ("end", False),
                    ("begin", first, "thread_local", False), ("end", False)]
    assert E.graph_counts()["captured"] == 3
    entry.replay(16, 32)
    assert seen[-1] == "replay" and CB.launch_counts()["mf_spmv"] == before["mf_spmv"] + 16
    gc.disable()
    try:                 # a collector already off stays off
        entry.capture(plan)
        assert not gc.isenabled()
    finally:
        gc.enable()


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _card_plan(name: str, dev):
    if name == "exact3":
        return SpMVPlan.compile(port_matrix("exact3"),
                                PlanConfig(device=dev, format="matrix_free"))
    return SpMVPlan.compile(port_matrix("surrogate3000"),
                            PlanConfig(device=dev, format="hybrid"))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", (16, 40, 96))
@pytest.mark.parametrize("reorth", (False, True), ids=("plain", "reorth"))
@pytest.mark.parametrize("name", ("exact3", "surrogate3000"))
def test_cuda_graph_lanczos_bitwise_the_eager_loop(cuda_device, name, reorth, steps):
    plan = _card_plan(name, cuda_device)
    assert plan.report.kernel == "cuda"
    n = plan.report.shape[0]
    v0 = torch.from_numpy(np.random.default_rng(7).standard_normal(n)).to(cuda_device)
    c0 = E.graph_counts()
    got = lanczos(plan, n, m=steps, v0=v0, reorthogonalize=reorth)
    c1 = E.graph_counts()
    want = lanczos(lambda x: plan(x), n, m=steps, v0=v0, reorthogonalize=reorth)
    assert c1["replayed_solves"] == c0["replayed_solves"] + 1
    assert E.graph_counts()["eager_solves"] == c1["eager_solves"] + 1
    _same(got, want)
    assert got.n_spmv == want.n_spmv == steps
    again = lanczos(plan, n, m=steps, v0=v0, reorthogonalize=reorth)
    _same(again, want)
    assert E.graph_counts()["captured"] == c1["captured"]  # the second solve captures nothing


@pytest.mark.cuda
def test_cuda_graph_lanczos_launch_counts_one_per_spmv(cuda_device):
    plan = SpMVPlan.compile(port_matrix("surrogate3000"),
                            PlanConfig(device=cuda_device, format="hybrid"))
    n = plan.report.shape[0]
    v0 = torch.from_numpy(np.random.default_rng(8).standard_normal(n)).to(cuda_device)

    def launched(apply_A):
        before = CB.launch_counts()
        lanczos(apply_A, n, m=40, v0=v0, reorthogonalize=False)
        torch.cuda.synchronize()
        return {k: v - before[k] for k, v in CB.launch_counts().items() if v != before[k]}

    c0 = E.graph_counts()["captured"]
    first = launched(plan)                       # captures: 3 graphs
    assert E.graph_counts()["captured"] == c0 + 3
    eager = launched(lambda x: plan(x))
    assert first == eager == launched(plan) == {"dia_spmv": 40, "sell_spmv": 40}


@pytest.mark.cuda
def test_cuda_graph_lanczos_stops_and_breaks_down_like_the_eager_loop(cuda_device):
    for distinct in (5, 12, 16):
        plan = SpMVPlan.compile(_tiny_csr(3000, distinct=distinct),
                                PlanConfig(device=cuda_device, format="csr"))
        v0 = torch.from_numpy(np.random.default_rng(2).standard_normal(3000)).to(cuda_device)
        want = lanczos(lambda x: plan(x), 3000, m=40, v0=v0)
        got = lanczos(plan, 3000, m=40, v0=v0)
        _same(got, want)
        assert got.n_spmv == min(40, -(-want.n_iterations // 16) * 16)
        if distinct < 16:  # beta ends 25x or more below the stopping rule's
            assert got.n_iterations == distinct
    inf = np.diag(2.0 + np.arange(300) % 7)
    inf[17, 17] = float("inf")
    path = np.diag(np.ones(95), 1) + np.diag(np.ones(95), -1)
    path[40, 41] = path[41, 40] = 1e200
    for dense, v0, at in ((inf, np.random.default_rng(3).standard_normal(300), 0),
                          (path, np.eye(96)[0], 40)):
        plan = SpMVPlan.compile(PF.CSR.from_dense(dense),
                                PlanConfig(device=cuda_device, format="csr"))
        n = dense.shape[0]
        x = torch.from_numpy(v0).to(cuda_device)
        with pytest.raises(LanczosBreakdown) as want:
            lanczos(lambda y: plan(y), n, m=64, v0=x)
        with pytest.raises(LanczosBreakdown) as got:
            lanczos(plan, n, m=64, v0=x)
        assert got.value.iteration == want.value.iteration == at
        assert got.value.n_spmv == (at // 16 + 1) * 16
