"""The microbenchmark slice: index generators, the Table-1 kernels, the
STREAM-triad and gather kernels' plain versions and the timers, held
against the reference on shared numpy inputs.

Generators are bitwise equal.  The Table-1 kernels agree to 1e-5 relative
in f32 (the reductions sum in another order).  The reference's Pallas
microbenchmark kernels run in interpret mode at n = 4096, tile 1024, as
its own tests run them.  The CUDA kernels themselves run on the card
(``test_torch_on_card.py``, ``chip_smoke.py``).
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import microbench as RMB  # noqa: E402
from repro.kernels import gather_bench as RGB  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro.testing import timing as RT  # noqa: E402
from repro_torch.core import microbench as MB  # noqa: E402
from repro_torch.kernels import cuda_build as CB  # noqa: E402
from repro_torch.kernels import gather_bench as GB  # noqa: E402
from repro_torch.testing import timing as T  # noqa: E402


def test_constant_stride_and_gaussian_generators_bitwise():
    for n, k, nb in ((1000, 1, 1000), (1000, 8, 8000), (777, 3, 1000), (64, 5, 0)):
        a, b = RMB.ind_constant_stride(n, k, nb), MB.ind_constant_stride(n, k, nb)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for mean, var in ((4.0, 1.0), (2.0, 16.0), (8.0, 0.0)):
        a = RMB.ind_gaussian(2000, mean, var, 5000, seed=3)
        b = MB.ind_gaussian(2000, mean, var, 5000, seed=3)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("k", (1, 2.5, 8, 64))
def test_bernoulli_generator_and_stride_stats_bitwise(k):
    a, b = RMB.ind_random_bernoulli(20000, k, seed=5), MB.ind_random_bernoulli(20000, k, seed=5)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert RMB.stride_stats(a) == MB.stride_stats(b)


def test_table1_kernels_match_in_f32():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    n, k = 4096, 8
    A = rng.standard_normal(n).astype(np.float32)
    B = rng.standard_normal(n * k).astype(np.float32)
    ind = MB.ind_constant_stride(n, k, n * k)
    ind_ir = MB.ind_random_bernoulli(n * k, k, 0)[:n]
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    cases = [
        (RMB.pdadd(Bj[:n]), MB.pdadd(Bt[:n])),
        (RMB.pdscp(Aj, Bj[:n]), MB.pdscp(At, Bt[:n])),
        (RMB.csscp(Aj, Bj[::k][:n]), MB.csscp(At, Bt[::k][:n].contiguous())),
        (RMB.isadd(Bj, jnp.asarray(ind)), MB.isadd(Bt, torch.from_numpy(ind))),
        (RMB.isscp(Aj, Bj, jnp.asarray(ind)), MB.isscp(At, Bt, torch.from_numpy(ind))),
        (RMB.iradd(Bj, jnp.asarray(ind_ir)), MB.iradd(Bt, torch.from_numpy(ind_ir))),
        (RMB.irscp(Aj[:ind_ir.size], Bj, jnp.asarray(ind_ir)),
         MB.irscp(At[:ind_ir.size], Bt, torch.from_numpy(ind_ir))),
    ]
    for want, got in cases:
        want, got = float(want), float(got)
        assert got.__class__ is float
        scale = float(np.abs(B).sum())  # the sums cancel: bound by the magnitudes
        assert abs(want - got) <= 1e-5 * scale


def _triad_inputs(dtype=np.float32):
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(4096).astype(dtype) for _ in range(3))


def test_stream_triad_plain_matches_reference_kernel():
    import jax.numpy as jnp
    a, b, c = _triad_inputs()
    want = np.asarray(RGB.stream_triad(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                                       tile=1024, interpret=True))
    got = GB.stream_triad_plain(*map(torch.from_numpy, (a, b, c))).numpy()
    # the reference's interpreter may fuse the multiply-add (one rounding)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = np.asarray(RREF.stream_triad_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # the CPU wrapper is the plain version, launch counts untouched
    before = CB.launch_counts()
    assert np.array_equal(GB.stream_triad(*map(torch.from_numpy, (a, b, c))).numpy(), got)
    assert CB.launch_counts() == before


def test_gather_scp_plain_matches_reference_kernel_and_sum_matches_ref():
    import jax.numpy as jnp
    a, x, _ = _triad_inputs()
    idx = np.random.default_rng(1).integers(0, 4096, 4096).astype(np.int32)
    want = np.asarray(RGB.gather_scp(jnp.asarray(a), jnp.asarray(idx), jnp.asarray(x),
                                     tile=1024, interpret=True))
    got = GB.gather_scp(*map(torch.from_numpy, (a, idx, x)))
    assert np.array_equal(got.numpy(), want)  # one product each: exact
    # the reference's oracle takes (a, x, idx) and returns the sum
    s_ref = float(RREF.gather_scp_ref(jnp.asarray(a), jnp.asarray(x), jnp.asarray(idx)))
    assert abs(float(torch.sum(got)) - s_ref) <= 1e-5 * float(np.abs(want).sum())


@pytest.mark.parametrize("n,vb", [(4096, 4), (1 << 22, 8), (1000, 2)])
def test_traffic_model_identical(n, vb):
    assert RGB.traffic_model(n, vb) == GB.traffic_model(n, vb)
    assert GB.traffic_model(n, vb)["stream_triad"] >= GB.traffic_model(n, vb)["gather_scp"]


def test_f64_wrappers_on_cpu_follow_the_plain_versions():
    a, b, c = (torch.from_numpy(v) for v in _triad_inputs(np.float64))
    assert torch.equal(GB.stream_triad(a, b, c), b + a * c)
    idx = torch.arange(4095, -1, -1, dtype=torch.int32)
    assert torch.equal(GB.gather_scp(a, idx, c), a * c.flip(0))


def test_fake_timer_behaves_like_the_reference():
    lat = {"m/csr/torch": 0.5, "m/sell/torch": 0.25}
    r, p = RT.FakeTimer(dict(lat), default_s=2.0), T.FakeTimer(dict(lat), default_s=2.0)
    called = []
    for key in ("m/csr/torch", "m/dia/torch", "m/sell/torch", "m/csr/torch"):
        assert r.measure(called.append, (1,), key=key) == \
            p.measure(called.append, (1,), key=key)
    assert not called  # never executes the measured callable
    assert r.calls == p.calls and r.n_calls == p.n_calls == 4
    assert r.count("m/csr/torch") == p.count("m/csr/torch") == 2


def test_wall_timer_times_on_the_host_and_event_timer_needs_the_card(monkeypatch):
    calls = []
    t = T.WallTimer(repeats=2).measure(lambda: calls.append(1), iters=3)
    assert t >= 0 and len(calls) == 1 + 2 * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        T.CudaEventTimer().measure(lambda: None)


def test_runners_on_the_host_with_a_scripted_timer():
    timer = T.FakeTimer(default_s=1e-3)
    rows = MB.run_table1(n=1024, k=8, device="cpu", timer=timer)
    assert [r.name for r in rows] == ["PDADD", "PDSCP", "CSSCP_k8", "ISADD_k8", "ISSCP_k8",
                                      "IRADD_k8", "IRSCP_k8"]
    assert rows[1].bytes_moved == 2 * 1024 * 4 and rows[4].bytes_moved == 1024 * 12
    split = MB.run_gather_split(n=2048, device="cpu", timer=timer)
    assert [r.name for r in split] == ["TRIAD", "GATHER_IS_k1", "GATHER_IS_k8",
                                       "GATHER_IR_k8"]
    assert split[0].bytes_moved == 4 * 2048 * 4
    assert split[0].ns_per_element == pytest.approx(1e-3 / 2048 * 1e9)
    sweep = MB.run_stride_sweep((1, 4), n=512, kind="ir", device="cpu", timer=timer)
    grid = MB.run_gaussian_grid((2.0,), (1.0, 9.0), n=256, device="cpu", timer=timer)
    assert len(sweep) == 2 and len(grid) == 2
    bw = MB.stream_triad_bandwidth(n=4096, device="cpu", timer=T.FakeTimer(default_s=1e-6))
    assert bw == pytest.approx(4 * 4096 * 4 / 1e-6)


def test_card_chip_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MB.card_chip()


def test_bench_result_fields_and_time_fn_match_the_reference():
    assert [f.name for f in dataclasses.fields(MB.BenchResult)] == \
        [f.name for f in dataclasses.fields(RMB.BenchResult)]
    calls = []

    def fn(a):
        calls.append(1)
        return a + 1

    best, mean = MB.time_fn(fn, torch.ones(8), repeats=2, inner=3)
    assert len(calls) == 1 + 2 * 3 and 0 < best <= mean
    r = MB.bench("X", fn, (torch.ones(8),), 8, 64.0, timer=T.FakeTimer(default_s=2e-6))
    assert r.best_s == r.mean_s == 2e-6 and len(calls) == 7   # never run
    assert r.cycles_per_element_1ghz == r.ns_per_element == pytest.approx(250.0)
    assert r.row() == "X,8,2.000e-06,0.03,250.00"
    times = T.WallTimer(repeats=3).measure_all(fn, (torch.ones(8),), iters=2)
    assert len(times) == 3 and len(calls) == 7 + 1 + 3 * 2
    w = MB.bench("W", fn, (torch.ones(8),), 8, 64.0, timer=T.WallTimer(repeats=3), iters=2)
    assert 0 < w.best_s <= w.mean_s


def test_host_chip_is_the_reference_host_chip_but_its_bandwidth(monkeypatch):
    import benchmarks.common as BC
    monkeypatch.setattr(BC, "_CAL", {})
    monkeypatch.setattr(BC, "stream_triad_bandwidth", lambda: 12.5e9)
    monkeypatch.setattr(MB, "_CAL", {})
    monkeypatch.setattr(MB, "stream_triad_bandwidth", lambda *a, **k: 12.5e9)
    want, got = BC.host_chip(), MB.host_chip()
    assert got is MB.host_chip()                 # measured once a process
    assert (got.name, got.peak_flops_bf16, got.peak_flops_fp32, got.hbm_bytes_per_s,
            got.hbm_bytes, got.link_bytes_per_s, got.links) == (
        want.name, want.peak_flops_bf16, want.peak_flops_fp32, want.hbm_bytes_per_s,
        want.hbm_bytes, want.ici_bytes_per_s_per_link, want.ici_links)
    assert got.peak_flops_fp64 == got.peak_flops_fp32 and got.measured
