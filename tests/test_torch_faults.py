"""The port's fault injection (``repro_torch.testing.faults``) held against
the reference's: the same registered points, the same arming contract
(unknown point, double arm, exactly one kind), the same ``times`` /
``when`` / ``log`` semantics, ``poison`` writing NaN where the reference's
does, and the plan's ``plan.spmv`` / ``plan.spmm`` points firing around
``plan(x)`` / ``plan.spmm(X)`` on the CPU."""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.testing import faults as RFT  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core.eigensolver import LanczosBreakdown, lanczos  # noqa: E402
from repro_torch.core.plan import SpMVPlan  # noqa: E402
from repro_torch.core.planconfig import PlanConfig  # noqa: E402
from repro_torch.core.validate import check_finite_columns  # noqa: E402
from repro_torch.testing import faults as PFT  # noqa: E402


@pytest.fixture(autouse=True)
def _disarm():
    yield
    PFT.reset()
    RFT.reset()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _plan(n=40, seed=0):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < 0.2) * rng.standard_normal((n, n))
    dense = dense + dense.T + np.diag(np.full(n, 4.0))
    return SpMVPlan.compile(PF.CSR.from_dense(dense), PlanConfig(device="cpu", format="csr"))


def test_the_same_points_are_registered():
    assert PFT.FAULT_POINTS == RFT.FAULT_POINTS
    assert {"plan.spmv", "plan.spmm", "dist.spmv", "dist.spmm", "serve.flush",
            "serve.queue_full"} <= set(PFT.FAULT_POINTS)
    assert PFT.fault_point("plan.spmv", "another text") == "plan.spmv"
    assert PFT.FAULT_POINTS["plan.spmv"] == RFT.FAULT_POINTS["plan.spmv"]


@pytest.mark.parametrize("name,kw,exc,match", [
    ("no.such.point", dict(error=RuntimeError()), KeyError, "unknown fault point"),
    ("plan.spmv", dict(error=RuntimeError(), nonfinite=True), ValueError, "exactly one"),
    ("plan.spmv", {}, ValueError, "exactly one"),
    ("plan.spmv", dict(delay_s=0.1, nonfinite=True), ValueError, "exactly one"),
])
def test_arming_contract_matches_reference(name, kw, exc, match):
    for mod in (RFT, PFT):
        with pytest.raises(exc, match=match):
            with mod.inject(name, **kw):
                pass
        assert mod.armed(name) is None


def test_double_arm_is_refused_and_context_disarms():
    for mod in (RFT, PFT):
        with mod.inject("plan.spmv", error=RuntimeError()) as spec:
            assert mod.armed("plan.spmv") is spec
            with pytest.raises(RuntimeError, match="already armed"):
                with mod.inject("plan.spmv", error=RuntimeError()):
                    pass
        assert mod.armed("plan.spmv") is None


def _script(mod):
    """One sequence of fires under every kind; what each returned or raised."""
    out = []
    clock = FakeClock()
    ctxs = [{"op": "spmv", "kernel": "torch"}, {"op": "spmv", "kernel": "cuda"},
            {"op": "spmv", "kernel": "torch"}, {"op": "spmv", "kernel": "cuda"}]
    with mod.inject("plan.spmv", error=RuntimeError("boom"), times=2) as s:
        for c in ctxs:
            try:
                out.append(("ret", mod.fire("plan.spmv", c)))
            except RuntimeError as e:
                out.append(("raise", str(e)))
        out.append(("spec", s.fired, s.log))
    with mod.inject("plan.spmm", error=ValueError, times=None,
                    when=lambda ctx: ctx.get("kernel") == "cuda") as s:
        for c in ctxs:
            try:
                out.append(("ret", mod.fire("plan.spmm", c)))
            except ValueError as e:
                out.append(("raise", type(e).__name__))
        out.append(("spec", s.fired, s.log))
    with mod.inject("serve.flush", delay_s=0.5, times=3) as s:
        for _ in range(4):
            out.append(("ret", mod.fire("serve.flush", {}, clock=clock)))
        out.append(("clock", clock.t, s.fired))
    with mod.inject("plan.spmv", nonfinite=True, column=2) as s:
        got = mod.fire("plan.spmv", {"op": "spmv"})
        out.append(("nonfinite", got is s, got.column, mod.fire("plan.spmv", {})))
    out.append(("disarmed", mod.fire("plan.spmv", {}), mod.fire("dist.spmv", {})))
    return out


def test_fire_semantics_match_reference():
    assert _script(PFT) == _script(RFT)


def test_delay_on_the_real_clock_sleeps(monkeypatch):
    slept = []
    monkeypatch.setattr(PFT.time, "sleep", slept.append)
    with PFT.inject("serve.flush", delay_s=0.25):
        assert PFT.fire("serve.flush") is None
    assert slept == [0.25]


@pytest.mark.parametrize("shape,column", [((5,), 0), ((4, 3), 1), ((4, 3), 9)])
def test_poison_matches_reference(shape, column):
    import jax.numpy as jnp
    y = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
    spec_r = RFT.FaultSpec("plan.spmv", nonfinite=True, column=column)
    spec_p = PFT.FaultSpec("plan.spmv", nonfinite=True, column=column)
    want = np.asarray(RFT.poison(jnp.asarray(y), spec_r))
    t = torch.from_numpy(y.copy())
    got = PFT.poison(t, spec_p).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want))
    assert not torch.isnan(t).any()              # the input is left as it was


def test_plan_fault_points_fire_on_the_host():
    plan = _plan()
    n = plan.report.shape[1]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n))
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 4)))
    y0, Y0 = plan(x), plan.spmm(X)
    with PFT.inject("plan.spmv", error=RuntimeError("kernel died")) as spec:
        with pytest.raises(RuntimeError, match="kernel died"):
            plan(x)
        assert torch.equal(plan(x), y0)          # disarmed after one firing
    assert spec.log == [{"op": "spmv", "format": "csr", "kernel": "torch"}]
    with PFT.inject("plan.spmm", nonfinite=True, column=2, times=None) as spec:
        Y = plan.spmm(X)
        assert plan(x) is not None and spec.fired == 1       # spmv is not spmm
    bad = check_finite_columns(Y)
    assert bad.tolist() == [True, True, False, True]
    assert torch.equal(torch.nan_to_num(Y, nan=0.0)[:, [0, 1, 3]], Y0[:, [0, 1, 3]])
    with PFT.inject("plan.spmv", nonfinite=True, times=None):
        with pytest.raises(LanczosBreakdown):
            lanczos(plan, n, m=8, v0=x.numpy())
    PFT.reset()
    assert torch.equal(plan(x), y0) and torch.equal(plan.spmm(X), Y0)


def test_shard_death_matches_reference():
    r, p = RFT.ShardDeath(3), PFT.ShardDeath(3)
    assert isinstance(p, RuntimeError) and p.part == r.part == 3
    assert str(p) == str(r)
