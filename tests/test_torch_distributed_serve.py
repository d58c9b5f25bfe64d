"""Serving over the distributed plans on the CPU: the port's
``register_distributed`` held against the reference's.

The reference's distributed chaos cases (``tests/test_chaos.py``) and its
distributed batching cases (``tests/test_serve_batching.py``) run on its
4-device emulated mesh in one subprocess; the port runs the same scenarios
on a 4-shard CPU mesh and must report the same: shard death raised at the
``dist.spmv`` point and clean bits after, a transient ``dist.spmm``
failure retried bit for bit, a persistent fault on the composite slab
backend (the reference's ``xla``, the port's ``torch``) degraded to the
``loop_reference`` oracles, the width flush and the padded partial flush.
On the reference's one-device session mesh and a one-shard CPU mesh the
``stats()`` of a distributed operator compare entry by entry.
"""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import ref_matrix, to_port  # noqa: E402
from _torch_serve import COUNTERS, PORT_HOST, PORT_ONLY, REF_HOST, FakeClock  # noqa: E402
from repro.core import spmv as RS  # noqa: E402
from repro.serve import BatchingSpMVServer as RefServer  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core import matrices as PM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BatchingSpMVServer, KernelFault, ResiliencePolicy, SparseOperatorServer)
from repro_torch.testing import faults  # noqa: E402

_CHAOS_WORKER = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from repro.core.formats import COO, CSR
from repro.core.distributed_plan import compile_distributed_spmv_plan
from repro.core.matrices import holstein_hubbard_surrogate
from repro.serve import BatchingSpMVServer, ResiliencePolicy
from repro.testing import faults

rng = np.random.default_rng(0)
n = 64
dense = (rng.random((n, n)) < 0.15) * rng.standard_normal((n, n))
rows, cols = np.nonzero(dense)
m = CSR.from_coo(COO(rows.astype(np.int32), cols.astype(np.int32),
                     dense[rows, cols].astype(np.float32), (n, n)))
x = jnp.asarray(rng.standard_normal(n), jnp.float32)
out = {"devices": len(jax.devices())}

plan = compile_distributed_spmv_plan(m, variant="overlap")
out["parts"] = plan.parts
y0 = np.asarray(plan(x))
with faults.inject("dist.spmv", error=faults.ShardDeath(1), times=1):
    try:
        plan(x)
        out["shard_death_raised"] = False
    except faults.ShardDeath as e:
        out["shard_death_raised"] = True
        out["dead_part"] = e.part
out["recovery_bitwise"] = bool((np.asarray(plan(x)) == y0).all())

srv = BatchingSpMVServer(max_batch=4, resilience=ResiliencePolicy(max_retries=1))
srv.register_distributed("D", m, variant="allgather")
xs = [jnp.asarray(rng.standard_normal(n), jnp.float32) for _ in range(4)]
clean = [np.asarray(f.result()) for f in [srv.submit("D", v) for v in xs]]
with faults.inject("dist.spmm", error=RuntimeError("collective died"), times=1):
    got = [np.asarray(f.result()) for f in [srv.submit("D", v) for v in xs]]
out["served_retry_bitwise"] = bool(all((a == b).all() for a, b in zip(clean, got)))
st = srv.stats()["D"]
out["retried"], out["failed"] = st["retried"], st["failed"]

srv2 = BatchingSpMVServer(max_batch=4, resilience=ResiliencePolicy(max_retries=0,
                                                                  breaker_threshold=2))
srv2.register_distributed("D", m, variant="allgather")
with faults.inject("dist.spmm", error=RuntimeError("xla slab broken"), times=None,
                   when=lambda ctx: ctx.get("backend") == "xla"):
    got2 = [np.asarray(f.result()) for f in [srv2.submit("D", v) for v in xs]]
st2 = srv2.stats()["D"]
out["degraded"] = st2["degraded"]
out["degraded_backend"] = srv2.plan("D").slab_backend
out["degraded_close"] = bool(all(np.allclose(a, b, atol=1e-4) for a, b in zip(clean, got2)))

n2 = 800
m2 = holstein_hubbard_surrogate(n2, seed=3)
srv3 = BatchingSpMVServer(max_batch=4, deadline_s=60.0)
srv3.register_distributed("hh", m2, variant="overlap")
rng2 = np.random.default_rng(0)
xs2 = [jnp.asarray(rng2.standard_normal(n2).astype(np.float32)) for _ in range(6)]
futs = srv3.submit_many("hh", xs2)
out["flushed_at_width"] = all(f.done() for f in futs[:4]) and not futs[4].done()
srv3.flush("hh")
st3 = srv3.stats()["hh"]
out.update({"batch_parts": st3["parts"], "batches": st3["batches"],
            "mean_batch_width": st3["mean_batch_width"],
            "padding_ratio": st3["padding_ratio"]})
np.savez(%(path)r, y=np.stack([np.asarray(f.result()) for f in futs]))
print(json.dumps(out))
"""


@pytest.fixture(scope="session")
def ref_chaos4(emulated_devices_run, tmp_path_factory):
    """The reference's distributed serving scenarios on 4 devices."""
    path = str(tmp_path_factory.mktemp("chaos4") / "y.npz")
    out = emulated_devices_run(4, _CHAOS_WORKER % {"path": path})
    with np.load(path) as z:
        out["y"] = z["y"]
    return out


def chaos_matrix(n=64, seed=0):
    """The scenarios' matrix and the generator that made it (as the
    reference's worker draws them)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < 0.15) * rng.standard_normal((n, n))
    rows, cols = np.nonzero(dense)
    m = PF.CSR.from_coo(PF.COO(rows.astype(np.int32), cols.astype(np.int32),
                               dense[rows, cols].astype(np.float32), (n, n)))
    return m, rng


def mesh4():
    return D.make_mesh_1d(n_devices=4, device="cpu")


def server(**kw):
    return BatchingSpMVServer(chip=PORT_HOST, device="cpu", clock=FakeClock(), **kw)


def vec(rng, n, dtype=np.float32):
    return torch.from_numpy(rng.standard_normal(n).astype(dtype))


def test_distributed_chaos_matches_reference(ref_chaos4):
    """The reference's 4-device chaos scenario, replayed on 4 CPU shards."""
    from repro_torch.core.distributed_plan import compile_distributed_spmv_plan

    ref = ref_chaos4
    assert ref["devices"] == 4 and ref["parts"] == 4
    m, rng = chaos_matrix()
    n = m.shape[0]
    x = vec(rng, n)
    out = {}
    plan = compile_distributed_spmv_plan(m, mesh4(), variant="overlap")
    out["parts"] = plan.parts
    y0 = plan(x)
    with faults.inject("dist.spmv", error=faults.ShardDeath(1), times=1) as spec:
        try:
            plan(x)
            out["shard_death_raised"] = False
        except faults.ShardDeath as e:
            out["shard_death_raised"] = True
            out["dead_part"] = e.part
    assert spec.log == [{"op": "spmv", "variant": "overlap", "parts": 4, "backend": "torch",
                         "kernel": "overlap"}]
    out["recovery_bitwise"] = bool(torch.equal(plan(x), y0))

    srv = server(max_batch=4, resilience=ResiliencePolicy(max_retries=1))
    srv.register_distributed("D", m, mesh=mesh4(), variant="allgather")
    xs = [vec(rng, n) for _ in range(4)]
    clean = [f.result() for f in [srv.submit("D", v) for v in xs]]
    with faults.inject("dist.spmm", error=RuntimeError("collective died"), times=1):
        got = [f.result() for f in [srv.submit("D", v) for v in xs]]
    out["served_retry_bitwise"] = all(torch.equal(a, b) for a, b in zip(clean, got))
    st = srv.stats()["D"]
    out["retried"], out["failed"] = st["retried"], st["failed"]

    srv2 = server(max_batch=4, resilience=ResiliencePolicy(max_retries=0, breaker_threshold=2))
    srv2.register_distributed("D", m, mesh=mesh4(), variant="allgather")
    assert srv2.stats()["D"]["ladder"] == ("loop_reference",)
    with faults.inject("dist.spmm", error=RuntimeError("torch slab broken"), times=None,
                       when=lambda ctx: ctx.get("backend") == "torch"):
        got2 = [f.result() for f in [srv2.submit("D", v) for v in xs]]
    out["degraded"] = srv2.stats()["D"]["degraded"]
    out["degraded_backend"] = srv2.plan("D").slab_backend
    out["degraded_close"] = all(np.allclose(a.numpy(), b.numpy(), atol=1e-4)
                                for a, b in zip(clean, got2))
    for key, val in out.items():
        assert val == ref[key], (key, val, ref[key])
    assert out["degraded"] == 1 and out["retried"] == 1 and out["shard_death_raised"]


def test_distributed_batching_matches_reference(ref_chaos4):
    """Width flush, padded partial flush and their stats on 4 shards, and
    the futures against the reference's."""
    ref = ref_chaos4
    m = PM.holstein_hubbard_surrogate(800, seed=3)
    srv = server(max_batch=4, deadline_s=60.0)
    srv.register_distributed("hh", m, mesh=mesh4(), variant="overlap")
    rng = np.random.default_rng(0)
    xs = [vec(rng, 800) for _ in range(6)]
    futs = srv.submit_many("hh", xs)
    assert (all(f.done() for f in futs[:4]) and not futs[4].done()) == ref["flushed_at_width"]
    srv.flush("hh")
    st = srv.stats()["hh"]
    assert st["parts"] == ref["batch_parts"] == 4
    for key in ("batches", "mean_batch_width", "padding_ratio"):
        assert st[key] == pytest.approx(ref[key]), key
    y = np.stack([f.result().numpy() for f in futs])
    assert float(np.abs(y - ref["y"]).max() / np.abs(ref["y"]).max()) <= 2e-5
    d = m.to_dense().astype(np.float64)
    want = np.stack([d @ x.numpy().astype(np.float64) for x in xs])
    assert float(np.abs(y - want).max() / np.abs(want).max()) <= 2e-5


def test_register_distributed_stats_match_reference():
    """One shard each side: every stats() entry equal (the predictions to
    rounding; the port's own ``PORT_ONLY`` beside them), the slab backend
    the reference's xla read as torch."""
    rm = ref_matrix("surrogate600")
    pm = to_port(rm)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(pm.shape[1]).astype(np.float32)
    X = rng.standard_normal((pm.shape[1], 3)).astype(np.float32)
    rsrv = RefServer(chip=REF_HOST)
    rrep = rsrv.register_distributed("hh", rm, variant="overlap")
    psrv = SparseOperatorServer(chip=PORT_HOST, device="cpu")
    prep = psrv.register_distributed("hh", pm, variant="overlap")
    assert prep.kernel == rrep.kernel == "overlap" and prep.format == rrep.format
    y_ref = np.asarray(rsrv.spmv("hh", jnp.asarray(x)))
    y = psrv.spmv("hh", torch.from_numpy(x)).numpy()
    assert float(np.abs(y - y_ref).max() / np.abs(y_ref).max()) <= 2e-5
    assert float(np.abs(y - np.asarray(RS.spmv(rm, jnp.asarray(x)))).max()) <= 2e-4
    assert psrv.spmm("hh", torch.from_numpy(X)).shape == (pm.shape[0], 3)
    rsrv.spmm("hh", jnp.asarray(X))
    r, p = rsrv.stats()["hh"], psrv.stats()["hh"]
    assert set(r) == set(p) - PORT_ONLY and PORT_ONLY <= set(p)
    for key in COUNTERS + ("kernel", "variant", "parts", "slab_format", "imbalance",
                           "local_fraction", "collective_bytes_per_call"):
        assert r[key] == p[key], (key, r[key], p[key])
    for key in ("predicted_gflops", "predicted_bytes_per_call"):
        assert np.isclose(r[key], p[key], rtol=1e-9, atol=0), key
    assert p["calls"] == 4 and p["parts"] == 1
    assert {"xla": "torch"}[rsrv.plan("hh").slab_backend] == psrv.plan("hh").slab_backend


# --- the in-process contracts (the reference's multi-device class) -----------


def _dist_server(resilience=None):
    m, _ = chaos_matrix()
    srv = server(max_batch=4, resilience=resilience)
    srv.register_distributed("D", m, mesh=mesh4(), variant="overlap")
    return srv, m


def _requests(n, k, seed=1):
    rng = np.random.default_rng(seed)
    return [vec(rng, n) for _ in range(k)]


def test_shard_death_structured_on_future():
    srv, m = _dist_server(ResiliencePolicy(max_retries=0, breaker_threshold=100))
    xs = _requests(m.shape[1], 4)
    clean = [f.result() for f in [srv.submit("D", x) for x in xs]]
    with faults.inject("dist.spmm", error=faults.ShardDeath(2), times=None):
        futs = [srv.submit("D", x) for x in xs]
        srv.flush("D")
    for f in futs:
        assert isinstance(f.error(), KernelFault)
        assert isinstance(f.error().__cause__, faults.ShardDeath)
        assert f.error().kernel == "overlap"
    st = srv.stats()["D"]
    assert st["failed"] == 4 and st["degraded"] == 0
    got = [f.result() for f in [srv.submit("D", x) for x in xs]]
    assert all(torch.equal(a, b) for a, b in zip(clean, got))


def test_transient_collective_failure_retries_bitwise():
    srv, m = _dist_server()
    xs = _requests(m.shape[1], 4)
    clean = [f.result() for f in [srv.submit("D", x) for x in xs]]
    with faults.inject("dist.spmm", error=RuntimeError("flaky link"), times=1) as spec:
        got = [f.result() for f in [srv.submit("D", x) for x in xs]]
    assert spec.fired == 1
    assert all(torch.equal(a, b) for a, b in zip(clean, got))
    assert srv.stats()["D"]["retried"] == 1


def test_distributed_operator_batching():
    """Batching composes with a mesh plan: one flush at width, futures
    against plan(x)."""
    m = to_port(ref_matrix("surrogate600"))
    srv = server(max_batch=4, deadline_s=60.0)
    srv.register_distributed("hh", m, mesh=mesh4(), variant="overlap")
    xs = _requests(m.shape[1], 4, seed=8)
    futs = srv.submit_many("hh", xs)
    assert all(f.done() for f in futs)
    plan = srv.plan("hh")
    for x, f in zip(xs, futs):
        np.testing.assert_allclose(f.result().numpy(), plan(x).numpy(), rtol=2e-5, atol=2e-5)
    st = srv.stats()["hh"]
    assert st["variant"] == "overlap" and st["parts"] == 4 and st["slab_format"] in ("ell", "sell")
    assert st["batches"] == 1 and st["mean_batch_width"] == 4.0
    assert st["collective_bytes_per_call"] == plan.traffic["collective"] > 0


def test_register_distributed_default_mesh_and_ladders():
    """A host server's default mesh is one shard on its device; the ladder
    is one rung under torch and none under loop_reference."""
    m, _ = chaos_matrix()
    srv = server(max_batch=4)
    srv.register_distributed("D", m)
    assert srv.plan("D").mesh.devices == (torch.device("cpu"),)
    assert srv.stats()["D"]["ladder"] == ("loop_reference",)
    from repro_torch.core.planconfig import PlanConfig
    srv.register_distributed("L", m, config=PlanConfig(backend="loop_reference"))
    assert srv.stats()["L"]["ladder"] == ()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(m.shape[1]))
    np.testing.assert_allclose(srv.spmv("L", x).numpy(), srv.spmv("D", x).numpy(),
                               rtol=1e-12, atol=1e-12)
