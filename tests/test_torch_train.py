"""The port's training path against the reference: every case of
``tests/test_train.py`` (optimizer, checkpoint, elastic, compression,
trainer) held against the reference on the same seeded inputs, the AdamW
weight-decay decision for every leaf of every architecture, the tree and
opt-state carries, checkpoints crossing between the packages bitwise,
remat, microbatching, NaN skipping, deterministic resume and
``launch.train``."""
import pytest

pytest.importorskip("jax")

import os  # noqa: E402
import tempfile  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_lm import ARCHS, configs, port_module, ref_params, rel, spec_tree  # noqa: E402
from repro_torch.interop import (as_tensor, lm_state_from_reference,  # noqa: E402
                                 opt_state_from_reference, opt_state_to_reference)
from repro_torch.models.registry import Model, get_config  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train import compression as GC  # noqa: E402
from repro_torch.train import elastic as E  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as T  # noqa: E402
from repro_torch.utils.tree import flatten_with_paths, reference_path, stacked_tree  # noqa: E402


def _bits(a) -> np.ndarray:
    """The raw bits of a tensor or array (bf16 and its void form as int16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype.kind == "V":
        return a.view(np.int16)
    return a


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


# --- optimizer -----------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ("wsd", "cosine", "const"))
def test_schedules_equal_reference(schedule):
    from repro.train import optimizer as RO
    kw = dict(lr=1.0, schedule=schedule, warmup_steps=10, total_steps=100, decay_frac=0.2,
              min_lr_frac=0.1)
    got = [float(O.schedule_lr(O.OptimizerConfig(**kw), torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 121)]
    want = [float(RO.schedule_lr(RO.OptimizerConfig(**kw), jnp.int32(s))) for s in range(0, 121)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_wsd_schedule_phases():
    cfg = O.OptimizerConfig(lr=1.0, schedule="wsd", warmup_steps=10,
                            total_steps=100, decay_frac=0.2, min_lr_frac=0.1)
    lr = lambda s: float(O.schedule_lr(cfg, s))  # noqa: E731
    assert lr(0) == pytest.approx(0.0)
    assert lr(5) == pytest.approx(0.5)          # warmup
    assert lr(10) == pytest.approx(1.0)
    assert lr(50) == pytest.approx(1.0)          # stable plateau
    assert lr(79) == pytest.approx(1.0, abs=0.06)
    assert lr(90) == pytest.approx(0.55, abs=0.02)  # mid decay
    assert lr(100) == pytest.approx(0.1, abs=0.01)  # floor


def test_cosine_schedule_monotone_decay():
    cfg = O.OptimizerConfig(lr=1.0, schedule="cosine", warmup_steps=5, total_steps=50)
    lrs = [float(O.schedule_lr(cfg, s)) for s in range(5, 51, 5)]
    assert all(a >= b - 1e-6 for a, b in zip(lrs, lrs[1:]))


def test_grad_clip():
    from repro.train import optimizer as RO
    g = {"a": torch.full((4,), 10.0)}
    clipped, gn = O.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)
    assert torch.equal(g["a"], torch.full((4,), 10.0))
    rclipped, rgn = RO.clip_by_global_norm({"a": jnp.full((4,), 10.0)}, 1.0)
    assert np.array_equal(clipped["a"].numpy(), np.asarray(rclipped["a"]))
    # under the limit: unscaled (scale min(1, ...)), unlike torch's max_norm / (gn + 1e-6)
    small = {"a": torch.full((4,), 0.1)}
    assert torch.equal(O.clip_by_global_norm(small, 1.0)[0]["a"], small["a"])


def test_adamw_converges_quadratic():
    """AdamW minimizes a simple quadratic, as the reference's does."""
    from repro.train import optimizer as RO
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = O.init_opt_state(params)
    kw = dict(lr=0.1, weight_decay=0.0, grad_clip=100.0, schedule="const", warmup_steps=1)
    for _ in range(300):
        params, opt, _ = O.adamw_update(O.OptimizerConfig(**kw),
                                        {"w": 2 * (params["w"] - target)}, opt, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)
    rp = {"w": jnp.zeros(3)}
    ropt = RO.init_opt_state(rp)
    for _ in range(300):
        rp, ropt, _ = RO.adamw_update(RO.OptimizerConfig(**kw),
                                      {"w": 2 * (rp["w"] - jnp.asarray(target.numpy()))},
                                      ropt, rp)
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(rp["w"]), atol=1e-5)
    assert int(opt["step"]) == int(ropt["step"]) == 300 and opt["step"].dtype == torch.int32


def test_adamw_bf16_state_roundtrip():
    from repro.train import optimizer as RO
    params = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
    opt = O.init_opt_state(params, dtype=torch.bfloat16)
    g = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
    p2, o2, _ = O.adamw_update(O.OptimizerConfig(lr=1e-2), g, opt, params)
    assert p2["w"].dtype == torch.bfloat16
    assert o2["m"]["w"].dtype == torch.bfloat16
    rparams = {"w": jnp.ones((8, 8), jnp.bfloat16)}
    rp2, ro2, _ = RO.adamw_update(RO.OptimizerConfig(lr=1e-2),
                                  {"w": jnp.ones((8, 8), jnp.bfloat16)},
                                  RO.init_opt_state(rparams, dtype=jnp.bfloat16), rparams)
    for got, want in ((p2["w"], rp2["w"]), (o2["m"]["w"], ro2["m"]["w"]),
                      (o2["v"]["w"], ro2["v"]["w"])):
        assert np.array_equal(_bits(got), _bits(want))


def _stacked_pair(seed: int):
    """Random params, and grads for 4 steps, as port names and as the
    reference's stacked tree: a decayed matrix, a stacked norm scale (rank 1
    a unit, rank 2 stacked: decayed), an unstacked norm scale (not)."""
    rng = np.random.default_rng(seed)
    shapes = {"embed.table": (8, 4), "ln_f.scale": (4,), "units.0.ln.scale": (4,),
              "units.1.ln.scale": (4,), "units.0.w": (4, 4), "units.1.w": (4, 4)}
    def draw():
        return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    p = draw()
    gs = [draw() for _ in range(4)]
    ref = lambda d: jax.tree.map(jnp.asarray, stacked_tree(d, stack=np.stack))  # noqa: E731
    port = lambda d: {k: torch.from_numpy(v.copy()) for k, v in d.items()}  # noqa: E731
    return port(p), ref(p), [port(g) for g in gs], [ref(g) for g in gs]


@pytest.mark.parametrize("wd", (0.0, 0.1))
def test_adamw_steps_equal_reference_with_stacked_decay(wd):
    """Four AdamW steps (clipped, WSD warmup) on a port-named state and on
    the reference's stacked tree: parameters and moments within 1e-6."""
    from repro.train import optimizer as RO
    kw = dict(lr=0.05, weight_decay=wd, grad_clip=1.0, warmup_steps=2, total_steps=10)
    p, rp, gs, rgs = _stacked_pair(0)
    opt, ropt = O.init_opt_state(p), RO.init_opt_state(rp)
    assert O.decayed(p) == {"embed.table": True, "ln_f.scale": False, "units.0.ln.scale": True,
                            "units.1.ln.scale": True, "units.0.w": True, "units.1.w": True}
    for g, rg in zip(gs, rgs):
        p, opt, st = O.adamw_update(O.OptimizerConfig(**kw), g, opt, p)
        rp, ropt, rst = RO.adamw_update(RO.OptimizerConfig(**kw), rg, ropt, rp)
        assert float(st["lr"]) == pytest.approx(float(rst["lr"]), rel=1e-7)
        assert float(st["grad_norm"]) == pytest.approx(float(rst["grad_norm"]), rel=1e-6)
    for got, want in ((stacked_tree(p), rp), (stacked_tree(opt["m"]), ropt["m"]),
                      (stacked_tree(opt["v"]), ropt["v"])):
        want = _ref_flat(want)
        for path, leaf in flatten_with_paths(got):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(want[path]), rtol=1e-6,
                                       atol=1e-7, err_msg=path)


@pytest.mark.parametrize("name", ARCHS)
def test_weight_decay_decision_equals_reference(name):
    """Every leaf of the full config: the port decays exactly the leaves the
    reference decays (rank >= 2 in the stacked tree), norm scales of the
    stacked units among them."""
    from repro.models.registry import Model as RModel
    rcfg, cfg = configs(name, reduced=False)
    want = {p: len(s.shape) >= 2 for p, s in _ref_flat(RModel(rcfg).param_shapes()).items()}
    got = {}
    for k, dec in O.decayed(Model(cfg).build("meta")).items():
        got.setdefault(reference_path(k)[0], set()).add(dec)
    assert {p: d.pop() for p, d in got.items() if len(d) == 1} == want
    assert all(len(d) <= 1 for d in got.values())
    if cfg.family != "ssm" and cfg.family != "encdec":
        norm = [p for p in want if p.endswith("ln_attn/scale") and p.startswith("units/")]
        assert norm and all(want[p] for p in norm)


def test_opt_state_shapes_equal_reference():
    from repro.models.registry import Model as RModel
    from repro.train import optimizer as RO
    for name in ("qwen3-0.6b", "jamba-1.5-large-398b"):
        rcfg, cfg = configs(name, reduced=False)
        for dt, rdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            got = O.opt_state_shapes(Model(cfg).param_shapes(), dt)
            want = RO.opt_state_shapes(RModel(rcfg).param_shapes(), rdt)
            assert spec_tree(got) == spec_tree(want)


# --- tree and opt-state carries --------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_stacked_tree_is_the_reference_tree(name):
    """stacked_tree(module) is the reference's parameter tree, leaf by leaf
    and in the reference's order, bit for bit; the opt-state carry goes
    both ways."""
    _, rp = ref_params(name)
    model, module = port_module(name)
    got, want = flatten_with_paths(stacked_tree(module)), _ref_flat(rp)
    assert [p for p, _ in got] == list(want)
    for path, leaf in got:
        assert np.array_equal(_bits(leaf), _bits(want[path])), path
    ropt = {"m": rp, "v": jax.tree.map(lambda a: a * 2, rp), "step": jnp.int32(7)}
    opt = opt_state_from_reference(model.cfg, jax.tree.map(np.asarray, ropt))
    assert set(opt["m"]) == set(dict(module.named_parameters())) and int(opt["step"]) == 7
    back = flatten_with_paths(opt_state_to_reference(opt))
    assert [p for p, _ in back] == list(_ref_flat(ropt))
    for path, leaf in back:
        assert np.array_equal(_bits(leaf), _bits(_ref_flat(ropt)[path])), path


# --- checkpoint ------------------------------------------------------------------------


def _tiny_state():
    """The reference's ``_tiny_state`` in the port's names: an (8, 4) table
    and three stacked (4, 4) unit weights."""
    g = torch.Generator().manual_seed(0)
    params = {"emb.table": torch.randn((8, 4), generator=g)}
    params.update({f"units.{i}.w": torch.randn((4, 4), generator=g) for i in range(3)})
    return params, O.init_opt_state(params)


def _like(params, opt):
    return {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "opt_state": {"m": {k: torch.ones_like(v) for k, v in opt["m"].items()},
                          "v": {k: torch.ones_like(v) for k, v in opt["v"].items()},
                          "step": torch.ones_like(opt["step"])}}


def test_checkpoint_roundtrip():
    params, opt = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        C.save(d, 7, params=params, opt_state=opt, extra={"note": "x"})
        out = C.restore(d, 7, like=_like(params, opt))
        for k in params:
            assert torch.equal(out["params"][k], params[k])
            assert torch.equal(out["opt_state"]["m"][k], opt["m"][k])
        assert out["step"] == 7 and int(out["opt_state"]["step"]) == 0
        assert out["extra"]["note"] == "x"
        raw = C.restore(d, 7)
        assert torch.equal(raw["params"]["units"]["w"][2], params["units.2.w"])
        assert raw["params"]["units"]["w"].shape == (3, 4, 4)


def test_checkpoint_retention_and_latest():
    params, opt = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4):
            C.save(d, s, params=params, opt_state=opt, keep=2)
        assert C.available_steps(d) == [3, 4]
        out = C.restore_latest(d, like=_like(params, opt))
        assert out["step"] == 4
        assert C.restore_latest(os.path.join(d, "none")) is None


def test_checkpoint_atomicity_no_tmp_left():
    params, opt = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        C.save(d, 1, params=params, opt_state=opt)
        assert not any(f.endswith(".tmp") for f in os.listdir(d))


def test_checkpoint_restore_refuses_a_missing_or_mismatched_leaf():
    params, opt = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        C.save(d, 1, params=params, opt_state=opt)
        with pytest.raises(KeyError, match="params/other"):
            C.restore(d, 1, like={"params": {"other.x": torch.zeros(2)}})
        with pytest.raises(ValueError, match="emb/table"):
            C.restore(d, 1, like={"params": {"emb.table": torch.zeros((8, 4),
                                                                      dtype=torch.float64)}})


def test_elastic_restore_reshard():
    """Restore a checkpoint and place it on a (1-device) mesh -- the elastic
    path; a mesh of several cards raises (no multi-card training)."""
    params, opt = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        C.save(d, 3, params=params, opt_state=opt)
        out = C.restore(d, 3, like=_like(params, opt))
        shape = E.choose_mesh_shape(1)
        mesh = E.make_mesh_from_devices([torch.device("cpu")], shape)
        like = stacked_tree(params, stack=lambda ts: torch.stack(ts))
        state = E.remesh_state(out, like, mesh)
        for k in params:
            assert torch.equal(state["params"][k], params[k])
        two = E.make_mesh_from_devices([torch.device("cuda", 0), torch.device("cuda", 1)],
                                       (1, 2))
        with pytest.raises(NotImplementedError, match="multi-card training"):
            E.remesh_state(out, like, two)


def test_choose_mesh_shape_degrades():
    from repro.train.elastic import choose_mesh_shape
    assert E.choose_mesh_shape(256) == (16, 16)
    assert E.choose_mesh_shape(240, prefer_model=16) == (15, 16)
    assert E.choose_mesh_shape(7) == (1, 7)
    assert all(E.choose_mesh_shape(n, pm) == choose_mesh_shape(n, pm)
               for n in range(1, 300) for pm in (1, 4, 16))


def test_heartbeat_flags_stragglers():
    from repro.train.elastic import ElasticPolicy, Heartbeat
    hb = E.Heartbeat(factor=3.0)
    for s in range(10):
        hb.beat(s, 0.1)
    assert not hb.is_straggling()
    hb.beat(10, 0.9)
    assert hb.is_straggling()
    pol = E.ElasticPolicy(tolerate_flags=3)
    for s in (11, 12):
        hb.beat(s, 0.9)
    assert pol.should_remesh(hb) or len(hb.flagged) >= 3
    times = np.random.default_rng(4).lognormal(-2, 0.8, 200)
    a, b = E.Heartbeat(window=16), Heartbeat(window=16)
    for s, t in enumerate(times):
        a.beat(s, float(t))
        b.beat(s, float(t))
        assert E.ElasticPolicy().should_remesh(a) == ElasticPolicy().should_remesh(b)
    assert a.flagged == b.flagged and a.median() == b.median()


def _reference_bf16_state():
    """Jamba's reduced model (bf16 parameters) with a bf16 opt state, in the
    reference, and the same state in the port."""
    from repro.train.optimizer import init_opt_state
    name = "jamba-1.5-large-398b"
    _, rp = ref_params(name)
    ropt = init_opt_state(rp, dtype=jnp.bfloat16)
    ropt = {"m": jax.tree.map(lambda a: (a * 3).astype(jnp.bfloat16), rp),
            "v": jax.tree.map(lambda a: (a * a).astype(jnp.bfloat16), rp),
            "step": ropt["step"] + 5}
    model, module = port_module(name)
    opt = opt_state_from_reference(model.cfg, jax.tree.map(np.asarray, ropt))
    return rp, ropt, model, module, opt


def test_checkpoint_manifest_and_files_equal_reference():
    """The reference and the port save the same state: the same manifest
    (paths, shapes, dtypes, file names, in the same order) and the same
    bytes in every file, bf16 leaves included."""
    from repro.train import checkpoint as RC
    rp, ropt, model, module, opt = _reference_bf16_state()
    with tempfile.TemporaryDirectory() as d:
        RC.save(os.path.join(d, "ref"), 9, params=rp, opt_state=ropt, extra={"a": 1})
        C.save(os.path.join(d, "port"), 9, params=module, opt_state=opt, extra={"a": 1})
        rdir, pdir = (os.path.join(d, x, "step_00000009") for x in ("ref", "port"))
        with open(os.path.join(rdir, "manifest.json")) as f:
            rman = f.read()
        with open(os.path.join(pdir, "manifest.json")) as f:
            pman = f.read()
        assert pman == rman
        assert '"dtype": "bfloat16"' in pman
        for fname in sorted(os.listdir(rdir)):
            with open(os.path.join(rdir, fname), "rb") as a, \
                    open(os.path.join(pdir, fname), "rb") as b:
                assert a.read() == b.read(), fname


def test_checkpoint_crosses_both_ways_bitwise():
    """The reference saves and the port restores into a fresh module and opt
    state; the port saves and the reference's ``restore(like=)`` reads it.
    bf16 leaves come back from the reference's restore as 2-byte void
    arrays (a fault of the reference, kept): their bits are compared."""
    from repro.train import checkpoint as RC
    rp, ropt, model, module, opt = _reference_bf16_state()
    fresh = model.build("cpu")
    fresh_opt = O.init_opt_state(fresh, dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as d:
        RC.save(d, 4, params=rp, opt_state=ropt)
        out = C.restore(d, 4, like={"params": fresh, "opt_state": fresh_opt})
        assert out["step"] == 4 and out["params"] is fresh
        for k, p in module.named_parameters():
            assert np.array_equal(_bits(dict(fresh.named_parameters())[k]), _bits(p)), k
            assert np.array_equal(_bits(fresh_opt["m"][k]), _bits(opt["m"][k])), k
            assert np.array_equal(_bits(fresh_opt["v"][k]), _bits(opt["v"][k])), k
        assert int(fresh_opt["step"]) == int(ropt["step"]) == 5
    with tempfile.TemporaryDirectory() as d:
        C.save(d, 6, params=module, opt_state=opt)
        back = RC.restore(d, 6, like={"params": rp, "opt_state": ropt})
        got, want = _ref_flat({"params": back["params"], "opt_state": back["opt_state"]}), \
            _ref_flat({"params": rp, "opt_state": ropt})
        assert list(got) == list(want)
        kinds = set()
        for path in want:
            kinds.add(np.asarray(got[path]).dtype.kind)
            assert np.array_equal(_bits(got[path]), _bits(want[path])), path
        assert "V" in kinds
        raw = C.restore(d, 6)
        assert raw["params"]["units"]["l0"]["ln"]["scale"].dtype == torch.bfloat16


# --- gradient compression -----------------------------------------------------------


def test_quantize_roundtrip_error_bound():
    x_np = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    x = torch.from_numpy(x_np)
    q, s = GC.quantize_int8(x)
    err = (GC.dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) / 2 + 1e-6
    from repro.train import compression as RGC
    rq, rs = RGC.quantize_int8(jnp.asarray(x_np))
    assert np.array_equal(q.numpy(), np.asarray(rq)) and float(s) == float(rs)


def test_error_feedback_unbiased_over_steps():
    """With error feedback, the accumulated compressed sum converges to the
    accumulated true sum (residual stays bounded), as in the reference."""
    from repro.train import compression as RGC
    g_np = np.random.default_rng(1).standard_normal(256).astype(np.float32) * 1e-3
    g = torch.from_numpy(g_np)
    r, acc = torch.zeros(256), torch.zeros(256)
    rr, racc = jnp.zeros(256), jnp.zeros(256)
    for _ in range(50):
        q, s, r = GC.compress_residual(g, r)
        acc = acc + GC.dequantize_int8(q, s)
        rq, rs, rr = RGC.compress_residual(jnp.asarray(g_np), rr)
        racc = racc + RGC.dequantize_int8(rq, rs)
        assert np.array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(acc.numpy(), 50 * g_np, atol=2 * float(s))
    np.testing.assert_allclose(acc.numpy(), np.asarray(racc), rtol=1e-6, atol=1e-9)


def test_psum_compressed_single_device():
    """One shard: the compressed mean against the reference's shard_map on
    one device (bitwise) and the plain gradient (2e-2)."""
    from jax.sharding import Mesh, PartitionSpec as RP
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from repro.train import compression as RGC
    g_np = {"w": np.random.default_rng(2).standard_normal(64).astype(np.float32)}
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    rg = jax.tree.map(jnp.asarray, g_np)
    rout, rr2 = shard_map(lambda g, r: RGC.psum_compressed(g, r, "dp"), mesh=mesh,
                          in_specs=(RP(), RP()), out_specs=(RP(), RP()))(
        rg, RGC.init_residuals(rg))
    g = {k: torch.from_numpy(v) for k, v in g_np.items()}
    out, r2 = GC.psum_compressed([g], [GC.init_residuals(g)])
    np.testing.assert_allclose(out["w"].numpy(), g_np["w"], atol=2e-2)
    assert np.array_equal(out["w"].numpy(), np.asarray(rout["w"]))
    assert np.array_equal(r2[0]["w"].numpy(), np.asarray(rr2["w"]))


def test_psum_compressed_four_shards_matches_numpy_emulation():
    """Four CPU shards with residuals against a numpy emulation of the
    reference's per-leaf body (shared scale = max over shards, int8 sum
    in int32, mean, new residuals)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (33,), "b": (4, 5)}
    gs = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
          for _ in range(4)]
    rs = [{k: (rng.standard_normal(s) * 1e-2).astype(np.float32) for k, s in shapes.items()}
          for _ in range(4)]
    out, new_r = GC.psum_compressed([{k: torch.from_numpy(v) for k, v in g.items()} for g in gs],
                                    [{k: torch.from_numpy(v) for k, v in r.items()} for r in rs])
    for k in shapes:
        corrected = [g[k] + r[k] for g, r in zip(gs, rs)]
        amax = np.float32(max(np.abs(c).max() for c in corrected))
        scale = np.float32(max(amax, np.float32(1e-12)) / np.float32(127.0))
        qs = [np.clip(np.round(c / scale), -127, 127).astype(np.int8) for c in corrected]
        acc = np.sum([q.astype(np.int32) for q in qs], axis=0)
        mean = acc.astype(np.float32) * scale / np.float32(4)
        np.testing.assert_array_equal(out[k].numpy(), mean)
        for i in range(4):
            np.testing.assert_array_equal(new_r[i][k].numpy(),
                                          corrected[i] - qs[i].astype(np.float32) * scale)
    assert GC.compression_ratio(out) == 4.0
    assert GC.init_residuals(out)["b"].shape == (4, 5)


# --- trainer -------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_remat_modes_give_equal_grads(name):
    """remat none / full / dots: equal loss and grads (bitwise on the
    host), and the same forward under no_grad."""
    from repro_torch.configs import reduced, smoke_batch
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = reduced(get_config(name), compute_dtype=torch.float32, remat=remat)
        model = Model(cfg)
        module = model.init(torch.Generator().manual_seed(0), device="cpu")
        batch = smoke_batch(cfg, torch.Generator().manual_seed(1))
        loss, _, grads = T.loss_and_grads(model, module, batch)
        with torch.no_grad():
            fwd = model.loss(module, batch)[0]
        out[remat] = (loss, grads, fwd)
    for remat in ("full", "dots"):
        loss, grads, fwd = out[remat]
        assert torch.equal(loss, out["none"][0]) and torch.equal(fwd, out["none"][2])
        assert all(torch.equal(grads[k], out["none"][1][k]) for k in grads), remat


def _qwen_f32():
    rm, rp = ref_params("qwen3-0.6b", "float32")
    model, module = port_module("qwen3-0.6b", "float32")
    return rm, rp, model, module


def test_microbatch_accumulation_matches_full_batch():
    """The reference's case in the port (loss rel 1e-5, parameters 5e-5),
    and the port's two-microbatch step against the reference's on the same
    parameters and batch (loss and grad_norm 1e-5 relative, parameters
    within 2 * lr: AdamW's first step is about lr * sign(g))."""
    from repro.configs import smoke_batch
    from repro.train.optimizer import OptimizerConfig, init_opt_state
    from repro.train.trainer import make_train_step
    rm, rp, model, module = _qwen_f32()
    batch = jax.tree.map(np.asarray, smoke_batch(rm.cfg, batch=4, seq=32))
    pbatch = {k: as_tensor(v) for k, v in batch.items()}
    ocfg = O.OptimizerConfig(lr=1e-3)
    state0 = {k: v.clone() for k, v in module.state_dict().items()}
    s1 = T.make_train_step(model, ocfg, microbatches=1, donate=False)
    s2 = T.make_train_step(model, ocfg, microbatches=2, donate=False)
    p1, _, m1 = s1(module, O.init_opt_state(module), pbatch)
    after1 = {k: v.clone() for k, v in p1.state_dict().items()}
    module.load_state_dict(state0)
    p2, opt2, m2 = s2(module, O.init_opt_state(module), pbatch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert max(float((after1[k] - v).abs().max()) for k, v in p2.state_dict().items()) < 5e-5
    rstep = make_train_step(rm, OptimizerConfig(lr=1e-3), microbatches=2, donate=False)
    rp2, _, rm2 = rstep(rp, init_opt_state(rp), jax.tree.map(jnp.asarray, batch))
    assert rel(m2["loss"], rm2["loss"]) <= 1e-5 and rel(m2["grad_norm"], rm2["grad_norm"]) <= 1e-5
    assert rel(m2["ce"], rm2["ce"]) <= 1e-5
    lr = float(rm2["lr"])
    want = lm_state_from_reference(model.cfg, jax.tree.map(np.asarray, rp2))
    assert max(float((v - want[k]).abs().max()) for k, v in p2.state_dict().items()) <= 2 * lr


def test_nan_loss_skips_the_update():
    """A non-finite loss keeps the parameters and the opt state (step
    included) and sets ``skipped``, as the reference's step does."""
    from repro.configs import smoke_batch
    from repro.train.optimizer import OptimizerConfig, init_opt_state
    from repro.train.trainer import make_train_step
    rm, rp, model, module = _qwen_f32()
    rp = dict(rp, ln_f={"scale": rp["ln_f"]["scale"].at[0].set(jnp.nan)})
    with torch.no_grad():
        module.ln_f.scale[0] = float("nan")
    batch = jax.tree.map(np.asarray, smoke_batch(rm.cfg))
    opt = O.init_opt_state(module)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    _, opt, met = T.make_train_step(model, O.OptimizerConfig(lr=1e-2))(
        module, opt, {k: as_tensor(v) for k, v in batch.items()})
    assert met["skipped"] is True and not bool(torch.isfinite(met["loss"]))
    assert int(opt["step"]) == 0
    assert all(torch.equal(v.isnan(), before[k].isnan()) and
               torch.equal(v.nan_to_num(), before[k].nan_to_num())
               for k, v in module.state_dict().items())
    assert all(not bool(m.any()) for m in opt["m"].values())
    _, ropt, rmet = make_train_step(rm, OptimizerConfig(lr=1e-2), donate=False)(
        rp, init_opt_state(rp), jax.tree.map(jnp.asarray, batch))
    assert bool(rmet["skipped"]) and int(ropt["step"]) == 0
    assert float(met["lr"]) == pytest.approx(float(rmet["lr"]))


def test_train_step_donate_has_no_effect():
    model, module = port_module("qwen3-0.6b", "float32")
    from repro_torch.configs import smoke_batch
    batch = smoke_batch(model.cfg, torch.Generator().manual_seed(0))
    state0 = {k: v.clone() for k, v in module.state_dict().items()}
    outs = []
    for donate in (True, False):
        module.load_state_dict(state0)
        p, opt, met = T.make_train_step(model, O.OptimizerConfig(), donate=donate)(
            module, O.init_opt_state(module), batch)
        outs.append(({k: v.clone() for k, v in p.state_dict().items()}, met["loss"]))
    assert torch.equal(outs[0][1], outs[1][1])
    assert all(torch.equal(outs[0][0][k], outs[1][0][k]) for k in outs[0][0])


def _loop(model, ckpt_dir, total, ckpt_every):
    from repro_torch.data.pipeline import pipeline_for
    return T.TrainLoop(model, O.OptimizerConfig(lr=3e-3, warmup_steps=3, total_steps=30),
                       T.TrainLoopConfig(total_steps=total, log_every=1,
                                         ckpt_every=ckpt_every, ckpt_dir=ckpt_dir),
                       pipeline_for(model.cfg, shape_batch=4, seq_len=64, device="cpu"))


def test_trainer_loss_decreases():
    """The reference's case through the port's TrainLoop on the host."""
    from repro_torch.configs import reduced
    model = Model(reduced(get_config("qwen3-0.6b")))
    with tempfile.TemporaryDirectory() as d:
        loop = _loop(model, d, 30, 30)
        loop.run(resume=False)
        losses = [loss for (_, loss, _) in loop.history]
        assert len(losses) == 30 and all(np.isfinite(losses))
        assert losses[-1] < 5.56  # below random-init CE (ln 256 = 5.545 + margin)
        assert C.available_steps(d) == [30]


def test_resume_reproduces_the_uninterrupted_losses_bitwise():
    """Save at step 3, restart from the checkpoint in a new loop: steps 4-6
    give the uninterrupted run's losses bit for bit (the data pipeline is a
    function of (seed, step), the state is restored whole)."""
    from repro_torch.configs import reduced
    model = Model(reduced(get_config("qwen3-0.6b")))
    with tempfile.TemporaryDirectory() as d:
        full = _loop(model, os.path.join(d, "a"), 6, 3)
        full.run(resume=False)
        os.makedirs(os.path.join(d, "b"))
        os.rename(os.path.join(d, "a", "step_00000003"), os.path.join(d, "b", "step_00000003"))
        resumed = _loop(model, os.path.join(d, "b"), 6, 3)
        _, opt, step = resumed.run(resume=True)
        assert step == 6 and int(opt["step"]) == 6
        assert [h[0] for h in resumed.history] == [4, 5, 6]
        assert [h[1] for h in resumed.history] == [h[1] for h in full.history[3:]]


def test_launch_train_first_step_equals_make_train_step():
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.launch import train as LT
    with tempfile.TemporaryDirectory() as d:
        out = LT.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", "2",
                       "--log-every", "1", "--ckpt-dir", d, "--batch", "4", "--seq", "32"])
        assert out["step"] == 2 and out["mesh"].shape == {"data": 1, "model": 1}
        assert int(out["opt_state"]["step"]) == 2 and C.available_steps(d) == [2]
    model = out["model"]
    module = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = pipeline_for(model.cfg, 4, 32, device="cpu").batch_at(0)
    ocfg = O.OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=2)
    _, _, met = T.make_train_step(model, ocfg)(module, O.init_opt_state(module), batch)
    assert out["loop"].history[0][1] == float(met["loss"])


def test_launch_train_refuses_model_parallel_on_one_device():
    from repro_torch.launch import train as LT
    with tempfile.TemporaryDirectory() as d, \
            pytest.raises(NotImplementedError, match="multi-card training"):
        LT.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", "1",
                 "--ckpt-dir", d, "--model-parallel", "2"])

