"""The port's sharding rules, meshes and data pipeline against the reference:
every rules case of ``tests/test_infra.py``, ``param_specs`` /
``zero1_specs`` (and their divisibility fallbacks) of all ten full configs
on both production meshes as strings, ``batch_specs`` / ``cache_specs``,
and the pipeline's batches bitwise."""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh as RAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as RP  # noqa: E402

from _torch_lm import ARCHS, configs  # noqa: E402
from repro_torch.data import pipeline as PP  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.models.registry import Model, get_config  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.sharding.rules import P  # noqa: E402
from repro_torch.utils.tree import TensorSpec, flatten_with_paths  # noqa: E402

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape=(16, 16), names=("data", "model")):
    return PM.AbstractMesh(shape, names)


def _ref_mesh(shape=(16, 16), names=("data", "model")):
    try:
        return RAbstractMesh(shape, names)
    except TypeError:  # older jax: AbstractMesh(((name, size), ...))
        return RAbstractMesh(tuple(zip(names, shape)))


def _strings(tree) -> dict:
    """{path: str(spec)} of a port or a reference tree of specs."""
    if any(isinstance(s, R.PartitionSpec) for _, s in flatten_with_paths(tree)):
        return {p: str(s) for p, s in flatten_with_paths(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, RP))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): str(s)
            for path, s in flat}


# --- the rules cases of tests/test_infra.py -------------------------------------


def test_param_rules_qwen3():
    model = Model(get_config("qwen3-0.6b"))
    specs = R.param_specs(model.param_shapes(), _mesh())
    assert specs["embed"]["table"] == P("model", None)
    # stacked units: leading layer axis unsharded, head dim sharded
    assert specs["units"]["attn"]["wq"] == P(None, None, "model")
    assert specs["units"]["attn"]["wo"] == P(None, "model", None)
    assert specs["units"]["mlp"]["wi_gate"] == P(None, None, "model")
    assert specs["units"]["ln_attn"]["scale"] == P(None, None)  # (L, D) stacked
    assert specs["units"]["ln_attn"]["scale"] != P()


def test_param_rules_divisibility_fallback():
    """A 24-wide dim on a 16-way model axis falls back to replicated."""
    from repro.sharding import rules as RR
    fb, rfb = [], []
    spec = R._resolve(("tp",), (24,), _mesh(), fb, "x")
    assert spec == P(None) and fb
    assert str(RR._resolve(("tp",), (24,), _ref_mesh(), rfb, "x")) == str(spec)
    assert fb == rfb


def test_zero1_adds_dp_axis():
    model = Model(get_config("qwen3-0.6b"))
    z = R.zero1_specs(model.param_shapes(), _mesh())
    assert "data" in str(z["units"]["mlp"]["wi_gate"])


def test_moe_expert_parallel_specs():
    model = Model(get_config("moonshot-v1-16b-a3b"))
    specs = R.param_specs(model.param_shapes(), _mesh())
    assert specs["units"]["moe"]["wi_gate"] == P(None, "model", None, None)


def test_cache_specs_kv_vs_ssm():
    mesh = _mesh()
    kv = {"k": TensorSpec((128, 32768, 16, 128), torch.bfloat16)}
    assert R.cache_specs(kv, mesh)["k"] == P("data", None, "model", None)
    ssm = {"ssm": TensorSpec((128, 80, 64, 128), torch.float32)}
    assert R.cache_specs(ssm, mesh)["ssm"] == P("data", "model", None, None)
    # long-context unshardable heads -> sequence parallel
    kv_long = {"k": TensorSpec((1, 524288, 8, 128), torch.bfloat16)}
    assert R.cache_specs(kv_long, mesh)["k"] == P(None, "model", None, None)


def test_batch_specs():
    mesh = _mesh()
    b = {"tokens": TensorSpec((256, 4096), torch.int32)}
    assert R.batch_specs(b, mesh)["tokens"] == P("data", None)
    b1 = {"tokens": TensorSpec((1, 4096), torch.int32)}
    assert R.batch_specs(b1, mesh)["tokens"] == P()


def test_partition_spec_prints_and_compares_as_jax():
    for entries in [(), (None,), ("model", None), (("pod", "data"), None, "model")]:
        assert str(P(*entries)) == str(RP(*entries)) == repr(P(*entries))
    assert P(None, None) != P() and P("model") == P("model") and len(P(None, "x")) == 2
    assert hash(P("model", None)) == hash(P("model", None))


# --- every full config on both production meshes ---------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_param_and_zero1_specs_equal_reference(name, mesh_name, capsys):
    from repro.models.registry import Model as RModel
    from repro.sharding import rules as RR
    shape, axes = MESHES[mesh_name]
    rcfg, cfg = configs(name, reduced=False)
    rshapes, shapes = RModel(rcfg).param_shapes(), Model(cfg).param_shapes()
    mesh, rmesh = _mesh(shape, axes), _ref_mesh(shape, axes)
    got, want = _strings(R.param_specs(shapes, mesh)), _strings(RR.param_specs(rshapes, rmesh))
    assert list(got.items()) == list(want.items())
    for profile in ("default", "dp_only", "moe2d"):
        got = _strings(R.zero1_specs(shapes, mesh, profile=profile))
        want = _strings(RR.zero1_specs(rshapes, rmesh, profile=profile))
        assert list(got.items()) == list(want.items()), profile
    # the divisibility fallbacks, as each package logs them
    capsys.readouterr()
    R.param_specs(shapes, mesh, log_fallbacks=True)
    port_log = capsys.readouterr().out
    RR.param_specs(rshapes, rmesh, log_fallbacks=True)
    assert port_log == capsys.readouterr().out


@pytest.mark.parametrize("name", ARCHS)
def test_batch_and_cache_specs_equal_reference(name):
    from repro.configs import input_specs as ref_inputs
    from repro.models.registry import Model as RModel
    from repro.sharding import rules as RR
    from repro_torch.configs import input_specs
    rcfg, cfg = configs(name, reduced=False)
    for mesh_name in sorted(MESHES):
        mesh, rmesh = _mesh(*MESHES[mesh_name]), _ref_mesh(*MESHES[mesh_name])
        for profile in ("default", "dp_only"):
            got = R.batch_specs(input_specs(cfg, "train_4k")["batch"], mesh, profile=profile)
            want = RR.batch_specs(ref_inputs(rcfg, "train_4k")["batch"], rmesh,
                                  profile=profile)
            assert _strings(got) == _strings(want)
        got = R.cache_specs(Model(cfg).cache_shape(128, 32768), mesh)
        want = RR.cache_specs(RModel(rcfg).cache_shape(128, 32768), rmesh)
        assert list(_strings(got).items()) == list(_strings(want).items())


def test_param_shardings_carry_mesh_and_spec():
    mesh = _mesh()
    shapes = Model(get_config("qwen3-0.6b")).param_shapes()
    sh = R.param_shardings(shapes, mesh)
    assert sh["embed"]["table"] == R.NamedSharding(mesh, P("model", None))


# --- meshes ------------------------------------------------------------------------


def test_production_meshes():
    m = PM.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    m2 = PM.make_production_mesh(multi_pod=True)
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512
    assert R.dp_axes(m2) == ("pod", "data")


def test_host_mesh_on_one_device_splits_nothing():
    """The design point: one card (here the host) -> a (1, 1) mesh on which
    every parameter and opt-state spec resolves to unsplit."""
    mesh = PM.make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert list(mesh.devices.flat) == [torch.device("cpu")]
    assert PM.make_host_mesh(model=4, device="cpu").shape == {"data": 1, "model": 1}
    shapes = Model(get_config("qwen3-0.6b")).param_shapes()
    for tree in (R.param_specs(shapes, mesh), R.zero1_specs(shapes, mesh)):
        specs = [s for _, s in flatten_with_paths(tree)]
        assert specs and not any(R.spec_splits(s, mesh) for s in specs)
    assert R.spec_splits(P(None, "model"), _mesh())


def test_host_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is over the cards")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.make_host_mesh()


# --- data pipeline --------------------------------------------------------------------


def test_pipeline_deterministic_skip_ahead():
    cfg = PP.PipelineConfig(vocab=1000, seq_len=16, global_batch=4, seed=7)
    p1, p2 = PP.TokenPipeline(cfg, device="cpu"), PP.TokenPipeline(cfg, device="cpu")
    p2.skip_to(5)
    for _ in range(5):
        p1.next_batch()
    b1, b2 = p1.next_batch(), p2.next_batch()
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert int(b1["tokens"].max()) < 1000 and b1["tokens"].dtype == torch.int32
    # labels are next-token shifted
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_pipeline_host_sharding():
    full = PP.TokenPipeline(PP.PipelineConfig(vocab=100, seq_len=8, global_batch=8, seed=1),
                            device="cpu")
    assert full.next_batch()["tokens"].shape == (8, 8)
    shard = PP.TokenPipeline(PP.PipelineConfig(vocab=100, seq_len=8, global_batch=8, seed=1,
                                               host_index=1, host_count=2), device="cpu")
    assert shard.next_batch()["tokens"].shape == (4, 8)


def _pipelines(name: str, host_index: int, host_count: int):
    """(reference, port) pipelines of ``name``'s reduced config's kind."""
    from repro.data import pipeline as RPP
    rcfg, cfg = configs(name)
    kw = dict(seq_len=24, global_batch=4, seed=3, host_index=host_index,
              host_count=host_count)
    rp, pp = RPP.PipelineConfig(vocab=rcfg.vocab, **kw), PP.PipelineConfig(vocab=cfg.vocab, **kw)
    if cfg.family == "encdec":
        return RPP.EncDecPipeline(rp, rcfg.d_model), PP.EncDecPipeline(pp, cfg.d_model, "cpu")
    if cfg.input_mode == "embeds":
        return RPP.EmbedsPipeline(rp, rcfg.d_model), PP.EmbedsPipeline(pp, cfg.d_model, "cpu")
    return RPP.TokenPipeline(rp), PP.TokenPipeline(pp, "cpu")


@pytest.mark.parametrize("host", ((0, 1), (1, 2)))
@pytest.mark.parametrize("name", ("qwen3-0.6b", "pixtral-12b", "whisper-tiny"))
def test_pipeline_batches_bitwise_equal_reference(name, host):
    """Every pipeline kind, several steps and a host shard: tokens, labels
    and bf16 embeddings bit for bit (torch's bf16 cast rounds to nearest
    even as ``ml_dtypes`` does)."""
    from repro.data import pipeline as RPP
    rcfg, cfg = configs(name)
    assert type(PP.pipeline_for(cfg, 4, 24, device="cpu")).__name__ == \
        type(RPP.pipeline_for(rcfg, 4, 24)).__name__
    ref, port = _pipelines(name, *host)
    for p in (ref, port):
        p.skip_to(2)
    for _ in range(3):
        rb, pb = ref.next_batch(), port.next_batch()
        assert sorted(rb) == sorted(pb)
        for k in rb:
            r = np.asarray(rb[k])
            if r.dtype.name == "bfloat16":
                assert pb[k].dtype == torch.bfloat16
                assert np.array_equal(pb[k].view(torch.int16).numpy(), r.view(np.int16)), k
            else:
                assert pb[k].dtype == torch.int32 and np.array_equal(pb[k].numpy(), r), k
    assert port.step == ref.step == 5


def test_pipeline_bf16_cast_rounds_as_ml_dtypes():
    """Ties (to even), subnormals, the largest finite value and infinities:
    torch's f32 -> bf16 cast gives the bits of ``jax.numpy.bfloat16``'s.  A
    NaN stays a NaN in both, with another payload (torch 0xFFFF, ml_dtypes
    0x7FC0); the pipeline draws none."""
    bits = np.array([0x3F808000, 0x3F818000, 0x3F80C000, 0x00000001, 0x807FFFFF,
                     0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x40490FDB], np.uint32)
    x = np.concatenate([bits.view(np.float32),
                        np.random.default_rng(0).standard_normal(4096).astype(np.float32)])
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    assert np.array_equal(got, np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16))
    assert torch.tensor([float("nan")]).to(torch.bfloat16).isnan().all()


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PP.TokenPipeline(PP.PipelineConfig(vocab=10, seq_len=4, global_batch=2))
