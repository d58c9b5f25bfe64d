"""The port's model registry and configs against the reference's, for every
architecture: configs field by field, parameter, cache and input specs leaf
by leaf, parameter counts (full configs, arithmetic only), the tree
utilities, the parameter carry-over and ``Model.init``."""
import pytest

pytest.importorskip("jax")

import dataclasses  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_lm import (ARCHS, F32, MOE_ARCHS, as_port, as_ref, config_fields,  # noqa: E402
                       configs, np_inputs, port_module, ref_params, rel, rj, spec_tree)
from repro_torch.interop import lm_state_from_reference  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import whisper as W  # noqa: E402
from repro_torch.utils import tree as TREE  # noqa: E402

@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


# --- configs and specs ------------------------------------------------------------


def test_registry_names_equal_reference():
    from repro.models import registry as RR
    assert PR.get_config("qwen3-0.6b").name == RR.get_config("qwen3-0.6b").name
    assert PR.names() == RR.names() and set(PR.names()) == set(ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        PR.get_config("no-such-arch")


@pytest.mark.parametrize("name", ARCHS)
def test_configs_equal_reference(name):
    for reduced in (False, True):
        ref, port = configs(name, reduced)
        assert config_fields(port) == config_fields(ref)
    over = dict(moe_dispatch_groups=4, moe_gather_weights=1, q_chunk=32)
    from repro.models.registry import get_config as ref_get
    assert config_fields(PR.get_config(name, **over)) == config_fields(ref_get(name, **over))


@pytest.mark.parametrize("name", ARCHS)
def test_param_and_cache_specs_equal_reference(name):
    from repro.models.registry import Model as RModel
    for reduced in (False, True):
        rcfg, cfg = configs(name, reduced)
        rm, pm = RModel(rcfg), PR.Model(cfg)
        assert spec_tree(pm.param_shapes()) == spec_tree(rm.param_shapes())
        assert spec_tree(pm.cache_shape(3, 40)) == spec_tree(rm.cache_shape(3, 40))
        assert list(spec_tree(pm.param_shapes())) == list(spec_tree(rm.param_shapes()))
    shapes = PR.Model(configs(name)[1]).param_shapes()
    module = PR.Model(configs(name)[1]).build("cpu")
    assert TREE.param_count(module) == TREE.param_count(shapes)
    assert TREE.param_bytes(module) == TREE.param_bytes(shapes)


@pytest.mark.parametrize("name", ARCHS)
def test_full_param_counts_equal_reference(name):
    from repro.models.registry import Model as RModel
    rcfg, cfg = configs(name, reduced=False)
    assert PR.Model(cfg).total_params() == RModel(rcfg).total_params()
    assert PR.Model(cfg).active_params() == RModel(rcfg).active_params()


def test_qwen3_full_width_counts():
    model = PR.get("qwen3-0.6b")
    assert model.total_params() == 596_049_920
    assert TREE.param_bytes(model.param_shapes()) == 4 * 596_049_920


def test_input_specs_equal_reference():
    from repro.configs import base as RB
    from repro_torch.configs import base as PB
    assert {k: dataclasses.astuple(v) for k, v in PB.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in RB.SHAPES.items()}
    for name in ARCHS:
        rcfg, cfg = configs(name, reduced=False)
        for shape in PB.SHAPES:
            assert PB.shape_applicable(cfg, shape) == RB.shape_applicable(rcfg, shape)
            assert spec_tree(PB.input_specs(cfg, shape)) == spec_tree(RB.input_specs(rcfg, shape))


def test_tree_utilities_match_reference():
    from repro.utils import tree as RTREE
    rm, rp = ref_params("deepseek-v2-lite-16b")
    _, module = port_module("deepseek-v2-lite-16b")
    shapes = PR.Model(configs("deepseek-v2-lite-16b")[1]).param_shapes()
    assert TREE.param_count(shapes) == RTREE.param_count(rm.param_shapes())
    assert TREE.param_bytes(shapes) == RTREE.param_bytes(rm.param_shapes())
    assert [p for p, _ in TREE.flatten_with_paths(shapes)] == \
        [p for p, _ in RTREE.flatten_with_paths(rm.param_shapes())]
    assert float(TREE.global_norm(module)) == pytest.approx(
        float(RTREE.global_norm(rp)), rel=1e-6)
    assert not TREE.tree_any_nan(module) and not TREE.tree_any_nonfinite(module)
    bad = {"a": torch.ones(3), "b": [torch.tensor([1.0, float("inf")])]}
    assert TREE.tree_any_nonfinite(bad) and not TREE.tree_any_nan(bad)
    bad["b"].append(torch.tensor([float("nan")], dtype=torch.float64))
    assert TREE.tree_any_nan(bad)
    cast = TREE.cast_tree({"w": torch.ones(2), "i": torch.ones(2, dtype=torch.int32),
                           "s": TREE.TensorSpec((2,), torch.float32)}, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32
    assert cast["s"] == TREE.TensorSpec((2,), torch.bfloat16)


def test_lm_state_carries_bf16_bit_for_bit():
    rm, rp = ref_params("jamba-1.5-large-398b")
    _, module = port_module("jamba-1.5-large-398b")
    want = np.asarray(rp["units"]["l0"]["ssm"]["A_log"][0])
    got = module.units[0].l0.ssm.A_log
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    cfg = configs("jamba-1.5-large-398b")[1]
    with pytest.raises(ValueError, match="stacked entries"):
        lm_state_from_reference(dataclasses.replace(cfg, n_layers=8),
                                jax.tree.map(np.asarray, rp))


def test_model_init_is_seeded_and_needs_a_device():
    cfg = configs("qwen3-0.6b")[1]
    model = PR.Model(cfg)
    a = model.init(torch.Generator().manual_seed(3), device="cpu")
    b = model.init(torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())
    assert float(a.units[0].ln_attn.scale.min()) == 1.0
    assert float(a.embed.table.std()) == pytest.approx(0.02, rel=0.1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init_cache(2, 8)
    with pytest.raises(ValueError, match="generator"):
        model.init(SimpleNamespace(device=torch.device("cuda")), device="cpu")


def test_frontend_stubs_and_smoke_batch_match_reference_specs():
    from repro.configs import base as RB
    from repro.models import frontends as RF
    from repro_torch.configs import base as PB
    from repro_torch.models import frontends as PF
    gen = torch.Generator().manual_seed(5)
    vit = PF.vit_patch_embeddings_stub(gen, 2, 7, 16)
    audio = PF.audio_frame_embeddings_stub(torch.Generator().manual_seed(5), 2, 7, 16)
    want = RF.vit_patch_embeddings_stub(jax.random.PRNGKey(0), 2, 7, 16)
    assert tuple(vit.shape) == want.shape and str(vit.dtype) == f"torch.{want.dtype}"
    assert torch.equal(vit, audio) and float(vit.float().std()) == pytest.approx(1.0, rel=0.5)
    assert spec_tree({"e": PF.embeds_spec(2, 7, 16)}) == spec_tree({"e": RF.embeds_spec(2, 7, 16)})
    for name in ARCHS:
        rcfg, cfg = configs(name)
        got = PB.smoke_batch(cfg, torch.Generator().manual_seed(0), batch=2, seq=8)
        ref = RB.smoke_batch(rcfg, batch=2, seq=8)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
            == {k: (tuple(v.shape), str(v.dtype).replace("int32", "int64")) for k, v in ref.items()}
        assert int(got["labels"].max()) < cfg.vocab
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PB.smoke_batch(configs("qwen3-0.6b")[1])
