"""The port's LM examples (``repro_torch.examples.serve_sparse`` and
``train_lm``) on the host, held against the reference's library functions:
the reference's parameters are carried into the port's module
(``interop.lm_state_from_reference``), so the pruned weight, the advised
format, the modelled bytes and the greedy tokens compare side against
side; the training configs and the WSD schedule compare field by field and
step by step."""
import dataclasses
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_lm import config_fields  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import perfmodel as RPM  # noqa: E402
from repro.models import sparse as RSP  # noqa: E402
from repro.models.registry import Model as RefModel  # noqa: E402
from repro.models.registry import get_config as ref_config  # noqa: E402
from repro.train import optimizer as ROPT  # noqa: E402
from repro_torch.core import perfmodel as PM  # noqa: E402
from repro_torch.examples import serve_sparse as EX_SERVE  # noqa: E402
from repro_torch.examples import train_lm as EX_TRAIN  # noqa: E402
from repro_torch.interop import lm_state_from_reference  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.train.optimizer import schedule_lr  # noqa: E402

F32 = {"compute_dtype": "float32", "cache_dtype": "float32"}


# --- serve_sparse ---------------------------------------------------------------


def _ref_serve_config(**dtypes):
    """The reference example's config (``examples/serve_sparse.py:24``)."""
    return ref_reduced(ref_config("qwen3-0.6b"), d_model=128, d_ff=512, n_layers=2,
                       **{k: getattr(jnp, v) for k, v in dtypes.items()})


def _port_serve_config(**dtypes):
    return dataclasses.replace(EX_SERVE.model_config(),
                               **{k: getattr(torch, v) for k, v in dtypes.items()})


@functools.lru_cache(maxsize=None)
def _carried():
    """(reference model, its f32-compute params, port model, port module):
    the reference example's parameters, ``init(PRNGKey(0))``, carried across."""
    rm = RefModel(_ref_serve_config(**F32))
    rp = jax.jit(rm.init)(jax.random.PRNGKey(0))
    rp = jax.tree.map(lambda a, s: a.astype(s.dtype), rp, rm.param_shapes())
    model = Model(_port_serve_config(**F32))
    module = model.build("cpu")
    module.load_state_dict(lm_state_from_reference(model.cfg, jax.tree.map(np.asarray, rp)))
    return rm, rp, model, module


def test_serve_sparse_config_is_the_references():
    assert config_fields(EX_SERVE.model_config()) == config_fields(_ref_serve_config())
    full = EX_SERVE.model_config(full=True)
    assert config_fields(full) == config_fields(ref_config("qwen3-0.6b"))
    assert (full.d_model, full.d_ff, full.n_layers) == (1024, 3072, 28)


def test_serve_sparse_gate_matches_reference():
    rm, rp, model, module = _carried()
    w_ref = np.asarray(rp["units"]["mlp"]["wi_gate"][0]).T
    w = EX_SERVE.gate_weight(module)
    assert np.array_equal(w, w_ref) and w.shape == (512, 128)
    gate = EX_SERVE.sparse_gate(w, torch.device("cpu"), model.cfg.d_model)
    w_sparse_ref = RSP.magnitude_prune(w_ref, density=0.25, structured=(8, 128))
    assert np.array_equal(gate["w_sparse"], w_sparse_ref)
    rep_ref = RSP.sparsity_report(w_sparse_ref)
    assert gate["report"]["advised_format"] == rep_ref["advised_format"]
    assert gate["layer"].fmt == rep_ref["advised_format"]
    assert gate["rel_err"] <= 1e-5
    lin_ref = RSP.SparseLinear.from_dense(w_sparse_ref, fmt="auto", backend="ref")
    assert gate["streamed_bytes"] == lin_ref.streamed_bytes(RPM.TPU_FP32)


def test_line128_fp32_is_the_references_tpu_fp32():
    for f in ("value_bytes", "index_bytes", "line_elems", "invec_waste", "invec_reuse"):
        assert getattr(PM.LINE128_FP32, f) == getattr(RPM.TPU_FP32, f), f
    assert PM.LINE128_FP32.invec_waste == PM.LINE128_FP32.invec_reuse == 1.0


def test_serve_sparse_greedy_tokens_equal_reference_at_f32():
    from repro.serve.engine import Engine as RefEngine
    from repro.serve.engine import GenerationConfig as RefGen
    rm, rp, model, module = _carried()
    served = EX_SERVE.serve(model, module, torch.device("cpu"))
    want = RefEngine(rm, rp, batch_size=2, max_len=64).generate(
        served["prompts"], RefGen(max_new_tokens=12))
    assert served["outs"] == want and all(len(o) == 12 for o in want)
    assert served["decode_bytes_per_token"] == RefEngine(
        rm, rp, batch_size=2, max_len=64).decode_bytes_per_token()


def test_serve_sparse_main_on_the_host():
    res = EX_SERVE.main(["--device", "cpu"])
    assert res["gate"]["layer"].device == torch.device("cpu")
    assert res["gate"]["rel_err"] <= 1e-5
    assert [len(o) for o in res["outs"]] == [12, 12]
    assert res["engine"].generate(res["prompts"], res["gen_cfg"]) == res["outs"]


# --- train_lm -------------------------------------------------------------------


def _ref_train_config(tiny: bool):
    """The reference example's configs (``examples/train_lm.py:33-41``)."""
    cfg = ref_config("qwen3-0.6b")
    if tiny:
        return ref_reduced(cfg)
    return dataclasses.replace(
        cfg, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab=32768, remat="none", q_chunk=256, k_chunk=256)


@pytest.mark.parametrize("tiny", (False, True), ids=("100m", "tiny"))
def test_train_lm_configs_equal_reference(tiny):
    cfg, rcfg = EX_TRAIN.model_config(tiny), _ref_train_config(tiny)
    assert config_fields(cfg) == config_fields(rcfg)
    model, rmodel = Model(cfg), RefModel(rcfg)
    assert model.total_params() == rmodel.total_params()
    assert model.active_params() == rmodel.active_params()


@pytest.mark.parametrize("steps", (300, 60, 6))
def test_train_lm_wsd_schedule_equals_reference(steps):
    cfg = EX_TRAIN.optimizer_config(steps)
    rcfg = ROPT.OptimizerConfig(lr=6e-4, schedule="wsd", warmup_steps=steps // 10,
                                total_steps=steps, decay_frac=0.2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    got = np.array([float(schedule_lr(cfg, s)) for s in range(steps + 1)], np.float32)
    want = np.array([float(ROPT.schedule_lr(rcfg, jnp.asarray(s))) for s in range(steps + 1)],
                    np.float32)
    assert np.array_equal(got, want)


def test_train_lm_tiny_on_the_host(tmp_path):
    ckpt = tmp_path / "ckpt"
    res = EX_TRAIN.main(["--tiny", "--steps", "6", "--batch", "2", "--seq", "32",
                         "--device", "cpu", "--ckpt-dir", str(ckpt)])
    losses = res["losses"]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert res["step"] == 6 and [s for s, _, _ in res["loop"].history] == list(range(1, 7))
    assert any(ckpt.iterdir())
