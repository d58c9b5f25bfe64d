"""Shared pieces of the ``test_torch_lm_*`` parity suites.

The reference's parameters are carried into the port's module through
``repro_torch.interop.lm_state_from_reference``, after each leaf is cast to
the dtype ``param_shapes()`` declares: the reference's ``dense_init``
returns f32 leaves under ``param_dtype=bfloat16`` (its numpy float64 scale
promotes), where the port keeps every parameter in ``param_dtype``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

ARCHS = ("gemma-7b", "qwen3-0.6b", "minicpm-2b", "glm4-9b", "pixtral-12b",
         "moonshot-v1-16b-a3b", "deepseek-v2-lite-16b", "mamba2-2.7b", "whisper-tiny",
         "jamba-1.5-large-398b")
TOKEN_ARCHS = tuple(a for a in ARCHS if a not in ("pixtral-12b", "whisper-tiny"))
MOE_ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b")

F32 = {"compute_dtype": "float32", "cache_dtype": "float32"}


def dtype_name(d) -> str:
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    return np.dtype(d).name


def config_fields(cfg) -> dict:
    """A config as plain data: nested configs as dicts, dtypes by name."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = config_fields(v)
        elif f.name.endswith("_dtype"):
            v = dtype_name(v)
        out[f.name] = v
    return out


def spec_tree(tree) -> dict:
    """{path: (shape, dtype name)} of a reference (ShapeDtypeStruct) or port
    (TensorSpec) tree."""
    import jax
    from repro_torch.utils.tree import TensorSpec, flatten_with_paths
    if any(isinstance(leaf, TensorSpec) for _, leaf in flatten_with_paths(tree)):
        return {p: (tuple(s.shape), dtype_name(s.dtype)) for p, s in flatten_with_paths(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(s.shape), dtype_name(s.dtype)) for path, s in flat}


def rj(fn, **static):
    """``fn`` jitted with ``static`` bound: the reference runs one compiled
    graph instead of many eager dispatches (several times faster here)."""
    import jax
    return jax.jit(functools.partial(fn, **static))


def _dtypes(kw: dict, lib: str) -> dict:
    import jax.numpy as jnp
    mod = jnp if lib == "jax" else torch
    return {k: getattr(mod, v) if k.endswith("_dtype") else v for k, v in kw.items()}


def configs(name: str, reduced: bool = True, **over):
    """(reference config, port config) of ``name``; ``over`` values of
    ``*_dtype`` fields are dtype names."""
    from repro.configs import reduced as ref_reduced
    from repro.models.registry import get_config as ref_get
    from repro_torch.configs import reduced as port_reduced
    from repro_torch.models.registry import get_config as port_get
    if reduced:
        return (ref_reduced(ref_get(name), **_dtypes(over, "jax")),
                port_reduced(port_get(name), **_dtypes(over, "torch")))
    return ref_get(name, **_dtypes(over, "jax")), port_get(name, **_dtypes(over, "torch"))


@functools.lru_cache(maxsize=None)
def _ref_tree(name: str, seed: int):
    import jax
    from repro.models.registry import Model
    model = Model(configs(name)[0])
    params = jax.jit(model.init)(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a, s: a.astype(s.dtype), params, model.param_shapes())


def ref_params(name: str, compute: str = "bfloat16", seed: int = 0):
    """The reference's reduced model at ``compute`` (compute and cache
    dtype) and its parameters, cast to the dtypes its ``param_shapes``
    declares (the same tree at every compute dtype)."""
    from repro.models.registry import Model
    rcfg, _ = configs(name, compute_dtype=compute, cache_dtype=compute)
    return Model(rcfg), _ref_tree(name, seed)


def port_module(name: str, compute: str = "bfloat16", seed: int = 0):
    """The port's reduced model and its module on the host, holding the
    parameters of ``ref_params``."""
    import jax
    from repro_torch.interop import lm_state_from_reference
    from repro_torch.models.registry import Model
    _, cfg = configs(name, compute_dtype=compute, cache_dtype=compute)
    _, rp = ref_params(name, compute, seed)
    model = Model(cfg)
    module = model.build("cpu")
    module.load_state_dict(lm_state_from_reference(cfg, jax.tree.map(np.asarray, rp)))
    return model, module


def np_inputs(cfg, batch: int, seq: int, seed: int = 0) -> dict:
    """Seeded numpy inputs of the config's kind: tokens, embeds (f32) and,
    for encdec, encoder embeds."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    elif cfg.input_mode == "embeds":
        out["embeds"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    return out


def as_ref(a: np.ndarray):
    import jax.numpy as jnp
    return jnp.asarray(a)


def as_port(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if not t.is_floating_point() else t


def rel(got, want) -> float:
    """max|got - want| / max|want| in f64."""
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / max(1e-300, np.abs(w).max()))
