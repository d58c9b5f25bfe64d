"""Model registry: a uniform API over every family.

``get(name)`` returns a ``Model`` whose methods are what the serving engine
(and the trainer and dry-run, in later slices) consume:

    init(generator, device=) / build(device) / param_shapes()
    loss(params, batch)                       -> (loss, metrics)
    prefill(params, batch, cache)             -> (last logits, cache)
    decode_step(params, cache, token, pos)    -> (logits, cache)
    cache_shape(batch_size, max_len) / init_cache(batch_size, max_len, device=)

``params`` is the model's ``nn.Module`` (``init`` or ``build`` makes it),
in the place of the reference's parameter tree.  Caches are trees of
tensors in the reference's layout, written in place.  Configs register
themselves through ``register`` when ``repro_torch.configs`` is imported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from . import transformer as T
from . import whisper as W
from .layers import init_module
from ..utils.hw import default_device
from ..utils.tree import map_tree, param_count

_REGISTRY: dict[str, Callable[[], "T.ModelConfig"]] = {}


def register(name: str, cfg_fn: Callable[[], "T.ModelConfig"]):
    _REGISTRY[name] = cfg_fn


def names() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str, **overrides) -> "T.ModelConfig":
    """The registered config ``name`` with ``overrides`` replaced; the MoE
    passthroughs ``moe_dispatch_groups`` / ``moe_gather_weights`` set the
    nested MoE config's fields."""
    if name not in _REGISTRY:
        from .. import configs  # noqa: F401  (registers the architectures)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {names()}")
    cfg = _REGISTRY[name]()
    mdg = overrides.pop("moe_dispatch_groups", None)
    if mdg is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               dispatch_groups=int(mdg)))
    mgw = overrides.pop("moe_gather_weights", None)
    if mgw is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, gather_weights=bool(int(mgw))))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


@dataclass
class Model:
    cfg: T.ModelConfig

    # --- params ---
    def build(self, device=None) -> nn.Module:
        """The model's module with uninitialized parameters on ``device``
        (default the card; ``"meta"`` allocates nothing)."""
        dev = default_device(device)
        if self.cfg.family == "encdec":
            return W.EncDec(self.cfg, device=dev)
        return T.LM(self.cfg, device=dev)

    def init(self, generator: torch.Generator | None = None, *, device=None) -> nn.Module:
        """The module with random parameters from ``generator`` (default: a
        generator seeded 0 on ``device``), on ``device`` (default the card).
        The draws are not ``jax.random``'s: a parity test carries the
        reference's parameters across (``interop.lm_state_from_reference``)."""
        dev = default_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif generator.device.type != dev.type:
            raise ValueError(f"the generator lives on {generator.device}; the model "
                             f"is built on {dev}")
        return init_module(self.build(dev), generator)

    def param_shapes(self) -> dict:
        if self.cfg.family == "encdec":
            return W.encdec_param_shapes(self.cfg)
        return T.lm_param_shapes(self.cfg)

    # --- training ---
    def loss(self, params, batch):
        if self.cfg.family == "encdec":
            return W.encdec_loss(params, self.cfg, batch)
        return T.lm_loss(params, self.cfg, batch)

    # --- serving ---
    def cache_shape(self, batch_size: int, max_len: int) -> dict:
        if self.cfg.family == "encdec":
            return W.encdec_cache_shape(self.cfg, batch_size, max_len)
        return T.lm_cache_shape(self.cfg, batch_size, max_len)

    def init_cache(self, batch_size: int, max_len: int, device=None) -> dict:
        dev = default_device(device)
        return map_tree(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                        self.cache_shape(batch_size, max_len))

    @torch.no_grad()
    def prefill(self, params, batch: dict, cache: dict):
        """batch: {"tokens" | "embeds" (+ "enc_embeds")}; cache: a zeroed
        cache of capacity max_len, written in place.  Returns (last-position
        logits, cache)."""
        if self.cfg.family == "encdec":
            enc_out = W.encode(params, self.cfg, batch["enc_embeds"])
            logits, cache = W.decode(params, self.cfg, batch["tokens"], enc_out,
                                     cache=cache, cache_pos=0)
            return logits[:, -1], {"dec": cache, "enc_out": enc_out}
        inputs = batch["embeds"] if self.cfg.input_mode == "embeds" else batch["tokens"]
        logits, cache, _ = T.lm_forward(params, self.cfg, inputs, cache=cache, cache_pos=0)
        return logits[:, -1], cache

    @torch.no_grad()
    def decode_step(self, params, cache: dict, token: torch.Tensor, pos: int):
        """token (B,) integer (or (B, D) embeds); pos: the write position.
        Returns (logits (B, V), cache)."""
        if self.cfg.family == "encdec":
            logits, dec = W.decode(params, self.cfg, token[:, None], cache["enc_out"],
                                   cache=cache["dec"], cache_pos=pos)
            return logits[:, -1], {"dec": dec, "enc_out": cache["enc_out"]}
        inputs = token[:, None, :] if self.cfg.input_mode == "embeds" else token[:, None]
        logits, cache, _ = T.lm_forward(params, self.cfg, inputs, cache=cache, cache_pos=pos)
        return logits[:, -1], cache

    # --- accounting ---
    def active_params(self) -> float:
        if self.cfg.family == "encdec":
            D = self.cfg.d_model
            attn = D * (self.cfg.n_heads + 2 * self.cfg.n_kv_heads) * self.cfg.head_dim \
                + self.cfg.n_heads * self.cfg.head_dim * D
            mlp = 3 * D * self.cfg.d_ff
            return (self.cfg.n_enc_layers * (attn + mlp)
                    + self.cfg.n_layers * (2 * attn + mlp)
                    + D * self.cfg.vocab)
        return T.active_param_count(self.cfg)

    def total_params(self) -> int:
        return param_count(self.param_shapes())


def get(name: str, **overrides) -> Model:
    return Model(get_config(name, **overrides))
