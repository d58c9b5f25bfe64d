"""Config substrate: assigned input shapes, input_specs(), reduced configs.

The four assigned LM shapes (each cell of the 10x4 grid):

    train_4k     seq 4096,    global_batch 256   (training step)
    prefill_32k  seq 32768,   global_batch 32    (inference prefill)
    decode_32k   seq 32768,   global_batch 128   (one token, 32k KV cache)
    long_500k    seq 524288,  global_batch 1     (one token, 500k context)

``decode_*`` / ``long_*`` are one new token against a KV cache of seq_len;
``long_500k`` applies only to sub-quadratic archs (ssm / hybrid).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..models.transformer import ModelConfig
from ..utils.hw import default_device
from ..utils.tree import TensorSpec

SDS = TensorSpec


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Assignment skip rules."""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention -> skipped")
    return True, ""


def input_specs(cfg: ModelConfig, shape: str, batch: int | None = None) -> dict:
    """TensorSpec stand-ins for every input of the step, at the shape's
    global batch or at ``batch`` (one device's share of it).

    train  -> {"batch": {...}}
    prefill-> {"batch": {...}, "cache": tree}
    decode -> {"cache": tree, "token": ..., "pos": ...}
    """
    from ..models.registry import Model

    spec = SHAPES[shape]
    B, S = spec.global_batch if batch is None else batch, spec.seq_len
    model = Model(cfg)
    toks = SDS((B, S), torch.int32)
    embeds = SDS((B, S, cfg.d_model), torch.bfloat16)
    if spec.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            batch = {"enc_embeds": embeds, "tokens": toks}
        elif cfg.input_mode == "embeds":
            batch = {"embeds": embeds}
        else:
            batch = {"tokens": toks}
        if spec.kind == "train":
            return {"batch": {**batch, "labels": SDS((B, S), torch.int32)}}
        return {"batch": batch, "cache": model.cache_shape(B, S)}
    cache = model.cache_shape(B, S)
    if cfg.family == "encdec":
        cache = {"dec": cache, "enc_out": SDS((B, min(S, 4096), cfg.d_model), torch.bfloat16)}
    token = (SDS((B, cfg.d_model), torch.bfloat16) if cfg.input_mode == "embeds"
             else SDS((B,), torch.int32))
    return {"cache": cache, "token": token, "pos": SDS((), torch.int32)}


# ---------------------------------------------------------------------------
# reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig, **extra) -> ModelConfig:
    """Small same-family config: few layers, narrow width, tiny vocab."""
    from ..models.attention import MLAConfig
    from ..models.mamba2 import SSMConfig
    from ..models.moe import MoEConfig

    kw: dict = dict(
        n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16, d_ff=128, vocab=256,
        q_chunk=64, k_chunk=64, remat="none",
    )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(d_model=64, n_heads=4, kv_lora=32, rope_dim=8,
                              nope_dim=16, v_dim=16)
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_expert=32,
                              n_shared=min(1, cfg.moe.n_shared),
                              capacity_factor=2.0)
        kw["first_dense"] = min(cfg.first_dense, 1)
        kw["dense_ff"] = 128 if cfg.first_dense else 0
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                              chunk=32)
    if cfg.family == "hybrid":
        kw["n_layers"] = 4
        kw["hybrid_period"] = 4
        kw["hybrid_attn_idx"] = 2
    if cfg.family == "encdec":
        kw["n_enc_layers"] = 2
    kw.update(extra)
    return dataclasses.replace(cfg, **kw)


def smoke_batch(cfg: ModelConfig, generator: torch.Generator | None = None,
                batch: int = 2, seq: int = 32, device=None) -> dict:
    """Random tokens, labels (and embeds) of the config's inputs, drawn from
    ``generator`` (default: seeded 0 on ``device``, default the card)."""
    if generator is None:
        generator = torch.Generator(device=default_device(device)).manual_seed(0)
    dev = generator.device
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=generator, device=dev)
    labels = torch.randint(0, cfg.vocab, (batch, seq), generator=generator, device=dev)
    if cfg.family == "encdec" or cfg.input_mode == "embeds":
        emb = torch.randn((batch, seq, cfg.d_model), generator=generator,
                          device=dev).to(torch.bfloat16)
        if cfg.family == "encdec":
            return {"enc_embeds": emb, "tokens": toks, "labels": labels}
        return {"embeds": emb, "labels": labels}
    return {"tokens": toks, "labels": labels}
