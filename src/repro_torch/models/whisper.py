"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

``configs.base.input_specs`` provides precomputed frame embeddings
(B, S, D) in place of the log-mel + conv frontend (see frontends.py).  The
backbone: a bidirectional encoder, a causal decoder with cross-attention;
rotary positions stand in for Whisper's learned / sinusoidal embeddings,
as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as A
from .layers import (MLP, Embed, RMSNorm, apply_embed, apply_mlp, apply_rmsnorm,
                     apply_unembed, softmax_cross_entropy)
from .transformer import ModelConfig, param_specs, remat_call, stack_specs, unit_view
from ..utils.tree import TensorSpec


class EncUnit(nn.Module):
    def __init__(self, cfg: ModelConfig, dt, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, dt, device)
        self.attn = A.GQA(cfg.attn, dt, device)
        self.ln_ffn = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class DecUnit(nn.Module):
    def __init__(self, cfg: ModelConfig, dt, device=None):
        super().__init__()
        self.ln_self = RMSNorm(cfg.d_model, dt, device)
        self.self_attn = A.GQA(cfg.attn, dt, device)
        self.ln_cross = RMSNorm(cfg.d_model, dt, device)
        self.cross_attn = A.GQA(cfg.attn, dt, device)
        self.ln_ffn = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.param_dtype
        self.embed = Embed(cfg.vocab, cfg.d_model, dt, device)
        self.enc_units = nn.ModuleList(EncUnit(cfg, dt, device)
                                       for _ in range(cfg.n_enc_layers))
        self.dec_units = nn.ModuleList(DecUnit(cfg, dt, device) for _ in range(cfg.n_layers))
        self.ln_enc = RMSNorm(cfg.d_model, dt, device)
        self.ln_f = RMSNorm(cfg.d_model, dt, device)


def encdec_param_shapes(cfg: ModelConfig) -> dict:
    return param_specs(EncDec(cfg, device="meta"))


def _mlp_residual(p, x, cfg: ModelConfig):
    h = apply_mlp(p.mlp, apply_rmsnorm(p.ln_ffn, x), act=cfg.act,
                  compute_dtype=cfg.compute_dtype).to(x.dtype)
    return x + h


def _remat(cfg: ModelConfig) -> str:
    """The reference checkpoints both stacks fully under "full" and "dots"."""
    return "full" if cfg.remat in ("full", "dots") else "none"


def encode(params: EncDec, cfg: ModelConfig, enc_embeds: torch.Tensor) -> torch.Tensor:
    """enc_embeds (B, Se, D) stub frame embeddings -> (B, Se, D)."""
    x = enc_embeds.to(cfg.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, u):
        h, _ = A.gqa_apply(u.attn, apply_rmsnorm(u.ln_attn, x), cfg.attn, positions,
                           causal=False, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
                           compute_dtype=cfg.compute_dtype)
        return _mlp_residual(u, x + h, cfg)

    for u in params.enc_units:
        x = remat_call(body, _remat(cfg), x, u)
    return apply_rmsnorm(params.ln_enc, x)


def decode(params: EncDec, cfg: ModelConfig, tokens, enc_out, *, cache=None, cache_pos=None):
    """tokens (B, S) -> (logits, cache).  ``cache`` ({"units": {"k", "v"}},
    stacked) holds the self-attention KV, written in place; cross-attention
    recomputes against ``enc_out`` (cache-free, O(Se) a step)."""
    x = apply_embed(params.embed, tokens, cfg.compute_dtype)
    base = int(cache_pos) if cache_pos is not None else 0
    positions = base + torch.arange(x.shape[1], device=x.device)

    def body(x, u, sub):
        h, _ = A.gqa_apply(u.self_attn, apply_rmsnorm(u.ln_self, x), cfg.attn, positions,
                           cache=sub, cache_pos=cache_pos, q_chunk=cfg.q_chunk,
                           k_chunk=cfg.k_chunk, compute_dtype=cfg.compute_dtype)
        x = x + h
        h, _ = A.gqa_apply(u.cross_attn, apply_rmsnorm(u.ln_cross, x), cfg.attn, positions,
                           causal=False, kv_input=enc_out, q_chunk=cfg.q_chunk,
                           k_chunk=cfg.k_chunk, compute_dtype=cfg.compute_dtype)
        return _mlp_residual(u, x + h, cfg)

    for i, u in enumerate(params.dec_units):
        sub = unit_view(cache["units"], i) if cache is not None else None
        x = remat_call(body, _remat(cfg), x, u, sub)
    x = apply_rmsnorm(params.ln_f, x)
    return apply_unembed(params.embed, x, cfg.compute_dtype), cache


def encdec_loss(params: EncDec, cfg: ModelConfig, batch: dict):
    enc_out = encode(params, cfg, batch["enc_embeds"])
    logits, _ = decode(params, cfg, batch["tokens"], enc_out)
    ce = softmax_cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce}


def encdec_cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    kv = TensorSpec((batch, max_len, cfg.n_kv_heads, cfg.head_dim), cfg.cache_dtype)
    return {"units": stack_specs({"k": kv, "v": kv}, cfg.n_layers)}
