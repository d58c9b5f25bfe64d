"""Unified decoder stack for every LM family of the registry.

One repeating **unit** (a layer, or a hybrid super-block of ``period``
layers) is applied over the depth: the reference scans stacked parameters,
the port loops over an ``nn.ModuleList`` of units.  Parameter specs and
caches keep the reference's stacked layout (``units`` leaves carry a
leading n_units axis); a unit reads its cache as views of those tensors and
writes them in place.

Families:
  dense   : [attn + gated-MLP] x L            (gemma/qwen3/minicpm/glm4/pixtral)
  moe     : [attn + MoE] x L (leading ``first_dense`` layers use a dense MLP)
  ssm     : [mamba2] x L                       (attention-free)
  hybrid  : [(period-1) mamba2 + 1 attn; alternating MoE/MLP] x (L/period)
  encdec  : see whisper.py

The attention flavour is GQA by default, MLA when ``cfg.mla`` is set.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch
import torch.utils.checkpoint
from torch import nn

from . import attention as A
from . import mamba2 as M2
from . import moe as MOE
from ..utils.tree import TensorSpec, map_tree, stacked_tree
from .layers import (MLP, Embed, RMSNorm, apply_embed, apply_mlp, apply_rmsnorm,
                     apply_unembed, softmax_cross_entropy)

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma: x *= sqrt(d_model)
    window: int | None = None
    mla: A.MLAConfig | None = None
    moe: MOE.MoEConfig | None = None
    moe_every: int = 1
    first_dense: int = 0
    dense_ff: int = 0                # FFN width of leading dense layers
    ssm: M2.SSMConfig | None = None
    hybrid_period: int = 8
    hybrid_attn_idx: int = 4
    n_enc_layers: int = 0
    input_mode: str = "tokens"       # tokens | embeds (stub frontends feed embeds)
    q_chunk: int = 1024
    k_chunk: int = 1024
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # remat takes effect in lm_forward / whisper (remat_call); the rest are
    # data for the sharding rules and the dry-run, as in the reference
    remat: str = "full"              # none | full | dots
    cache_dtype: Any = torch.bfloat16
    scan_unroll: int = 1
    fsdp: bool = False
    opt_dtype: Any = torch.float32
    shard_profile: str = "default"
    kv_seq_shard_threshold: int = 8192
    # doc fields
    source: str = ""
    notes: str = ""

    @property
    def attn(self) -> A.AttnConfig:
        return A.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.head_dim, self.rope_theta, self.qk_norm, self.window)

    @property
    def n_units(self) -> int:
        if self.family == "hybrid":
            return self.n_layers // self.hybrid_period
        return self.n_layers - self.first_dense

    def active_params_per_layer(self) -> float:
        """Active (per-token) parameter count of one repeating layer."""
        D, hd = self.d_model, self.head_dim
        if self.mla:
            m = self.mla
            attn = D * self.n_heads * (m.nope_dim + m.rope_dim) + D * (m.kv_lora + m.rope_dim) \
                + m.kv_lora * self.n_heads * (m.nope_dim + m.v_dim) + self.n_heads * m.v_dim * D
        else:
            attn = D * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * D
        if self.family == "ssm":
            return _ssm_params(self.ssm)
        if self.moe is not None:
            ff = 3 * D * self.moe.d_expert * (self.moe.top_k + self.moe.n_shared) \
                + D * self.moe.n_experts
        else:
            ff = 3 * D * self.d_ff
        return attn + ff


def _ssm_params(s: M2.SSMConfig) -> float:
    di = s.d_inner
    return (s.d_model * (2 * di + 2 * s.d_state + s.n_heads)
            + s.conv_dim * s.d_conv + di * s.d_model + 3 * s.n_heads + di)


def active_param_count(cfg: ModelConfig) -> float:
    """6*N_active FLOPs/token uses this N (embeddings excluded, unembed included)."""
    n = 0.0
    if cfg.family == "hybrid":
        per = cfg.hybrid_period
        for i in range(per):
            if i == cfg.hybrid_attn_idx:
                attn = cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
                    + cfg.n_heads * cfg.head_dim * cfg.d_model
            else:
                attn = _ssm_params(cfg.ssm)
            if cfg.moe is not None and i % 2 == 1:
                ff = 3 * cfg.d_model * cfg.moe.d_expert * cfg.moe.top_k
            else:
                ff = 3 * cfg.d_model * cfg.d_ff
            n += attn + ff
        n *= cfg.n_layers // per
    else:
        n = cfg.active_params_per_layer() * (cfg.n_layers - cfg.first_dense)
        if cfg.first_dense:
            D = cfg.d_model
            attn = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
                + cfg.n_heads * cfg.head_dim * D
            if cfg.mla:
                m = cfg.mla
                attn = D * cfg.n_heads * (m.nope_dim + m.rope_dim) + D * (m.kv_lora + m.rope_dim) \
                    + m.kv_lora * cfg.n_heads * (m.nope_dim + m.v_dim) + cfg.n_heads * m.v_dim * D
            n += cfg.first_dense * (attn + 3 * D * (cfg.dense_ff or cfg.d_ff))
    n += cfg.d_model * cfg.vocab  # unembed matvec
    return n


# ---------------------------------------------------------------------------
# layers and units
# ---------------------------------------------------------------------------


class AttnLayer(nn.Module):
    """Pre-norm attention + FFN (a dense MLP or a MoE)."""

    def __init__(self, cfg: ModelConfig, *, ffn: str, d_ff: int, dtype, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, dtype, device)
        self.attn = (A.MLA(cfg.mla, dtype, device) if cfg.mla is not None
                     else A.GQA(cfg.attn, dtype, device))
        self.ln_ffn = RMSNorm(cfg.d_model, dtype, device)
        if ffn == "moe":
            self.moe = MOE.MoE(cfg.d_model, cfg.moe, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, d_ff, dtype, device)


class SSMLayer(nn.Module):
    """Pre-norm Mamba-2; inside a hybrid unit also its FFN (``ffn``)."""

    def __init__(self, cfg: ModelConfig, dtype, device=None, *, ffn: str | None = None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, dtype, device)
        self.ssm = M2.SSM(cfg.ssm, dtype, device)
        if ffn is not None:
            self.ln_ffn = RMSNorm(cfg.d_model, dtype, device)
            if ffn == "moe":
                self.moe = MOE.MoE(cfg.d_model, cfg.moe, dtype, device)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)


def _hybrid_ffn(cfg: ModelConfig, i: int) -> str:
    return "moe" if (cfg.moe is not None and i % 2 == 1) else "mlp"


def make_unit(cfg: ModelConfig, dtype, device=None) -> nn.Module:
    if cfg.family in ("dense", "moe"):
        return AttnLayer(cfg, ffn="moe" if cfg.family == "moe" else "mlp", d_ff=cfg.d_ff,
                         dtype=dtype, device=device)
    if cfg.family == "ssm":
        return SSMLayer(cfg, dtype, device)
    if cfg.family == "hybrid":
        return nn.ModuleDict({
            f"l{i}": (AttnLayer(cfg, ffn=_hybrid_ffn(cfg, i), d_ff=cfg.d_ff, dtype=dtype,
                                device=device) if i == cfg.hybrid_attn_idx
                      else SSMLayer(cfg, dtype, device, ffn=_hybrid_ffn(cfg, i)))
            for i in range(cfg.hybrid_period)})
    raise ValueError(cfg.family)


def _zero_aux(device) -> dict:
    return {"aux_loss": torch.zeros((), device=device),
            "router_z": torch.zeros((), device=device)}


def _add_aux(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def _attn_apply(p, x, cfg: ModelConfig, positions, cache, cache_pos):
    if cfg.mla is not None:
        return A.mla_apply(p, x, cfg.mla, positions, cache=cache, cache_pos=cache_pos,
                           q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
                           compute_dtype=cfg.compute_dtype)
    return A.gqa_apply(p, x, cfg.attn, positions, cache=cache, cache_pos=cache_pos,
                       q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
                       compute_dtype=cfg.compute_dtype)


def _ffn_apply(p, x, cfg: ModelConfig):
    """(h, aux) of the FFN of a layer that holds ``moe`` or ``mlp``."""
    if hasattr(p, "moe"):
        h, aux_m = MOE.moe_apply(p.moe, apply_rmsnorm(p.ln_ffn, x), cfg.moe,
                                 compute_dtype=cfg.compute_dtype)
        return h, {"aux_loss": aux_m["aux_loss"], "router_z": aux_m["router_z"]}
    h = apply_mlp(p.mlp, apply_rmsnorm(p.ln_ffn, x), act=cfg.act,
                  compute_dtype=cfg.compute_dtype).to(x.dtype)
    return h, _zero_aux(x.device)


def attn_layer_apply(p: AttnLayer, x, cfg: ModelConfig, positions, cache, cache_pos):
    h, cache = _attn_apply(p.attn, apply_rmsnorm(p.ln_attn, x), cfg, positions, cache,
                           cache_pos)
    x = x + h
    h, aux = _ffn_apply(p, x, cfg)
    return x + h, cache, aux


def ssm_layer_apply(p: SSMLayer, x, cfg: ModelConfig, cache):
    h, cache = M2.ssm_apply(p.ssm, apply_rmsnorm(p.ln, x), cfg.ssm, cache=cache,
                            compute_dtype=cfg.compute_dtype)
    return x + h, cache, _zero_aux(x.device)


def unit_apply(p, x, cfg: ModelConfig, positions, cache, cache_pos):
    """Returns (x, cache, aux)."""
    if cfg.family in ("dense", "moe"):
        return attn_layer_apply(p, x, cfg, positions, cache, cache_pos)
    if cfg.family == "ssm":
        return ssm_layer_apply(p, x, cfg, cache)
    if cfg.family == "hybrid":
        aux_t = _zero_aux(x.device)
        for i in range(cfg.hybrid_period):
            blk = p[f"l{i}"]
            sub = cache[f"l{i}"] if cache is not None else None
            if i == cfg.hybrid_attn_idx:
                x, _, aux = attn_layer_apply(blk, x, cfg, positions, sub, cache_pos)
            else:
                x, _, aux = ssm_layer_apply(blk, x, cfg, sub)
                h, aux = _ffn_apply(blk, x, cfg)
                x = x + h
            aux_t = _add_aux(aux_t, aux)
        return x, cache, aux_t
    raise ValueError(cfg.family)


def _kv_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    if cfg.mla is not None:
        return {"c_kv": TensorSpec((batch, max_len, cfg.mla.kv_lora), cfg.cache_dtype),
                "k_rope": TensorSpec((batch, max_len, cfg.mla.rope_dim), cfg.cache_dtype)}
    kv = TensorSpec((batch, max_len, cfg.n_kv_heads, cfg.head_dim), cfg.cache_dtype)
    return {"k": kv, "v": kv}


#: the products ``remat="dots"`` keeps (the reference's ``checkpoint_dots``
#: saves every ``dot_general``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    P = torch.utils.checkpoint.CheckpointPolicy
    return P.MUST_SAVE if op in _DOTS else P.PREFER_RECOMPUTE


def remat_call(fn, remat: str, *args):
    """``fn(*args)`` under the reference's activation checkpointing of a
    scanned unit (``remat``: "none" | "full" | "dots"): "full" keeps only
    the inputs and recomputes the unit in the backward pass, "dots" also
    keeps the matmul outputs.  Only while grad is enabled: serving, under
    ``no_grad``, runs ``fn`` as it is."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "full":
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        ctx = functools.partial(torch.utils.checkpoint.create_selective_checkpoint_contexts,
                                _dots_policy)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 context_fn=ctx)
    raise ValueError(f"remat must be none, full or dots, got {remat!r}")


def unit_cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """TensorSpec tree of one unit's cache."""
    if cfg.family in ("dense", "moe"):
        return _kv_spec(cfg, batch, max_len)
    if cfg.family == "ssm":
        return M2.ssm_cache_shape(cfg.ssm, batch, cfg.cache_dtype)
    if cfg.family == "hybrid":
        return {f"l{i}": (_kv_spec(cfg, batch, max_len) if i == cfg.hybrid_attn_idx
                          else M2.ssm_cache_shape(cfg.ssm, batch, cfg.cache_dtype))
                for i in range(cfg.hybrid_period)}
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def stack_specs(tree, n: int):
    return map_tree(lambda s: TensorSpec((n,) + s.shape, s.dtype), tree)


def unit_view(tree, i: int):
    """Unit ``i``'s slice of a stacked tree: views, written in place."""
    return map_tree(lambda t: t[i], tree)


def param_specs(module: nn.Module) -> dict:
    """The reference's parameter tree of ``module`` as TensorSpecs: nested
    dicts by name, ``head_layers`` a list, the ``STACKED`` lists stacked."""
    return stacked_tree({k: TensorSpec(t.shape, t.dtype) for k, t in module.state_dict().items()},
                        stack=lambda ss: TensorSpec((len(ss),) + ss[0].shape, ss[0].dtype))


class LM(nn.Module):
    """Parameters of a decoder LM under the reference's names."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.param_dtype
        self.embed = Embed(cfg.vocab, cfg.d_model, dt, device)
        self.ln_f = RMSNorm(cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            self.unembed = Embed(cfg.vocab, cfg.d_model, dt, device)
        if cfg.first_dense:
            self.head_layers = nn.ModuleList(
                AttnLayer(cfg, ffn="mlp", d_ff=cfg.dense_ff or cfg.d_ff, dtype=dt,
                          device=device) for _ in range(cfg.first_dense))
        self.units = nn.ModuleList(make_unit(cfg, dt, device) for _ in range(cfg.n_units))


def lm_param_shapes(cfg: ModelConfig) -> dict:
    return param_specs(LM(cfg, device="meta"))


def lm_cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    cache = {"units": stack_specs(unit_cache_shape(cfg, batch, max_len), cfg.n_units)}
    if cfg.first_dense:
        cache["head_layers"] = [_kv_spec(cfg, batch, max_len) for _ in range(cfg.first_dense)]
    return cache


def lm_forward(params: LM, cfg: ModelConfig, inputs, *, positions=None, cache=None,
               cache_pos=None):
    """inputs: tokens (B, S) integer or embeds (B, S, D).  Returns (logits
    (B, S, V) f32, cache, aux); ``cache`` (``lm_cache_shape``'s tree of
    tensors) is written in place at ``cache_pos``."""
    cd = cfg.compute_dtype
    if cfg.input_mode == "tokens" and not inputs.is_floating_point():
        x = apply_embed(params.embed, inputs, cd)
    else:
        x = inputs.to(cd)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cd, device=x.device)
    if positions is None:
        base = int(cache_pos) if cache_pos is not None else 0
        positions = base + torch.arange(x.shape[1], device=x.device)

    aux = _zero_aux(x.device)
    for i, blk in enumerate(params.head_layers if cfg.first_dense else ()):
        sub = cache["head_layers"][i] if cache is not None else None
        x, _, aux_i = attn_layer_apply(blk, x, cfg, positions, sub, cache_pos)
        aux = _add_aux(aux, aux_i)
    for i, unit in enumerate(params.units):
        sub = unit_view(cache["units"], i) if cache is not None else None
        x, _, aux_u = remat_call(
            lambda x_, u_, c_: unit_apply(u_, x_, cfg, positions, c_, cache_pos),
            cfg.remat, x, unit, sub)
        aux = _add_aux(aux, aux_u)

    x = apply_rmsnorm(params.ln_f, x)
    table = params.embed if cfg.tie_embeddings else params.unembed
    return apply_unembed(table, x, cd), cache, aux


def lm_loss(params: LM, cfg: ModelConfig, batch: dict):
    """batch: {"tokens" | "embeds", "labels"} -> (loss, metrics)."""
    inputs = batch["embeds"] if cfg.input_mode == "embeds" else batch["tokens"]
    logits, _, aux = lm_forward(params, cfg, inputs)
    ce = softmax_cross_entropy(logits, batch["labels"])
    loss = ce + aux["aux_loss"] + aux["router_z"]
    return loss, {"ce": ce, **aux}
