"""Shared building blocks of every model family.

Parameters live in ``nn.Module``s under the reference's names (``scale``,
``table``, ``wi_gate`` ...), in the reference's ``(d_in, d_out)``
orientation (a block computes ``x @ w``), so a reference parameter tree
carries across as a copy (``interop.lm_state_from_reference``).  Every block
has an ``apply`` function that takes its module where the reference takes
its parameter dict.  Parameters stay in ``param_dtype`` and are cast to
``compute_dtype`` on entry to each block -- the reference's mixed-precision
policy.  Where the reference asks XLA for an f32 result of a low-precision
product (``preferred_element_type``) the port multiplies the rounded
operands in f32: the same exact products, summed in f32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# parameters and init
# ---------------------------------------------------------------------------


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialized parameter (``Model.init`` fills it)."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device))


@torch.no_grad()
def dense_(w: torch.Tensor, gen: torch.Generator, scale: float | None = None):
    """Normal init scaled by 1/sqrt(d_in), d_in the second-to-last axis
    (a dense (d_in, d_out) weight or a stack of expert weights)."""
    s = scale if scale is not None else 1.0 / np.sqrt(w.shape[-2])
    w.normal_(generator=gen).mul_(s)


def init_module(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` from ``gen``: each block's
    ``reset_parameters(gen)``, in registration order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(gen)
    return module


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = param((d,), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.scale.fill_(1.0)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.table = param((vocab, d), dtype, device)

    def reset_parameters(self, gen):
        dense_(self.table, gen, 0.02)


class MLP(nn.Module):
    """Gated MLP weights (SwiGLU / GeGLU)."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32, device=None):
        super().__init__()
        self.wi_gate = param((d_model, d_ff), dtype, device)
        self.wi_up = param((d_model, d_ff), dtype, device)
        self.wo = param((d_ff, d_model), dtype, device)

    def reset_parameters(self, gen):
        for w in (self.wi_gate, self.wi_up, self.wo):
            dense_(w, gen)


# ---------------------------------------------------------------------------
# embed / unembed
# ---------------------------------------------------------------------------


def apply_embed(p: Embed, tokens: torch.Tensor, compute_dtype=torch.bfloat16):
    return p.table[tokens].to(compute_dtype)


def apply_unembed(p: Embed, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """Logits in f32 (softmax stability)."""
    return x.to(compute_dtype).float() @ p.table.to(compute_dtype).float().T


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def apply_rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p.scale.float()).to(x.dtype)


def qk_norm_apply(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """Per-head RMS norm on q / k (Qwen3-style); x: (..., n_heads, head_dim)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding (split halves, not interleaved)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: (..., seq, n_heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = torch.tensor(rope_frequencies(hd, theta), dtype=torch.float32, device=x.device)
    angles = positions[..., :, None].float() * freqs          # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def apply_mlp(p: MLP, x: torch.Tensor, act: str = "silu", compute_dtype=torch.bfloat16):
    xc = x.to(compute_dtype)
    g = xc @ p.wi_gate.to(compute_dtype)
    u = xc @ p.wi_up.to(compute_dtype)
    # jax.nn.gelu defaults to its tanh approximation
    g = F.gelu(g, approximate="tanh") if act == "gelu" else F.silu(g)
    return (g * u) @ p.wo.to(compute_dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_id: int = -1, z_loss: float = 0.0):
    """Mean CE over non-ignored positions; logits f32 (B, S, V)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse.square()
    mask = (labels != ignore_id).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def causal_mask(s_q: int, s_k: int, q_offset=0, device=None) -> torch.Tensor:
    """(s_q, s_k) additive mask; q_offset shifts query positions (decode)."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return torch.where(kj <= qi, 0.0, NEG_INF).float()


def sliding_mask(s_q: int, s_k: int, window: int, q_offset=0, device=None) -> torch.Tensor:
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    ok = (kj <= qi) & (kj > qi - window)
    return torch.where(ok, 0.0, NEG_INF).float()
