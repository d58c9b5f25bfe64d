"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch.

Dispatch is sort-based (tokens sorted by expert, a fixed per-expert
capacity ``C``), not a one-hot einsum, so the expert GEMMs do only useful
work and dispatch shows up as memory traffic.  Routing runs in f32.  The
expert GEMMs stay ``torch.einsum`` over the gathered tokens, as the
reference computes them outside any kernel; ``kernels.ops.grouped_gemm``
(kernel 7) is the grouped-GEMM entry, which no model calls.

The reference's dispatch scatters with ``.set`` onto duplicate indices:
every token past an expert's capacity is sent to slot ``C - 1`` with the pad
sentinel, after the token that rightly holds that slot, and XLA on the CPU
keeps the last write.  So an expert that overflows keeps ``C - 1`` tokens,
its slot ``C - 1`` holds the pad row with weight 0, and ``dropped_frac``
(counted before that overwrite) undercounts by those tokens.  The port
builds the dispatch from an explicit keep mask that gives the same result
on every device -- the write order of a duplicate-index scatter is
undefined on CUDA -- and reports the reference's ``dropped_frac``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, apply_mlp, dense_, param


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden dim
    n_shared: int = 0          # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss_coef: float = 1e-2
    # routing, sort and capacity run independently per group of tokens
    dispatch_groups: int = 16
    # a sharding constraint on the expert weights in the reference; one
    # card has no mesh, so it does nothing here
    gather_weights: bool = False


class MoE(nn.Module):
    def __init__(self, d_model: int, cfg: MoEConfig, dtype=torch.float32, device=None):
        super().__init__()
        E, F_ = cfg.n_experts, cfg.d_expert
        self.router = param((d_model, E), dtype, device)
        self.wi_gate = param((E, d_model, F_), dtype, device)
        self.wi_up = param((E, d_model, F_), dtype, device)
        self.wo = param((E, F_, d_model), dtype, device)
        if cfg.n_shared:
            self.shared = MLP(d_model, cfg.n_shared * F_, dtype, device)

    def reset_parameters(self, gen):
        dense_(self.router, gen, 0.02)
        for w in (self.wi_gate, self.wi_up, self.wo):   # scale 1/sqrt(d_in)
            dense_(w, gen)


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _moe_dispatch_group(p: MoE, xf: torch.Tensor, cfg: MoEConfig, C: int, compute_dtype):
    """Capacity-bounded sort dispatch for ONE token group: xf (Tg, D)."""
    Tg, D = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = xf.device
    xc = xf.to(compute_dtype)

    # routing (f32 for stability)
    logits = xf.float() @ p.router.float()                               # (Tg, E)
    probs = torch.softmax(logits, dim=-1)
    topw, tope = torch.topk(probs, K, dim=-1)                            # (Tg, K)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # aux losses (load balance + router z)
    flat_e = tope.reshape(-1)
    # per-expert counts with a static shape (no bincount), so that the step
    # also runs on the meta device
    counts = torch.zeros(E, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    me = probs.mean(dim=0)
    ce = counts.float() / (Tg * K)
    aux_loss = cfg.aux_loss_coef * E * torch.sum(me * ce)
    router_z = cfg.router_z_loss * torch.logsumexp(logits, dim=-1).square().mean()

    # capacity-bounded sort dispatch
    flat_w = topw.reshape(-1)
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    e_s, t_s, w_s = flat_e[order], flat_t[order], flat_w[order]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(Tg * K, device=dev) - starts[e_s]
    keep = pos < C
    # the reference's slot C - 1 of an overflowing expert: the pad sentinel
    held = keep & ~((counts[e_s] > C) & (pos == C - 1))
    # every entry is written, the ones not held into a spare slot C that is
    # cut off: no boolean index, so no data-dependent shape
    slot = torch.where(held, pos, C)
    idx = torch.full((E, C + 1), Tg, dtype=torch.long, device=dev)  # Tg = pad sentinel
    idx[e_s, slot] = t_s
    idx = idx[:, :C]
    wmat = torch.zeros((E, C + 1), dtype=torch.float32, device=dev)
    wmat[e_s, slot] = w_s
    wmat = wmat[:, :C]

    x_pad = torch.cat([xc, torch.zeros((1, D), dtype=compute_dtype, device=dev)])
    x_e = x_pad[idx]                                                  # (E, C, D)

    # expert GEMMs (the block-sparse-by-routing compute)
    g = torch.einsum("ecd,edf->ecf", x_e, p.wi_gate.to(compute_dtype))
    u = torch.einsum("ecd,edf->ecf", x_e, p.wi_up.to(compute_dtype))
    h = F.silu(g) * u
    y_e = torch.einsum("ecf,efd->ecd", h, p.wo.to(compute_dtype))    # (E, C, D)

    # weighted scatter back (atomic on CUDA: not bitwise between calls)
    y = torch.zeros((Tg + 1, D), dtype=torch.float32, device=dev)
    y.index_add_(0, idx.reshape(-1), (wmat[..., None] * y_e.float()).reshape(E * C, D))
    aux = {"aux_loss": aux_loss, "router_z": router_z,
           "dropped_frac": 1.0 - keep.float().mean()}
    return y[:Tg], aux


def moe_apply(p: MoE, x: torch.Tensor, cfg: MoEConfig, *, compute_dtype=torch.bfloat16):
    """x (B, S, D) -> (y, aux), aux = {"aux_loss", "router_z",
    "dropped_frac"} averaged over the dispatch groups.

    Tokens over capacity are dropped (they reach the output only through
    the shared experts and the residual).  Dispatch runs per group of
    ``dispatch_groups`` token groups (fewer when they do not divide the
    token count)."""
    B, S, D = x.shape
    T = B * S
    G = max(1, min(cfg.dispatch_groups, B))
    while T % G:
        G -= 1
    Tg = T // G
    C = _capacity(Tg, cfg)
    ys, auxs = zip(*(_moe_dispatch_group(p, xf, cfg, C, compute_dtype)
                     for xf in x.reshape(G, Tg, D)))
    y = torch.cat(ys)
    aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    if cfg.n_shared:
        y = y + apply_mlp(p.shared, x.reshape(T, D), compute_dtype=compute_dtype).float()
    return y.reshape(B, S, D).to(x.dtype), aux
