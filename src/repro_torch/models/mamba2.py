"""Mamba-2 (SSD, state-space duality) layer.

Train / prefill uses the *block* form of SSD: the sequence is cut into
chunks of Q tokens; within a chunk the recurrence is expanded into a (Q, Q)
masked "attention", and between chunks only the (heads, hd, N) state is
carried (a loop over chunks here, ``lax.scan`` in the reference).  Decode is
the pure recurrence h <- a*h + B x; y = C.h + D*x: a bandwidth-bound state
update.

As in the reference: ngroups = 1, no sequence parallelism inside the
layer, real (not complex) A.  Where the reference mixes a compute-dtype
operand with an f32 one, JAX promotes to f32; the port casts the same way
explicitly (``torch.einsum`` does not promote).  The cache ({"conv_x",
"conv_bc", "ssm"}) is written in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_, param
from ..utils.tree import TensorSpec


@dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state  # x + B + C streams


class SSM(nn.Module):
    """The z / x / BC / dt projections and the depthwise conv are separate
    leaves, as in the reference."""

    def __init__(self, cfg: SSMConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        di, N, H = cfg.d_inner, cfg.d_state, cfg.n_heads
        self.z_proj = param((cfg.d_model, di), dtype, device)
        self.x_proj = param((cfg.d_model, di), dtype, device)
        self.bc_proj = param((cfg.d_model, 2 * N), dtype, device)
        self.dt_proj = param((cfg.d_model, H), dtype, device)
        self.conv_x_w = param((di, cfg.d_conv), dtype, device)
        self.conv_x_b = param((di,), dtype, device)
        self.conv_bc_w = param((2 * N, cfg.d_conv), dtype, device)
        self.conv_bc_b = param((2 * N,), dtype, device)
        self.A_log = param((H,), dtype, device)
        self.D = param((H,), dtype, device)
        self.dt_bias = param((H,), dtype, device)
        self.norm = param((di,), dtype, device)
        self.out_proj = param((di, cfg.d_model), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen):
        cfg, H = self.cfg, self.cfg.n_heads
        for w in (self.z_proj, self.x_proj, self.bc_proj, self.dt_proj, self.out_proj):
            dense_(w, gen)
        dense_(self.conv_x_w, gen, 0.2)
        dense_(self.conv_bc_w, gen, 0.2)
        self.conv_x_b.zero_()
        self.conv_bc_b.zero_()
        self.A_log.copy_(torch.log(torch.arange(1, H + 1, dtype=torch.float32)))
        self.D.fill_(1.0)
        # dt from the reference's fixed numpy seed, stored as inverse softplus
        dt = np.exp(np.random.RandomState(0).uniform(
            np.log(cfg.dt_min), np.log(cfg.dt_max), H)).astype(np.float32)
        self.dt_bias.copy_(torch.from_numpy(dt + np.log(-np.expm1(-dt))))
        self.norm.fill_(1.0)


def _gated_rmsnorm(scale, y, z, eps=1e-6):
    yf = (y * F.silu(z.float())).float()
    var = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _causal_conv_one(w, b, xbc, d_conv: int, conv_state=None):
    """Depthwise causal conv over seq; returns (out, new_conv_state)."""
    B, S, Cd = xbc.shape
    w = w.to(xbc.dtype)  # (Cd, d_conv)
    hist = (torch.zeros((B, d_conv - 1, Cd), dtype=xbc.dtype, device=xbc.device)
            if conv_state is None else conv_state)
    xin = torch.cat([hist, xbc], dim=1)  # (B, S + d_conv - 1, Cd), promoted
    out = sum(xin[:, i:i + S, :] * w[:, i][None, None, :] for i in range(d_conv)) \
        + b.to(xbc.dtype)
    new_state = xin[:, -(d_conv - 1):, :] if d_conv > 1 else hist
    return F.silu(out), new_state


def _ssd_chunked(xh, Bm, Cm, dt_a, cfg: SSMConfig, h0=None):
    """Chunked SSD scan.

    xh (B, S, H, hd) inputs per head; Bm, Cm (B, S, N) f32 input / output
    matrices (shared across heads); dt_a = (dt, a), each (B, S, H) f32 with
    a = -exp(A_log) * dt.  Returns (y (B, S, H, hd) f32, h_final
    (B, H, hd, N) f32).
    """
    B, S, H, hd = xh.shape
    N = Bm.shape[-1]
    Q = min(cfg.chunk, S)
    S_orig = S
    dt, a = dt_a
    if S % Q:  # pad to a chunk multiple; pads are causal-inert (B = 0, x = 0)
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
        dt, a = F.pad(dt, (0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad))
        S = S + pad
    nq = S // Q
    xq = xh.reshape(B, nq, Q, H, hd)
    Bq, Cq = Bm.reshape(B, nq, Q, N), Cm.reshape(B, nq, Q, N)
    dtq, aq = dt.reshape(B, nq, Q, H), a.reshape(B, nq, Q, H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    h = torch.zeros((B, H, hd, N), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0
    ys = []
    for c in range(nq):
        xb, bb, cb, dtb, ab = xq[:, c], Bq[:, c], Cq[:, c], dtq[:, c], aq[:, c]
        cum = torch.cumsum(ab, dim=1)                        # (B, Q, H) log-decay prefix
        total = cum[:, -1:, :]                               # (B, 1, H)
        # intra-chunk: masked quadratic form
        rel = cum[:, :, None, :] - cum[:, None, :, :]        # (B, Q, Q, H)
        decay = torch.where(mask[None, :, :, None], torch.exp(rel), 0.0)
        scores = torch.einsum("bqn,bsn->bqs", cb, bb)[..., None] * decay
        xdt = xb * dtb[..., None]                            # (B, Q, H, hd), f32
        y_intra = torch.einsum("bqsh,bshd->bqhd", scores.to(xb.dtype).float(), xdt)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bqn,bhdn->bqhd", cb, h.to(cb.dtype)) \
            * torch.exp(cum)[..., None].to(xb.dtype).float()
        # state update: h' = h * exp(total) + sum_t exp(total - cum_t) B_t (dt x)_t
        w = torch.exp(total - cum)
        h = h * torch.exp(total)[:, 0, :, None, None].to(h.dtype) + torch.einsum(
            "bqn,bqhd->bhdn", bb, (xdt * w[..., None]).to(bb.dtype))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, H, hd)
    return y[:, :S_orig], h


def ssm_apply(p: SSM, x: torch.Tensor, cfg: SSMConfig, *, cache: dict | None = None,
              compute_dtype=torch.bfloat16):
    """x (B, S, D) -> (y, cache).  ``cache`` = {"conv_x": (B, d_conv-1, di),
    "conv_bc": (B, d_conv-1, 2N), "ssm": (B, H, hd, N)} for decode (S == 1)
    and chunk-streaming prefill, updated in place."""
    B, S, D = x.shape
    di, N, H, hd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    cd = compute_dtype
    xc = x.to(cd)
    z, xs = xc @ p.z_proj.to(cd), xc @ p.x_proj.to(cd)
    bc, dt_raw = xc @ p.bc_proj.to(cd), xc @ p.dt_proj.to(cd)
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())                         # (H,)
    a = dt * A[None, None, :]                               # (B, S, H) log decay

    xin, new_conv_x = _causal_conv_one(p.conv_x_w, p.conv_x_b, xs, cfg.d_conv,
                                       cache["conv_x"] if cache is not None else None)
    bc_c, new_conv_bc = _causal_conv_one(p.conv_bc_w, p.conv_bc_b, bc, cfg.d_conv,
                                         cache["conv_bc"] if cache is not None else None)
    Bm, Cm = bc_c[..., :N], bc_c[..., N:]
    xh = xin.reshape(B, S, H, hd)
    Dh = p.D.to(cd)[None, None, :, None]

    if cache is not None and S == 1:
        # pure recurrence
        h = cache["ssm"]                                     # (B, H, hd, N) f32
        xdt = (xh[:, 0] * dt[:, 0, :, None]).float()         # (B, H, hd)
        h_new = h * torch.exp(a[:, 0])[:, :, None, None] + torch.einsum(
            "bn,bhd->bhdn", Bm[:, 0].float(), xdt)
        y = torch.einsum("bn,bhdn->bhd", Cm[:, 0].float(), h_new)
        y = y[:, None].to(cd)                                # (B, 1, H, hd)
        y = y + Dh * xh
        h_fin = h_new
    else:
        h0 = cache["ssm"] if cache is not None else None
        y, h_fin = _ssd_chunked(xh, Bm.float(), Cm.float(), (dt, a), cfg, h0)
        y = y.to(cd) + Dh * xh
    if cache is not None:
        cache["conv_x"].copy_(new_conv_x)
        cache["conv_bc"].copy_(new_conv_bc)
        cache["ssm"].copy_(h_fin)

    y = _gated_rmsnorm(p.norm, y.reshape(B, S, di), z)
    out = y.to(cd) @ p.out_proj.to(cd)
    return out.to(x.dtype), cache


def ssm_cache_shape(cfg: SSMConfig, batch: int, dtype=torch.bfloat16) -> dict:
    return {
        "conv_x": TensorSpec((batch, cfg.d_conv - 1, cfg.d_inner), dtype),
        "conv_bc": TensorSpec((batch, cfg.d_conv - 1, 2 * cfg.d_state), dtype),
        "ssm": TensorSpec((batch, cfg.n_heads, cfg.head_dim, cfg.d_state), torch.float32),
    }
