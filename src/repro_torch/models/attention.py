"""Attention variants: GQA (MHA / MQA as special cases), qk-norm, sliding
window, cross-attention, and DeepSeek-style MLA (multi-head latent
attention).

Both regimes of the paper's bandwidth analysis appear here:

* **train / prefill** -- chunked (flash-style, online-softmax) attention:
  a loop over query chunks with an inner loop over KV chunks, never
  materializing the (S, S) score matrix.
* **decode** -- one query token against a long KV cache: a matrix-*vector*
  pipeline, bandwidth-bound like the paper's SpMV.

The reference computes attention in plain ``jnp`` (no Pallas kernel), and
the port mirrors its algorithm op for op, so no library attention call
stands in for it.  The KV cache is a dict of tensors written in place at
``cache_pos``; the returned cache is the same dict.

MLA stores the compressed latent (kv_lora + rope_dim per token) and decodes
in the *absorbed* form: the up-projections fold into the query / output
transforms, so attention runs against the latent directly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .layers import NEG_INF, apply_rope, dense_, param, qk_norm_apply

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    window: int | None = None          # sliding-window size (None = full)
    softmax_scale: float | None = None

    @property
    def scale(self) -> float:
        return self.softmax_scale if self.softmax_scale else self.head_dim ** -0.5


@dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def scale(self) -> float:
        return (self.nope_dim + self.rope_dim) ** -0.5


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class GQA(nn.Module):
    def __init__(self, cfg: AttnConfig, dtype=torch.float32, device=None):
        super().__init__()
        D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = param((D, H * hd), dtype, device)
        self.wk = param((D, K * hd), dtype, device)
        self.wv = param((D, K * hd), dtype, device)
        self.wo = param((H * hd, D), dtype, device)
        if cfg.qk_norm:
            self.q_norm = param((hd,), dtype, device)
            self.k_norm = param((hd,), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen):
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_(w, gen)
        if hasattr(self, "q_norm"):
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


class MLA(nn.Module):
    def __init__(self, cfg: MLAConfig, dtype=torch.float32, device=None):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        qd = cfg.nope_dim + cfg.rope_dim
        self.wq = param((D, H * qd), dtype, device)
        self.w_dkv = param((D, cfg.kv_lora), dtype, device)
        self.w_kr = param((D, cfg.rope_dim), dtype, device)
        self.kv_norm = param((cfg.kv_lora,), dtype, device)
        self.w_uk = param((cfg.kv_lora, H * cfg.nope_dim), dtype, device)
        self.w_uv = param((cfg.kv_lora, H * cfg.v_dim), dtype, device)
        self.wo = param((H * cfg.v_dim, D), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen):
        for w in (self.wq, self.w_dkv, self.w_kr, self.w_uk, self.w_uv, self.wo):
            dense_(w, gen)
        self.kv_norm.fill_(1.0)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention -- train / prefill
# ---------------------------------------------------------------------------


def _chunk_mask(qpos, kpos, causal: bool, window: int | None):
    """(qc, kc) additive mask from absolute positions."""
    d = qpos[:, None] - kpos[None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF).float()


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    window: int | None = None, q_offset: int = 0,
                    q_chunk: int = 1024, k_chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, hd), k (B, Sk, K, hd), v (B, Sk, K, vd) -> (B, Sq, H, vd)
    in q's dtype: an online softmax over KV chunks for each query chunk."""
    B, Sq, H, hd = q.shape
    _, Sk, K, vd = v.shape
    G = H // K
    qc = min(q_chunk, Sq)
    kc = min(k_chunk, Sk)
    assert Sq % qc == 0 and Sk % kc == 0, (Sq, qc, Sk, kc)
    nq, nk = Sq // qc, Sk // kc
    qs = q.reshape(B, nq, qc, K, G, hd)
    ks = k.reshape(B, nk, kc, K, hd)
    vs = v.reshape(B, nk, kc, K, vd)
    outs = []
    for iq in range(nq):
        qblk = qs[:, iq]
        qpos = q_offset + iq * qc + torch.arange(qc, device=q.device)
        m = torch.full((B, qc, K, G), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, qc, K, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, qc, K, G, vd), dtype=torch.float32, device=q.device)
        for ik in range(nk):
            kblk, vblk = ks[:, ik], vs[:, ik]
            kpos = ik * kc + torch.arange(kc, device=q.device)
            s = torch.einsum("bqkgd,bskd->bqkgs", qblk.float(), kblk.float()) * scale
            s = s + _chunk_mask(qpos, kpos, causal, window)[None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgs,bskd->bqkgd", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-20)
        outs.append(out.to(q.dtype))
    return torch.stack(outs, dim=1).reshape(B, Sq, K * G, vd)


def decode_attention(q, k_cache, v_cache, pos: int, *, scale: float,
                     window: int | None = None) -> torch.Tensor:
    """One-token attention against the cache, q (B, 1, H, hd): the
    bandwidth-bound matrix-vector product.  ``pos`` is the position of the
    token (the number of valid cache slots - 1)."""
    B, S, K, hd = k_cache.shape
    H = q.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    kpos = torch.arange(S, device=q.device)
    ok = kpos <= pos
    if window is not None:
        ok &= kpos > pos - window
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def _write(cache_t: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """Write ``new`` (B, S, ...) into ``cache_t`` (B, Smax, ...) at ``pos``
    along the sequence axis, in place."""
    cache_t[:, pos:pos + new.shape[1]] = new.to(cache_t.dtype)
    return cache_t


# ---------------------------------------------------------------------------
# GQA apply (train / prefill / decode / cross)
# ---------------------------------------------------------------------------


def gqa_apply(p: GQA, x, cfg: AttnConfig, positions, *, causal: bool = True,
              cache: dict | None = None, cache_pos: int | None = None,
              kv_input=None, use_rope: bool = True, q_chunk: int = 1024,
              k_chunk: int = 1024, compute_dtype=torch.bfloat16):
    """x (B, S, D), positions (S,) -> (out (B, S, D), cache).  ``cache``
    ({"k", "v"}: (B, Smax, K, hd)) is written in place at ``cache_pos``;
    ``kv_input`` (B, Se, D) makes it cross-attention."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xc = x.to(compute_dtype)
    q = (xc @ p.wq.to(compute_dtype)).reshape(B, S, H, hd)
    kv_src = xc if kv_input is None else kv_input.to(compute_dtype)
    k = (kv_src @ p.wk.to(compute_dtype)).reshape(B, -1, K, hd)
    v = (kv_src @ p.wv.to(compute_dtype)).reshape(B, -1, K, hd)
    if cfg.qk_norm:
        q = qk_norm_apply(p.q_norm, q)
        k = qk_norm_apply(p.k_norm, k)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_input is None:
            k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        wp = int(cache_pos) if cache_pos is not None else 0
        k_cache, v_cache = _write(cache["k"], k, wp), _write(cache["v"], v, wp)
        if S == 1:  # decode step
            out = decode_attention(q, k_cache.to(compute_dtype), v_cache.to(compute_dtype),
                                   wp, scale=cfg.scale, window=cfg.window)
        else:  # prefill: attend within the freshly written prefix
            out = flash_attention(q, k, v, scale=cfg.scale, causal=causal,
                                  window=cfg.window, q_chunk=q_chunk, k_chunk=k_chunk)
    else:
        out = flash_attention(q, k, v, scale=cfg.scale, causal=causal,
                              window=cfg.window, q_chunk=q_chunk, k_chunk=k_chunk)

    y = out.reshape(B, S, H * hd) @ p.wo.to(compute_dtype)
    return y.to(x.dtype), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent-compressed KV
# ---------------------------------------------------------------------------


def _mla_latent(p: MLA, xc, positions, cfg: MLAConfig):
    """Compressed latent c_kv (B, S, kv_lora) and shared rope key (B, S, rope)."""
    c_kv = qk_norm_apply(p.kv_norm, xc @ p.w_dkv.to(xc.dtype))
    k_r = (xc @ p.w_kr.to(xc.dtype)).reshape(*xc.shape[:2], 1, cfg.rope_dim)
    return c_kv, apply_rope(k_r, positions, cfg.rope_theta)[:, :, 0, :]


def mla_apply(p: MLA, x, cfg: MLAConfig, positions, *, cache: dict | None = None,
              cache_pos: int | None = None, q_chunk: int = 1024, k_chunk: int = 1024,
              compute_dtype=torch.bfloat16):
    """x (B, S, D) -> (out, cache); ``cache`` ({"c_kv": (B, Smax, kv_lora),
    "k_rope": (B, Smax, rope)}) is written in place at ``cache_pos``."""
    B, S, D = x.shape
    H, cd = cfg.n_heads, compute_dtype
    xc = x.to(cd)
    q = (xc @ p.wq.to(cd)).reshape(B, S, H, cfg.nope_dim + cfg.rope_dim)
    q_nope, q_rope = q[..., :cfg.nope_dim], q[..., cfg.nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _mla_latent(p, xc, positions, cfg)

    if cache is not None:
        wp = int(cache_pos) if cache_pos is not None else 0
        _write(cache["c_kv"], c_kv, wp)
        _write(cache["k_rope"], k_rope, wp)

    if cache is not None and S == 1:
        # absorbed decode: attention directly on the latent cache
        wuk = p.w_uk.to(cd).reshape(cfg.kv_lora, H, cfg.nope_dim)
        q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], wuk)
        c = cache["c_kv"].to(cd)                   # (B, Smax, lora)
        kr = cache["k_rope"].to(cd)                # (B, Smax, rope)
        s = (torch.einsum("bhl,bsl->bhs", q_lat.float(), c.float())
             + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(), kr.float())) * cfg.scale
        kpos = torch.arange(c.shape[1], device=x.device)
        s = torch.where((kpos <= wp)[None, None, :], s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhs,bsl->bhl", pr.to(cd).float(), c.float()).to(cd)
        wuv = p.w_uv.to(cd).reshape(cfg.kv_lora, H, cfg.v_dim)
        out = torch.einsum("bhl,lhv->bhv", o_lat, wuv).reshape(B, 1, H * cfg.v_dim)
    else:
        # train / prefill: materialize per-head k / v from the latent
        k_nope = (c_kv @ p.w_uk.to(cd)).reshape(B, S, H, cfg.nope_dim)
        v = (c_kv @ p.w_uv.to(cd)).reshape(B, S, H, cfg.v_dim)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, cfg.rope_dim)],
                           dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(q_full, k_full, v, scale=cfg.scale, causal=True,
                              q_chunk=q_chunk, k_chunk=k_chunk).reshape(B, S, H * cfg.v_dim)

    y = out @ p.wo.to(cd)
    return y.to(x.dtype), cache

