"""Gradient compression for the data-parallel all-reduce (int8 + error
feedback).

Each DP step quantizes the local gradient to int8 with a per-tensor f32
scale, sums the int8 payload across shards (4x fewer collective bytes than
f32), dequantizes, and carries the quantization residual into the next step
(error feedback: Seide et al. / Karimireddy et al.).

``psum_compressed`` takes the single-controller form of the distributed
layer (``core.distributed``): one gradient tree and one residual tree per
shard, reduced in this process.  The reference's module docstring names a
``make_train_step(compress_grads=True)`` that its trainer does not have;
neither has the port's.
"""
from __future__ import annotations

import torch

from .optimizer import named_params


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_residual(g: torch.Tensor, residual: torch.Tensor):
    """Error-feedback step: quantize (g + residual), return (q, scale, new_residual)."""
    corrected = g.float() + residual
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def psum_compressed(grads: list, residuals: list):
    """int8 all-reduce of per-shard gradient trees (dicts of tensors, one a
    shard; ``residuals`` alike).  Each leaf: error-feedback correct, agree on
    the scale (the max over shards of the local amax), quantize, sum the
    int8 payloads in int32, average, dequantize.  Returns (the mean grads,
    one dict; the new residuals, one dict a shard)."""
    n = len(grads)
    mean, new_res = {}, [{} for _ in range(n)]
    for k in grads[0]:
        corrected = [g[k].float() + r[k] for g, r in zip(grads, residuals)]
        amax = torch.stack([c.abs().max() for c in corrected]).max()
        scale = torch.clamp(amax, min=1e-12) / 127.0
        qs = [torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8) for c in corrected]
        acc = torch.stack([q.to(torch.int32) for q in qs]).sum(0)
        mean[k] = (acc.float() * scale / n).to(grads[0][k].dtype)
        for res, c, q in zip(new_res, corrected, qs):
            res[k] = c - q.float() * scale
    return mean, new_res


def init_residuals(params) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named_params(params).items()}


def compression_ratio(params, wire_bits: int = 8, ref_bits: int = 32) -> float:
    return ref_bits / wire_bits
