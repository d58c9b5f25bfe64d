"""AdamW with a WSD (warmup-stable-decay) schedule, written out in torch ops.

WSD is the minicpm-2b training schedule (arXiv:2404.06395): linear warmup,
a long constant plateau, a short sharp decay; cosine and constant serve the
other archs.  The formulas are the reference's, not ``torch.optim.AdamW``'s
or ``clip_grad_norm_``'s: the clip scale is ``min(1, max_norm / max(gn,
1e-9))``, the bias corrections ``1 - b ** step`` are computed in f32, and
weight decay is folded into the update as ``delta + wd * p``.

Parameters, grads and moments are dicts keyed by the port's parameter names
(``units.3.attn.wq``), or an ``nn.Module`` for the parameters.  The update
works in place under ``torch.no_grad()`` with ``torch._foreach_*`` ops (a
handful of multi-tensor launches a step, not a dozen per leaf), and reads
nothing back to the host: ``step``, the learning rate and the clip scale
stay tensors on the device.

Which leaves are decayed follows the reference, which decays a leaf of rank
>= 2 *in its stacked tree*: every leaf of a ``STACKED`` list carries the
leading layer axis there, so a unit's RMSNorm scale (``(L, D)`` stacked) is
decayed, as are ``q_norm`` and Mamba-2's ``A_log`` / ``D`` / ``dt_bias``.
``decayed`` decides by that stacked rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..utils.tree import STACKED, TensorSpec, global_norm, map_tree


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "wsd"        # wsd | cosine | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1      # WSD: final fraction spent decaying
    min_lr_frac: float = 0.1


def schedule_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor) as an f32
    tensor on the step's device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(1.0, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm
    if cfg.schedule == "cosine":
        t = torch.clamp((s - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps),
                        0.0, 1.0)
        cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return cfg.lr * warm * cos
    # WSD: warmup -> stable -> linear decay over the last decay_frac steps
    decay_start = cfg.total_steps * (1.0 - cfg.decay_frac)
    t = torch.clamp((s - decay_start) / max(1.0, cfg.total_steps - decay_start), 0.0, 1.0)
    dec = 1.0 - (1.0 - cfg.min_lr_frac) * t
    return cfg.lr * warm * dec


def named_params(params) -> dict:
    """{name: tensor} of a module's parameters, or ``params`` itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def decayed(params) -> dict:
    """{name: bool}: the leaves the reference's AdamW decays, those of rank
    >= 2 in its stacked tree (a leaf of a ``STACKED`` list gains the leading
    layer axis there)."""
    return {k: len(t.shape) + (k.split(".")[0] in STACKED) >= 2
            for k, t in named_params(params).items()}


def init_opt_state(params, dtype=torch.float32) -> dict:
    """{"m", "v", "step"}: zero moments keyed by the parameters' names in
    ``dtype``, on each parameter's device, and an int32 step."""
    named = named_params(params)
    dev = next(iter(named.values())).device
    return {"m": {k: torch.zeros(p.shape, dtype=dtype, device=p.device) for k, p in named.items()},
            "v": {k: torch.zeros(p.shape, dtype=dtype, device=p.device) for k, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_shapes(param_shapes, dtype=torch.float32) -> dict:
    """The opt state's TensorSpecs for a tree of parameter specs (the
    reference's stacked layout, as ``Model.param_shapes()`` gives it)."""
    z = map_tree(lambda p: TensorSpec(p.shape, dtype), param_shapes)
    return {"m": z, "v": z, "step": TensorSpec((), torch.int32)}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / max(gn, 1e-9))``, gn).  The
    scaled grads are new tensors; ``grads`` is left as it was."""
    named = named_params(grads)
    gn = global_norm(named)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return dict(zip(named, torch._foreach_mul(list(named.values()), scale))), gn


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, opt_state: dict, params):
    """One AdamW step, in place: ``params`` (a module or a dict of tensors)
    and ``opt_state`` are updated and returned with the stats {"lr",
    "grad_norm"} (tensors on the device).  ``grads`` is keyed as
    ``params``; it is clipped first (its tensors may be scaled in place)."""
    named = named_params(params)
    names = list(named)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    g = [grads[k].float() for k in names]
    torch._foreach_mul_(g, scale)
    step = opt_state["step"].add_(1)
    lr = schedule_lr(cfg, step)
    sf = step.to(torch.float32)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(b1, sf)
    bc2 = 1.0 - torch.pow(b2, sf)

    m = [opt_state["m"][k] for k in names]
    v = [opt_state["v"][k] for k in names]
    mf = [t.float() for t in m]             # the moments themselves when f32
    vf = [t.float() for t in v]
    torch._foreach_mul_(mf, b1)
    torch._foreach_add_(mf, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(vf, b2)
    torch._foreach_add_(vf, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
    del g
    delta = torch._foreach_div(mf, bc1)                       # mhat
    den = torch._foreach_div(vf, bc2)                         # vhat
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(delta, den)
    del den
    pf = [named[k].float() for k in names]
    if cfg.weight_decay:
        dec = decayed(named)
        idx = [i for i, k in enumerate(names) if dec[k]]
        if idx:
            dsel = [delta[i] for i in idx]
            torch._foreach_add_(dsel, torch._foreach_mul([pf[i] for i in idx],
                                                         cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(pf, delta)
    for dst, src in ((m, mf), (v, vf), ([named[k] for k in names], pf)):
        for a, b in zip(dst, src):
            if a is not b:
                a.copy_(b)
    return params, opt_state, {"lr": lr, "grad_norm": gn}
