"""Train step + host-level training loop with fault tolerance.

``make_train_step`` builds the eager step:
  * loss and grads through the model registry (any family), by autograd;
  * optional microbatch gradient accumulation (an f32 sum over the
    microbatches, divided by their count);
  * grad clip + AdamW / WSD, updating the module and the opt state in place.

``TrainLoop`` adds the production concerns:
  * periodic checkpoint (atomic, manifest-based; train/checkpoint.py),
  * resume-from-latest with deterministic data skip-ahead,
  * per-step heartbeat + straggler detection hooks (train/elastic.py),
  * NaN-step rejection (skip the update, keep params and opt state).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..models.registry import Model
from ..utils.tree import global_norm
from . import checkpoint as ckpt_lib
from .elastic import Heartbeat
from .optimizer import OptimizerConfig, adamw_update, init_opt_state, schedule_lr


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        return model.loss(params, batch)
    return loss_fn


def loss_and_grads(model: Model, params, batch: dict, microbatches: int = 1):
    """(loss, metrics, grads) of ``params`` (the model's module) on
    ``batch``: grads keyed by parameter name, f32 when accumulated.  With
    ``microbatches`` > 1 the batch splits along axis 0, the grads are the
    f32 mean over the microbatches, the loss is their mean and the metrics
    are the last microbatch's, as the reference's scan gives them."""
    loss_fn = make_loss_fn(model)
    names, plist = zip(*params.named_parameters())

    def grads_of(b):
        with torch.enable_grad():
            loss, metrics = loss_fn(params, b)
            # an unused leaf (the embed table of an embeds-input arch) gets
            # zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, plist, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    if microbatches == 1:
        loss, metrics, grads = grads_of(batch)
        return loss, metrics, dict(zip(names, grads))
    n = next(iter(batch.values())).shape[0] // microbatches
    acc, loss_sum = None, 0.0
    for i in range(microbatches):
        loss, metrics, grads = grads_of({k: v[i * n:(i + 1) * n] for k, v in batch.items()})
        grads = [g.float() for g in grads]
        if acc is None:
            acc = grads
        else:
            torch._foreach_add_(acc, grads)
        loss_sum = loss_sum + loss
    torch._foreach_div_(acc, microbatches)
    return loss_sum / microbatches, metrics, dict(zip(names, acc))


def make_train_step(model: Model, opt_cfg: OptimizerConfig, *,
                    microbatches: int = 1, donate: bool = True,
                    skip_nan_updates: bool = True):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, which updates ``params`` (the model's module) and
    ``opt_state`` in place and returns them.  ``donate`` is accepted for
    the reference's signature and has no effect: an eager step owns no
    buffers to donate, it writes into the ones it is given.  With
    ``skip_nan_updates`` a non-finite loss leaves the parameters and the
    opt state (``step`` included) as they were and sets ``skipped``; that
    costs one read of the loss back to the host a step."""
    del donate

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch, microbatches)
        bad = skip_nan_updates and not bool(torch.isfinite(loss))
        if bad:
            stats = {"lr": schedule_lr(opt_cfg, opt_state["step"] + 1),
                     "grad_norm": global_norm(grads)}
        else:
            params, opt_state, stats = adamw_update(opt_cfg, grads, opt_state, params)
        if skip_nan_updates:
            stats = dict(stats, skipped=bad)
        return params, opt_state, {"loss": loss, **metrics, **stats}

    return train_step


# ---------------------------------------------------------------------------
# host loop
# ---------------------------------------------------------------------------


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep_ckpts: int = 3
    straggler_factor: float = 3.0


@dataclass
class TrainLoop:
    model: Model
    opt_cfg: OptimizerConfig
    loop_cfg: TrainLoopConfig
    data_iter: object                      # data.pipeline.TokenPipeline
    heartbeat: Heartbeat = field(default=None)
    history: list = field(default_factory=list)

    def run(self, params=None, opt_state=None, start_step: int = 0,
            resume: bool = True, seed: int = 0):
        """Train to ``loop_cfg.total_steps`` on the data pipeline's device;
        returns (params, opt_state, step).  ``history`` gains (step, loss,
        seconds) at every log step."""
        cfgL = self.loop_cfg
        dev = self.data_iter.device
        step_fn = make_train_step(self.model, self.opt_cfg)
        if resume and ckpt_lib.available_steps(cfgL.ckpt_dir):
            params = self.model.build(dev) if params is None else params
            opt_state = init_opt_state(params) if opt_state is None else opt_state
            restored = ckpt_lib.restore_latest(
                cfgL.ckpt_dir, like={"params": params, "opt_state": opt_state})
            start_step = restored["step"]
            print(f"[train] resumed from step {start_step}")
        if params is None:
            params = self.model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
        if opt_state is None:
            opt_state = init_opt_state(params)
        self.data_iter.skip_to(start_step)
        hb = self.heartbeat or Heartbeat(factor=cfgL.straggler_factor)

        step = start_step
        while step < cfgL.total_steps:
            batch = self.data_iter.next_batch()
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            hb.beat(step, dt)
            step += 1
            if step % cfgL.log_every == 0 or step == cfgL.total_steps:
                loss = float(metrics["loss"])
                self.history.append((step, loss, dt))
                print(f"[train] step {step:5d} loss {loss:.4f} {dt*1e3:.1f} ms"
                      + (" STRAGGLER" if hb.is_straggling() else ""))
            if step % cfgL.ckpt_every == 0 or step == cfgL.total_steps:
                ckpt_lib.save(cfgL.ckpt_dir, step, params=params,
                              opt_state=opt_state, keep=cfgL.keep_ckpts)
        return params, opt_state, step
