"""End-to-end example: train a ~100M-parameter LM for a few hundred steps.

Uses the qwen3 family at a ~100M scale (same architecture, reduced depth
and width), the WSD schedule, checkpointing, and deterministic resume.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny --steps 6 --device cpu

(about 100M parameters; ``--tiny`` is the family's ``reduced`` config for
a quick run).  Runs on the card unless ``--device`` names another device.
A run resumes from the newest checkpoint in ``--ckpt-dir``, as the loop
does.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..configs import reduced
from ..data.pipeline import pipeline_for
from ..models.registry import Model, get_config
from ..train.optimizer import OptimizerConfig
from ..train.trainer import TrainLoop, TrainLoopConfig
from ..utils.hw import default_device


def model_config(tiny: bool = False):
    """The ~100M-parameter qwen3 variant, or the family's ``reduced`` one."""
    cfg = get_config("qwen3-0.6b")
    if tiny:
        return reduced(cfg)
    return dataclasses.replace(
        cfg, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab=32768, remat="none", q_chunk=256, k_chunk=256)


def optimizer_config(steps: int) -> OptimizerConfig:
    """WSD at 6e-4: a tenth of the run warming up, the last fifth decaying."""
    return OptimizerConfig(lr=6e-4, schedule="wsd", warmup_steps=steps // 10,
                           total_steps=steps, decay_frac=0.2)


def main(argv=None) -> dict:
    """Train ``--steps`` steps; returns the loop (its ``history``), the
    model, the parameters, the opt state, the step reached and the logged
    losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    cfg = model_config(args.tiny)
    model = Model(cfg)
    print(f"[train_lm] {model.total_params() / 1e6:.1f}M params "
          f"({model.active_params() / 1e6:.1f}M active) on {dev}")

    pipe = pipeline_for(cfg, shape_batch=args.batch, seq_len=args.seq, device=dev)
    # a loss every 20 steps, as the reference logs; at least ten a shorter run
    log_every = min(20, max(1, args.steps // 10))
    loop = TrainLoop(model, optimizer_config(args.steps),
                     TrainLoopConfig(total_steps=args.steps, log_every=log_every,
                                     ckpt_every=max(50, args.steps // 4),
                                     ckpt_dir=args.ckpt_dir),
                     pipe)
    params, opt_state, step = loop.run()
    losses = [l for _, l, _ in loop.history]
    print(f"[train_lm] loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return {"loop": loop, "model": model, "params": params, "opt_state": opt_state,
            "step": step, "losses": losses}


if __name__ == "__main__":
    main()
