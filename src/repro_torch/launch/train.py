"""Training launcher.

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 20
    python -m repro_torch.launch.train --arch qwen3-0.6b --reduced --device cpu

Runs on the card unless ``--device`` names another device.  The parameters
are placed by the sharding rules on the host mesh: one card, where every
spec resolves to unsplit; a ``--model-parallel`` wider than one card
raises, as ``train.elastic.remesh_state`` does.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import reduced
from ..data.pipeline import pipeline_for
from ..models.registry import Model, get_config
from ..sharding import rules as shrules
from ..train.elastic import remesh_state
from ..train.optimizer import OptimizerConfig
from ..train.trainer import TrainLoop, TrainLoopConfig
from ..utils.hw import default_device
from ..utils.tree import leaves
from .mesh import make_host_mesh


def main(argv=None) -> dict:
    """Train ``--steps`` steps; returns the loop (its ``history``), the
    module, the opt state, the step reached and the mesh."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="wsd", choices=["wsd", "cosine", "const"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = default_device(args.device)
    model = Model(cfg)
    print(f"[launch] {cfg.name} ({cfg.family}): "
          f"{model.total_params()/1e6:.1f}M params, "
          f"{model.active_params()/1e6:.1f}M active/token")

    mesh = make_host_mesh(model=args.model_parallel, device=dev)
    print(f"[launch] mesh {mesh.shape}")
    if args.model_parallel > mesh.shape["model"]:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel} needs {args.model_parallel} cards; "
            f"the host mesh is {mesh.shape}: multi-card training is not implemented")

    pipe = pipeline_for(cfg, shape_batch=args.batch, seq_len=args.seq, seed=args.seed,
                        device=dev)
    opt_cfg = OptimizerConfig(lr=args.lr, schedule=args.schedule,
                              warmup_steps=max(1, args.steps // 10),
                              total_steps=args.steps)
    loop_cfg = TrainLoopConfig(total_steps=args.steps, log_every=args.log_every,
                               ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)

    specs = leaves(shrules.param_specs(model.param_shapes(), mesh))
    print(f"[launch] {len(specs)} parameter specs, "
          f"{sum(shrules.spec_splits(s, mesh) for s in specs)} split on this mesh")
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    params = remesh_state({"params": params}, model.param_shapes(), mesh)["params"]
    loop = TrainLoop(model, opt_cfg, loop_cfg, pipe)
    params, opt_state, step = loop.run(params=params, resume=not args.no_resume,
                                       seed=args.seed)
    print("[launch] done")
    return {"loop": loop, "params": params, "opt_state": opt_state, "step": step,
            "mesh": mesh, "model": model}


if __name__ == "__main__":
    main()
