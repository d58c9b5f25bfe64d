"""Serving launcher: batched generation with the decode engine.

    python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 4
    python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced --device cpu

Runs on the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import reduced
from ..models.registry import Model, get_config
from ..serve.engine import Engine, GenerationConfig
from ..utils.hw import default_device


def main(argv=None) -> dict:
    """Serve ``--requests`` random prompts in one wave; returns the engine,
    the prompts, the sampling config, the token lists and the wave's
    seconds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family == "encdec" or cfg.input_mode == "embeds":
        raise SystemExit(f"{args.arch}: token-serving demo needs a token-input LM")
    dev = default_device(args.device)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    engine = Engine(model, params, batch_size=args.requests, max_len=args.max_len,
                    device=dev)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len)).astype(np.int64)
    gen_cfg = GenerationConfig(max_new_tokens=args.max_new,
                               temperature=args.temperature, seed=args.seed)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, gen_cfg)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        print(f"[serve] req {i}: {len(o)} tokens: {o[:12]}{'...' if len(o) > 12 else ''}")
    print(f"[serve] {n_tok} tokens in {dt:.2f}s = {n_tok / dt:.1f} tok/s on {dev} "
          f"(~{engine.decode_bytes_per_token() / 1e6:.1f} MB streamed/token at "
          f"batch {args.requests})")
    return {"engine": engine, "prompts": prompts, "gen_cfg": gen_cfg, "outs": outs,
            "seconds": dt}


if __name__ == "__main__":
    main()
