"""Perf hill-climb runner: run a named (cell, change) pair and append the
record to a JSONL next to the baselines.

Port of ``repro.launch.hillclimb``.  Each iteration is one hypothesis ->
change -> re-run -> re-analyse cycle; the changes are pure config /
sharding overrides, so every iteration is reproducible from the CLI:

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen3_train --iter dp_only
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from .dryrun import run_cell

# cell -> (arch, shape); iter -> extra_cfg overrides
CELLS = {
    "qwen3_train": ("qwen3-0.6b", "train_4k"),
    "jamba_train": ("jamba-1.5-large-398b", "train_4k"),
    "glm4_decode": ("glm4-9b", "decode_32k"),
    "deepseek_decode": ("deepseek-v2-lite-16b", "decode_32k"),
}

ITERS = {
    # H1: qwen3-0.6b x train_4k (collective-bound at TP=16)
    "baseline": {},
    "dp_only": {"shard_profile": "dp_only"},
    "dp_only_remat_dots": {"shard_profile": "dp_only", "remat": "dots"},
    "dp_only_remat_none": {"shard_profile": "dp_only", "remat": "none"},
    # H2: jamba x train_4k (global-sort dispatch + FSDP weight all-gathers)
    "moe2d": {"shard_profile": "moe2d"},
    "moe2d_remat_dots": {"shard_profile": "moe2d", "remat": "dots"},
    "dispatch_g1": {"moe_dispatch_groups": 1},     # reproduce old baseline
    "grouped_dispatch": {"moe_dispatch_groups": 16},
    "grouped_remat_dots": {"moe_dispatch_groups": 16, "remat": "dots"},
    "gather_w": {"moe_dispatch_groups": 16, "moe_gather_weights": 1},
    "gather_w_dots": {"moe_dispatch_groups": 16, "moe_gather_weights": 1,
                      "remat": "dots"},
    # per-stream SSM projections (shard-aligned splits): the change lives in
    # models/mamba2.py; this iteration measures the new default
    "aligned_ssm": {"moe_dispatch_groups": 16},
    "aligned_ssm_dots": {"moe_dispatch_groups": 16, "remat": "dots"},
    # H3: glm4 x decode_32k (KV replicated: kv=2 unshardable on 16-way TP)
    "seq_kv": {"kv_seq_shard_threshold": 16384},
    "seq_kv_q8": {"kv_seq_shard_threshold": 16384, "cache_dtype": "f8"},
    "seq_kv_bf16w": {"kv_seq_shard_threshold": 16384, "param_dtype": "bf16"},
    "seq_kv_bf16w_q8": {"kv_seq_shard_threshold": 16384, "param_dtype": "bf16",
                        "cache_dtype": "f8"},
    "cache_q8": {"cache_dtype": "f8"},
}


def resolve_overrides(d: dict) -> dict:
    out = dict(d)
    if out.get("cache_dtype") == "f8":
        out["cache_dtype"] = torch.float8_e4m3fn
    if out.get("param_dtype") == "bf16":
        out["param_dtype"] = torch.bfloat16
    return out


def _gb(x) -> str:
    return "n/c" if x is None else f"{x / 1e9:.2f} GB"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(CELLS))
    ap.add_argument("--iter", required=True, choices=list(ITERS))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default="results/hillclimb.jsonl")
    ap.add_argument("--no-extrapolate", action="store_true")
    args = ap.parse_args(argv)

    arch, shape = CELLS[args.cell]
    extra = resolve_overrides(ITERS[args.iter])
    rec = run_cell(arch, shape, multi_pod=(args.mesh == "multi"),
                   extra_cfg=extra, extrapolate=not args.no_extrapolate)
    rec["cell"] = args.cell
    rec["iteration"] = args.iter
    rec["extra_cfg"] = {k: str(v) for k, v in extra.items()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec, default=str) + "\n")
    ex = rec.get("extrap") or {}
    bytes_dev = ex.get("bytes_per_device_extrap", rec.get("bytes_per_device"))
    flops = rec.get("op_flops_global")
    print(f"[hillclimb] {args.cell}/{args.iter}: status={rec['status']} "
          f"op_flops={'n/a' if flops is None else f'{flops:.4g}'} "
          f"coll/dev={_gb(rec.get('collective_bytes_per_device'))} "
          f"bytes/dev={_gb(bytes_dev)}")
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    raise SystemExit(main())
