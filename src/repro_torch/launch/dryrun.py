"""Production dry-run: run every (arch x shape x mesh) step on ``meta``.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
step for 512 placeholder CPU devices and reads XLA's cost and memory
analyses and the compiled HLO.  PyTorch has none of these, so the port runs
the real step -- ``train_step`` (loss, backward, AdamW), ``prefill`` or
``decode_step`` -- once on the ``meta`` device, at full width and the
shape's global batch, under ``utils.op_flops.OpCounter``.  ``meta`` tensors
carry shapes and dtypes and no storage: the run allocates nothing, computes
nothing, and needs no card.  The production mesh (``launch.mesh``) is an
abstract one: the sharding rules give each input's spec on it, and the
record derives what the specs determine.

The record keeps the reference's keys where the meaning is the same:

  * ``flops_per_device`` = counted global FLOPs / devices;
  * ``model_flops`` (6 N tokens train, 2 N tokens serve), ``n_active_params``;
  * ``memory.argument_bytes``: the inputs' local shards under the rules;
  * ``bytes_per_device``: the eager bytes the counter sees in the per-device
    program (the step at the local batch), only where the specs split
    nothing but the batch -- the parameters whole, the batch (and cache)
    split along dim 0 only; the optimizer state counts whole there, as the
    port holds it (it has no partitioner to apply ZeRO-1).  Elsewhere
    ``null``, with ``bytes_reason``;
  * ``collective_bytes_per_device``, ``collective_detail`` and
    ``memory.temp_bytes`` are ``null``, with a reason: the port has no
    partitioner, so no split program exists to census or to plan buffers
    for.  Never 0.

Renamed: ``lower_s`` / ``compile_s`` -> ``trace_s`` (host seconds of the
meta run); ``jaxpr_flops_global`` -> ``op_flops_global`` (with its products
apart in ``op_matmul_flops_global`` and the eager bytes in
``op_bytes_global``).  Added: ``launches`` (counted CUDA kernels in the
window; nonzero would mean unseen work).  Dropped:
``memory.generated_code_bytes`` (nothing is compiled).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, input_specs, shape_applicable
from ..models.registry import Model, get_config
from ..sharding import rules as shrules
from ..train.optimizer import OptimizerConfig, adamw_update, init_opt_state, opt_state_shapes
from ..train.trainer import loss_and_grads
from ..utils.op_flops import count_fn
from ..utils.tree import TensorSpec, leaves, map_tree
from .mesh import make_production_mesh

#: why a record holds no collective or temp count
NO_PARTITIONER = ("the port has no partitioner: no split program exists to census "
                  "collectives in or to plan temporaries for")


def _materialize(tree, device, generator=None, vocab: int = 2):
    """Tensors for a tree of TensorSpecs: storage-less on ``meta``; else
    integers in [0, vocab), floats from N(0, 1) (``generator`` on
    ``device``)."""
    dev = torch.device(device)

    def make(s: TensorSpec):
        if dev.type == "meta":
            return torch.empty(s.shape, dtype=s.dtype, device=dev)
        if s.dtype.is_floating_point:
            return torch.randn(s.shape, generator=generator, device=dev).to(s.dtype)
        return torch.randint(0, vocab, s.shape, generator=generator, device=dev,
                             dtype=s.dtype)

    return map_tree(make, tree)


def step_specs(model: Model, shape_name: str, mesh) -> tuple:
    """The PartitionSpec trees of the step's inputs (at the global batch) on
    ``mesh``, in ``build_step``'s order, as the sharding rules give them."""
    cfg = model.cfg
    kind = SHAPES[shape_name].kind
    specs = input_specs(cfg, shape_name)
    pshapes = model.param_shapes()
    prof = cfg.shard_profile
    # FSDP (huge models): params themselves carry the DP shard dim too
    pspec_fn = shrules.zero1_specs if cfg.fsdp else shrules.param_specs
    pspec = pspec_fn(pshapes, mesh, profile=prof)
    if kind == "train":
        ospec = {"m": shrules.zero1_specs(pshapes, mesh, profile=prof),
                 "v": shrules.zero1_specs(pshapes, mesh, profile=prof),
                 "step": shrules.P()}
        return pspec, ospec, shrules.batch_specs(specs["batch"], mesh, profile=prof)
    cspec = shrules.cache_specs(specs["cache"], mesh,
                                seq_axis_threshold=cfg.kv_seq_shard_threshold)
    if kind == "prefill":
        return pspec, shrules.batch_specs(specs["batch"], mesh, profile=prof), cspec
    return (pspec, cspec, shrules.batch_specs(specs["token"], mesh, profile=prof),
            shrules.P())


def arg_shapes(model: Model, shape_name: str) -> tuple:
    """The step's inputs (at the global batch) as TensorSpec trees, in
    ``build_step``'s order."""
    cfg = model.cfg
    specs = input_specs(cfg, shape_name)
    pshapes = model.param_shapes()
    kind = SHAPES[shape_name].kind
    if kind == "train":
        return pshapes, opt_state_shapes(pshapes, cfg.opt_dtype), specs["batch"]
    if kind == "prefill":
        return pshapes, specs["batch"], specs["cache"]
    return pshapes, specs["cache"], specs["token"], TensorSpec((), torch.int32)


def build_step(model: Model, shape_name: str, mesh, opt_cfg=OptimizerConfig(), *,
               device="meta", batch: int | None = None, params=None, generator=None):
    """Returns ``(fn, args, in_specs, out_specs)``: the step, its inputs as
    tensors on ``device`` (at the global batch, or at ``batch``), and the
    PartitionSpec trees of its global inputs and outputs on ``mesh``
    (``out_specs`` None where the reference leaves them to the compiler).

    ``params`` (the model's module) defaults to ``model.build(device)``,
    whose values are unset: pass initialized parameters to run on a card.
    A cache starts zeroed there; other inputs are drawn from ``generator``."""
    cfg = model.cfg
    kind = SHAPES[shape_name].kind
    specs = input_specs(cfg, shape_name, batch)
    in_specs = step_specs(model, shape_name, mesh)
    if params is None:
        params = model.build(device)

    if kind == "train":
        data = _materialize(specs["batch"], device, generator, cfg.vocab)
        opt_state = init_opt_state(params, cfg.opt_dtype)

        def train_step(params, opt_state, batch):
            loss, metrics, grads = loss_and_grads(model, params, batch)
            new_p, new_o, stats = adamw_update(opt_cfg, grads, opt_state, params)
            return new_p, new_o, {"loss": loss, **metrics, **stats}

        return (train_step, (params, opt_state, data), in_specs,
                (in_specs[0], in_specs[1], None))

    cache = map_tree(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                     specs["cache"])
    if kind == "prefill":
        data = _materialize(specs["batch"], device, generator, cfg.vocab)

        def prefill_step(params, batch, cache):
            return model.prefill(params, batch, cache)

        return prefill_step, (params, data, cache), in_specs, None

    # decode: one token against a full cache (decode attention reads every
    # slot and masks, so the last position costs what any does)
    token = _materialize(specs["token"], device, generator, cfg.vocab)

    def decode_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    return (decode_step, (params, cache, token, SHAPES[shape_name].seq_len - 1),
            in_specs, None)


def _depth_override(cfg, n_units: int) -> dict:
    """Config overrides giving exactly ``n_units`` repeating units."""
    if cfg.family == "hybrid":
        return {"n_layers": n_units * cfg.hybrid_period, "scan_unroll": n_units}
    if cfg.family == "encdec":
        return {"n_layers": n_units, "n_enc_layers": n_units, "scan_unroll": n_units}
    return {"n_layers": cfg.first_dense + n_units, "scan_unroll": n_units}


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names)


def local_shape(shape, spec, mesh) -> tuple:
    """The shard of ``shape`` one device holds under ``spec`` (ceil)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(-(-d // _axis_size(mesh, e)) for d, e in zip(shape, entries))


def local_bytes(shape_tree, spec_tree, mesh) -> int:
    """Bytes of one device's shards of a tree of specs (or tensors)."""
    return sum(math.prod(local_shape(s.shape, p, mesh)) * s.dtype.itemsize
               for s, p in zip(leaves(shape_tree), leaves(spec_tree)))


def local_batch(model: Model, shape_name: str, in_specs, mesh) -> tuple[int | None, str]:
    """(the per-device batch, "") where the specs split nothing but the
    batch -- parameters whole, batch and cache leaves split on dim 0 only --
    else (None, the reason).  The optimizer state is not looked at: the port
    holds it whole."""
    kind = SHAPES[shape_name].kind
    shapes = arg_shapes(model, shape_name)
    if any(shrules.spec_splits(p, mesh) for p in leaves(in_specs[0])):
        return None, "the parameter specs split a weight over the mesh"
    data = (2,) if kind == "train" else (1, 2)
    global_b = SHAPES[shape_name].global_batch
    b_loc = global_b
    for i in data:
        for s, p in zip(leaves(shapes[i]), leaves(in_specs[i])):
            split0 = len(p) > 0 and _axis_size(mesh, p[0]) > 1
            if shrules.spec_splits(shrules.P(*list(p)[1:]), mesh) or (
                    split0 and s.shape[0] != global_b):
                return None, "a batch or cache spec splits a dim other than the batch"
            if split0:
                b_loc = min(b_loc, -(-global_b // _axis_size(mesh, p[0])))
    return b_loc, ""


def _count_cell(cfg, shape_name: str, mesh) -> dict:
    """Counts of one step on ``meta``: the global run, and the per-device
    run's bytes where the specs allow it."""
    model = Model(cfg)
    fn, args, in_specs, out_specs = build_step(model, shape_name, mesh)
    counts = count_fn(fn, *args)
    b_loc, why = local_batch(model, shape_name, in_specs, mesh)
    dev_bytes = None
    if b_loc is not None:
        fn_l, args_l, _, _ = build_step(model, shape_name, mesh, batch=b_loc)
        dev_bytes = count_fn(fn_l, *args_l).bytes
    return {"model": model, "counts": counts, "in_specs": in_specs,
            "out_specs": out_specs, "local_batch": b_loc, "bytes_per_device": dev_bytes,
            "bytes_reason": why}


def extrapolate_depth(arch: str, shape_name: str, mesh, *, depths=(1, 2),
                      extra_cfg: dict | None = None) -> dict:
    """Per-device FLOPs / bytes / collective bytes at full depth from a
    linear fit C(L) = a + b*L over two shallow runs.  The reference needs it
    because XLA counts a rolled scan body once; the port counts every layer
    it runs, so the fit reproduces the full-depth count for a homogeneous
    stack.  A count the port does not make stays ``None``."""
    cfg = get_config(arch, **(extra_cfg or {}))
    n_dev = mesh.size
    pts = []
    for L in depths:
        cfg_l = get_config(arch, **(extra_cfg or {}), **_depth_override(cfg, L))
        c = _count_cell(cfg_l, shape_name, mesh)
        pts.append({"L": L,
                    "flops": c["counts"].flops,
                    "bytes": c["bytes_per_device"],
                    "coll": None,
                    "coll_detail": None})
    L1, L2 = pts[0]["L"], pts[1]["L"]
    full_units = cfg.n_units if cfg.family != "encdec" else cfg.n_layers
    out = {"depths": list(depths), "full_units": full_units, "points": pts}
    for k in ("flops", "bytes", "coll"):
        if pts[0][k] is None or pts[1][k] is None:
            out[f"{k}_per_device_extrap"] = out[f"{k}_per_unit"] = out[f"{k}_outside"] = None
            continue
        # exact integer fit (global FLOPs pass 2**53); FLOPs then per device
        b = (pts[1][k] - pts[0][k]) // (L2 - L1)
        a = pts[0][k] - b * L1
        div = n_dev if k == "flops" else 1
        out[f"{k}_per_device_extrap"] = (a + b * full_units) / div
        out[f"{k}_per_unit"] = b / div
        out[f"{k}_outside"] = a / div
    for p in pts:
        p["flops"] = p["flops"] / n_dev
    return out


def _model_flops(model: Model, shape_name: str) -> float:
    spec = SHAPES[shape_name]
    n_active = model.active_params()
    if spec.kind == "train":
        return 6.0 * n_active * spec.seq_len * spec.global_batch
    if spec.kind == "prefill":
        return 2.0 * n_active * spec.seq_len * spec.global_batch
    return 2.0 * n_active * spec.global_batch


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, verbose: bool = True,
             extra_cfg: dict | None = None, extrapolate: bool = False) -> dict:
    cfg = get_config(arch, **(extra_cfg or {}))
    ok, why = shape_applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        c = _count_cell(cfg, shape_name, mesh)
        t_trace = time.time() - t0
        model, counts = c["model"], c["counts"]
        n_dev = mesh.size
        shapes = arg_shapes(model, shape_name)
        out_bytes = None
        if c["out_specs"] is not None:   # train: the new parameters and opt state
            out_bytes = sum(local_bytes(s, p, mesh)
                            for s, p in zip(shapes[:2], c["out_specs"][:2]))
        rec.update(
            status="ok",
            n_devices=int(n_dev),
            trace_s=round(t_trace, 1),
            flops_per_device=counts.flops / n_dev,
            op_flops_global=counts.flops,
            op_matmul_flops_global=counts.matmul,
            op_bytes_global=counts.bytes,
            launches=counts.launches,
            local_batch=c["local_batch"],
            bytes_per_device=c["bytes_per_device"],
            collective_bytes_per_device=None,
            collective_detail=None,
            collective_reason=NO_PARTITIONER,
            utilization_ratio=None,
            memory={"argument_bytes": sum(local_bytes(s, p, mesh)
                                          for s, p in zip(shapes, c["in_specs"])),
                    "output_bytes": out_bytes,
                    "temp_bytes": None,
                    "temp_reason": NO_PARTITIONER},
        )
        if c["bytes_per_device"] is None:
            rec["bytes_reason"] = c["bytes_reason"]
        rec["model_flops"] = float(_model_flops(model, shape_name))
        rec["n_active_params"] = float(model.active_params())
        if extrapolate:
            try:
                rec["extrap"] = extrapolate_depth(arch, shape_name, mesh,
                                                  extra_cfg=extra_cfg)
            except Exception as e:  # noqa: BLE001
                rec["extrap_error"] = f"{type(e).__name__}: {e}"
        if verbose:
            dev_b = ("n/c" if rec["bytes_per_device"] is None
                     else f"{rec['bytes_per_device'] / 1e9:.2f} GB/dev")
            print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: OK "
                  f"(trace {t_trace:.1f}s, {rec['flops_per_device']:.4g} flops/dev, "
                  f"bytes {dev_b}, coll n/c)")
            print(f"  memory: {rec['memory']['argument_bytes'] / 1e9:.3f} GB of "
                  f"arguments a device")
    except Exception as e:  # noqa: BLE001 -- report, don't crash the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: FAILED {e}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, help="a shape, or several joined by commas")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--extrapolate", action="store_true",
                    help="also fit the counts over two shallow depths")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, multi_pod=mp,
                               extrapolate=args.extrapolate and not mp)
                records.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
