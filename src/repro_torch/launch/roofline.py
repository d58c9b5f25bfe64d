"""Roofline analysis: dry-run records -> the three-term table, priced on a chip.

Port of ``repro.launch.roofline``.  Terms (seconds, per step, on ``chip``,
default the ``H100`` data sheet of ``utils/hw.py``):

  compute    = FLOPs_global / (chips * bf16 peak)   [FLOPs: every op the step
                                                     runs, ``utils/op_flops``]
  memory     = HBM bytes/device / HBM rate          [two columns: the
                analytic model below, the headline, and the eager bytes the
                op counter saw (unfused: an upper bound), where the record
                has them]
  collective = collective bytes/device / link rate  [one link, as the
                reference prices its ICI]

Plus MODEL_FLOPS = 6*N_active*tokens (train) / 2*N_active*tokens (serve), the
useful-compute ratio MODEL/counted, the dominant term, and a one-line note.

A term the record does not hold (``null``: the port has no partitioner, so
no collective census of a split program and no per-device count of one) is
printed "n/c" and left out of the bound, never read as 0.

Two differences from the reference, both its faults (``ROADMAP.md``):

* the itemsizes of ``analytic_hbm_bytes_per_device`` come from the config's
  dtypes.  The reference tests ``str(dtype).endswith("32")``, which is False
  for ``jnp.float32`` (``"<class 'jax.numpy.float32'>"``), so it prices f32
  parameters and AdamW state at 2 bytes; the error cancels only when the
  parameters and the opt state have the same width;
* ``tp = 16`` is kept for every shard profile, as the reference keeps it:
  under ``dp_only`` the formula's local batch is ``global / (devices / 16)``,
  where the program's is ``global / devices``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import torch

from ..configs import SHAPES
from ..models.registry import Model, get_config
from ..serve.kv_cache import cache_bytes
from ..utils.hw import H100, ChipSpec
from ..utils.tree import param_bytes, param_count

#: the reference's tensor-parallel width, kept for every profile
TP = 16


def _resolve_dtype(s) -> torch.dtype:
    """The reference's reading of a dtype override: fp8, bf16, else f32."""
    s = str(s)
    if "float8" in s or s == "f8":
        return torch.float8_e4m3fn
    if "bf16" in s or "bfloat16" in s:
        return torch.bfloat16
    return torch.float32


def _config_overrides(overrides: dict | None) -> dict:
    ov = dict(overrides or {})
    for k in ("param_dtype", "cache_dtype", "opt_dtype"):
        if k in ov:
            ov[k] = _resolve_dtype(ov[k])
    ov = {k: v for k, v in ov.items() if k in
          ("param_dtype", "cache_dtype", "opt_dtype", "remat",
           "shard_profile", "kv_seq_shard_threshold", "moe_dispatch_groups")}
    if "kv_seq_shard_threshold" in ov:
        ov["kv_seq_shard_threshold"] = int(ov["kv_seq_shard_threshold"])
    return ov


def analytic_hbm_bytes_per_device(arch: str, shape_name: str, n_devices: int,
                                  tp: int = TP, overrides: dict | None = None) -> float:
    """First-principles HBM traffic per device per step (fused model).

    train : params read 3x (fwd + bwd + remat recompute) from their shard,
            grads write+read, opt state read+write (ZeRO-sharded),
            remat-saved unit inputs write+read, logits write+read (fp32).
    prefill: params 1x + cache write + unit-input activations.
    decode : params 1x + cache read 1x (the bandwidth-bound MVM regime).
    """
    cfg = get_config(arch, **_config_overrides(overrides))
    model = Model(cfg)
    spec = SHAPES[shape_name]
    shapes = model.param_shapes()
    P_bytes = param_bytes(shapes)
    n_params = param_count(shapes)
    opt_itemsize = cfg.opt_dtype.itemsize
    dp = n_devices // tp
    B_loc = max(1, spec.global_batch // dp)
    param_shards = n_devices if cfg.fsdp else tp
    local_params = P_bytes / param_shards

    if spec.kind == "train":
        S = spec.seq_len
        D = cfg.d_model
        L = cfg.n_layers
        act_unit = B_loc * S * D * 2          # bf16 saved input per unit
        logits = B_loc * S * (cfg.vocab / tp) * 4
        opt_local = 3 * n_params * opt_itemsize / n_devices  # m, v, master touch
        return (3 * local_params                 # fwd + bwd + remat weight reads
                + 2 * local_params               # grad write + read
                + 2 * opt_local                  # opt read + write
                + 2 * L * act_unit               # remat saves w+r
                + 2 * logits)
    cache = cache_bytes(model.cache_shape(spec.global_batch, spec.seq_len))
    cache_local = cache / n_devices
    if spec.kind == "prefill":
        S, D, L = spec.seq_len, cfg.d_model, cfg.n_layers
        act = 2 * L * B_loc * S * D * 2
        return local_params + cache_local + act
    # decode: weights once + cache once (+ small vectors)
    return local_params + cache_local


def _ms(s: float | None) -> str:
    return "n/c" if s is None else f"{s * 1e3:.2f}"


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_global: float
    model_flops: float
    bytes_dev_counted: float | None
    bytes_dev_analytic: float
    coll_dev: float | None
    compute_s: float
    memory_s_counted: float | None
    memory_s: float
    collective_s: float | None
    bound: str
    useful_ratio: float
    mfu_bound: float
    note: str

    def md(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{_ms(self.compute_s)} | {_ms(self.memory_s)} | "
                f"{_ms(self.memory_s_counted)} | {_ms(self.collective_s)} | "
                f"**{self.bound}** | {self.useful_ratio:.2f} | "
                f"{self.mfu_bound*100:.1f}% | {self.note} |")


_NOTES = {
    "compute": "compute-bound: raise tensor-core utilization (fusion, bf16, larger tiles)",
    "memory": "HBM-bound: cut bytes/step (remat policy, dtype, cache layout)",
    "collective": "link-bound: reshard (less TP / more DP), overlap or compress collectives",
}


def _max_present(*xs):
    present = [x for x in xs if x is not None]
    return max(present) if present else None


def analyse_record(rec: dict, chip: ChipSpec = H100) -> RooflineRow | None:
    if rec.get("status") != "ok":
        return None
    chips = rec["n_devices"]
    flops_global = rec.get("op_flops_global") or rec["flops_per_device"] * chips
    ex = rec.get("extrap") or {}
    # a depth fit of the per-device counts, where one was made; the record's
    # own count is the floor; a missing count stays missing
    bytes_dev = _max_present(ex.get("bytes_per_device_extrap"), rec.get("bytes_per_device"))
    coll_dev = _max_present(ex.get("coll_per_device_extrap"),
                            rec.get("collective_bytes_per_device"))
    bytes_dev_an = analytic_hbm_bytes_per_device(rec["arch"], rec["shape"], chips, TP,
                                                 overrides=rec.get("extra_cfg"))
    compute_s = flops_global / (chips * chip.peak_flops_bf16)
    memory_s_counted = None if bytes_dev is None else bytes_dev / chip.hbm_bytes_per_s
    memory_s = bytes_dev_an / chip.hbm_bytes_per_s
    collective_s = None if coll_dev is None else coll_dev / chip.link_bytes_per_s
    terms = {k: v for k, v in (("compute", compute_s), ("memory", memory_s),
                               ("collective", collective_s)) if v is not None}
    bound = max(terms, key=terms.get)
    model_flops = rec["model_flops"]
    crit = max(terms.values())
    mfu_bound = (model_flops / crit) / (chips * chip.peak_flops_bf16) if crit else 0.0
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        flops_global=flops_global, model_flops=model_flops,
        bytes_dev_counted=bytes_dev, bytes_dev_analytic=bytes_dev_an,
        coll_dev=coll_dev, compute_s=compute_s, memory_s_counted=memory_s_counted,
        memory_s=memory_s, collective_s=collective_s, bound=bound,
        useful_ratio=model_flops / max(1.0, flops_global),
        mfu_bound=mfu_bound, note=_NOTES[bound],
    )


HEADER = ("| arch | shape | mesh | compute ms | memory ms (analytic) | "
          "memory ms (counted) | collective ms | bound | useful FLOP ratio | "
          "MFU bound | note |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def table_from_jsonl(path: str, mesh_filter: str | None = "16x16",
                     chip: ChipSpec = H100) -> str:
    """Roofline table of the records in ``path`` (the last record of each
    arch x shape x mesh wins), single-pod by default; "n/c": not counted."""
    rows, skips, errs = [], [], []
    seen = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            key = (rec["arch"], rec["shape"], rec["mesh"])
            seen[key] = rec  # last record wins (re-runs override)
    for rec in seen.values():
        if rec["status"] == "skipped":
            skips.append(f"- {rec['arch']} x {rec['shape']}: {rec['reason']}")
        elif rec["status"] == "error":
            errs.append(f"- {rec['arch']} x {rec['shape']} x {rec['mesh']}: {rec['error']}")
        elif mesh_filter in (None, rec["mesh"]):
            rows.append(analyse_record(rec, chip))
    rows = [r for r in rows if r]
    rows.sort(key=lambda r: (r.arch, r.shape, r.mesh))
    out = [HEADER] + [r.md() for r in rows]
    if skips:
        out += ["", "Skipped cells (assignment rules):"] + sorted(set(skips))
    if errs:
        out += ["", "ERRORS:"] + errs
    return "\n".join(out)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    t = table_from_jsonl(args.jsonl, mesh_filter=None if args.mesh == "all" else args.mesh)
    if args.out:
        with open(args.out, "w") as f:
            f.write(t + "\n")
    print(t)


if __name__ == "__main__":
    main()
