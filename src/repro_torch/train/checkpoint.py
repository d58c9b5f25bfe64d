"""Checkpointing: atomic, manifest-based, in the reference's on-disk format.

    <dir>/step_<N>/
        manifest.json        {step, leaves: [{path, shape, dtype, file}], extra}
        <leaf_idx>.npy       one numpy file per leaf of the reference's tree

The leaves are those of the reference's state tree ``{"params", "opt_state":
{"m", "v", "step"}}``, with the ``STACKED`` lists stacked along a leading
axis (``utils.tree.stacked_tree``), listed and numbered in sorted key
order as ``jax.tree`` flattens them: the same manifest and files as the
reference writes for the same model and state, so either package restores
the other's checkpoints.  A bf16 leaf is its raw 16 bits under the numpy
descr ``'<V2'`` (what ``np.save`` writes for an ``ml_dtypes.bfloat16``
array) with dtype "bfloat16" in the manifest, and is read back by that
dtype.

Properties: **atomic** (written to ``step_<N>.tmp``, then renamed), global
leaves (restore places them wherever the caller's tensors live), and
**retention** (the newest ``keep`` checkpoints stay).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
from torch import nn

from ..utils.tree import flatten_with_paths, reference_path, stacked_tree


def _host(t) -> np.ndarray:
    """A tensor (or array / number) as a numpy array, bf16 as its bits."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


class _Stack:
    """A stacked leaf not yet stacked: its unit tensors, joined on the host
    when the leaf is written (one leaf in host memory at a time)."""

    def __init__(self, parts):
        self.parts = parts

    @property
    def dtype(self):
        return self.parts[0].dtype


def _state_tree(params, opt_state) -> dict:
    """The reference's state tree: a module or a name-keyed dict becomes the
    stacked tree of ``_Stack`` leaves; a nested tree passes as it is."""
    def tree(named):
        if isinstance(named, nn.Module):
            named = {k: p.detach() for k, p in named.named_parameters()}
        if all(isinstance(v, torch.Tensor) for v in named.values()):
            return stacked_tree(named, stack=_Stack)
        return named
    state = {"params": tree(params)}
    if opt_state is not None:
        state["opt_state"] = {"m": tree(opt_state["m"]), "v": tree(opt_state["v"]),
                              "step": opt_state["step"]}
    return state


def _dtype_name(leaf) -> str:
    dt = leaf.dtype
    if dt == torch.bfloat16:
        return "bfloat16"
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return str(np.dtype(dt))


def _write_npy(path: str, arr: np.ndarray, bf16: bool):
    with open(path, "wb") as f:
        if bf16:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
        else:
            np.lib.format.write_array(f, np.asarray(arr), allow_pickle=False)


def save(ckpt_dir: str, step: int, *, params, opt_state=None, extra: dict | None = None,
         keep: int = 3) -> str:
    """Write ``params`` (a module, a dict keyed by the port's names, or a
    reference-layout tree) and ``opt_state`` (the port's AdamW state) as
    ``<ckpt_dir>/step_<step>``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    records = flatten_with_paths(_state_tree(params, opt_state))
    manifest = {"step": int(step), "leaves": [], "extra": extra or {}}
    for i, (path, leaf) in enumerate(records):
        if isinstance(leaf, _Stack):
            arr = np.stack([_host(p) for p in leaf.parts])
        else:
            arr = _host(leaf)
        dtype = _dtype_name(leaf) if hasattr(leaf, "dtype") else str(arr.dtype)
        fname = f"{i:05d}.npy"
        _write_npy(os.path.join(tmp, fname), arr, dtype == "bfloat16")
        manifest["leaves"].append(
            {"path": path, "shape": list(arr.shape), "dtype": dtype, "file": fname})
        del arr
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
    return sorted(out)


def _load_raw(path: str) -> tuple[dict, dict]:
    """(manifest, {leaf path: CPU tensor}); bf16 leaves by the manifest's
    dtype from their 16 bits."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for rec in manifest["leaves"]:
        arr = np.load(os.path.join(path, rec["file"]))
        if rec["dtype"] == "bfloat16":
            leaves[rec["path"]] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            leaves[rec["path"]] = torch.from_numpy(arr)
    return manifest, leaves


@torch.no_grad()
def _fill(named: dict, prefix: str, leaves: dict):
    """Copy each checkpoint leaf into the tensor of ``named`` it holds."""
    for name, t in named.items():
        path, unit = reference_path(name)
        key = f"{prefix}/{path}"
        if key not in leaves:
            raise KeyError(f"checkpoint missing leaf {key}")
        src = leaves[key] if unit is None else leaves[key][unit]
        if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
            raise ValueError(f"{key}[{unit}]: checkpoint {tuple(src.shape)} {src.dtype}, "
                             f"target {tuple(t.shape)} {t.dtype}")
        t.copy_(src)


def restore(ckpt_dir: str, step: int, *, like=None, shardings=None) -> dict:
    """Restore the state of ``step``.  ``like`` ({"params": module or
    name-keyed tensors, "opt_state": the port's AdamW state}) is filled in
    place and returned under the same keys.  Without it, a nested dict
    keyed by path segments of CPU tensors is returned, placed on the device
    ``shardings`` names when it is given.  Either way "step" and "extra"
    come from the manifest."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest, leaves = _load_raw(path)

    if like is not None:
        params = like["params"]
        _fill({k: p for k, p in params.named_parameters()} if isinstance(params, nn.Module)
              else params, "params", leaves)
        state = {"params": params}
        if "opt_state" in like:
            opt = like["opt_state"]
            _fill(opt["m"], "opt_state/m", leaves)
            _fill(opt["v"], "opt_state/v", leaves)
            _fill({"step": opt["step"]}, "opt_state", leaves)
            state["opt_state"] = opt
    else:
        state = {}
        for lpath, arr in leaves.items():
            cur = state
            parts = lpath.split("/")
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = arr if shardings is None else arr.to(shardings)
    out = dict(state)
    out["step"] = manifest["step"]
    out["extra"] = manifest.get("extra", {})
    return out


def restore_latest(ckpt_dir: str, **kw):
    steps = available_steps(ckpt_dir)
    if not steps:
        return None
    return restore(ckpt_dir, steps[-1], **kw)
