"""Elastic scaling + straggler mitigation.

  1. **detect** -- ``Heartbeat`` tracks per-step wall time; a step slower
     than ``factor`` x the rolling median flags a straggler.
  2. **decide** -- ``ElasticPolicy`` chooses: tolerate (transient), or
     re-mesh to the surviving device set.
  3. **re-mesh** -- checkpoints store *global* arrays, so resuming on another
     mesh is restore + placement with the new mesh's specs
     (``remesh_state``).

The port trains on one card: ``remesh_state`` places a state on a
one-device mesh and raises ``NotImplementedError`` on a mesh of several
devices, where the rules would split (or replicate) the state across cards.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from ..launch.mesh import DeviceMesh
from ..sharding import rules as shrules
from ..utils.tree import leaves


@dataclass
class Heartbeat:
    factor: float = 3.0
    window: int = 32
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def beat(self, step: int, wall_s: float):
        self.times.append(wall_s)
        if len(self.times) > self.window:
            self.times.pop(0)
        if self.is_straggling():
            self.flagged.append(step)

    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0

    def is_straggling(self) -> bool:
        if len(self.times) < 5:
            return False
        return self.times[-1] > self.factor * statistics.median(self.times[:-1])


@dataclass
class ElasticPolicy:
    tolerate_flags: int = 3      # consecutive straggler steps before re-mesh

    def should_remesh(self, hb: Heartbeat) -> bool:
        if len(hb.flagged) < self.tolerate_flags:
            return False
        tail = hb.flagged[-self.tolerate_flags:]
        return tail == list(range(tail[0], tail[0] + self.tolerate_flags))


def choose_mesh_shape(n_devices: int, prefer_model: int = 16) -> tuple[int, int]:
    """Largest (data, model) factorization with model <= prefer_model.
    Survivor counts that aren't nicely divisible degrade model-parallel width
    first (TP needs divisibility more than DP does)."""
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model -= 1
    return n_devices // model, model


def make_mesh_from_devices(devices, shape: tuple[int, int],
                           axis_names=("data", "model")) -> DeviceMesh:
    arr = np.empty(shape[0] * shape[1], dtype=object)
    arr[:] = list(devices[: shape[0] * shape[1]])
    return DeviceMesh(arr.reshape(shape), tuple(axis_names))


def remesh_state(state: dict, param_like, new_mesh: DeviceMesh) -> dict:
    """Place a restored {"params", "opt_state"} on ``new_mesh``.

    ``param_like`` is the reference's stacked tree of the parameters
    (``Model.param_shapes()``) the rules are computed on.  On a one-device
    mesh every spec resolves to unsplit and the state moves to that device
    (a module in place).  A mesh of several devices raises
    ``NotImplementedError``: the port has no multi-card training."""
    devs = list(dict.fromkeys(new_mesh.devices.flat))
    if len(devs) > 1:
        specs = leaves(shrules.param_specs(param_like, new_mesh)) + \
            leaves(shrules.zero1_specs(param_like, new_mesh))
        split = [s for s in specs if shrules.spec_splits(s, new_mesh)]
        raise NotImplementedError(
            f"multi-card training is not implemented: a mesh of {len(devs)} devices "
            f"{dict(new_mesh.shape)} would split {len(split)} parameter / opt-state specs "
            "across cards, and the port keeps its state on one card")
    dev = devs[0]
    params = state["params"]
    if isinstance(params, nn.Module):
        out = {"params": params.to(dev)}
    else:
        out = {"params": {k: v.to(dev) for k, v in params.items()}}
    if "opt_state" in state:
        mo = state["opt_state"]
        out["opt_state"] = {"m": {k: v.to(dev) for k, v in mo["m"].items()},
                            "v": {k: v.to(dev) for k, v in mo["v"].items()},
                            "step": torch.as_tensor(mo["step"]).to(dev)}
    return out
