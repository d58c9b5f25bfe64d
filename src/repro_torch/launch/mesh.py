"""Mesh construction for the sharding rules.

The port trains on one card.  A mesh is the rules' view of a device grid:
its ``axis_names`` and a ``shape`` dict.  ``make_host_mesh`` lays the visible
cards out as ("data", "model") -- (1, 1) on a one-card machine, where every
spec resolves to replicated; ``make_production_mesh`` is the reference's
256-chip pod (or two) as an ``AbstractMesh``: the shape the rules are
computed for, with no devices behind it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.hw import default_device


@dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names, no devices (``jax.sharding.AbstractMesh``)."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))


@dataclass(frozen=True, eq=False)
class DeviceMesh:
    """An array of ``torch.device``s laid out along ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 chips/pod ("data", "model"); 2 pods -> (2, 16, 16) with
    the leading "pod" axis folded into data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def visible_devices(device=None) -> list:
    """Every visible card (or ``[device]`` when a non-CUDA device is named)."""
    dev = default_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_host_mesh(model: int | None = None, device=None) -> DeviceMesh:
    """("data", "model") mesh over the visible cards, ``model`` (default 1)
    lowered until it divides their count; ``device="cpu"`` gives the host."""
    devs = visible_devices(device)
    n = len(devs)
    m = model or 1
    while n % m:
        m -= 1
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(n // m, m), ("data", "model"))
