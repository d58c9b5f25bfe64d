"""KV-cache management for the token serving engine.

The cache is the model-defined tree (``registry.Model.cache_shape``), held
as tensors on the device and written in place; this module adds the
host-side slot manager for continuous batching: a fixed batch of B slots,
each slot independently holding one request's position, so finished
requests are replaced without reshaping any device buffer.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.hw import default_device
from ..utils.tree import leaves, map_tree


def zeros_like_shapes(shape_tree, device=None):
    """A tree of zero tensors of ``shape_tree``'s specs on ``device``
    (default the card)."""
    dev = default_device(device)
    return map_tree(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev), shape_tree)


def cache_bytes(shape_tree) -> int:
    return int(sum(torch.Size(leaf.shape).numel() * leaf.dtype.itemsize
                   for leaf in leaves(shape_tree)))


@dataclass
class Slot:
    request_id: int | None = None
    pos: int = 0                 # next write position
    prompt_len: int = 0
    generated: list = field(default_factory=list)
    done: bool = True


@dataclass
class SlotManager:
    batch_size: int
    max_len: int
    slots: list = None

    def __post_init__(self):
        self.slots = [Slot() for _ in range(self.batch_size)]

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.done]

    def admit(self, request_id: int, prompt_len: int) -> int | None:
        free = self.free_slots()
        if not free:
            return None
        i = free[0]
        self.slots[i] = Slot(request_id, prompt_len, prompt_len, [], False)
        return i

    def record_token(self, i: int, token: int, eos_id: int, max_new: int):
        s = self.slots[i]
        if s.done:
            return
        s.generated.append(int(token))
        s.pos += 1
        if token == eos_id or len(s.generated) >= max_new or s.pos >= self.max_len - 1:
            s.done = True

    def positions(self) -> np.ndarray:
        return np.asarray([s.pos for s in self.slots], np.int32)

    def active_mask(self) -> np.ndarray:
        return np.asarray([not s.done for s in self.slots], bool)
