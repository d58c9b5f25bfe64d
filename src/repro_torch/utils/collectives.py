"""Collective census: the bytes each kind of collective moves, for the roofline.

Port of ``repro.utils.hlo``.  The reference parses the compiled HLO text of
an SPMD program.  The port has no HLO (and no partitioner that would insert
collectives), so it records the collectives a function actually runs:
``count_collectives`` runs it under a ``TorchDispatchMode`` that sees every
``_c10d_functional`` op -- the ops ``torch.distributed._functional_collectives``
and ``DTensor`` lower to -- on any process-group backend.  HLO-text parsing
(``parse_collectives``, ``collective_bytes``) is not ported: there is no text.

Byte convention (the reference's): the output bytes for an all-gather (what
lands on each device), the input bytes for an all-reduce, a reduce-scatter
and an all-to-all, the message for a broadcast.  ``effective_link_bytes``
applies the ring factors.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: ``_c10d_functional`` op -> (the reference's kind, whether its output
#: bytes count); every other op of the namespace (``wait_tensor``) is not
#: a collective
_KINDS = {
    "all_gather_into_tensor": ("all-gather", True),
    "all_gather_into_tensor_out": ("all-gather", True),
    "all_gather_into_tensor_coalesced": ("all-gather", True),
    "all_reduce": ("all-reduce", False),
    "all_reduce_": ("all-reduce", False),
    "all_reduce_coalesced": ("all-reduce", False),
    "all_reduce_coalesced_": ("all-reduce", False),
    "reduce_scatter_tensor": ("reduce-scatter", False),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", False),
    "all_to_all_single": ("all-to-all", False),
    "broadcast": ("collective-broadcast", False),
    "broadcast_": ("collective-broadcast", False),
}


def shape_bytes(dtype: torch.dtype, shape) -> int:
    """Bytes of one tensor of ``dtype`` and ``shape`` (a scalar for ``()``)."""
    return torch.Size(shape).numel() * dtype.itemsize


def _bytes(tree) -> int:
    return sum(shape_bytes(t.dtype, t.shape) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclass
class CollectiveStats:
    """Per-kind op counts and byte totals of one recorded run."""

    bytes_by_kind: dict = field(default_factory=lambda: defaultdict(int))
    count_by_kind: dict = field(default_factory=lambda: defaultdict(int))
    ops: list = field(default_factory=list)  # (kind, bytes, op and shapes)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def record(self, kind: str, nbytes: int, line: str) -> None:
        self.bytes_by_kind[kind] += nbytes
        self.count_by_kind[kind] += 1
        self.ops.append((kind, nbytes, line[:160]))

    def summary(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "total_count": self.total_count,
            **{f"{k}_bytes": v for k, v in sorted(self.bytes_by_kind.items())},
            **{f"{k}_count": v for k, v in sorted(self.count_by_kind.items())},
        }


def effective_link_bytes(stats: CollectiveStats, axis_sizes: dict | None = None) -> float:
    """Apply ring-algorithm per-device link-byte factors.

    For a ring over n devices: all-gather and reduce-scatter move (n-1)/n of
    the full buffer per device; all-reduce = RS + AG = 2(n-1)/n; all-to-all
    moves (n-1)/n; collective-permute moves exactly its message.  Without
    axis sizes the n -> inf limit (factor 1, all-reduce 2)."""
    if axis_sizes:
        n = 1
        for v in axis_sizes.values():
            n *= int(v)
        f = (n - 1) / n if n > 1 else 0.0
    else:
        f = 1.0
    factors = {
        "all-gather": f,
        "reduce-scatter": f,
        "all-reduce": 2 * f,
        "all-to-all": f,
        "collective-permute": 1.0,
        "collective-broadcast": 1.0,
        "ragged-all-to-all": f,
    }
    return sum(factors.get(k, 1.0) * v for k, v in stats.bytes_by_kind.items())


class CollectiveCounter(TorchDispatchMode):
    """Records every ``_c10d_functional`` collective run inside it into
    ``self.stats``."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "_c10d_functional":
            name = func.overloadpacket.__name__
            if name in _KINDS:
                kind, by_output = _KINDS[name]
                nbytes = _bytes(out) if by_output else _bytes(args[0])
                shapes = ",".join(f"{t.dtype}{list(t.shape)}" for t in tree_leaves(args[0])
                                  if isinstance(t, torch.Tensor))
                self.stats.record(kind, nbytes, f"{name}({shapes})")
        return out


def count_collectives(fn, *args, **kwargs) -> CollectiveStats:
    """Run ``fn(*args, **kwargs)`` once and census its collectives."""
    with CollectiveCounter() as c:
        fn(*args, **kwargs)
    return c.stats


def count_op(stats: CollectiveStats, opcode: str) -> int:
    """How many recorded collectives are of kind ``opcode`` (``all-reduce``)
    or of the ``_c10d_functional`` op ``opcode`` (``all_reduce``)."""
    return sum(1 for kind, _, line in stats.ops
               if kind == opcode or line.split("(", 1)[0] == opcode)
