"""Small tree utilities shared across the LM stack.

A tree is a nested dict (keys visited in sorted order, as ``jax.tree``
does) or list / tuple whose leaves are tensors or :class:`TensorSpec`s; an
``nn.Module`` stands for its ``state_dict()``.  ``TensorSpec`` takes the
place of the reference's ``jax.ShapeDtypeStruct``: a shape and a dtype, no
storage.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not allocated."""

    shape: tuple
    dtype: torch.dtype

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))


def _items(tree):
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree) -> list[tuple[str, object]]:
    """(slash-joined path, leaf) pairs in the reference's order."""
    items = _items(tree)
    if items is None:
        return [("", tree)]
    out = []
    for k, sub in items:
        for path, leaf in flatten_with_paths(sub):
            out.append((f"{k}/{path}" if path else k, leaf))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def map_tree(fn, tree):
    """The tree with every leaf replaced by ``fn(leaf)`` (modules become the
    dict of their state)."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def _is_float(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def param_count(tree) -> int:
    """Total number of elements across all tensor / spec leaves."""
    return int(sum(torch.Size(leaf.shape).numel() if hasattr(leaf, "shape") else 1
                   for leaf in leaves(tree)))


def param_bytes(tree) -> int:
    return int(sum(torch.Size(leaf.shape).numel() * leaf.dtype.itemsize
                   for leaf in leaves(tree) if hasattr(leaf, "dtype")))


def tree_any_nan(tree) -> bool:
    """True when any floating leaf holds a NaN, checked in the leaf's own
    dtype (an upcast could turn finite values into Inf and costs a copy)."""
    flags = [torch.isnan(leaf).any() for leaf in leaves(tree) if _is_float(leaf)]
    return bool(torch.stack(flags).any()) if flags else False


def tree_any_nonfinite(tree) -> bool:
    """True when any floating leaf holds a NaN or an Inf (own dtype)."""
    flags = [(~torch.isfinite(leaf)).any() for leaf in leaves(tree) if _is_float(leaf)]
    return bool(torch.stack(flags).any()) if flags else False


def global_norm(tree) -> torch.Tensor:
    sq = [leaf.float().square().sum() for leaf in leaves(tree)
          if isinstance(leaf, torch.Tensor)]
    return torch.stack(sq).sum().sqrt() if sq else torch.tensor(0.0)


def cast_tree(tree, dtype: torch.dtype):
    """Floating leaves cast to ``dtype`` (specs get the new dtype); the rest
    pass."""
    def cast(leaf):
        if _is_float(leaf):
            return leaf.to(dtype)
        if isinstance(leaf, TensorSpec) and leaf.dtype.is_floating_point:
            return TensorSpec(leaf.shape, dtype)
        return leaf
    return map_tree(cast, tree)
