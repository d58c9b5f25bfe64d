"""Small tree utilities shared across the LM stack.

A tree is a nested dict (keys visited in sorted order, as ``jax.tree``
does) or list / tuple whose leaves are tensors or :class:`TensorSpec`s; an
``nn.Module`` stands for its ``state_dict()``.  ``TensorSpec`` takes the
place of the reference's ``jax.ShapeDtypeStruct``: a shape and a dtype, no
storage.

The port's modules name a parameter by its dotted path (``units.3.attn.wq``);
the reference keeps one tree in which the entries of the ``STACKED`` lists
are stacked along a leading axis (``units/attn/wq`` of shape ``(L, ...)``)
and ``head_layers`` is a list.  ``stacked_tree`` builds the reference's tree
from names, ``reference_path`` names the leaf (and the entry of its
leading axis) a port name lands in.
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


#: the module lists whose entries the reference stacks along a leading axis
STACKED = ("units", "enc_units", "dec_units")
#: the module lists the reference keeps as Python lists
LISTED = ("head_layers",)


def reference_path(name: str) -> tuple[str, int | None]:
    """The reference's slash-joined leaf path of the port's parameter
    ``name``, and the index along its stacked axis (None when unstacked):
    ``units.3.attn.wq`` -> (``units/attn/wq``, 3)."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def stacked_tree(named, stack=None) -> dict:
    """The reference's nested tree of ``named`` (a module -- its parameters
    -- or a dict of leaves keyed by the port's parameter names, such as
    grads or AdamW moments): dicts by name, the ``STACKED`` lists' leaves
    combined by ``stack`` (default ``torch.stack`` on axis 0) in unit order,
    the ``LISTED`` lists as lists."""
    if isinstance(named, nn.Module):
        named = {k: p.detach() for k, p in named.named_parameters()}
    stack = torch.stack if stack is None else stack
    tree: dict = {}
    for key, leaf in named.items():
        *path, last = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    for key in STACKED:
        if key in tree:
            tree[key] = _stack_entries([tree[key][str(i)] for i in range(len(tree[key]))],
                                       stack)
    for key in LISTED:
        if key in tree:
            tree[key] = [tree[key][str(i)] for i in range(len(tree[key]))]
    return tree


def _stack_entries(entries: list, stack):
    if isinstance(entries[0], dict):
        return {k: _stack_entries([e[k] for e in entries], stack) for k in entries[0]}
    return stack(entries)


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
    """sqrt of the sum of every leaf's squared entries, in f32 (one
    multi-tensor norm, not a reduction a leaf)."""
    ts = [leaf.float() for leaf in leaves(tree) if isinstance(leaf, torch.Tensor)]
    if not ts:
        return torch.tensor(0.0)
    return torch.stack(torch._foreach_norm(ts)).square().sum().sqrt()


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
