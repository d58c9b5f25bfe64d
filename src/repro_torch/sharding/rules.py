"""Sharding rules: parameter-path regexes -> partition specs, as pure spec
computation.

Logical axes:
  TP   -- the mesh "model" axis: attention heads, FFN hidden, vocab, experts.
  DP   -- the data axes ("data", plus "pod" when multi-pod): batch, and
          (ZeRO-1) optimizer-state shards.

Rules match on the '/'-joined parameter path of the reference's stacked tree
(``Model.param_shapes()``) and give a spec for the *trailing* dims of the
tensor (stacked layer axes are padded with None on the left).  The resolver
downgrades any axis whose dimension is not divisible by the mesh-axis size
to replicated (e.g. a 24-wide dim on a 16-way model axis), so every config
resolves on every mesh.

The port trains on one card: a mesh here is anything with ``axis_names``
and a ``shape`` dict (``launch.mesh.AbstractMesh`` for the production
meshes, ``launch.mesh.DeviceMesh`` over the visible cards), and a spec is a
``PartitionSpec`` -- a frozen sequence of axis names (or tuples of them)
and None that compares and prints as JAX's does.  On the one-card host mesh (1, 1) every
axis has size 1, so nothing is split (``spec_splits``).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Sequence

from ..utils.tree import flatten_with_paths, leaves, map_tree

TP = "model"
# DP axes resolved at mesh time: ("pod", "data") if present, else ("data",)


@dataclass(frozen=True, init=False)
class PartitionSpec:
    """One entry per tensor dim: a mesh-axis name, a tuple of names, or None
    (replicated).  Compared and printed as ``jax.sharding.PartitionSpec``;
    not a tuple, so tree utilities take it as one leaf."""

    entries: tuple

    def __init__(self, *entries):
        object.__setattr__(self, "entries", tuple(entries))

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"

    __str__ = __repr__


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec placed on a mesh (the port's stand-in for JAX's)."""

    mesh: object
    spec: PartitionSpec


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _size(mesh, names) -> int:
    return int(math.prod(mesh.shape[n] for n in names))


def spec_splits(spec: PartitionSpec, mesh) -> bool:
    """True when ``spec`` really splits a dim over ``mesh`` (some named axis
    has more than one device)."""
    return any(_size(mesh, e if isinstance(e, tuple) else (e,)) > 1
               for e in spec if e is not None)


# (regex, trailing-dims spec template) -- template entries: "tp", "dp", None
PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings: vocab-sharded (row-parallel embed / column-parallel unembed)
    (r"(embed|unembed)/table$", ("tp", None)),
    # attention projections
    (r"attn/wq$", (None, "tp")),
    (r"attn/wk$", (None, "tp")),
    (r"attn/wv$", (None, "tp")),
    (r"attn/wo$", ("tp", None)),
    (r"attn/(q_norm|k_norm)$", (None,)),
    # MLA
    (r"attn/w_dkv$", (None, None)),
    (r"attn/w_kr$", (None, None)),
    (r"attn/kv_norm$", (None,)),
    (r"attn/w_uk$", (None, "tp")),
    (r"attn/w_uv$", (None, "tp")),
    # MoE: expert-parallel over TP
    (r"moe/router$", (None, None)),
    (r"moe/wi_(gate|up)$", ("tp", None, None)),
    (r"moe/wo$", ("tp", None, None)),
    (r"moe/shared/wi_(gate|up)$", (None, "tp")),
    (r"moe/shared/wo$", ("tp", None)),
    # dense MLP
    (r"mlp/wi_(gate|up)$", (None, "tp")),
    (r"mlp/wo$", ("tp", None)),
    # mamba2 (per-stream projections: shard boundaries align by construction)
    (r"ssm/(z_proj|x_proj|bc_proj|dt_proj)$", (None, "tp")),
    (r"ssm/conv_(x|bc)_w$", ("tp", None)),
    (r"ssm/conv_(x|bc)_b$", ("tp",)),
    (r"ssm/(A_log|D|dt_bias)$", (None,)),
    (r"ssm/norm$", ("tp",)),
    (r"ssm/out_proj$", ("tp", None)),
    # norms / scalars
    (r"(ln_\w+|norm)/scale$", (None,)),
]


def _match_spec(path: str) -> tuple | None:
    for rx, spec in PARAM_RULES:
        if re.search(rx, path):
            return spec
    return None


def _resolve(template: Sequence, shape: tuple[int, ...], mesh,
             fallbacks: list | None = None, path: str = "") -> PartitionSpec:
    """Pad template to rank, map 'tp'/'dp' to mesh axes, check divisibility."""
    rank = len(shape)
    tmpl = (None,) * (rank - len(template)) + tuple(template)
    axes_of = {"tp": (TP,), "dp": dp_axes(mesh)}
    out = []
    for dim, t in zip(shape, tmpl):
        if t is None:
            out.append(None)
            continue
        names = axes_of.get(t, (t,))
        names = tuple(n for n in names if n in mesh.axis_names)
        size = _size(mesh, names) if names else 1
        if not names or dim % size != 0:
            if fallbacks is not None:
                fallbacks.append((path, t, dim, size))
            out.append(None)
        else:
            out.append(names if len(names) > 1 else names[0])
    return P(*out)


# Sharding profiles:
#   default : TP over "model" per PARAM_RULES
#   dp_only : replicate params, shard batch over EVERY mesh axis
#   moe2d   : MoE expert weights sharded expert x hidden over (model x data)
_MOE2D_OVERRIDES = [
    (r"moe/wi_(gate|up)$", ("tp", None, "dp")),
    (r"moe/wo$", ("tp", "dp", None)),
]


def _match_spec_profile(path: str, profile: str):
    if profile == "moe2d":
        for rx, spec in _MOE2D_OVERRIDES:
            if re.search(rx, path):
                return spec
    return _match_spec(path)


def _unflatten(tree, values: list):
    """``tree`` with its leaves replaced by ``values`` in flatten order."""
    it = iter(values)
    return map_tree(lambda _: next(it), _sorted(tree))


def _sorted(tree):
    """``tree`` with its dicts in sorted key order (the order of
    ``flatten_with_paths``, so a map visits leaves in that order)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def param_specs(param_shapes, mesh, *, log_fallbacks: bool = False,
                profile: str = "default"):
    """Tree of PartitionSpec matching ``param_shapes`` (the reference's
    stacked tree of TensorSpecs or tensors, as ``Model.param_shapes()``)."""
    fallbacks: list = []
    specs = []
    for name, leaf in flatten_with_paths(param_shapes):
        tmpl = _match_spec_profile(name, profile)
        if profile == "dp_only" and tmpl is not None:
            tmpl = tuple(None if t == "tp" else t for t in tmpl)
        if tmpl is None:
            specs.append(P())
        else:
            specs.append(_resolve(tmpl, leaf.shape, mesh, fallbacks, name))
    if log_fallbacks and fallbacks:
        seen = set()
        for path, t, dim, size in fallbacks:
            key = re.sub(r"units/", "", path)
            if key in seen:
                continue
            seen.add(key)
            print(f"[sharding] replicated {path}: dim {dim} % {t}({size}) != 0")
    return _unflatten(param_shapes, specs)


def param_shardings(param_shapes, mesh, **kw):
    return map_tree(lambda s: NamedSharding(mesh, s), param_specs(param_shapes, mesh, **kw))


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding on top of TP
# ---------------------------------------------------------------------------


def zero1_specs(param_shapes, mesh, *, profile: str = "default"):
    """Optimizer-state specs: the param spec plus DP sharding on the largest
    still-replicated dim (divisibility permitting)."""
    base = param_specs(param_shapes, mesh, profile=profile)
    if profile == "dp_only":
        dps = tuple(mesh.axis_names)       # every axis is a data axis
    else:
        dps = dp_axes(mesh)
    dp_size = _size(mesh, dps) if dps else 1

    def augment(spec: PartitionSpec, leaf):
        if dp_size <= 1:
            return spec
        shape = leaf.shape
        entries = list(spec) + [None] * (len(shape) - len(spec))
        # a dp axis may appear at most once per spec (e.g. moe2d already
        # spends "data" on the expert hidden dim) -- skip if present
        used = {a for e in entries if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        if used & set(dps):
            return spec
        # choose the largest replicated dim divisible by dp_size
        best, best_dim = None, 0
        for i, (s, d) in enumerate(zip(entries, shape)):
            if s is None and d % dp_size == 0 and d > best_dim:
                best, best_dim = i, d
        if best is None:
            return spec
        entries[best] = dps if len(dps) > 1 else dps[0]
        return P(*entries)

    specs = [augment(s, leaf) for s, leaf in zip(leaves(base), leaves(param_shapes))]
    return _unflatten(param_shapes, specs)


# ---------------------------------------------------------------------------
# activation / batch / cache shardings
# ---------------------------------------------------------------------------


def batch_specs(batch_shapes, mesh, *, profile: str = "default"):
    """Shard dim 0 (global batch) over the DP axes (every axis in dp_only)."""
    dps = tuple(mesh.axis_names) if profile == "dp_only" else dp_axes(mesh)
    dp = dps if len(dps) > 1 else (dps[0] if dps else None)
    dp_size = _size(mesh, dps) if dps else 1

    def spec(leaf):
        if not leaf.shape or leaf.shape[0] % dp_size:
            return P()
        return P(dp, *([None] * (len(leaf.shape) - 1)))

    return _unflatten(batch_shapes, [spec(leaf) for _, leaf in flatten_with_paths(batch_shapes)])


def cache_specs(cache_shapes, mesh, *, seq_axis_threshold: int = 100_000):
    """KV/SSM-cache sharding for serving:

    * batch dim over DP when divisible;
    * KV-head / SSM-head dim over TP when divisible;
    * for very long contexts (>= threshold) with unshardable heads, shard the
      *sequence* dim over TP instead (sequence parallelism for decode).
    """
    dps = dp_axes(mesh)
    dp = dps if len(dps) > 1 else (dps[0] if dps else None)
    dp_size = _size(mesh, dps) if dps else 1
    tp_size = int(mesh.shape[TP]) if TP in mesh.axis_names else 1

    def spec_shape(shape):
        entries: list = [None] * len(shape)
        if shape and shape[0] % dp_size == 0 and shape[0] >= dp_size:
            entries[0] = dp
        # rank-4: KV cache (B, S, K, hd) -- S huge -- or SSM state (B, H, hd, N)
        if len(shape) == 4:
            kv_like = shape[1] >= 1024 and shape[1] >= 4 * shape[2]
            if kv_like:
                if shape[2] % tp_size == 0 and shape[2] >= tp_size:
                    entries[2] = TP      # KV heads
                elif shape[1] % tp_size == 0 and shape[1] >= seq_axis_threshold:
                    entries[1] = TP      # sequence parallelism over the cache
            else:
                if shape[1] % tp_size == 0 and shape[1] >= tp_size:
                    entries[1] = TP      # SSM heads
                elif shape[2] % tp_size == 0 and shape[2] >= tp_size:
                    entries[2] = TP
        elif len(shape) == 3:            # MLA latent (B, S, lora) / conv state
            if shape[1] >= seq_axis_threshold and shape[1] % tp_size == 0:
                entries[1] = TP
            elif shape[2] % tp_size == 0 and shape[2] >= tp_size:
                entries[2] = TP          # conv channels / latent dim
        return entries

    out = []
    for path, leaf in flatten_with_paths(cache_shapes):
        shape = tuple(leaf.shape)
        if "units" in path.split("/"):
            # stacked (n_units, ...) cache: layer axis stays unsharded
            entries = [None] + spec_shape(shape[1:])
        else:
            entries = spec_shape(shape)
        out.append(P(*entries))
    return _unflatten(cache_shapes, out)
