"""Containers from plain arrays: the bridge the parity tests use.

``from_reference_arrays(kind, arrays, meta)`` builds a port container from
the numpy arrays of a container of the same kind and its scalar metadata,
so both packages can be fed the identical matrix; ``sparse_linear_from_arrays``
builds a ``SparseLinear`` over such a container, ``expert_weights``
takes MoE expert weights ``W (E, D, F)`` over, ``lm_state_from_reference``
turns an LM's parameter tree into the port module's state dict and
``opt_state_from_reference`` / ``opt_state_to_reference`` carry an AdamW
state across (``utils.tree.stacked_tree`` is the way back for parameters).
It reads arrays only and imports nothing of the reference package; bf16 and
fp8 arrays (whose numpy dtypes come from an extension package) are taken
over by their raw bits.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import formats as F

#: numpy dtype names without a numpy builtin -> the torch dtype of the bits
_BITS_DTYPES = {"bfloat16": (np.int16, torch.bfloat16),
                "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def as_tensor(a) -> torch.Tensor | None:
    """A CPU tensor holding exactly the values of ``a`` (None passes)."""
    if a is None or isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype.name in _BITS_DTYPES:
        bits, dtype = _BITS_DTYPES[a.dtype.name]
        return torch.from_numpy(a.view(bits).copy()).view(dtype)
    return torch.from_numpy(a.copy())


def from_reference_arrays(kind: str, arrays: dict, meta: dict):
    """A port container of ``kind`` ("coo", "csr", "ell", "jds", "sell",
    "bsr", "dia", "hybrid", "matrix_free") from ``arrays`` (name -> array; for "hybrid" the dicts
    ``arrays["dia"]`` / ``arrays["rest"]``) and ``meta`` (shape and the
    container's scalar fields; for "hybrid" ``meta["dia"]`` /
    ``meta["rest"]``)."""
    a = {k: as_tensor(v) for k, v in arrays.items() if not isinstance(v, dict)}
    shape = tuple(int(s) for s in meta["shape"])
    if kind == "coo":
        return F.COO(a["rows"], a["cols"], a["vals"], shape, a.get("scale"))
    if kind == "csr":
        return F.CSR(a["row_ptr"], a["col_idx"], a["val"], shape, a.get("scale"))
    if kind == "ell":
        return F.ELL(a["col_idx"], a["val"], shape, int(meta["nnz"]), a.get("scale"))
    if kind == "jds":
        return F.JDS(a["jd_ptr"], a["col_idx"], a["val"], a["perm"], shape,
                     a.get("scale"))
    if kind == "sell":
        return F.SELL(a["chunk_ptr"], a["chunk_width"], a["col_idx"], a["val"],
                      a["perm"], shape, int(meta["C"]), int(meta["sigma"]),
                      int(meta["nnz"]), a.get("scale"))
    if kind == "bsr":
        return F.BSR(a["block_row_ptr"], a["block_col_idx"], a["blocks"], shape,
                     tuple(int(b) for b in meta["block_shape"]), a.get("scale"))
    if kind == "dia":
        return F.DIA(a["offsets"], a["data"], shape, a.get("scale"))
    if kind == "hybrid":
        return F.HybridDIA(
            from_reference_arrays("dia", arrays["dia"], {"shape": shape, **meta.get("dia", {})}),
            from_reference_arrays("sell", arrays["rest"], {"shape": shape, **meta["rest"]}),
            shape)
    if kind == "matrix_free":
        return F.MatrixFreeOperator(
            data=a.get("data"), shape=shape, offsets=tuple(meta["offsets"]),
            periods=tuple(meta["periods"]), los=tuple(meta["los"]),
            his=tuple(meta["his"]), gen_values=tuple(meta["gen_values"]),
            nnz=int(meta["nnz"]), stored_nnz=int(meta["stored_nnz"]),
            value_dtype=str(meta["value_dtype"]))
    raise ValueError(f"unknown container kind {kind!r}")


def sparse_linear_from_arrays(fmt: str, arrays: dict, meta: dict, *,
                              density: float | None = None, backend: str = "auto",
                              device=None):
    """A ``models.sparse.SparseLinear`` whose weight is the ``fmt`` ("bsr"
    or "sell") container of ``arrays`` / ``meta`` (as
    ``from_reference_arrays`` takes them)."""
    from .models.sparse import SparseLinear
    return SparseLinear(fmt, from_reference_arrays(fmt, arrays, meta), density=density,
                        backend=backend, device=device)


def expert_weights(W, device=None) -> torch.Tensor:
    """MoE expert weights ``W (E, D, F)`` (numpy, bf16 by its bits) as a
    tensor on ``device`` (default the card)."""
    from .utils.hw import default_device
    t = as_tensor(W)
    if t.dim() != 3:
        raise ValueError(f"expert weights must be (E, D, F), got shape {tuple(t.shape)}")
    return t.to(default_device(device))


def lm_state_from_reference(cfg, tree) -> dict:
    """The ``state_dict`` of the port's module (``models.registry.Model(cfg)``)
    holding the parameters of the reference's tree ``tree`` (nested dicts
    and lists of arrays).  Each stacked leaf of ``units`` / ``enc_units`` /
    ``dec_units`` is split along axis 0, one entry a unit module; values
    pass bit for bit (``as_tensor``)."""
    from .utils.tree import STACKED

    n_stacked = {"units": cfg.n_units, "enc_units": cfg.n_enc_layers,
                 "dec_units": cfg.n_layers}
    state = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        elif path[0] in STACKED:
            a = np.asarray(node)
            if a.shape[0] != n_stacked[path[0]]:
                raise ValueError(f"{'/'.join(path)}: {a.shape[0]} stacked entries, "
                                 f"the config has {n_stacked[path[0]]}")
            for i in range(a.shape[0]):
                state[".".join([path[0], str(i)] + path[1:])] = as_tensor(a[i])
        else:
            state[".".join(path)] = as_tensor(node)

    walk(tree, [])
    return state


def opt_state_from_reference(cfg, tree) -> dict:
    """The port's AdamW state ({"m", "v"} keyed by the module's parameter
    names, "step" an int32 scalar tensor) of the reference's opt-state tree
    ``tree`` for the config ``cfg``; values pass bit for bit."""
    return {"m": lm_state_from_reference(cfg, tree["m"]),
            "v": lm_state_from_reference(cfg, tree["v"]),
            "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32)}


def opt_state_to_reference(opt_state: dict) -> dict:
    """The reference's opt-state tree of the port's AdamW state: the moments
    stacked as the reference's parameter tree (tensors on their device)."""
    from .utils.tree import stacked_tree
    return {"m": stacked_tree(opt_state["m"]), "v": stacked_tree(opt_state["v"]),
            "step": opt_state["step"]}
