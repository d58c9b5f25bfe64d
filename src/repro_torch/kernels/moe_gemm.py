"""Grouped (MoE expert) GEMM: the CUDA kernel's wrapper, its plain PyTorch
version, and the host-routed dispatch around it (sort, pad, unsort).

MoE expert weights are block-sparse by routing: each token tile multiplies
exactly one expert's weights, a block pattern decided at dispatch.  The
function is ``Y[tile t] = X[tile t] @ W[tile_expert[t]]`` for ``X (T, D)``
sorted by expert with every expert's group padded to a multiple of ``bt``
rows, and ``W (E, D, F)``; the output is ``result_type(X, W)``.  Padding
rows are zero rows, multiplied like any other and dropped on unsort, so
the padded ``Yp`` equals the reference's.  ``grouped_gemm_arrays``
launches ``csrc/grouped_gemm.cu`` on CUDA tensors and runs
``grouped_gemm_plain`` on CPU tensors.  The source holds two kernels;
``gemm_plan`` picks one by rule: the wgmma + TMA kernel on the bf16
tensor cores, or the register-tiled SIMT kernel on the f32 pipes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build as CB

NAME = "grouped_gemm"
_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 + [ctypes.c_int64] + \
    [ctypes.c_int] * 5 + [ctypes.c_void_p]

#: input / output dtypes of the kernel and their codes in grouped_gemm.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the two kernels of grouped_gemm.cu (GemmPath); each launch is counted
#: under NAME and under ``grouped_gemm_<path>``
PATHS = {"simt": 0, "wgmma": 1}


def plan_groups(expert_of_token: np.ndarray, n_experts: int, bt: int):
    """Sort tokens by expert and pad each group to a multiple of ``bt``.

    Returns ``(order, inverse_scatter, tile_expert, padded_T)`` as numpy, the
    reference's arrays: ``inverse_scatter[t]`` is the padded row of token t.
    """
    expert_of_token = np.asarray(expert_of_token)
    order = np.argsort(expert_of_token, kind="stable").astype(np.int32)
    counts = np.bincount(expert_of_token, minlength=n_experts)
    padded = np.maximum(-(-counts // bt) * bt, 0)
    starts = np.concatenate([[0], np.cumsum(padded)])
    T_pad = int(starts[-1]) if starts[-1] else bt
    tile_expert = np.zeros(max(1, T_pad // bt), dtype=np.int32)
    tile_expert[:int(starts[-1]) // bt] = np.repeat(
        np.arange(len(counts), dtype=np.int32), padded // bt)
    # destination row of each sorted token: its group's start + its rank
    src_starts = np.concatenate([[0], np.cumsum(counts)])
    group = np.repeat(np.arange(len(counts)), counts)
    dest = (starts[group] + np.arange(len(order)) - src_starts[group]).astype(np.int32)
    inverse_scatter = np.zeros(len(order), dtype=np.int32)
    inverse_scatter[order] = dest
    return order, inverse_scatter, tile_expert, T_pad


def grouped_gemm_plain(tile_expert, X, W, bt: int):
    """Gather every tile's expert weights and ``bmm``."""
    T, D = X.shape
    odt = torch.promote_types(X.dtype, W.dtype)
    Wt = W.index_select(0, tile_expert.long()).to(odt)      # (T/bt, D, F)
    return torch.bmm(X.to(odt).reshape(T // bt, bt, D), Wt).reshape(T, W.shape[2])


def gemm_rows(bt: int) -> int:
    """Rows of one output sub-tile: the largest divisor of ``bt`` up to 64,
    so that a tile never straddles two experts."""
    return max(d for d in range(1, min(bt, 64) + 1) if bt % d == 0)


def gemm_plan(bt: int, D: int, F: int, x_dtype, w_dtype) -> tuple[str, int]:
    """``(path, bm)``: which kernel of grouped_gemm.cu runs, and the rows of
    its CTA tile (both kernels take 128 columns of F a CTA).  The wgmma kernel takes bf16 x bf16 with ``bt % 64 == 0`` (its
    tiles are 64 or 128 rows of one expert) and ``D % 8 == 0``, ``F % 8 ==
    0`` (TMA needs 16-byte row strides), at 128 rows where ``bt % 128 ==
    0``.  Everything else runs the SIMT kernel, whose CTA covers two
    consecutive ``gemm_rows`` sub-tiles of one expert where ``bt`` holds
    them and 128 rows do, else one."""
    if x_dtype == w_dtype == torch.bfloat16 and bt % 64 == 0 and D % 8 == 0 \
            and F % 8 == 0:
        return "wgmma", (128 if bt % 128 == 0 else 64)
    rows = gemm_rows(bt)
    bm = 2 * rows if bt % (2 * rows) == 0 and 2 * rows <= 128 else rows
    return "simt", bm


def grouped_gemm_arrays(tile_expert, X, W, *, bt: int = 128, bf: int | None = None):
    """Grouped GEMM over a sorted, group-padded ``X (T, D)``: the CUDA
    kernel ``gemm_plan`` picks for CUDA tensors, the plain version for CPU
    tensors.  ``bf`` (default F) must divide F, the reference's contract;
    the kernels tile F by their own 128 columns."""
    T, D = X.shape
    E, D2, F = W.shape
    bf = bf or F
    if D != D2 or T % bt or F % bf:
        raise ValueError(f"grouped_gemm: X {tuple(X.shape)}, W {tuple(W.shape)}, "
                         f"bt={bt}, bf={bf}: need D equal, T % bt == 0, F % bf == 0")
    if tile_expert.shape != (T // bt,):
        raise ValueError(f"tile_expert has shape {tuple(tile_expert.shape)}, "
                         f"expected ({T // bt},)")
    if X.device.type == "cpu":
        return grouped_gemm_plain(tile_expert, X, W, bt)
    if X.device.type != "cuda":
        raise ValueError(f"grouped_gemm: no kernel for device {X.device}")
    dev = X.device
    for t, what in ((X, "X"), (W, "W")):
        CB.check_tensor(t, what, dev, tuple(_CODES))
    CB.check_tensor(tile_expert, "tile_expert", dev, (torch.int32,), 1)
    odt = torch.promote_types(X.dtype, W.dtype)
    Y = torch.empty((T, F), dtype=odt, device=dev)
    if T == 0 or F == 0:
        return Y
    path, bm = gemm_plan(bt, D, F, X.dtype, W.dtype)
    CB.launch(NAME, _ARGTYPES, dev, PATHS[path], _CODES[X.dtype], _CODES[W.dtype],
              _CODES[odt], CB.ptr(tile_expert), CB.ptr(X), CB.ptr(W), CB.ptr(Y), T, D, F, E,
              bt, bm, counts=(NAME, f"{NAME}_{path}"))
    return Y


def grouped_gemm(X, expert_of_token, W, *, bt: int = 128, plain: bool = False):
    """Full dispatch: sort and pad the tokens (host routing, as the
    reference's serving path), the grouped GEMM, unsort.  ``X (T, D)`` in
    token order; ``plain=True`` runs the plain version on any device."""
    T, D = X.shape
    _, inv, tile_expert, T_pad = plan_groups(np.asarray(expert_of_token), W.shape[0], bt)
    inv = torch.from_numpy(inv.astype(np.int64)).to(X.device)
    te = torch.from_numpy(tile_expert).to(X.device)
    Xp = torch.zeros((T_pad, D), dtype=X.dtype, device=X.device).index_copy_(0, inv, X)
    Yp = grouped_gemm_plain(te, Xp, W, bt) if plain else \
        grouped_gemm_arrays(te, Xp, W, bt=bt)
    return Yp.index_select(0, inv)
