"""SparseLinear: a linear layer whose weight is stored in the paper's formats.

The paper's contribution applied to LM weights: a (d_out, d_in) weight is
stored as BSR (dense (bm, bn) blocks, for structured pruning) or SELL
(unstructured), with the format advisor choosing the scheme from the
sparsity pattern -- "a hint to the respective optimal storage scheme" --
and the hand-written kernels executing it: the BELL kernel for bsr (through
``kernels.ops.make_bsr_spmm``), the SELL SpMM kernel for sell (through
``SpMVPlan.spmm``).  At decode, with a few activation vectors, one apply is
the paper's SpMV: the weight streams once from device memory.

``SparseLinear`` is an ``nn.Module`` bound to one device: the container's
arrays live there as buffers, and the executor is compiled for them when
the module is built (build it again to change the device).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core import perfmodel as PM
from ..core.formats import BSR, CSR, SELL, _np, matrix_stats
from ..core.plan import SpMVPlan
from ..core.planconfig import PlanConfig
from ..kernels import ops as KOPS
from ..utils.hw import default_device

#: the tensor fields of the two weight containers, registered as buffers
_ARRAYS = {"bsr": ("block_row_ptr", "block_col_idx", "blocks", "scale"),
           "sell": ("chunk_ptr", "chunk_width", "col_idx", "val", "perm", "scale")}


class SparseLinear(nn.Module):
    """``y = x @ W^T`` with ``W`` (d_out, d_in) stored as a BSR or SELL
    container ``matrix``, run on ``device`` (default the card; "cpu" runs
    the plain PyTorch versions) by the ``backend`` the registry resolves
    ("auto": the kernel on the card)."""

    def __init__(self, fmt: str, matrix, *, density: float | None = None,
                 backend: str = "auto", device=None):
        super().__init__()
        if fmt not in _ARRAYS:
            raise ValueError(f"fmt={fmt!r}; expected one of {tuple(_ARRAYS)}")
        if not isinstance(matrix, BSR if fmt == "bsr" else SELL):
            raise TypeError(f"fmt={fmt!r} needs a {'BSR' if fmt == 'bsr' else 'SELL'} "
                            f"container, got {type(matrix).__name__}")
        self.device = default_device(device)
        self.fmt = fmt
        self.d_out, self.d_in = (int(s) for s in matrix.shape)
        self.matrix = dataclasses.replace(matrix, **{
            f: getattr(matrix, f).to(self.device) for f in _ARRAYS[fmt]
            if getattr(matrix, f) is not None})
        for f in _ARRAYS[fmt]:
            self.register_buffer(f, getattr(self.matrix, f))
        if density is None:
            vals = _np(matrix.blocks if fmt == "bsr" else matrix.val)
            density = np.count_nonzero(vals) / (self.d_out * self.d_in)
        self.density = float(density)
        if fmt == "bsr":
            self._apply_fn = KOPS.make_bsr_spmm(self.matrix, backend=backend,
                                                device=self.device)
        else:  # one SpMM over the batch, not B SpMVs
            be = {"pallas": "cuda", "ref": "torch"}.get(backend, backend)
            self._apply_fn = SpMVPlan.compile(
                self.matrix, PlanConfig(backend=be, device=self.device)).spmm

    @staticmethod
    def from_dense(w, *, fmt: str = "auto", block_shape: tuple[int, int] = (8, 128),
                   backend: str = "auto", device=None) -> "SparseLinear":
        """``w`` (d_out, d_in) with zeros marking pruned weights; ``fmt="auto"``
        asks ``advise_weight_format``.  (A layer over another storage
        precision is ``SparseLinear(fmt, with_value_dtype(container, vd))``.)"""
        w = _np(w)
        density = int((w != 0).sum()) / w.size
        if fmt == "auto":
            fmt = advise_weight_format(w, block_shape)
        if fmt == "bsr":
            mat = BSR.from_dense(w, block_shape)
        elif fmt == "sell":
            mat = SELL.from_csr(CSR.from_dense(w), C=8)   # default sigma window
        else:
            raise ValueError(fmt)
        return SparseLinear(fmt, mat, density=density, backend=backend, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., d_in) on the module's device -> (..., d_out), computed in
        f32 (f64 for f64 weights) and returned in x's dtype."""
        lead = x.shape[:-1]
        x2d = x.reshape(-1, self.d_in).T.to(torch.float32)   # (d_in, B)
        y2d = self._apply_fn(x2d)                              # (d_out, B)
        return y2d.T.reshape(*lead, self.d_out).to(x.dtype)

    def streamed_bytes(self, am: PM.AccessModel | None = None,
                       backend: str = "auto") -> float:
        """Model bytes of one SpMV through the stored weight, in the stream
        regime of ``backend`` ("auto": the executor on the module's device)."""
        be = PM.resolve_stream_backend(backend, self.device)
        return PM.spmv_streamed_bytes(self.matrix, am, backend=be)

    def extra_repr(self) -> str:
        return (f"fmt={self.fmt}, d_in={self.d_in}, d_out={self.d_out}, "
                f"density={self.density:.4f}, device={self.device}")


def magnitude_prune(w: np.ndarray, density: float, *,
                    structured: tuple[int, int] | None = None, seed: int = 0) -> np.ndarray:
    """Keep the top-``density`` fraction of weights by magnitude (whole
    ``structured`` blocks by mean magnitude, when given)."""
    w = np.asarray(w).copy()
    if structured:
        bm, bn = structured
        M, N = w.shape
        score = np.abs(w).reshape(M // bm, bm, N // bn, bn).mean((1, 3))
        k = max(1, int(score.size * density))
        thr = np.partition(score.ravel(), -k)[-k]
        mask = np.kron(score >= thr, np.ones((bm, bn), dtype=bool))
        w[~mask] = 0.0
    else:
        k = max(1, int(w.size * density))
        thr = np.partition(np.abs(w).ravel(), -k)[-k]
        w[np.abs(w) < thr] = 0.0
    return w


def advise_weight_format(w: np.ndarray, block_shape: tuple[int, int]) -> str:
    """BSR when the pattern is block-friendly (stored block entries at most
    2.5x the nonzeros, the balance model's crossover), else SELL."""
    bm, bn = block_shape
    M, N = w.shape
    if M % bm or N % bn:
        return "sell"
    tiles = np.abs(w).reshape(M // bm, bm, N // bn, bn).max((1, 3)) > 0
    nnz = (w != 0).sum()
    fill_ratio = tiles.sum() * bm * bn / max(1, nnz)
    return "bsr" if fill_ratio <= 2.5 else "sell"


def sparsity_report(w: np.ndarray, block_shape=(8, 128)) -> dict:
    """``matrix_stats`` of the weight plus the advised format."""
    st = matrix_stats(CSR.from_dense(np.asarray(w)))
    st["advised_format"] = advise_weight_format(w, block_shape)
    return st
