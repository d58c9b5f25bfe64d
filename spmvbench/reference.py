"""The plain reference: SpMV and Lanczos in plain PyTorch from the CSR
arrays the benchmark made, on whatever device it is given.

It imports nothing of the program and reads nothing the program derived:
the SpMV is a gather, a product and an ``index_add_`` over the benchmark's
own CSR; Lanczos is the textbook three-term recurrence with, where asked,
two classical Gram-Schmidt passes a step.  ``dtype`` sets the precision of
the vectors and of the sums; the lower precisions of ``control_precision``
serve as the control, the reference put in the program's place one
precision below what the configuration states.
"""
from __future__ import annotations

import numpy as np
import torch


class CsrRef:
    """The benchmark's CSR on ``device``, values as stored."""

    def __init__(self, row_ptr: np.ndarray, col: np.ndarray, val: np.ndarray, device):
        self.n = len(row_ptr) - 1
        lens = torch.from_numpy(np.diff(row_ptr.astype(np.int64))).to(device)
        self.rows = torch.repeat_interleave(torch.arange(self.n, device=device), lens)
        self.cols = torch.from_numpy(col.astype(np.int64)).to(device)
        self.val = torch.from_numpy(val).to(device)
        self.device = torch.device(device)

    def spmv(self, x: torch.Tensor, dtype: torch.dtype = torch.float64,
             store: torch.dtype | None = None) -> torch.Tensor:
        """y = A x with the products and sums in ``dtype``; ``store`` rounds
        the values and x first (the bf16 control of a float32 product)."""
        v, xs = self.val, x
        if store is not None:
            v, xs = v.to(store), xs.to(store)
        prod = v.to(dtype) * xs.to(dtype)[self.cols]
        return torch.zeros(self.n, dtype=dtype, device=self.device).index_add_(0, self.rows, prod)


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max |y - ref| / max |ref|, in f64; NaN where y holds a NaN."""
    return float((y.to(torch.float64) - ref).abs().max() / ref.abs().max())


def worst(values) -> float:
    """The largest of ``values``: NaN if any is NaN, infinite if there are
    none (nothing compared is no evidence of a correct run)."""
    vals = [float(v) for v in values]
    if not vals:
        return float("inf")
    return float(np.max(vals))


def control_precision(vector_dtype: str) -> tuple[torch.dtype, torch.dtype]:
    """(storage, sums) of the control: one step below the configuration's
    vectors, f32 for f64, and for f32 the values and x in bf16 with f32
    sums."""
    if vector_dtype == "float64":
        return torch.float32, torch.float32
    if vector_dtype == "float32":
        return torch.bfloat16, torch.float32
    raise ValueError(f"no control below {vector_dtype}")


def lanczos(A: CsrRef, v0: torch.Tensor, m: int, reorthogonalize: bool,
            dtype: torch.dtype = torch.float64):
    """m steps of Lanczos from ``v0``; returns (alphas, betas, E0) with the
    coefficients as f64 numpy arrays and E0 the least eigenvalue of the
    tridiagonal matrix.  Stops early, as the algorithm does, when beta falls
    to 1e-12 of |alpha|."""
    v = v0.to(device=A.device, dtype=dtype)
    v = v / torch.linalg.vector_norm(v)
    V = torch.empty((m + 1, A.n), dtype=dtype, device=A.device) if reorthogonalize else None
    if V is not None:
        V[0] = v
    v_prev = torch.zeros_like(v)
    beta = 0.0
    alphas, betas = [], []
    for j in range(m):
        w = A.spmv(v, dtype)
        alpha = torch.dot(v, w)
        w = w - alpha * v - beta * v_prev
        if V is not None:
            for _ in range(2):
                w = w - V[:j + 1].T @ (V[:j + 1] @ w)
        beta_new = torch.linalg.vector_norm(w)
        a, b = float(alpha), float(beta_new)
        alphas.append(a)
        betas.append(b)
        if not (np.isfinite(a) and np.isfinite(b)) or b < 1e-12 * max(1.0, abs(a)):
            break
        v_prev, v, beta = v, w / beta_new, beta_new
        if V is not None:
            V[j + 1] = v
    return np.asarray(alphas), np.asarray(betas), tridiagonal_min(alphas, betas)


def tridiagonal_min(alphas, betas) -> float:
    a = np.asarray(alphas, dtype=np.float64)
    if not len(a) or not np.all(np.isfinite(a)) or not np.all(np.isfinite(betas)):
        return float("nan")
    b = np.asarray(betas[:len(a) - 1], dtype=np.float64)
    return float(np.linalg.eigvalsh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))[0])
