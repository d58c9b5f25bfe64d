"""The accumulation-dtype contract shared by every kernel backend.

Value storage precision is a streaming choice: it sets the bytes an SpMV
moves, never the arithmetic it does.  Kernels multiply-accumulate in at
least f32 whatever the stored dtype; f64 stays f64.
"""
from __future__ import annotations

import torch


def acc_dtype(*dtypes) -> torch.dtype:
    """f64 if any operand dtype is f64, else f32 (narrow storage widens)."""
    if any(d == torch.float64 for d in dtypes):
        return torch.float64
    return torch.float32
