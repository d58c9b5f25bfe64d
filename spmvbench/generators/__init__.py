"""The benchmark's matrix generators, one module a configuration's
``generator`` names: ``spmvbench/generators/<generator>.py``, whose
``build(params, dtype)`` makes the operator from the configuration's
``params`` (with ``seed`` where the configuration is ``seeded``) and the
numpy type of its ``value_dtype``, and returns a :class:`Matrix`.

A generator that can hold its operator as CSR hands the arrays over (the
drivers plan the program's CSR from copies of them); one whose operator no
CSR can hold hands over ``csr=None`` and a plain reference of its own, and
its driver builds the program's operator from ``params``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass(frozen=True)
class Matrix:
    """What a generator made: the sizes the yardstick counts from, the CSR
    arrays or ``None``, and the plain reference."""

    n: int
    #: nonzeros of the equivalent CSR
    nnz: int
    #: nonzeros on the main diagonal
    n_diag: int
    #: ``(row_ptr, col, val)`` as ``spmvbench/gen.py`` makes them, or None
    csr: tuple | None
    #: device -> an object with ``spmv(x, dtype, store)``, as ``CsrRef``'s
    reference: Callable


def from_csr(row_ptr: np.ndarray, col: np.ndarray, val: np.ndarray) -> Matrix:
    """The record of CSR arrays, with ``CsrRef`` over them as its reference."""
    from ..reference import CsrRef

    n = len(row_ptr) - 1
    rows = np.repeat(np.arange(n), np.diff(row_ptr))
    return Matrix(n=n, nnz=len(col), n_diag=int(np.count_nonzero(rows == col)),
                  csr=(row_ptr, col, val),
                  reference=lambda device: CsrRef(row_ptr, col, val, device))
