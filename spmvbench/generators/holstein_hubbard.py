"""The exact Holstein-Hubbard Hamiltonian on an L-site chain: the CSR of
``spmvbench/gen.py``'s ``holstein_hubbard``."""
from __future__ import annotations

from .. import gen
from . import Matrix, from_csr


def build(params: dict, dtype) -> Matrix:
    return from_csr(*gen.holstein_hubbard(**params, dtype=dtype))
