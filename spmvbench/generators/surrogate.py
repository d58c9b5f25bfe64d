"""The HMeP statistics at any N, drawn from the run's seed: the CSR of
``spmvbench/gen.py``'s ``surrogate``."""
from __future__ import annotations

from .. import gen
from . import Matrix, from_csr


def build(params: dict, dtype) -> Matrix:
    return from_csr(*gen.surrogate(**params, dtype=dtype))
