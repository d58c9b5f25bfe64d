"""The paper's own experiment config: Holstein-Hubbard SpMVM + Lanczos.

Matches the paper's evaluation setting (Sec. 4.2 / Fig. 5): a symmetric
Hamiltonian with ~14 nnz/row, ~60 % of non-zeros in 12 dense secondary
diagonals, the remainder scattered over a band.  ``paper_scale`` uses the
published dimension N = 1,201,200; smaller presets keep CPU runs fast.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.matrices import HolsteinHubbardParams
from ..core.planconfig import default_sell_sigma


@dataclass(frozen=True)
class HolsteinConfig:
    name: str = "holstein-hubbard"
    # surrogate (scalable) matrix
    n: int = 1_201_200                 # paper's dimension
    nnz_per_row: float = 14.0
    n_secondary_diags: int = 12
    frac_in_diags: float = 0.60
    band_frac: float = 0.02
    seed: int = 0
    # exact (validation) model
    exact: HolsteinHubbardParams = field(default_factory=HolsteinHubbardParams)
    # formats under test (paper Fig. 6/7)
    formats: tuple = ("csr", "ell", "jds", "sell", "hybrid")
    sell_C: int = 8
    # one source of truth for the sorting window: the PlanConfig default
    sell_sigma: int = field(default_factory=default_sell_sigma)
    # eigensolver
    lanczos_steps: int = 96
    # distributed SpMV
    partition: str = "nnz"             # "rows" | "nnz"
    variant: str = "allgather"         # "allgather" | "ring"


def paper_scale() -> HolsteinConfig:
    return HolsteinConfig()


def bench_scale() -> HolsteinConfig:
    """Large enough to exceed any cache, small enough for CPU benches."""
    return HolsteinConfig(n=200_000)


def smoke_scale() -> HolsteinConfig:
    return HolsteinConfig(n=2_000, lanczos_steps=32)
