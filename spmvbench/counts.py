"""The yardstick's arithmetic: the card's peaks and the least work of each
operation the cells time, counted from the problem's sizes alone.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, 700 W); a card set
below 700 W reaches less, so every run prints the card's power limit.

Least bytes of one SpMV ``y = A x``: the values that no implementation can
avoid reading once, plus x read once and y written once.  Index bytes are
not counted: a format may drop them (DIA stores none), and a count that
included them could be beaten, reading a roofline share above 100 %.  The
values that must be read are a property of the operator, stated in its
configuration file:

* ``"values": "stored"`` -- every stored value once;
* ``"values": "symmetric"`` -- the upper triangle and the diagonal once (a
  symmetric kernel reads each off-diagonal pair once);
* ``"values": "generated"`` -- none: the operator follows from a few
  parameters (the exact Hamiltonian), so only the vectors must move.

A Lanczos solve of m steps does m SpMVs and, per step, reads two vectors
and writes one (w, v, v_prev); full reorthogonalization adds, at step j, one
Gram-Schmidt pass over the j + 1 basis vectors, which reads the basis twice
(``basis @ w`` and ``basis.T @ h``).  The tridiagonal eigensolve is m x m on
the host and counts nothing.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet (dense rates, 700 W)
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {"float32": 67e12, "float64": 34e12}

#: substrings of the CUDA kernels that compute the port's SpMV and SpMM
#: (``csrc/{sell_spmv,dia_spmv,csr_spmv,mf_spmv,sell_spmm}.cu``)
SPMV_KERNELS = ("sell_block_kernel", "dia_spmv_kernel", "csr_rowblock_kernel",
                "mf_spmv_kernel", "sell_spmm_kernel")

DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def is_spmv_kernel(name: str) -> bool:
    return any(k in name for k in SPMV_KERNELS)


def least_values(values: str, nnz: int, n_diag_nonzero: int) -> int:
    """Values an SpMV must read at least (see the module docstring)."""
    if values == "stored":
        return nnz
    if values == "symmetric":
        return (nnz - n_diag_nonzero) // 2 + n_diag_nonzero
    if values == "generated":
        return 0
    raise ValueError(f"unknown values rule {values!r}")


def spmv_bytes(n: int, nnz: int, n_diag_nonzero: int, values: str, value_dtype: str,
               vector_dtype: str, columns: int = 1) -> int:
    """Least bytes of one SpMM over ``columns`` right-hand sides (an SpMV at
    1): the matrix's values once, each x read and each y written once."""
    vals = least_values(values, nnz, n_diag_nonzero) * DTYPE_BYTES[value_dtype]
    return vals + columns * 2 * n * DTYPE_BYTES[vector_dtype]


def spmv_flops(nnz: int, columns: int = 1) -> int:
    """A multiply and an add per stored entry and right-hand side."""
    return 2 * nnz * columns


def lanczos_bytes(m: int, spmv_b: int, n: int, vector_dtype: str, reorthogonalize: bool) -> int:
    vb = DTYPE_BYTES[vector_dtype]
    total = m * (spmv_b + 3 * n * vb)
    if reorthogonalize:
        total += sum(2 * (j + 1) * n * vb for j in range(m))
    return total


def lanczos_flops(m: int, nnz: int, n: int, reorthogonalize: bool) -> int:
    """SpMVs, the step's dot, two axpys, norm and scale (9 n), and one
    Gram-Schmidt pass (4 (j + 1) n) a step."""
    total = m * (spmv_flops(nnz) + 9 * n)
    if reorthogonalize:
        total += sum(4 * (j + 1) * n for j in range(m))
    return total


def bound_seconds(nbytes: int, flops: int, compute_dtype: str) -> float:
    """Least time on the card: the larger of bytes over the memory rate and
    operations over the peak of ``compute_dtype``."""
    return max(nbytes / H100_BYTES_PER_S, flops / H100_FLOPS[compute_dtype])
