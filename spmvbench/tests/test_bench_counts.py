"""The yardstick's byte and operation counts against hand counts on a 5 x 5
matrix, and the peaks it holds."""
from __future__ import annotations

import numpy as np

from spmvbench import counts

# a symmetric 5 x 5 matrix: full diagonal, one off-diagonal pair in rows
# 0/3 and one in rows 1/4: nnz 9, 5 of them on the diagonal
ROWS = np.array([0, 0, 1, 1, 2, 3, 3, 4, 4])
COLS = np.array([0, 3, 1, 4, 2, 0, 3, 1, 4])


def test_least_values_by_rule():
    assert counts.least_values("stored", 9, 5) == 9
    assert counts.least_values("symmetric", 9, 5) == 7      # 5 diagonal + 2 pairs
    assert counts.least_values("generated", 9, 5) == 0


def test_spmv_bytes_and_flops_by_hand():
    assert len(ROWS) == 9 and int(np.sum(ROWS == COLS)) == 5
    # f32 values, f64 vectors: 7 values x 4 B + x 5 x 8 B + y 5 x 8 B
    assert counts.spmv_bytes(5, 9, 5, "symmetric", "float32", "float64") == 28 + 40 + 40
    assert counts.spmv_bytes(5, 9, 5, "stored", "float64", "float64") == 72 + 80
    assert counts.spmv_bytes(5, 9, 5, "generated", "float64", "float64") == 80
    # an SpMM of 3 columns reads the values once and each x, y once
    assert counts.spmv_bytes(5, 9, 5, "stored", "float32", "float32", columns=3) == 36 + 3 * 40
    assert counts.spmv_flops(9) == 18 and counts.spmv_flops(9, 3) == 54


def test_lanczos_counts_by_hand():
    spmv = counts.spmv_bytes(5, 9, 5, "stored", "float64", "float64")      # 152
    # m = 2: 2 SpMVs + 3 vectors a step; reorth at j = 0, 1 reads 2 x 1 and
    # 2 x 2 basis vectors of 5 x 8 B
    assert counts.lanczos_bytes(2, spmv, 5, "float64", False) == 2 * (152 + 120)
    assert counts.lanczos_bytes(2, spmv, 5, "float64", True) == 2 * (152 + 120) + (2 + 4) * 40
    assert counts.lanczos_flops(2, 9, 5, False) == 2 * (18 + 45)
    assert counts.lanczos_flops(2, 9, 5, True) == 2 * (18 + 45) + (4 + 8) * 5


def test_bound_and_peaks():
    assert counts.H100_BYTES_PER_S == 3.35e12
    assert counts.H100_FLOPS == {"float32": 67e12, "float64": 34e12}
    assert counts.bound_seconds(3.35e12, 0, "float64") == 1.0
    assert counts.bound_seconds(0, 34e12, "float64") == 1.0


def test_spmv_kernel_names():
    assert counts.is_spmv_kernel("void mf_spmv_kernel<double, double>(...)")
    assert not counts.is_spmv_kernel("void at::native::elementwise_kernel<128, 2>")
