"""The CUDA kernels on the card, each held against its plain PyTorch
version through the plan layer.  Every test is marked ``cuda`` and skips
without a CUDA device.  The file needs no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_on_card.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import port_matrix
from repro_torch.core import formats as PF
from repro_torch.core.plan import SpMVPlan
from repro_torch.core.planconfig import PlanConfig
from repro_torch.kernels import cuda_build as CB


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "f16", "fp8_e4m3", "int8"))
@pytest.mark.parametrize("fmt", ("csr", "sell", "dia", "hybrid"))
def test_cuda_plan_matches_torch_plan_on_the_card(cuda_device, fmt, vd):
    m = PF.convert(port_matrix("surrogate3000"), fmt) if fmt != "dia" else \
        PF.DIA.from_csr(port_matrix("laplace48"))
    m = PF.with_value_dtype(m, vd)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(m.shape[1])).to(
        cuda_device, torch.float64 if vd == "f64" else torch.float32)
    kern = SpMVPlan.compile(m, PlanConfig(device=cuda_device))
    plain = SpMVPlan.compile(m, PlanConfig(device=cuda_device, backend="torch"))
    assert kern.report.kernel == "cuda" and plain.report.kernel == "torch"
    before = CB.launch_counts()
    got, want = kern(x), plain(x)
    torch.cuda.synchronize()
    assert sum(CB.launch_counts().values()) > sum(before.values())
    tol = 1e-12 if x.dtype == torch.float64 else 1e-5
    assert float((got - want).abs().max() / want.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("vd", ("f64", "f32", "bf16", "f16"))
def test_cuda_matrix_free_matches_torch_on_the_card(cuda_device, vd):
    op = PF.with_value_dtype(PF.detect_matrix_free(port_matrix("exact4")), vd)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal((op.shape[0], 3))).to(
        cuda_device)
    kern = SpMVPlan.compile(op, PlanConfig(device=cuda_device))
    plain = SpMVPlan.compile(op, PlanConfig(device=cuda_device, backend="torch"))
    assert kern.report.kernel == "cuda" and kern.report.spmm_kernel == "cuda"
    assert torch.allclose(kern(X[:, 0]), plain(X[:, 0]), rtol=0, atol=1e-12)
    assert torch.allclose(kern.spmm(X), plain.spmm(X), rtol=0, atol=1e-12)
