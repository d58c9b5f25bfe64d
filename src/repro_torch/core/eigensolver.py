"""Lanczos eigensolver -- the paper's host application.

"The fraction spent in the sparse matrix-vector multiplication may easily
constitute over 99 % of total run time" (Sec. 1).  This module supplies the
surrounding algorithm: plain Lanczos with optional full
reorthogonalization, plus a spectral-extent estimator.  The SpMV is
injected (a plan, a callable, or a container compiled into a plan once).

The start vector comes from numpy (``seed``) or from the caller's ``v0``,
so a run can be compared with the reference on the same vector.  With
reorthogonalization the basis lives in one preallocated (m + 1, n) tensor
on the plan's device, filled row by row, instead of being re-stacked on
every step.  Each iteration is the ``lanczos.step`` span, its read of
alpha and beta on the host the ``lanczos.sync`` span (``utils.spans``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..utils.hw import default_device
from ..utils.spans import span

Apply = Callable[[torch.Tensor], torch.Tensor]


class LanczosBreakdown(RuntimeError):
    """The recurrence produced a non-finite alpha or beta (the operator
    returned NaN/Inf); ``iteration`` names the first broken step."""

    def __init__(self, iteration: int, alpha: float, beta: float):
        super().__init__(
            f"Lanczos recurrence broke down at iteration {iteration}: "
            f"alpha={alpha!r}, beta={beta!r} (non-finite).  The operator "
            "returned NaN/Inf -- check the matrix and input vector, or pass "
            "on_breakdown='restart' to retry from a reseeded start vector.")
        self.iteration = iteration
        self.alpha = alpha
        self.beta = beta


def as_apply(op, config=None, device=None, *, mesh=None,
             variant: str = "overlap") -> Apply:
    """A callable (closure, ``SpMVPlan`` or ``DistributedSpMVPlan``) passes
    through; a format container is compiled into a plan once (``config`` a
    ``PlanConfig``; ``device`` fills its device when the config names none).
    With ``mesh`` (a ``core.distributed.Mesh``) a container is compiled into
    a ``DistributedSpMVPlan`` of ``variant`` over the mesh instead;
    ``config.format`` / ``config.value_dtype`` apply to local plans only and
    are refused there."""
    if callable(op):
        return op
    from .planconfig import PlanConfig

    cfg = PlanConfig() if config is None else config
    if mesh is not None:
        if cfg.format is not None or cfg.value_dtype is not None:
            raise ValueError(
                "format=/value_dtype= apply to local plans only; distributed compiles "
                "pick their slab packing per partition (see "
                "compile_distributed_spmv_plan's slab_format)")
        from .distributed_plan import compile_distributed_spmv_plan

        return compile_distributed_spmv_plan(op, mesh, variant=variant, config=cfg)
    from .plan import SpMVPlan

    if cfg.device is None and device is not None:
        cfg = cfg.replace(device=device)
    return SpMVPlan.compile(op, cfg)


@dataclass
class LanczosResult:
    eigenvalues: np.ndarray      # Ritz values (ascending)
    alphas: np.ndarray
    betas: np.ndarray
    n_iterations: int
    n_spmv: int
    residuals: np.ndarray        # |beta_m * s_last| per Ritz value


def lanczos(apply_A, n: int, m: int = 64, v0=None, reorthogonalize: bool = True,
            seed: int = 0, dtype=torch.float64, config=None, device=None,
            on_breakdown: str = "raise", max_restarts: int = 2,
            mesh=None) -> LanczosResult:
    """m-step Lanczos on the symmetric operator ``apply_A`` of dimension n.

    Each iteration performs exactly one SpMV.  The vectors live on the
    plan's device (``apply_A.device`` for a plan -- the mesh's first device
    for a distributed one; else ``device``, which defaults to the card).
    With ``mesh`` a container is compiled into a distributed plan over it
    (``as_apply``).  A non-finite coefficient raises
    :class:`LanczosBreakdown`; ``on_breakdown="restart"`` retries from a
    reseeded start vector up to ``max_restarts`` times.
    """
    if on_breakdown not in ("raise", "restart"):
        raise ValueError(f"on_breakdown={on_breakdown!r}; expected 'raise' or 'restart'")
    apply_A = as_apply(apply_A, config, device, mesh=mesh)
    dev = getattr(apply_A, "device", None)
    dev = default_device(device) if dev is None else dev
    attempts = 1 + (max_restarts if on_breakdown == "restart" else 0)
    n_spmv_prior = 0
    for attempt in range(attempts):
        try:
            result = _lanczos_once(apply_A, n, m, v0, reorthogonalize,
                                   seed if attempt == 0 else seed + 7919 * attempt,
                                   dtype, dev)
            result.n_spmv += n_spmv_prior
            return result
        except LanczosBreakdown as e:
            n_spmv_prior += e.iteration + 1
            v0 = None  # never reuse a start vector that broke the recurrence
            if attempt == attempts - 1:
                raise
    raise AssertionError("unreachable")  # pragma: no cover


def _lanczos_once(apply_A, n, m, v0, reorthogonalize, seed, dtype, dev) -> LanczosResult:
    if v0 is None:
        v0 = np.random.default_rng(seed).standard_normal(n)
    if isinstance(v0, torch.Tensor):
        v = v0.to(device=dev, dtype=dtype)
    else:
        v = torch.as_tensor(np.asarray(v0), dtype=dtype, device=dev)
    v = v / torch.linalg.vector_norm(v)
    V = None
    if reorthogonalize:
        V = torch.empty((m + 1, n), dtype=dtype, device=dev)
        V[0] = v
    alphas, betas = [], []
    beta = 0.0
    v_prev = torch.zeros_like(v)
    n_spmv = 0
    for j in range(m):
        with span("lanczos.step"):
            w = apply_A(v).to(dtype)
            n_spmv += 1
            alpha = torch.dot(v, w)
            w = w - alpha * v - beta * v_prev
            if reorthogonalize:
                basis = V[:j + 1]
                w = w - basis.T @ (basis @ w)
                w = w - basis.T @ (basis @ w)  # twice is enough
            beta_new = torch.linalg.vector_norm(w)
            with span("lanczos.sync"):
                a, b = float(alpha), float(beta_new)
            if not (np.isfinite(a) and np.isfinite(b)):
                raise LanczosBreakdown(j, a, b)
            alphas.append(a)
            betas.append(b)
            if b < 1e-12 * max(1.0, abs(a)):
                break
            v_prev = v
            v = w / beta_new
            if reorthogonalize:
                V[j + 1] = v
            beta = beta_new

    a = np.asarray(alphas)
    b = np.asarray(betas[: len(alphas) - 1])
    T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    evals, evecs = np.linalg.eigh(T)
    resid = (np.abs(betas[len(alphas) - 1] * evecs[-1, :]) if len(alphas)
             else np.zeros(0))
    return LanczosResult(eigenvalues=evals, alphas=a, betas=np.asarray(betas),
                         n_iterations=len(alphas), n_spmv=n_spmv, residuals=resid)


def ground_state_energy(apply_A, n: int, m: int = 96, **kw) -> float:
    """Smallest Ritz value -- the physics observable of the Hamiltonian."""
    return float(lanczos(apply_A, n, m=m, **kw).eigenvalues[0])


def spectral_extent(apply_A, n: int, m: int = 32, **kw) -> tuple[float, float]:
    r = lanczos(apply_A, n, m=m, **kw)
    return float(r.eigenvalues[0]), float(r.eigenvalues[-1])


def power_iteration(apply_A, n: int, iters: int = 200, seed: int = 0,
                    dtype=torch.float64, device=None) -> float:
    """|lambda|_max via power iteration -- an independent cross-check oracle.

    The start vector comes from numpy (``seed``), as ``lanczos``'s default
    does, so it is not the reference's ``jax.random`` vector.  The vectors
    live on the plan's device (else ``device``, default the card)."""
    apply_A = as_apply(apply_A, device=device)
    dev = getattr(apply_A, "device", None)
    dev = default_device(device) if dev is None else dev
    v = torch.as_tensor(np.random.default_rng(seed).standard_normal(n), dtype=dtype,
                        device=dev)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = apply_A(v).to(dtype)
        v = w / torch.linalg.vector_norm(w)
    return float(torch.dot(v, apply_A(v).to(dtype)))
