"""Lanczos eigensolver -- the paper's host application.

"The fraction spent in the sparse matrix-vector multiplication may easily
constitute over 99 % of total run time" (Sec. 1).  This module supplies the
surrounding algorithm: plain Lanczos with optional full
reorthogonalization, plus a spectral-extent estimator.  The SpMV is
injected (a plan, a callable, or a container compiled into a plan once).

The start vector comes from numpy (``seed``) or from the caller's ``v0``,
so a run can be compared with the reference on the same vector.  The
recurrence's state lives on the plan's device in preallocated tensors: the
vectors (the (m + 1, n) basis with reorthogonalization, else a ring of
three) and an (m, 2) array that each step writes its alpha and beta into.
One step is one function of that state (``_Krylov.step``), run two ways:

* eagerly, one step at a time, reading the step's alpha and beta on the
  host after it (everything but a local plan on the card);
* on the card, for a local ``SpMVPlan``, as CUDA graphs of ``K`` steps,
  captured on the first solve and cached on the plan; a solve copies its
  start vector in, replays a graph and reads that chunk's coefficients in
  one copy, ``ceil(m / K)`` reads a solve (:func:`graph_fallback` says when
  the eager loop runs instead).

Both paths stop by the same rules (:func:`scan_coefficients`) and give the
same bits.  ``lanczos.step`` is the span of one eager step or one replayed
chunk, ``lanczos.sync`` of its read on the host (``utils.spans``);
:func:`graph_counts` counts the graphs captured and the solves each path
completed.
"""
from __future__ import annotations

import gc
import math
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..testing import faults
from ..utils.hw import default_device
from ..utils.spans import span

Apply = Callable[[torch.Tensor], torch.Tensor]


class LanczosBreakdown(RuntimeError):
    """The recurrence produced a non-finite alpha or beta (the operator
    returned NaN/Inf); ``iteration`` names the first broken step and
    ``n_spmv`` the SpMVs the attempt ran (on the graph path up to the end of
    the broken step's chunk)."""

    def __init__(self, iteration: int, alpha: float, beta: float,
                 n_spmv: int | None = None):
        super().__init__(
            f"Lanczos recurrence broke down at iteration {iteration}: "
            f"alpha={alpha!r}, beta={beta!r} (non-finite).  The operator "
            "returned NaN/Inf -- check the matrix and input vector, or pass "
            "on_breakdown='restart' to retry from a reseeded start vector.")
        self.iteration = iteration
        self.alpha = alpha
        self.beta = beta
        self.n_spmv = iteration + 1 if n_spmv is None else n_spmv


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
    reseeded start vector up to ``max_restarts`` times, on the eager loop.

    A local plan on the card runs the recurrence as CUDA graphs of ``K``
    steps (module docstring).  Where the recurrence stops early (a beta
    below ``1e-12 * max(1, |alpha|)``) or breaks down, the card has then run
    the rest of that chunk, at most ``K - 1`` steps more: ``n_iterations``
    counts the steps kept, ``n_spmv`` the SpMVs the card ran.  Kept
    coefficients and Ritz values are bitwise the eager loop's.
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
                                   dtype, dev, graphs=attempt == 0)
            result.n_spmv += n_spmv_prior
            return result
        except LanczosBreakdown as e:
            n_spmv_prior += e.n_spmv
            v0 = None  # never reuse a start vector that broke the recurrence
            if attempt == attempts - 1:
                raise
    raise AssertionError("unreachable")  # pragma: no cover


#: steps of the recurrence that one CUDA graph holds
K = 16
#: graph entries (one per n, m, reorthogonalize, dtype) a plan keeps; the
#: least recently used is dropped
MAX_GRAPH_ENTRIES = 4

_COUNTS = {"captured": 0, "replayed_solves": 0, "eager_solves": 0}
_COUNTS_LOCK = threading.Lock()
_CACHE_LOCK = threading.Lock()


def graph_counts() -> dict:
    """{"captured": CUDA graphs captured, "replayed_solves": solves
    completed from graphs, "eager_solves": solves completed by the eager
    loop} since the last :func:`reset_graph_counts`; a solve that broke down
    is not completed."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_graph_counts() -> None:
    with _COUNTS_LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


def _count(key: str, k: int = 1) -> None:
    with _COUNTS_LOCK:
        _COUNTS[key] += k


def scan_coefficients(coefs, start: int = 0) -> tuple[int, bool]:
    """The recurrence's stopping rules over ``coefs``, the (alpha, beta)
    pairs of steps ``start``, ``start + 1``, ... in step order.  Returns how
    many pairs are kept and whether the recurrence stopped at the last kept
    one (beta < 1e-12 * max(1, |alpha|)); raises :class:`LanczosBreakdown`
    at the first pair with a non-finite number."""
    for i, (a, b) in enumerate(coefs):
        if not (math.isfinite(a) and math.isfinite(b)):
            raise LanczosBreakdown(start + i, a, b)
        if b < 1e-12 * max(1.0, abs(a)):
            return i + 1, True
    return len(coefs), False


def chunk_bounds(m: int) -> list[tuple[int, int]]:
    """The steps [j0, j1) of each chunk of ``K`` of an m-step solve; the
    last is shorter where K does not divide m."""
    return [(j, min(j + K, m)) for j in range(0, m, K)]


def graph_fallback(apply_A, m: int) -> str | None:
    """Why a solve of m steps on ``apply_A`` runs the eager loop, or None
    where it replays CUDA graphs: a local ``SpMVPlan`` on a CUDA device,
    with its ``plan.spmv`` fault point disarmed (a capture would bake one
    firing into every replay)."""
    from .plan import SpMVPlan

    if not isinstance(apply_A, SpMVPlan):
        return "not a local plan"
    if faults.armed("plan.spmv") is not None:
        return "fault point plan.spmv armed"
    if apply_A.device.type != "cuda":
        return "not on a CUDA device"
    if m < 1:
        return "no steps"
    return None


class _Krylov:
    """The recurrence's state on the device: its vectors -- the (m + 1, n)
    basis with reorthogonalization, else a ring of three -- and ``coefs``,
    the (m, 2) alphas and betas."""

    def __init__(self, n: int, m: int, reorthogonalize: bool, dtype, dev):
        self.reorth = reorthogonalize
        self.V = torch.empty((m + 1 if reorthogonalize else 3, n), dtype=dtype, device=dev)
        self.coefs = torch.empty((m, 2), dtype=dtype, device=dev)

    def row(self, j: int) -> torch.Tensor:
        return self.V[j if self.reorth else j % 3]

    def start(self, x: torch.Tensor) -> None:
        """v_0 = x / |x|."""
        torch.div(x, torch.linalg.vector_norm(x), out=self.row(0))

    def step(self, apply_A, j: int) -> None:
        """Step j: one SpMV, alpha and beta into ``coefs[j]``, v_(j+1)."""
        v = self.row(j)
        w = apply_A(v).to(v.dtype)
        alpha = torch.dot(v, w, out=self.coefs[j, 0])
        w = w - alpha * v
        if j:
            w = w - self.coefs[j - 1, 1] * self.row(j - 1)
        if self.reorth:
            basis = self.V[:j + 1]
            w = w - basis.T @ (basis @ w)
            w = w - basis.T @ (basis @ w)  # twice is enough
        beta = torch.linalg.vector_norm(w, out=self.coefs[j, 1])
        torch.div(w, beta, out=self.row(j + 1))


def _start_vector(v0, n, seed, dtype, dev) -> torch.Tensor:
    if v0 is None:
        v0 = np.random.default_rng(seed).standard_normal(n)
    if isinstance(v0, torch.Tensor):
        return v0.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(v0), dtype=dtype, device=dev)


def _recur(st: _Krylov, chunks, run_chunk) -> tuple[list, int]:
    """Run ``chunks`` of steps in order (``run_chunk(j0, j1)``), each a
    ``lanczos.step`` span ending in one read of its coefficients (the
    ``lanczos.sync`` span), until the rules stop the recurrence.  Returns
    the kept (alpha, beta) pairs and the SpMVs run."""
    kept, n_spmv = [], 0
    for j0, j1 in chunks:
        with span("lanczos.step"):
            run_chunk(j0, j1)
            n_spmv += j1 - j0
            with span("lanczos.sync"):
                coefs = st.coefs[j0:j1].tolist()
            try:
                k, stop = scan_coefficients(coefs, j0)
            except LanczosBreakdown as e:
                e.n_spmv = n_spmv
                raise
        kept += coefs[:k]
        if stop:
            break
    return kept, n_spmv


def _lanczos_once(apply_A, n, m, v0, reorthogonalize, seed, dtype, dev,
                  graphs: bool = True) -> LanczosResult:
    v = _start_vector(v0, n, seed, dtype, dev)
    cache = None
    if graphs and graph_fallback(apply_A, m) is None:
        cache = _GraphCache.of(apply_A)
        if not cache.lock.acquire(blocking=False):
            cache = None  # another solve is replaying this plan's graphs
    if cache is None:
        st = _Krylov(v.shape[0], m, reorthogonalize, dtype, dev)
        st.start(v)
        kept, n_spmv = _recur(st, [(j, j + 1) for j in range(m)],
                              lambda j0, j1: st.step(apply_A, j0))
        _count("eager_solves")
    else:
        try:
            entry = cache.entry(apply_A, v, m, reorthogonalize)
            kept, n_spmv = _recur(entry.state, entry.chunks, entry.replay)
        finally:
            cache.lock.release()
        _count("replayed_solves")

    a = np.asarray([c[0] for c in kept])
    betas = np.asarray([c[1] for c in kept])
    b = betas[: len(a) - 1]
    T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    evals, evecs = np.linalg.eigh(T)
    resid = np.abs(betas[len(a) - 1] * evecs[-1, :]) if len(a) else np.zeros(0)
    return LanczosResult(eigenvalues=evals, alphas=a, betas=betas,
                         n_iterations=len(a), n_spmv=n_spmv, residuals=resid)


class _GraphEntry:
    """The CUDA graphs of one (n, m, reorthogonalize, dtype) on a plan: the
    static start vector ``x0``, the recurrence's state, and one graph a
    chunk of ``K`` steps (each chunk reads other basis rows) with the kernel
    launches its capture counted."""

    def __init__(self, plan, n: int, m: int, reorthogonalize: bool, dtype):
        self.x0 = torch.empty(n, dtype=dtype, device=plan.device)
        self.state = _Krylov(n, m, reorthogonalize, dtype, plan.device)
        self.chunks = chunk_bounds(m)
        self.graphs, self.launches = [], []

    def capture(self, plan) -> None:
        """Capture every chunk on a side stream, after one eager step there
        (lazy device copies, library handles and workspaces come into being
        outside the capture).  The collector is off meanwhile: a collection
        could free CUDA objects of garbage in this thread, and a call that
        is unsafe in a capture invalidates it.  The launches that step and
        the captures counted are taken back: a replay adds its chunk's."""
        from ..kernels import cuda_build as CB

        st, dev = self.state, plan.device
        before = CB.launch_counts()
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        pool = None
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                st.start(self.x0)
                st.step(plan, 0)
                for j0, j1 in self.chunks:
                    g = torch.cuda.CUDAGraph()
                    counted = CB.launch_counts()
                    g.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        self.run_chunk(plan, j0, j1)
                    finally:
                        g.capture_end()
                    pool = g.pool() if pool is None else pool
                    self.graphs.append(g)
                    self.launches.append(_minus(CB.launch_counts(), counted))
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(dev).wait_stream(stream)
        CB.add_launch_counts(_minus(before, CB.launch_counts()))
        _count("captured", len(self.graphs))

    def run_chunk(self, plan, j0: int, j1: int) -> None:
        """What the graph of chunk [j0, j1) holds: the first normalizes the
        start vector, then steps j0 .. j1 - 1."""
        if j0 == 0:
            self.state.start(self.x0)
        for j in range(j0, j1):
            self.state.step(plan, j)

    def replay(self, j0: int, j1: int) -> None:
        from ..kernels import cuda_build as CB

        c = j0 // K
        self.graphs[c].replay()
        CB.add_launch_counts(self.launches[c])


def _minus(a: dict, b: dict) -> dict:
    return {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}


class _GraphCache:
    """A plan's graph entries, least recently used first, and the lock a
    graph solve holds (a second solve meanwhile runs the eager loop)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: OrderedDict = OrderedDict()

    @staticmethod
    def of(plan) -> "_GraphCache":
        with _CACHE_LOCK:
            cache = plan.__dict__.get("_lanczos_graphs")
            if cache is None:
                cache = plan._lanczos_graphs = _GraphCache()
            return cache

    def entry(self, plan, v: torch.Tensor, m: int, reorthogonalize: bool) -> _GraphEntry:
        """The entry for this solve, with ``v`` copied into its start
        vector; captured here on first use."""
        key = (v.shape[0], m, reorthogonalize, v.dtype)
        entry = self.entries.get(key)
        if entry is None:
            entry = _GraphEntry(plan, v.shape[0], m, reorthogonalize, v.dtype)
            entry.x0.copy_(v)
            entry.capture(plan)
            self.entries[key] = entry
            while len(self.entries) > MAX_GRAPH_ENTRIES:
                self.entries.popitem(last=False)
        else:
            self.entries.move_to_end(key)
            entry.x0.copy_(v)
        return entry


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
