"""Compiled SpMV plans: preprocess once, execute many times.

The paper's workloads never do one SpMV: Lanczos applies the same
Hamiltonian on every iteration.  ``SpMVPlan.compile`` turns a format
container into a reusable executor:

1. the container is converted to the requested format and value dtype
   (both cached on the source); ``format="auto"`` asks
   ``perfmodel.select_format`` for the format the model predicts fastest on
   the plan's chip, with the stream-byte regime of the plan's backend;
2. every host-derived table (row ids, segment ids, gather indices,
   descriptors) is built once and moved to the plan's device together with
   the container's arrays -- once, at compile time;
3. the registry picks the kernel: ``backend="auto"`` takes the ``cuda``
   kernel whenever its probe accepts the operand (on a CUDA device) and
   otherwise ranks the accepting entries by their cost hooks (or by the
   measured times of a tuning DB); an explicit backend whose entry is
   missing or refuses the operand falls back to ``torch``, and
   ``report.kernel`` shows which ran;
4. plans are memoized on the container, so ``compile`` is free after the
   first call.

``validate`` checks (or repairs) a CSR/COO source before anything else,
and ``tuning`` (a ``core.tunedb.TuneDB``) lets measured winners decide
``format="auto"`` and the backend (the warm path).  ``plan(x)`` and
``plan.spmm(X)`` pass the ``plan.spmv`` / ``plan.spmm`` fault points of
``testing.faults``: free when disarmed.  The operand, its shape and the
fault point are the ``plan.operand`` span (``utils.spans``).

``plan.report`` records what was decided and what the roofline predicts
for it (balance, GFlop/s, seconds, the bound), with the byte regime of the
kernel that runs.  PyTorch runs eagerly, so there is no ``jit`` step.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import registry as R
from ..testing import faults
from ..utils.hw import H100, ChipSpec, default_device
from ..utils.spans import span
from . import perfmodel as PM
from .formats import (BSR, COO, CSR, DIA, ELL, JDS, SELL, ElectronPhononOperator, HybridDIA,
                      MatrixFreeOperator)
from .planconfig import PlanConfig, coerce_config

_FMT_NAMES = {COO: "coo", CSR: "csr", ELL: "ell", JDS: "jds", SELL: "sell", BSR: "bsr",
              DIA: "dia", HybridDIA: "hybrid", MatrixFreeOperator: "matrix_free",
              ElectronPhononOperator: "mf_product"}


@dataclass(frozen=True)
class PlanReport:
    """What the plan decided and what the model predicts for it."""

    format: str
    shape: tuple
    nnz: int
    kernel: str                     # SpMV: "cuda" | "torch" | "loop"
    spmm_kernel: str                # SpMM: "cuda" | "torch" | "loop"
    device: str
    balance_bytes_per_flop: float | None = None
    predicted_gflops: float | None = None
    predicted_time_s: float | None = None
    bound: str | None = None        # "memory" | "compute"


def as_operand(x, device: torch.device, what: str) -> torch.Tensor:
    """``x`` as a tensor on a plan's ``device``: a numpy array is moved
    there; a tensor on another device is a ``ValueError``."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a tensor or numpy array, "
                        f"got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}; this plan runs on {device}")
    return x


class SpMVPlan:
    """A compiled SpMV executor: ``plan(x) -> y`` and ``plan.spmm(X) -> Y``."""

    def __init__(self, matrix, report: PlanReport, apply_fn, apply_multi,
                 device: torch.device):
        self.matrix = matrix
        self.report = report
        self.apply = apply_fn
        self.apply_multi = apply_multi
        self.device = device

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.spmv(x)

    @property
    def spmm_by_columns(self) -> bool:
        """True when the SpMM entry runs the SpMV once a column
        (``kernels.cache.spmm_by_columns``), so the matrix is streamed once
        per column rather than once per call."""
        return getattr(self.apply_multi, "by_columns", False)

    def _operand(self, x, what: str) -> torch.Tensor:
        return as_operand(x, self.device, what)

    def _fire(self, op: str):
        return faults.fire(f"plan.{op}", ctx={"op": op, "format": self.report.format,
                                              "kernel": self.report.kernel})

    def spmv(self, x) -> torch.Tensor:
        """y = A @ x for x of shape (N,) on the plan's device; raises
        ValueError on a shape or device mismatch."""
        with span("plan.operand"):
            x = self._operand(x, "x")
            if tuple(x.shape) != (self.report.shape[1],):
                raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                                 f"({self.report.shape[1]},)")
            spec = self._fire("spmv")
        y = self.apply(x)
        return faults.poison(y, spec) if spec is not None else y

    def spmm(self, X) -> torch.Tensor:
        """Y = A @ X for X of shape (N, K)."""
        with span("plan.operand"):
            X = self._operand(X, "X")
            if X.dim() != 2 or X.shape[0] != self.report.shape[1]:
                raise ValueError(f"X has shape {tuple(X.shape)}, expected "
                                 f"({self.report.shape[1]}, K)")
            spec = self._fire("spmm")
        Y = self.apply_multi(X)
        return faults.poison(Y, spec) if spec is not None else Y

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        r = self.report
        return (f"SpMVPlan({r.format}, {r.shape}, nnz={r.nnz}, "
                f"kernel={r.kernel}, device={r.device})")

    @staticmethod
    def compile(matrix, config: PlanConfig | None = None, **kwargs) -> "SpMVPlan":
        """Build (or fetch the memoized) plan for ``matrix`` under ``config``
        (a :class:`PlanConfig`; None is the default record, which runs on
        the card and raises when there is none).  Bare kwargs are the
        reference's deprecated aliases of the config's fields
        (``planconfig.coerce_config``)."""
        cfg = coerce_config(config, kwargs, api="SpMVPlan.compile")
        device = default_device(cfg.device)
        backend = _resolve_backend(cfg.backend)
        validate = cfg.validate if cfg.validate is not None else "off"
        if validate != "off":
            from .validate import validate_matrix
            matrix = validate_matrix(matrix, policy=validate)
        tuning = None
        if cfg.tuning is not None:
            from .tunedb import open_db
            tuning = open_db(cfg.tuning)
        if cfg.format is not None:
            matrix = resolve_format(matrix, cfg.format, chip=cfg.chip, am=cfg.am,
                                    backend=backend, device=device, tuning=tuning,
                                    sigma=1 if not cfg.permute else cfg.sigma,
                                    convert_kwargs=cfg.sell_kwargs())
        if cfg.value_dtype is not None:
            matrix = _convert_cached(matrix, _FMT_NAMES.get(type(matrix), "csr"),
                                     {}, value_dtype=cfg.value_dtype)
        fmt = _FMT_NAMES.get(type(matrix))
        if fmt is None:
            raise TypeError(f"no plan for {type(matrix).__name__}")
        key = (fmt, backend, str(device), cfg.chip, cfg.am, getattr(tuning, "token", None))
        cache = getattr(matrix, "_spmv_plans", None)
        if cache is None:
            cache = {}
            object.__setattr__(matrix, "_spmv_plans", cache)
        plan = cache.get(key)
        if plan is None:
            plan = cache[key] = _compile(matrix, fmt, backend, device, cfg.chip,
                                         cfg.am, tuning)
        return plan


def resolve_format(matrix, format: str, *, chip: ChipSpec | None = None,
                   am=None, backend: str = "auto", device=None, tuning=None,
                   convert_kwargs: dict | None = None, **select_kw):
    """``matrix`` converted to ``format``: a CSR/COO source is converted
    (and the result cached on it); a container already in ``format``
    passes; any other container is refused.  ``"auto"`` converts a CSR/COO
    source to ``perfmodel.select_format``'s pick (with its own sigma) under
    ``chip``, ``am``, the stream regime of ``backend`` on ``device`` and,
    warm, the measured winners of ``tuning``; any other container stands as
    the upstream choice."""
    fmt = _FMT_NAMES.get(type(matrix))
    if fmt is None:
        raise TypeError(f"no plan for {type(matrix).__name__}")
    if format == "auto":
        if fmt not in ("csr", "coo"):
            return matrix
        src = _convert_cached(matrix, "csr", {}) if isinstance(matrix, COO) else matrix
        choice = PM.select_format(src, am=am, chip=chip or H100, backend=backend,
                                  device=device, tuning=tuning, **select_kw)
        return _convert_cached(matrix, choice.format, choice.convert_kwargs)
    if format == fmt:
        return matrix
    if format == "mf_product":
        raise ValueError(
            f"cannot convert a {fmt} container to 'mf_product': that operator is "
            "generated from its model's parameters, not recovered from stored entries; "
            "build it with core.matrices.holstein_hubbard_operator(params)")
    if fmt not in ("csr", "coo"):
        raise ValueError(f"cannot convert a {fmt} container to {format!r}; "
                         "pass the CSR/COO source instead")
    kw = dict(convert_kwargs or {}) if format in ("sell", "hybrid") else {}
    return _convert_cached(matrix, format, kw)


def _convert_cached(matrix, fmt: str, kw: dict, value_dtype: str | None = None):
    from .formats import convert, with_value_dtype
    cache = getattr(matrix, "_fmt_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(matrix, "_fmt_cache", cache)
    key = (fmt, value_dtype, tuple(sorted(kw.items())))
    obj = cache.get(key)
    if obj is None:
        src = CSR.from_coo(matrix) if isinstance(matrix, COO) else matrix
        if _FMT_NAMES.get(type(src)) == fmt:
            obj = src
        elif fmt == "coo":
            obj = src.to_coo()
        else:
            obj = convert(src, fmt, **kw)
        if value_dtype is not None:
            obj = with_value_dtype(obj, value_dtype)
        if obj is not src:
            # a converted container signs for the tuning DB through the
            # pattern of the CSR it came from (tunedb.signature_of)
            object.__setattr__(obj, "_tune_src", src)
        cache[key] = obj
    return obj


_BACKENDS = ("auto",) + R.BACKENDS


def _resolve_backend(backend: str) -> str:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {_BACKENDS}")
    return backend


def _pick_entry(matrix, fmt: str, op: str, backend: str,
                ctx: R.KernelContext) -> str:
    """``auto`` asks the registry; an explicit backend is honoured when its
    entry exists and its probe accepts the operand, else ``torch``."""
    if backend == "auto":
        return R.select_backend(matrix, fmt, op, ctx)[0]
    if R.has(fmt, op, backend) and R.get(fmt, op, backend).probe(matrix, ctx).ok:
        return backend
    return "torch"


#: report label -> the perfmodel stream-byte regime it executes
_LABEL_STREAM = {"cuda": "cuda", "torch": "torch", "loop": "loop_reference"}


def _compile(matrix, fmt: str, backend: str, device: torch.device,
             chip: ChipSpec, am, tuning=None) -> SpMVPlan:
    ctx = R.KernelContext(device=device, chip=chip, am=am, tuning=tuning)
    ck_v = R.build(matrix, fmt, "spmv", _pick_entry(matrix, fmt, "spmv", backend, ctx), ctx)
    ck_m = R.build(matrix, fmt, "spmm", _pick_entry(matrix, fmt, "spmm", backend, ctx), ctx)
    am = am if am is not None else PM.access_model_for(matrix, chip)
    balance = PM.balance_of(matrix, am, backend=_LABEL_STREAM[ck_v.label], chip=chip)
    pred = PM.predict(fmt, balance, matrix.nnz, chip=chip)
    report = PlanReport(format=fmt, shape=tuple(matrix.shape), nnz=matrix.nnz,
                        kernel=ck_v.label, spmm_kernel=ck_m.label,
                        device=str(device),
                        balance_bytes_per_flop=balance,
                        predicted_gflops=pred.gflops,
                        predicted_time_s=pred.time_s, bound=pred.bound)
    return SpMVPlan(matrix, report, ck_v.fn, ck_m.fn, device)


#: alias of ``SpMVPlan.compile`` for functional call sites
compile_plan = SpMVPlan.compile

#: the formats ``plan_all_formats`` plans by default (bsr joins them when
#: the shape tiles by its block)
ALL_FORMATS = ("csr", "ell", "jds", "sell", "hybrid")


def plan_all_formats(m: CSR, config: PlanConfig | None = None, *,
                     formats=None, **conv_kw) -> dict:
    """Convert and plan a CSR matrix into each of ``formats`` under
    ``config`` (its ``format`` is ignored).  ``formats=None`` is
    ``ALL_FORMATS``, plus ``bsr`` when the shape tiles by the bsr block
    (``conv_kw["bsr"]["block_shape"]``, default (8, 128)).  Returns {name:
    SpMVPlan}; the paper's "hint to the respective optimal storage scheme"
    is then ``min`` over ``plan.report.predicted_time_s``.  ``conv_kw`` maps
    a format to its conversion kwargs."""
    cfg = (config or PlanConfig()).replace(format=None)
    if formats is None:
        bm, bn = conv_kw.get("bsr", {}).get("block_shape", (8, 128))
        tiles = m.shape[0] % bm == 0 and m.shape[1] % bn == 0
        formats = ALL_FORMATS + (("bsr",) if tiles else ())
    return {fmt: SpMVPlan.compile(_convert_cached(m, fmt, conv_kw.get(fmt, {})), cfg)
            for fmt in formats}
