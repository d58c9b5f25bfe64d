"""The kernel registry: one ``(format, op, backend)`` table for the port.

Backends (:data:`BACKENDS`):

* ``torch`` -- the composite PyTorch formulations (gather + ``index_add_`` /
  ``sum``), the counterpart of the reference's ``xla`` entries.  They run on
  any device and are the plain versions the CUDA kernels are held against.
* ``cuda`` -- the hand-written Hopper kernels of ``csrc/``.  Their probe
  refuses an operand that is not placed on a CUDA device.
* ``loop_reference`` -- per-diagonal / per-chunk traversals: slow,
  obviously correct, never picked automatically.

``backend="auto"`` picks ``cuda`` when the operand goes to a CUDA device and
the probe accepts it, and ``torch`` otherwise.  Ranking by a cost model
belongs to the perfmodel slice (ROADMAP.md, queue 1 item 6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

OPS = ("spmv", "spmm")
BACKENDS = ("torch", "cuda", "loop_reference")


@dataclass(frozen=True)
class KernelContext:
    """What a build or probe hook needs beyond the operand: the device the
    plan places the operand on."""

    device: torch.device = field(default_factory=lambda: torch.device("cpu"))


@dataclass(frozen=True)
class Capability:
    """Outcome of a probe: can this entry run for this operand, here?"""

    ok: bool
    reason: str = ""


CAP_OK = Capability(True)


@dataclass
class CompiledKernel:
    """What a build hook returns: the executor and its report label."""

    fn: Callable
    label: str                    # "torch" | "cuda" | "loop"
    choice: object | None = None  # a kernel's launch geometry, if it has one


@dataclass(frozen=True)
class KernelEntry:
    format: str
    op: str
    backend: str
    build: Callable                   # build(matrix, ctx) -> CompiledKernel
    probe: Callable                   # probe(matrix, ctx) -> Capability
    description: str = ""

    @property
    def key(self) -> tuple:
        return (self.format, self.op, self.backend)


class BackendUnavailable(LookupError):
    """No registered entry can run this (format, op) here."""


_TABLE: dict[tuple, KernelEntry] = {}
_POPULATED = False


def _ensure_populated() -> None:
    """Import the kernel modules so their entries land in the table."""
    global _POPULATED
    if _POPULATED:
        return
    _POPULATED = True
    from . import csr, dia, hybrid, matrix_free, sell  # noqa: F401


def probe_cuda(matrix, ctx: KernelContext) -> Capability:
    """The platform gate of every ``cuda`` entry."""
    if ctx.device.type != "cuda":
        return Capability(False, "the cuda backend needs the operand on a "
                                 f"CUDA device; it is placed on {ctx.device}")
    return CAP_OK


def _probe_ok(matrix, ctx) -> Capability:
    return CAP_OK


def register_kernel(format: str, op: str, backend: str, *, description: str = ""):
    """Decorator: the decorated function is the entry's build hook.  Every
    entry takes every value dtype of ``core.formats.VALUE_DTYPES``."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")

    def deco(build):
        probe = probe_cuda if backend == "cuda" else _probe_ok
        entry = KernelEntry(format, op, backend, build, probe, description)
        if entry.key in _TABLE:
            raise ValueError(f"kernel {entry.key} already registered")
        _TABLE[entry.key] = entry
        return build

    return deco


def entries(format: str | None = None, op: str | None = None,
            backend: str | None = None) -> list[KernelEntry]:
    """Registered entries, optionally filtered, in registration order."""
    _ensure_populated()
    return [e for e in _TABLE.values()
            if (format is None or e.format == format)
            and (op is None or e.op == op)
            and (backend is None or e.backend == backend)]


def on_device(ctx: KernelContext, *tensors):
    """The tensors (None passes) moved to the context's device: a build
    hook's one-time placement of the operand."""
    return [None if t is None else t.to(ctx.device) for t in tensors]


def has(format: str, op: str, backend: str) -> bool:
    _ensure_populated()
    return (format, op, backend) in _TABLE


def get(format: str, op: str, backend: str) -> KernelEntry:
    _ensure_populated()
    try:
        return _TABLE[(format, op, backend)]
    except KeyError:
        have = sorted(e.backend for e in entries(format, op))
        raise KeyError(f"no kernel registered for ({format}, {op}, {backend}); "
                       f"registered backends: {have}") from None


def build(matrix, format: str, op: str, backend: str,
          ctx: KernelContext | None = None) -> CompiledKernel:
    """Build an explicit entry; :class:`BackendUnavailable` when its probe
    refuses the operand."""
    ctx = ctx or KernelContext()
    entry = get(format, op, backend)
    cap = entry.probe(matrix, ctx)
    if not cap.ok:
        raise BackendUnavailable(f"({format}, {op}, {backend}) cannot run "
                                 f"here: {cap.reason}")
    return entry.build(matrix, ctx)


def select_backend(matrix, format: str, op: str,
                   ctx: KernelContext | None = None) -> str:
    """``backend="auto"``: ``cuda`` when its entry exists and its probe
    accepts the operand, else ``torch``."""
    ctx = ctx or KernelContext()
    if has(format, op, "cuda") and get(format, op, "cuda").probe(matrix, ctx).ok:
        return "cuda"
    if has(format, op, "torch") and get(format, op, "torch").probe(matrix, ctx).ok:
        return "torch"
    raise BackendUnavailable(f"no registered backend can run ({format}, {op}) "
                             f"on {ctx.device}")
