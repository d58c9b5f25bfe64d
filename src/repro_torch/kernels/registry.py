"""The kernel registry: one ``(format, op, backend)`` table for the port.

Backends (:data:`BACKENDS`):

* ``torch`` -- the composite PyTorch formulations (gather + ``index_add_`` /
  ``sum``), the counterpart of the reference's ``xla`` entries.  They run on
  any device and are the plain versions the CUDA kernels are held against.
* ``cuda`` -- the hand-written Hopper kernels of ``csrc/``.  Their probe
  refuses an operand that is not placed on a CUDA device.
* ``loop_reference`` -- per-diagonal / per-chunk traversals: slow,
  obviously correct, never picked automatically (``auto=False``).

Every entry carries a cost hook: predicted seconds for one call through
``core.perfmodel.predict_exec``, with the entry's own stream-byte regime
(flat vs padded SELL) and formulation efficiency.  ``backend="auto"``
(:func:`select_backend`) probes every eligible entry, takes the ``cuda``
kernel whenever its probe accepts, ranks the other survivors by cost (or,
with a tuning DB in the context, by their measured times) and memoizes the
pick on the container.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..utils.hw import H100, ChipSpec, default_device

OPS = ("spmv", "spmm")
BACKENDS = ("torch", "cuda", "loop_reference")

#: ranking derate of the loop oracles: rankable (an explicit request
#: compiles) but never the winner of an auto selection
_BACKEND_DERATE = {"torch": 1.0, "cuda": 1.0, "loop_reference": 1e-3}


@dataclass(frozen=True)
class KernelContext:
    """What a build, probe or cost hook needs beyond the operand: the device
    the plan places it on (default: the card, a ``RuntimeError`` without
    one), the chip the cost model prices, its access model (``None``:
    derived from the stored value dtype) and the tuning DB whose measured
    times rank the entries (``None``: the cost hooks rank them)."""

    device: torch.device = field(default_factory=lambda: default_device(None))
    chip: ChipSpec = H100
    am: object = None
    tuning: object = None             # core.tunedb.TuneDB

    def __post_init__(self):
        object.__setattr__(self, "device", default_device(self.device))


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


@dataclass(frozen=True)
class KernelEntry:
    format: str
    op: str
    backend: str
    build: Callable                   # build(matrix, ctx) -> CompiledKernel
    probe: Callable                   # probe(matrix, ctx) -> Capability
    cost: Callable                    # cost(matrix, ctx) -> seconds
    auto: bool = True                 # eligible for backend="auto"
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
    from . import (  # noqa: F401
        bsr, coo, csr, dia, ell, hybrid, jds, matrix_free, mf_product, sell, slab)


def probe_cuda(matrix, ctx: KernelContext) -> Capability:
    """The platform gate of every ``cuda`` entry."""
    if ctx.device.type != "cuda":
        return Capability(False, "the cuda backend needs the operand on a "
                                 f"CUDA device; it is placed on {ctx.device}")
    return CAP_OK


def _probe_ok(matrix, ctx) -> Capability:
    return CAP_OK


def default_cost(fmt: str, backend: str):
    """Cost hook: the execution-aware roofline with the entry's stream-byte
    regime (on the context's chip) and the format's efficiency."""

    def cost(matrix, ctx: KernelContext) -> float:
        from ..core import perfmodel as PM
        am = ctx.am if ctx.am is not None else PM.access_model_for(matrix)
        balance = PM.balance_of(matrix, am, backend=backend, chip=ctx.chip)
        eff = PM.exec_efficiency(ctx.chip).get(fmt, 1.0) * _BACKEND_DERATE[backend]
        return PM.predict_exec(fmt, balance, max(1, matrix.nnz), chip=ctx.chip,
                               efficiency={fmt: eff}).time_s

    return cost


def register_kernel(format: str, op: str, backend: str, *, auto: bool | None = None,
                    description: str = "", cost: Callable | None = None):
    """Decorator: the decorated function is the entry's build hook.  Every
    entry takes every value dtype of ``core.formats.VALUE_DTYPES``; loop
    entries are never auto-selected.  ``cost`` replaces the roofline cost
    hook (the slab entries, whose operand is no container, rank by a flat
    nominal cost)."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")

    def deco(build):
        probe = probe_cuda if backend == "cuda" else _probe_ok
        entry = KernelEntry(format, op, backend, build, probe,
                            cost or default_cost(format, backend),
                            backend != "loop_reference" if auto is None else auto,
                            description)
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


def capabilities(matrix, format: str, op: str,
                 ctx: KernelContext | None = None) -> dict:
    """{backend: Capability} over every entry registered for (format, op)."""
    ctx = ctx or KernelContext()
    return {e.backend: e.probe(matrix, ctx) for e in entries(format, op)}


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


def container_fn(matrix, format: str, op: str, backend: str, device) -> Callable:
    """The callable of an explicit entry for ``matrix`` on ``device``, built
    once per (op, backend, device) and kept on the container: what the
    per-format functions (``csr_spmv(m, x)``, ...) and ``core.spmv`` run."""
    cache = getattr(matrix, "_facade_fns", None)
    if cache is None:
        cache = {}
        object.__setattr__(matrix, "_facade_fns", cache)
    key = (op, backend, str(device))
    fn = cache.get(key)
    if fn is None:
        fn = cache[key] = build(matrix, format, op, backend,
                                KernelContext(device=device)).fn
    return fn


def select_backend(matrix, format: str, op: str,
                   ctx: KernelContext | None = None) -> tuple[str, dict]:
    """``backend="auto"``: probe every eligible entry and memoize the pick
    on the container.  A ``cuda`` entry whose probe accepts is always the
    pick -- a kernel that can run never gives way to the plain version,
    whatever chip is priced and whatever a tuning DB recorded.  Among the
    rest, a fresh measured record of ``ctx.tuning`` decides (the warm path;
    its measured seconds stand in the cost slot), else the cost hooks rank
    them.  Returns ``(backend, {backend: seconds})``;
    :class:`BackendUnavailable` when nothing survives."""
    ctx = ctx or KernelContext()
    memo_key = (format, op, str(ctx.device), ctx.chip, ctx.am,
                getattr(ctx.tuning, "token", None))
    memo = getattr(matrix, "_backend_choices", None)
    if memo is None:
        memo = {}
        object.__setattr__(matrix, "_backend_choices", memo)
    if memo_key in memo:
        return memo[memo_key]
    costs = {e.backend: e.cost(matrix, ctx) for e in entries(format, op)
             if e.auto and e.probe(matrix, ctx).ok}
    tuned = None
    if "cuda" not in costs and ctx.tuning is not None:
        tuned = ctx.tuning.lookup_backend(matrix, format, op, chip=ctx.chip,
                                          device=ctx.device)
    if "cuda" in costs:
        choice = ("cuda", costs)
    elif tuned is not None:
        choice = (tuned["backend"], {tuned["backend"]: tuned["t_measured_s"]})
    elif costs:
        choice = (min(costs, key=costs.get), costs)
    else:
        raise BackendUnavailable(f"no registered backend can run ({format}, {op}) "
                                 f"on {ctx.device}")
    memo[memo_key] = choice
    return choice


def build_best(matrix, format: str, op: str,
               ctx: KernelContext | None = None) -> CompiledKernel:
    """``select_backend`` + ``build`` in one call."""
    ctx = ctx or KernelContext()
    backend, _ = select_backend(matrix, format, op, ctx)
    return build(matrix, format, op, backend, ctx)


# ---------------------------------------------------------------------------
# introspection / CLI
# ---------------------------------------------------------------------------


def _platform_device(device=None) -> torch.device:
    """The device the table's probes answer for: ``device``, else the card
    when this process has one, else the host (a listing runs nothing)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _cost_name(hook) -> str:
    """``roofline`` for a closure out of ``default_cost``; else the name of
    the function that made or is the hook (``const_cost`` for the slabs)."""
    name = getattr(hook, "__qualname__", "cost").split(".<locals>")[0]
    return "roofline" if name == "default_cost" else name.lstrip("_")


def table_rows(device=None) -> list[dict]:
    """One row per registered entry: key, auto flag, the platform probe on
    ``device`` (default: this process's platform, see ``_platform_device``)
    and docs.  Every entry takes every value dtype of
    ``core.formats.VALUE_DTYPES``."""
    from ..core.formats import VALUE_DTYPES

    _ensure_populated()
    ctx = KernelContext(device=_platform_device(device))
    rows = []
    for e in _TABLE.values():
        cap = e.probe(None, ctx)
        rows.append({
            "format": e.format, "op": e.op, "backend": e.backend,
            "auto": e.auto, "available": cap.ok, "reason": cap.reason,
            "description": e.description, "value_dtypes": tuple(VALUE_DTYPES),
            "cost": _cost_name(e.cost),
        })
    return rows


def format_table(markdown: bool = False, device=None) -> str:
    rows = table_rows(device)
    head = ("format", "op", "backend", "auto", "available", "dtypes", "cost",
            "description")
    data = [[r["format"], r["op"], r["backend"], "yes" if r["auto"] else "no",
             "yes" if r["available"] else f"no ({r['reason']})",
             ",".join(r["value_dtypes"]), r["cost"], r["description"]] for r in rows]
    widths = [max([len(h)] + [len(str(row[i])) for row in data])
              for i, h in enumerate(head)]
    sep = " | " if markdown else "  "
    lines = [sep.join(h.ljust(w) for h, w in zip(head, widths))]
    if markdown:
        lines[0] = "| " + lines[0] + " |"
        lines.append("| " + " | ".join("-" * w for w in widths) + " |")
    for row in data:
        line = sep.join(str(c).ljust(w) for c, w in zip(row, widths))
        lines.append(("| " + line + " |") if markdown else line)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Inspect the port's kernel registry")
    ap.add_argument("--list", action="store_true",
                    help="print the registered (format, op, backend) table")
    ap.add_argument("--markdown", action="store_true",
                    help="emit a GitHub-flavored markdown table")
    ap.add_argument("--device", default=None,
                    help="device the probes answer for (default: the card if "
                         "present, else the host)")
    args = ap.parse_args(argv)
    if not (args.list or args.markdown):
        ap.print_help()
        return 0
    dev = _platform_device(args.device)
    if args.markdown:
        rows = table_rows(dev)
        print(f"### Kernel registry -- {len(rows)} entries "
              f"({len({r['backend'] for r in rows})} backends) on `{dev}`\n")
    print(format_table(markdown=args.markdown, device=dev))
    return 0


if __name__ == "__main__":
    # ``python -m repro_torch.kernels.registry`` runs this file as __main__
    # while the package import created the canonical module, where every
    # kernel registered: delegate to that instance's table, not the empty
    # one runpy would otherwise see.
    from repro_torch.kernels import registry as _canonical

    sys.exit(_canonical.main(sys.argv[1:]))
