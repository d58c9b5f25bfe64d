"""Hybrid DIA + SELL entries: compositions of the two formats' entries.

The ``cuda`` SpMV runs the DIA kernel, then the SELL kernel adding its rows
into the DIA output: the same sum, bit for bit, as the reference's Pallas
hybrid, which adds its DIA and SELL kernels' outputs.  The two launch in
one C call from a launch record (``plan_launch``).  There
is no ``cuda`` SpMM, as the reference has no Pallas hybrid SpMM (the DIA
part has no multi-vector kernel): the SpMM runs the ``torch`` composition.
"""
from __future__ import annotations

from ..core.formats import HybridDIA
from . import dia as KD
from . import plan_launch as PL
from . import sell as KS
from .cache import spmm_by_columns
from .registry import CompiledKernel, container_fn, register_kernel


def hybrid_spmv(m: HybridDIA, x):
    """The ``torch`` entry on x's device: DIA part + SELL rest."""
    return container_fn(m, "hybrid", "spmv", "torch", x.device)(x)


def hybrid_spmm(m: HybridDIA, X):
    return container_fn(m, "hybrid", "spmm", "torch", X.device)(X)


def hybrid_spmv_loop(m: HybridDIA, x):
    """The loop oracles of the two parts, added."""
    return container_fn(m, "hybrid", "spmv", "loop_reference", x.device)(x)


def _compose(build_dia, build_sell, m: HybridDIA, ctx, label: str):
    fd = build_dia(m.dia, ctx).fn
    fs = build_sell(m.rest, ctx).fn if m.rest.nnz else None
    return CompiledKernel(fd if fs is None else (lambda x: fd(x) + fs(x)), label)


@register_kernel("hybrid", "spmv", "torch",
                 description="DIA gather + SELL flat index_add_")
def _build_spmv(m: HybridDIA, ctx) -> CompiledKernel:
    return _compose(KD._build_spmv, KS._build_spmv, m, ctx, "torch")


@register_kernel("hybrid", "spmm", "torch",
                 description="multi-vector DIA + SELL composition")
def _build_spmm(m: HybridDIA, ctx) -> CompiledKernel:
    return _compose(KD._build_spmm, KS._build_spmm, m, ctx, "torch")


@register_kernel("hybrid", "spmv", "loop_reference",
                 description="per-diagonal + per-chunk traversal oracles")
def _build_spmv_loop(m: HybridDIA, ctx) -> CompiledKernel:
    return _compose(KD._build_spmv_loop, KS._build_spmv_loop, m, ctx, "loop")


@register_kernel("hybrid", "spmm", "loop_reference",
                 description="column-by-column composed traversals")
def _build_spmm_loop(m: HybridDIA, ctx) -> CompiledKernel:
    return CompiledKernel(spmm_by_columns(_build_spmv_loop(m, ctx).fn), "loop")


@register_kernel("hybrid", "spmv", "cuda",
                 description="DIA kernel, then the SELL kernel adding its rows into "
                             "the DIA output in place")
def _build_spmv_cuda(m: HybridDIA, ctx) -> CompiledKernel:
    """Both kernels in one C call from a launch record (``plan_launch``), or
    the DIA kernel alone where the rest is empty.  Built on the card only:
    the entry's probe refuses any other device."""
    parts = (KD.spmv_part(m.dia, ctx),)
    if m.rest.nnz:
        parts += (KS.spmv_part(m.rest, ctx),)
    return CompiledKernel(PL.spmv_fn(parts, ctx.device), "cuda")
