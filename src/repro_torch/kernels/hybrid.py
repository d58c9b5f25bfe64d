"""Hybrid DIA + SELL entries: compositions of the two formats' entries.

The ``cuda`` SpMV adds the DIA kernel's and the SELL kernel's outputs, as
the reference's Pallas hybrid composes its DIA and SELL kernels.  There is
no ``cuda`` SpMM, as the reference has no Pallas hybrid SpMM (the DIA part
has no multi-vector kernel): the SpMM runs the ``torch`` composition.
"""
from __future__ import annotations

from ..core.formats import HybridDIA
from . import dia as KD
from . import sell as KS
from .cache import spmm_by_columns
from .registry import CompiledKernel, register_kernel


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
                 description="DIA kernel + SELL kernel, outputs added")
def _build_spmv_cuda(m: HybridDIA, ctx) -> CompiledKernel:
    return _compose(KD._build_spmv_cuda, KS._build_spmv_cuda, m, ctx, "cuda")
