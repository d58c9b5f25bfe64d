"""Operation counts of a PyTorch function: FLOPs and eager bytes, per op.

Port of ``repro.utils.jaxpr_flops``.  The reference walks a jaxpr, where a
scan's body appears once with its trip count and a remat region as an
explicit equation.  PyTorch has no such program: it runs.  So the port
counts what runs -- every ATen op that reaches one ``TorchDispatchMode``
while ``fn`` executes, on any device (``meta`` included, where nothing is
allocated or computed).  Python loops and ``torch.utils.checkpoint``
recompute are counted because they execute: there is no scan rule, and the
recompute of a rematerialized unit lands in the backward's count.

FLOPs follow the reference's rules:

  products (mm, bmm, addmm, baddbmm, convolution and its backward, every
  scaled-dot-product-attention op)   2 * batch * M * N * K, from
                                     ``torch.utils.flop_counter``'s formulas
  the add of addmm / baddbmm / a biased convolution   1 per output element
  elementwise ops and reductions     1 per output element (the reference's
                                     code charges the output of a reduction,
                                     not its input)
  views, copies, gathers, scatters, comparisons, fills, sorts   free
  anything else                      1 per output element

``OpCounts`` keeps the products (``matmul``) apart from the rest, as Python
integers (exact at any size: a global training step passes 2**53).  It also
sums the eager bytes of each op: every tensor argument read whole and every
output written whole, views excluded -- the traffic of the unfused eager
program, an upper bound on what a fused one moves.

A hand-written CUDA kernel is invisible to the mode: ``kernels.cuda_build``
calls it through ``ctypes``.  So ``OpCounter`` also reads the build's launch
counters before and after, and a nonzero ``launches`` marks the count as
missing that kernel's work.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: ops that cost no FLOPs: the reference's ``_FREE`` (views, copies, casts,
#: gathers, scatters, comparisons, sorts, random draws) in ATen's names
_FREE = frozenset({
    "_unsafe_view", "_reshape_alias", "clone", "copy", "_to_copy", "to",
    "contiguous", "cat", "stack", "split", "split_with_sizes", "unbind",
    "chunk", "index", "index_select", "gather", "scatter", "scatter_add",
    "scatter_reduce", "index_add", "index_put", "_index_put_impl", "index_copy",
    "index_fill", "masked_scatter", "embedding", "embedding_dense_backward",
    "eq", "ne", "ge", "gt", "le", "lt", "isfinite", "isnan", "isinf",
    "logical_not", "logical_and", "logical_or", "bitwise_not", "bitwise_and",
    "bitwise_or", "sort", "argsort", "argmax", "argmin", "fill", "zero",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "empty",
    "empty_like", "empty_strided", "empty_permuted", "new_zeros", "new_ones",
    "new_empty", "new_empty_strided", "new_full", "arange", "scalar_tensor",
    "lift_fresh", "lift_fresh_copy", "constant_pad_nd", "pad", "flip", "roll",
    "repeat", "repeat_interleave", "slice_scatter", "select_scatter",
    "diagonal_scatter", "as_strided_scatter", "slice_backward",
    "select_backward", "detach", "alias", "_local_scalar_dense", "rand",
    "randn", "randint", "randperm", "bernoulli", "normal", "uniform",
    "random", "exponential", "wait_tensor", "bitwise_left_shift",
    "bitwise_right_shift", "resize", "set", "_assert_tensor_metadata",
})

#: ops that move no bytes: they allocate or relabel (besides views)
_NO_TRAFFIC = frozenset({
    "_unsafe_view", "_reshape_alias", "empty", "empty_like", "empty_strided",
    "empty_permuted", "new_empty", "new_empty_strided", "lift_fresh",
    "detach", "alias", "_local_scalar_dense", "resize", "set",
    "_assert_tensor_metadata",
})

#: products that also add a bias (charged 1 per output element, as the
#: reference's separate ``add``)
_ADDS = frozenset({"addmm", "baddbmm"})


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _numel(ts) -> int:
    return sum(t.numel() for t in ts)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _base_name(func) -> str:
    """``aten.add_.Tensor`` -> ``add``; ``aten._foreach_mul_`` -> ``_foreach_mul``."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


@dataclass
class OpCounts:
    """FLOPs and eager bytes of one counted window.

    ``matmul`` holds the products' FLOPs, ``other`` the rest; ``by_op`` maps
    an ATen op name to ``[calls, flops, bytes]``; ``launches`` counts the
    hand-written CUDA kernels launched in the window, whose work the mode
    cannot see (``complete`` is False when any was)."""

    matmul: int = 0
    other: int = 0
    bytes: int = 0
    by_op: dict = field(default_factory=dict)
    launches: int = 0

    @property
    def flops(self) -> int:
        return self.matmul + self.other

    @property
    def complete(self) -> bool:
        return self.launches == 0

    def add(self, name: str, matmul: int, other: int, nbytes: int) -> None:
        self.matmul += matmul
        self.other += other
        self.bytes += nbytes
        row = self.by_op.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += matmul + other
        row[2] += nbytes


def _op_cost(func, args, kwargs, out) -> tuple[int, int, int]:
    """(matmul FLOPs, other FLOPs, eager bytes) of one ATen call."""
    from torch.utils.flop_counter import flop_registry

    name = _base_name(func)
    outs = _tensors(out)
    if out is None or (not outs and name.startswith("_foreach")):
        outs = _tensors(args[0]) if args else []     # an in-place foreach op
    if func.is_view or name in _NO_TRAFFIC:
        nbytes = 0
    else:
        nbytes = _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
    packet = func.overloadpacket
    if packet in flop_registry:
        mm = int(flop_registry[packet](*args, **kwargs, out_val=out))
        biased = name in _ADDS or (name == "convolution" and args[2] is not None)
        return mm, _numel(outs[:1]) if biased else 0, nbytes
    if func.is_view or name in _FREE or func.namespace == "_c10d_functional":
        return 0, 0, nbytes
    return 0, _numel(outs), nbytes


class OpCounter(TorchDispatchMode):
    """Counts every ATen op run inside it (and the counted CUDA launches)::

        with OpCounter() as c:
            loss = model.loss(params, batch)[0]
            loss.backward()
        c.counts.matmul, c.counts.bytes
    """

    def __init__(self):
        super().__init__()
        self.counts = OpCounts()

    def __enter__(self):
        from ..kernels import cuda_build

        self._launches0 = sum(cuda_build.launch_counts().values())
        return super().__enter__()

    def __exit__(self, *exc):
        from ..kernels import cuda_build

        self.counts.launches = sum(cuda_build.launch_counts().values()) - self._launches0
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        mm, other, nbytes = _op_cost(func, args, kwargs, out)
        self.counts.add(str(func.overloadpacket.__name__), mm, other, nbytes)
        return out


def count_fn(fn, *args, **kwargs) -> OpCounts:
    """Run ``fn(*args, **kwargs)`` once under one ``OpCounter``; a ``fn``
    that calls ``backward()`` (or ``torch.autograd.grad``) inside is counted
    forward plus backward."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.counts


def flops_of_fn(fn, *args, **kwargs) -> int:
    """Every FLOP ``fn`` executes (products and the rest), the reference's
    ``flops_of_fn``."""
    return count_fn(fn, *args, **kwargs).flops
