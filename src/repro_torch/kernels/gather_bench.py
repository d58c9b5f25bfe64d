"""The microbenchmark kernel pair: the streamed-vs-gathered split (Fig 2/3b).

Two kernels with the same streamed traffic, differing only in the gather:

  stream_triad : o = b + a * c     (dense triad; the STREAM calibration)
  gather_scp   : o = a * x[idx]    (the ISSCP/IRSCP inner body)

Each wrapper launches ``csrc/gather_bench.cu`` on CUDA tensors and runs the
plain PyTorch version on CPU tensors.  Unlike the reference's Pallas
kernels, any ``n`` is taken (no ``n % tile`` requirement).  The reduction of
``gather_scp``'s output stays with the caller (``torch.sum``), as in the
reference, so its streamed traffic stays comparable to the triad's.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build as CB

_FLOATS = (torch.float32, torch.float64)
_TRIAD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
_GATHER_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]

#: vectors of each array one thread of the triad loads before its first
#: store (``kTriadUnroll`` in gather_bench.cu): a block's tile is
#: ``TRIAD_UNROLL * 256`` vectors of 16 bytes
TRIAD_UNROLL = 8

#: resident blocks of 256 threads per SM that the gather's grid-stride pass
#: asks for (8 x 256 = 2048 threads, the SM's maximum)
BLOCKS_PER_SM = 8

_SMS: dict = {}


def stream_blocks(device: torch.device, work: int) -> int:
    """Grid of a grid-stride pass over ``work`` items: enough blocks to fill
    every SM once, never more than the work needs.  (The triad sizes its own
    grid to the work: one tile of ``TRIAD_UNROLL`` x 256 vectors a block.)"""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-work // 256), _SMS[device] * BLOCKS_PER_SM))


def stream_triad_plain(a, b, c):
    """o = b + a * c, rounded as the kernel rounds (product, then sum)."""
    return b + a * c


def gather_scp_plain(a, idx, x):
    """o = a * x[idx] per element."""
    return a * x.index_select(0, idx)


def _check(ts: dict, dev, dtype):
    for what, t in ts.items():
        CB.check_tensor(t, what, dev, (dtype,), 1)


def stream_triad(a, b, c):
    """STREAM triad: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  a, b, c: (n,) of one float dtype."""
    if a.device.type == "cpu":
        return stream_triad_plain(a, b, c)
    if a.device.type != "cuda":
        raise ValueError(f"stream_triad: no kernel for device {a.device}")
    dev, dtype = a.device, a.dtype
    if dtype not in _FLOATS:
        raise TypeError(f"stream_triad takes f32 or f64, got {dtype}")
    _check({"a": a, "b": b, "c": c}, dev, dtype)
    n = a.shape[0]
    if b.shape[0] != n or c.shape[0] != n:
        raise ValueError(f"a, b, c lengths differ: {n}, {b.shape[0]}, {c.shape[0]}")
    o = torch.empty_like(a)
    vec = int(all(t.data_ptr() % 16 == 0 for t in (a, b, c, o)))
    CB.launch("stream_triad", _TRIAD_ARGTYPES, dev, int(dtype == torch.float64), CB.ptr(a),
              CB.ptr(b), CB.ptr(c), CB.ptr(o), n, vec)
    return o


def gather_scp(a, idx, x):
    """o = a * x[idx]: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  a: (n,) f32/f64, idx: (n,) int32 with every entry in
    [0, len(x)) (the caller's contract: the kernel reads x at idx
    unchecked), x: (N,) of a's dtype."""
    if a.device.type == "cpu":
        return gather_scp_plain(a, idx, x)
    if a.device.type != "cuda":
        raise ValueError(f"gather_scp: no kernel for device {a.device}")
    dev, dtype = a.device, a.dtype
    if dtype not in _FLOATS:
        raise TypeError(f"gather_scp takes f32 or f64, got {dtype}")
    _check({"a": a, "x": x}, dev, dtype)
    CB.check_tensor(idx, "idx", dev, (torch.int32,), 1)
    n = a.shape[0]
    if idx.shape[0] != n:
        raise ValueError(f"a has {n} elements, idx {idx.shape[0]}")
    o = torch.empty_like(a)
    CB.launch("gather_scp", _GATHER_ARGTYPES, dev, int(dtype == torch.float64), CB.ptr(a),
              CB.ptr(idx), CB.ptr(x), CB.ptr(o), n, stream_blocks(dev, n))
    return o


def traffic_model(n: int, value_bytes: int, idx_bytes: int = 4) -> dict:
    """Streamed bytes for each kernel (the model input for fig3b)."""
    return {
        "stream_triad": 4 * n * value_bytes,              # a, b, c in + o out
        "gather_scp": n * (2 * value_bytes + idx_bytes),  # a, idx in + o out (x apart)
    }
