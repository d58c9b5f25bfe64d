"""Where the SELL SpMV kernel's time goes, measured on the card.

    PYTHONPATH=src python -m repro_torch.testing.sell_ablation [--n 1201200]

On the hybrid plan's SELL remainder of the Holstein-Hubbard surrogate
(``split_dia``: C = 8, sigma 256, f32 values, f64 x) it times kernel 1
(``csrc/sell_spmv.cu``) beside copies of it with one suspect taken out,
each built with the kernels' own ``nvcc`` flags into ``build/ablation/``:

* ``coalesced_x``: each gather reads x next to the slot's own position
  (still after, and dependent on, its col load) instead of at ``col``;
* ``slot_order``: each row stored at its permuted position, without
  ``perm``;

and the kernel's first design (one thread per chunk row walking its own
slots, kept here as a source) as it was, with the same two suspects taken
out, and with its slot loop unrolled by 8, all loads issued ahead.  A copy
that takes a suspect out gives wrong results on purpose; the kernel and
the first design with and without loads ahead are checked against the
plain version (``chip_smoke.py`` times the library call beside the
kernel).  Times are CUDA events, best of 5 repeats of 20 calls, the whole
set timed twice in opposite orders.  Prints the card, a line a variant,
and a JSON object last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from ..core import formats as F
from ..core import matrices as M
from ..kernels import cuda_build as CB
from ..kernels import sell as KS
from ..kernels import sell_spmv as KP
from ..utils.hw import H100
from .timing import CudaEventTimer

ABLATION_DIR = CB.BUILD_DIR.parent / "ablation"

#: the kernel's first design: a thread per chunk row, f32 values, f64 x
FIRST_DESIGN = r"""
#include "common.cuh"
__global__ void sell_rows_kernel(const int64_t* __restrict__ chunk_ptr,
                                 const int32_t* __restrict__ chunk_width,
                                 const int32_t* __restrict__ col, const float* __restrict__ val,
                                 const int32_t* __restrict__ perm, const double* __restrict__ x,
                                 double* __restrict__ y, int64_t n_chunks, int C,
                                 int64_t n_rows) {
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t c = slot / C;
  if (c >= n_chunks) return;
  const int lane = (int)(slot - c * C);
  const int w = chunk_width[c];
  int64_t p = chunk_ptr[c] + lane;
  double acc = 0;
  for (int j = 0; j < w; ++j, p += C) {
    acc += (double)val[p] * __ldg(x + col[p]);
  }
  const int32_t row = perm[slot];
  if (row < n_rows) y[row] = acc;
}

extern "C" int sell_rows(const void* chunk_ptr, const void* chunk_width, const void* col,
                         const void* val, const void* perm, const void* x, void* y,
                         int64_t n_chunks, int C, int64_t n_rows, void* stream) {
  sell_rows_kernel<<<grid_for(n_chunks * C), kBlock, 0, (cudaStream_t)stream>>>(
      (const int64_t*)chunk_ptr, (const int32_t*)chunk_width, (const int32_t*)col,
      (const float*)val, (const int32_t*)perm, (const double*)x, (double*)y, n_chunks, C,
      n_rows);
  return (int)cudaGetLastError();
}
"""
_ROWS_LOOP = """  for (int j = 0; j < w; ++j, p += C) {
    acc += (double)val[p] * __ldg(x + col[p]);
  }"""
_ROWS_AHEAD = """  for (int j0 = 0; j0 < w; j0 += 8, p += 8 * C) {
    int32_t cc[8];
    float vv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u < w) { cc[u] = ld_stream(col + p + u * C); vv[u] = ld_stream(val + p + u * C); }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u < w) acc += (double)vv[u] * __ldg(x + cc[u]);
  }"""
_ROWS_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                                      ctypes.c_void_p]

#: (variant, source, [(text, replacement)], checked against the plain version)
_KERNEL_GATHER = "prod[i] = widen<A>(vv[k]) * __ldg(x + cc[k]);"
_KERNEL_PERM = "row = perm[c * C + lane];"


def inline_kernel(src: str) -> str:
    """``src`` (``csrc/sell_spmv.cu``) with the kernel's header pasted in
    place of its ``#include``, so that a variant's edits reach the kernel."""
    header = (CB.CSRC / "sell_spmv.cuh").read_text().replace("#pragma once\n", "")
    return src.replace('#include "sell_spmv.cuh"', header)


def _variants(kernel_src: str) -> list:
    kernel_src = inline_kernel(kernel_src)
    return [
        ("kernel", kernel_src, [], True),
        ("coalesced_x", kernel_src, [(_KERNEL_GATHER, "prod[i] = widen<A>(vv[k]) * __ldg("
                                      "x + ((s0 + i) >> 3) + (cc[k] >> 31));")], False),
        ("slot_order", kernel_src, [(_KERNEL_PERM, "row = (int32_t)(c * C + lane);")], False),
        ("first_design", FIRST_DESIGN, [], True),
        ("first_design_coalesced_x", FIRST_DESIGN, [(
            "__ldg(x + col[p])", "__ldg(x + (slot < n_rows ? slot : 0) + (col[p] >> 31))")],
         False),
        ("first_design_slot_order", FIRST_DESIGN, [("perm[slot]", "(int32_t)slot")], False),
        ("first_design_loads_ahead", FIRST_DESIGN, [(_ROWS_LOOP, _ROWS_AHEAD)], True),
    ]


def build_variants(variants) -> dict:
    """Compile every variant, all ``nvcc`` runs in parallel; {name: CDLL}."""
    ABLATION_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = CB.nvcc_path(), {}
    for name, src, edits, _ in variants:
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"ablation {name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        cu, so = ABLATION_DIR / f"{name}.cu", ABLATION_DIR / f"lib{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *CB.NVCC_FLAGS, "-I", str(CB.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablation {name}: nvcc failed\n{out}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_201_200, help="surrogate rows")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sell_ablation: no CUDA device; the ablation runs on the card")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    s = F.split_dia(M.holstein_hubbard_surrogate(args.n, seed=0)).rest
    if s.val.dtype != torch.float32 or s.scale is not None:
        raise RuntimeError("sell_ablation: the first design is built for f32 values")
    n, C, nc = s.shape[0], s.C, s.n_chunks
    slots = s.col_idx.shape[0]
    if slots // 8 >= n:
        raise RuntimeError("sell_ablation: coalesced_x would read past x")
    cp, cw, col, val, perm = (t.to(dev) for t in
                              (s.chunk_ptr, s.chunk_width, s.col_idx, s.val, s.perm))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n)).to(dev)
    want = KP.sell_spmv_plain(cp, cw, col, val, None, perm, x, n, C)
    y = torch.empty(n, dtype=torch.float64, device=dev)
    blocks = KS.sell_chunk_blocks(s)
    bd = blocks.on(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    variants = _variants(CB.source_path("sell_spmv").read_text())
    libs = build_variants(variants)
    calls = {}
    for name, _, _, _ in variants:
        if name.startswith("first_design"):
            f = libs[name].sell_rows
            f.argtypes, f.restype = _ROWS_ARGS, ctypes.c_int
            calls[name] = (lambda f=f: f(CB.ptr(cp), CB.ptr(cw), CB.ptr(col), CB.ptr(val),
                                         CB.ptr(perm), CB.ptr(x), CB.ptr(y), nc, C, n, stream))
        else:
            f = libs[name].sell_spmv
            f.argtypes, f.restype = KP._ARGTYPES, ctypes.c_int
            calls[name] = (lambda f=f: f(CB.value_code(val, "val"), 1, CB.ptr(cp),
                                         CB.ptr(cw), CB.ptr(col), CB.ptr(val), None,
                                         CB.ptr(perm), CB.ptr(x), CB.ptr(y), 0, nc, C, n,
                                         CB.ptr(bd), blocks.n_blocks, stream))
    rel = {}
    for name, _, _, checked in variants:
        y.fill_(float("nan"))
        CB.raise_on_error(name, calls[name]())
        torch.cuda.synchronize()
        rel[name] = float((y - want).abs().max() / want.abs().max())
        if checked and not rel[name] <= 1e-12:
            raise AssertionError(f"sell_ablation: {name} disagrees with the plain version "
                                 f"(rel err {rel[name]:.3e})")
    timer = CudaEventTimer(repeats=5)
    order = list(calls)
    ms = {k: [] for k in order}
    for rnd in (order, order[::-1]):
        for name in rnd:
            ms[name].append(timer.measure(calls[name], iters=20) * 1e3)
    nbytes = sum(t.numel() * t.element_size() for t in (cp, cw, col, val, perm, x)) + n * 8
    bound = nbytes / H100.hbm_bytes_per_s * 1e3
    print(card)
    out = {"card": card, "n": n, "nnz": s.nnz, "slots": slots, "chunk_blocks": blocks.n_blocks,
           "budget": KP.SELL_BUDGET, "bound_ms": bound, "gather_bytes": slots * 8,
           "variants": {k: {"ms": min(v), "ms_rounds": v, "rel_err": rel[k]}
                        for k, v in ms.items()}}
    for k, v in out["variants"].items():
        print(f"{k:26s} {v['ms']:.4f} ms ({100 * bound / v['ms']:.1f} % of the byte bound "
              f"{bound:.4f} ms); rel err vs plain {v['rel_err']:.2e}")
    print(json.dumps(out))
    return 0



if __name__ == "__main__":
    raise SystemExit(main())
