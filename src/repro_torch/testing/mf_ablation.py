"""Where the matrix-free SpMV kernel's time goes, measured on the card.

    PYTHONPATH=src python -m repro_torch.testing.mf_ablation [--laplace 1100]
        [--L 6] [--max-phonon 5]

On the two shapes ``chip_smoke.py`` times kernel 4 at -- ``laplacian_2d(1100,
1100)`` (five generated diagonals, f64 x) and the exact Holstein-Hubbard
operator at L = 6, ``max_phonon=5`` (13 stored lanes, 8 generated
diagonals; f64 lanes and f32 lanes, f64 x) -- it times the kernel
(``csrc/mf_spmv.cu``) beside copies of it with one suspect changed, each
built with the kernels' own ``nvcc`` flags into ``build/ablation/``.  On
the exact operator each runs on the lanes streamed as they are stored and
on their 1-byte codes (``matrix_free.mf_encode``; the kernel on codes must
give the kernel on lanes bit for bit):

* ``masks_off``: no periodic mask (wrong results on purpose);
* ``rem64``: the phase ``row % p`` as a 64-bit remainder;
* ``desc_global``: the descriptor read from device memory at every
  diagonal instead of from shared memory;
* ``rows_<r>``: r rows a thread on streamed lanes instead of ``kRows``;
* ``code_rows_<r>``: r rows a thread on codes instead of ``kCodeRows``,
  the codes tiled for r (a word of r bytes a thread a lane);
* ``code_rows_consecutive``: a thread's rows consecutive instead of
  ``kBlock`` apart, the codes in row order (the same word, but a warp's x
  loads of a diagonal ``kCodeRows`` elements apart);
* ``min_blocks_8``: launch bounds that ask for 8 CTAs an SM (32 registers);
* ``x_padded``: x zero-padded by a copy at every call (``dia_spmv.pad_x``)
  and read without the column mask, as the first design's executor did;
* ``x_evict_last``: x loaded with an L2 evict_last cache policy;

and the kernel's first design (one thread a row, the descriptor in device
memory, a 64-bit remainder, a padded x; kept here as a source) alone on an
x padded once, and with the pad copy at every call.  Every variant but
``masks_off`` is checked against the plain version (1e-12: an f64
accumulator).  Times are CUDA events, best of 5 repeats of 20 calls, the
whole set timed twice in opposite orders; each bound counts what the form
reads once (lanes or codes and their table, x, y) at 3.35 TB/s.  Prints the
card, a line a variant and form, and a JSON object last.

On codes the kernel takes 4 rows a thread, ``kBlock`` apart (``kCodeRows``):
on an NVIDIA H100 80GB HBM3 at 700 W, exact L = 6 with f64 lanes, it took
0.0335 ms against 0.0637, 0.0442 and 0.0381 for 1, 2 and 8 rows, and
0.0454 with a thread's 4 rows consecutive (its codes' word the same, a
warp's x loads of a diagonal 32 bytes apart).  One byte a thread a lane
is slowest, as narrow loads were in ``mf_product``; 8 rows make 821 CTAs
of 2048 rows where 4 make 1641 (why 8 is slower is not measured: no
counters on that machine).  The streamed lanes keep 2 rows (0.0770 against
0.0826, 0.0829 and 0.0768 for 1, 4 and 8: 8 within noise of 2).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from ..core import formats as F
from ..core import matrices as M
from ..kernels import cuda_build as CB
from ..kernels import matrix_free as MF
from ..kernels.dia_spmv import pad_x
from ..utils.hw import H100
from .sell_ablation import build_variants
from .timing import CudaEventTimer

#: the kernel's first design: a thread a row, the descriptor in device
#: memory, a 64-bit remainder, x zero-padded by the caller
FIRST_DESIGN = r"""
#include "common.cuh"
template <typename T, typename A>
__global__ void mf_spmv_kernel(const T* __restrict__ data, int64_t ld,
                               const int32_t* __restrict__ desc,
                               const double* __restrict__ gen, int nd,
                               const A* __restrict__ x_pad, int64_t n_xpad,
                               int64_t pad0, A* __restrict__ y, int64_t n) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  A acc = 0;
  for (int k = 0; k < nd; ++k) {
    const int32_t* d = desc + 5 * k;
    const int64_t c = row + pad0 + d[0];
    const A xv = (c >= 0 && c < n_xpad) ? __ldg(x_pad + c) : (A)0;
    A contrib;
    if (d[4] >= 0) {
      contrib = widen<A>(data[d[4] * ld + row]) * xv;
    } else {
      contrib = (A)gen[k] * xv;
      if (d[1] != 0) {
        const int64_t r = row % d[1];
        if (r < d[2] || r >= d[3]) contrib = 0;
      }
    }
    acc += contrib;
  }
  y[row] = acc;
}

extern "C" int mf_first(int vcode, const void* data, int64_t ld, const void* desc,
                        const void* gen, int nd, const void* x_pad, int64_t n_xpad,
                        int64_t pad0, void* y, int64_t n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == V_F64)
    mf_spmv_kernel<double, double><<<grid_for(n), kBlock, 0, s>>>(
        (const double*)data, ld, (const int32_t*)desc, (const double*)gen, nd,
        (const double*)x_pad, n_xpad, pad0, (double*)y, n);
  else
    mf_spmv_kernel<float, double><<<grid_for(n), kBlock, 0, s>>>(
        (const float*)data, ld, (const int32_t*)desc, (const double*)gen, nd,
        (const double*)x_pad, n_xpad, pad0, (double*)y, n);
  return (int)cudaGetLastError();
}
"""
_FIRST_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]

_ROWS = re.compile(r"constexpr int kRows = (\d+);")
_CODE_ROWS = re.compile(r"constexpr int kCodeRows = (\d+);")
_ROW_MAP = "row[r] = base + r * kBlock;"
_MASK = "if (d.p != 0) {"
_PHASE = """  const uint32_t q = __umulhi(row << 1, d.magic) >> d.shift;
  return row - q * d.p;"""
_DESC = "const MfDiag* dd = sdesc;"
_GUARD = "const bool inb = (uint32_t)c < ncols;"
_INCLUDE = '#include "common.cuh"'
_X_LOAD = "__ldg(x + c)"
#: x loads with an L2 evict_last cache policy
_EVICT_LAST = r"""
__device__ __forceinline__ double ld_x_last(const double* p) {
  uint64_t pol;
  double v;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float ld_x_last(const float* p) {
  uint64_t pol;
  float v;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}
"""
_BOUNDS = "__launch_bounds__(kBlock)"
#: the forms of the stored lanes a variant is timed on: the lanes as they
#: are, codes tiled by ``tile_codes`` for the variant's rows a thread, and
#: codes in row order (a thread's rows consecutive)
LANES, CODES, CODES_IN_ROW_ORDER = "lanes", "codes", "codes_in_row_order"


def _variants(kernel_src: str) -> list:
    """(name, source, [(text, replacement)], checked, x padded, forms, code
    rows) per variant."""
    m, mc = _ROWS.search(kernel_src), _CODE_ROWS.search(kernel_src)
    if m is None or mc is None:
        raise RuntimeError("mf_ablation: the kernel source no longer sets kRows and kCodeRows")
    code_rows = int(mc.group(1))
    both = (LANES, CODES)
    rows = [("rows_%d" % r, kernel_src, [(m.group(0), f"constexpr int kRows = {r};")],
             True, False, (LANES,), code_rows) for r in (1, 2, 4, 8) if r != int(m.group(1))]
    crows = [("code_rows_%d" % r, kernel_src, [(mc.group(0), f"constexpr int kCodeRows = {r};")],
              True, False, (CODES,), r) for r in (1, 2, 4, 8) if r != code_rows]
    return [
        ("kernel", kernel_src, [], True, False, both, code_rows),
        ("masks_off", kernel_src, [(_MASK, "if (false) {")], False, False, both, code_rows),
        ("rem64", kernel_src, [(_PHASE, "  return (uint32_t)((int64_t)row % (int64_t)d.p);")],
         True, False, both, code_rows),
        ("desc_global", kernel_src, [(_DESC, "const MfDiag* dd = desc;")], True, False, both,
         code_rows),
        *rows,
        *crows,
        # a thread's rows consecutive: its codes' word is theirs in row order,
        # but a warp's x loads of a diagonal lie code_rows elements apart
        ("code_rows_consecutive", kernel_src, [(_ROW_MAP, "row[r] = word + r;")], True, False,
         (CODES_IN_ROW_ORDER,), code_rows),
        ("min_blocks_8", kernel_src, [(_BOUNDS, "__launch_bounds__(kBlock, 8)")], True, False,
         both, code_rows),
        ("x_padded", kernel_src, [(_GUARD, "const bool inb = true;")], True, True, both,
         code_rows),
        ("x_evict_last", kernel_src, [(_INCLUDE, _INCLUDE + _EVICT_LAST),
                                      (_X_LOAD, "ld_x_last(x + c)")], True, False, both,
         code_rows),
        ("first_design", FIRST_DESIGN, [], True, False, (LANES,), code_rows),
        ("first_design_with_pad", FIRST_DESIGN, [], True, True, (LANES,), code_rows),
    ]


def _shapes(args) -> dict:
    lap = F.MatrixFreeOperator.from_csr(M.laplacian_2d(args.laplace, args.laplace))
    ex = F.MatrixFreeOperator.from_csr(M.holstein_hubbard_exact(
        M.HolsteinHubbardParams(L=args.L, max_phonon=args.max_phonon)))
    return {f"laplacian_2d({args.laplace}) f64": lap,
            f"exact L={args.L} max_phonon={args.max_phonon} f64 lanes": ex,
            f"exact L={args.L} max_phonon={args.max_phonon} f32 lanes": F.with_value_dtype(
                ex, "f32")}


def _forms(op, data, launch, variants) -> dict:
    """{(form, code rows): (the entry point's (lanes, ld, codes, values, nv),
    the bytes the form reads, the tensors behind its pointers)} of every
    form the variants read; none coded where the lanes do not code."""
    out = {(LANES, 0): ((CB.ptr(data), data.shape[1], None, None, 0),
                        data.numel() * data.element_size(), (data,))}
    for *_, forms, r in variants:
        for form in set(forms) - {LANES}:
            codes = None if (form, r) in out else MF.mf_encode(data, launch, rows=r)
            if codes is None:
                continue
            c = codes.codes if form == CODES else MF.untile_codes(codes.codes, r).contiguous()
            v = codes.values
            out[(form, r)] = ((None, c.shape[1], CB.ptr(c), CB.ptr(v), v.numel()),
                              launch.n_stored * op.shape[0] + v.numel() * v.element_size(),
                              (c, v))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--laplace", type=int, default=1100, help="laplacian_2d side")
    ap.add_argument("--L", type=int, default=6, help="exact operator: chain sites")
    ap.add_argument("--max-phonon", type=int, default=5, help="exact operator: phonon cutoff")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mf_ablation: no CUDA device; the ablation runs on the card")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    variants = _variants(CB.source_path("mf_spmv").read_text())
    libs = build_variants([(f"mf_{v[0]}", *v[1:4]) for v in variants])
    stream = torch.cuda.current_stream(dev).cuda_stream
    timer = CudaEventTimer(repeats=5)
    out = {"card": card, "shapes": {}}
    print(card)
    for shape, op in _shapes(args).items():
        n, ncols = op.shape
        launch = MF.mf_launch(op)
        data = MF.mf_data(op).to(dev)
        forms = _forms(op, data, launch, variants)
        desc_d, gen_d = launch.desc.to(dev), launch.gen.to(dev)
        pad0, pad1 = launch.pads
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(ncols)).to(dev)
        xp = pad_x(x, pad0, pad1, torch.float64)
        want = MF.mf_spmv_plain(data, launch.desc, launch.gen, xp, pad0, n)
        y = torch.empty(n, dtype=torch.float64, device=dev)
        vcode, tab = CB.value_code(data, "data"), launch.on(dev)
        calls, nbytes = {}, {}
        for name, _, _, _, padded, vforms, r in variants:
            lib = libs[f"mf_{name}"]
            if name.startswith("first_design"):
                f = lib.mf_first
                f.argtypes, f.restype = _FIRST_ARGS, ctypes.c_int

                def call(f=f, padded=padded):
                    xq = pad_x(x, pad0, pad1, torch.float64) if padded else xp
                    return f(vcode, CB.ptr(data), data.shape[1], CB.ptr(desc_d),
                             CB.ptr(gen_d), launch.n_diags, CB.ptr(xq), xq.shape[0], pad0,
                             CB.ptr(y), n, stream)
                calls[(name, LANES)], nbytes[(name, LANES)] = call, forms[(LANES, 0)][1]
                continue
            f = lib.mf_spmv
            f.argtypes, f.restype = MF._ARGTYPES, ctypes.c_int
            for form in vforms:
                key = (form, 0 if form == LANES else r)
                if key not in forms:
                    continue
                form_args, nb, _ = forms[key]

                def call(f=f, padded=padded, form_args=form_args):
                    # a padded x is passed from its first real column on
                    xq = pad_x(x, pad0, pad1, torch.float64) if padded else x
                    return f(vcode, 1, *form_args, CB.ptr(tab), launch.n_diags,
                             CB.ptr(xq) + 8 * pad0 * padded, ncols, CB.ptr(y), n, stream)
                calls[(name, form)], nbytes[(name, form)] = call, nb
        rel, ys = {}, {}
        for (name, form), call in calls.items():
            y.fill_(float("nan"))
            CB.raise_on_error(name, call())
            torch.cuda.synchronize()
            if name == "kernel":
                ys[form] = y.clone()
            rel[(name, form)] = float((y - want).abs().max() / want.abs().max())
            checked = next(v[3] for v in variants if v[0] == name)
            if checked and not rel[(name, form)] <= 1e-12:
                raise AssertionError(f"mf_ablation {shape}: {name} on {form} disagrees with "
                                     f"the plain version (rel err {rel[(name, form)]:.3e})")
        if CODES in ys and not torch.equal(ys[CODES], ys[LANES]):
            raise AssertionError(f"mf_ablation {shape}: the kernel on codes and on lanes "
                                 "differ in bits")
        order = list(calls)
        ms = {k: [] for k in order}
        for rnd in (order, order[::-1]):
            for key in rnd:
                ms[key].append(timer.measure(calls[key], iters=20) * 1e3)
        res = {"rows": n, "stored_lanes": launch.n_stored, "diagonals": launch.n_diags,
               "masked": int((launch.table["p"] != 0).sum()), "variants": {}}
        print(f"[{shape}] {n} rows, {launch.n_stored} stored lanes, {launch.n_diags} "
              f"diagonals ({res['masked']} masked)")
        for (name, form), v in ms.items():
            nb = nbytes[(name, form)] + ncols * 8 + n * 8
            bound = nb / H100.hbm_bytes_per_s * 1e3
            res["variants"][f"{name}/{form}"] = {
                "ms": min(v), "ms_rounds": v, "rel_err": rel[(name, form)], "bytes": nb,
                "bound_ms": bound, "share_of_bound": bound / min(v)}
            print(f"  {name + '/' + form:40s} {min(v):.4f} ms; bound {bound:.4f} ms "
                  f"({nb / 1e6:.1f} MB, {100 * bound / min(v):.1f} %); rel err vs plain "
                  f"{rel[(name, form)]:.2e}")
        out["shapes"][shape] = res
        del data, x, xp, want, y, desc_d, gen_d, forms, ys
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
