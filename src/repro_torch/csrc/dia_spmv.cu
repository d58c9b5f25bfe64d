// DIA SpMV for Hopper.
//
// Replaces: repro/kernels/dia_spmv.py::dia_spmv_arrays (the Pallas kernel
// _dia_kernel) with the per-diagonal dequantization scales of
// repro/kernels/dia.py.
//
// Bound: memory.  One SpMV streams the (nd, n) diagonal table once (1-8 B
// per slot, no index bytes at all), reads x and writes y.  The 13 diagonals
// that split_dia takes from the N = 1,201,200 Holstein surrogate are
// 15.6 M slots, ~62 MB in f32, so ~19 us at the H100 SXM's 3.35 TB/s.
//
// Design: one thread per row, looping over the diagonals.  data[k, row] and
// x_pad[row + pad0 + off[k]] are both stride-1 across a warp, so every load
// is coalesced.  A column that runs off either edge of x_pad reads zero
// under a bounds check on x_pad's length.  The plan's path
// (plan_launch.cu) passes x itself, unpadded, with pad0 = 0 and n_xpad = N,
// so that check gives the edges' zeros there and no padded copy of x is
// made; dia_spmv_arrays' callers pass an x zero-padded by the wrapper
// (pad_x), whose zeros give the same products.
// The offsets and the optional per-diagonal scales are small device arrays
// (the TPU kernel baked them in as static tuples); every thread of a block
// reads the same entry, which the L1 broadcasts.  The products are added in
// ascending diagonal order, as the Pallas kernel does.  The kernel and its
// launcher are in dia_spmv.cuh.
#include "dia_spmv.cuh"

extern "C" int dia_spmv(int vcode, int acc64, const void* data, int64_t ld,
                        const void* offsets, const void* scales, int nd,
                        const void* x_pad, int64_t n_xpad, int64_t pad0,
                        void* y, int64_t n, void* stream) {
  const int rc = launch_dia_spmv(vcode, acc64, data, ld, offsets, scales, nd, x_pad, n_xpad,
                                 pad0, y, n, (cudaStream_t)stream);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
