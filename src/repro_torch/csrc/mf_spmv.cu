// Matrix-free generated-operator SpMV for Hopper.
//
// Replaces: repro/kernels/matrix_free.py::mf_spmv_arrays (the Pallas kernel
// _mf_kernel).
//
// Bound: memory.  Column indices are never stored (col = row + offset), and a
// generated diagonal streams no values either, so one SpMV moves only the
// stored lanes (1-8 B per row each), x and y.  For laplacian_2d(1100, 1100)
// -- five generated diagonals, no stored lane -- that is x and y alone:
// 19.4 MB in f64, ~6 us at the H100 SXM's 3.35 TB/s.
//
// Design: one thread per row, looping over the diagonals in ascending offset
// order (the reference's accumulation order).  The descriptor travels as a
// packed (nd, 5) int32 device array -- offset, period, lo, hi, stored-lane
// index (-1 for a generated diagonal) -- plus an f64 array of the generated
// constants, already rounded through the storage dtype.  A stored lane is a
// DIA row: data[s, row] * x[row + off].  A generated lane is gv * x[row + off],
// set to zero unless lo <= row % p < hi when p != 0 (p == 0: the rule is
// trivial, or is the matrix boundary that the padding already enforces).
// x_pad is zero-padded by the wrapper, so out-of-range columns read zeros
// (a bounds check on x_pad's length guards against short padding).
// All loads are stride-1 across a warp.
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
    const A xv = (c >= 0 && c < n_xpad) ? __ldg(x_pad + c) : (A)0;  // guard only
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

extern "C" int mf_spmv(int vcode, int acc64, const void* data, int64_t ld,
                       const void* desc, const void* gen, int nd,
                       const void* x_pad, int64_t n_xpad, int64_t pad0,
                       void* y, int64_t n, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, A)                                                       \
  mf_spmv_kernel<T, A><<<grid_for(n), kBlock, 0, s>>>(                     \
      (const T*)data, ld, (const int32_t*)desc, (const double*)gen, nd,    \
      (const A*)x_pad, n_xpad, pad0, (A*)y, n)
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
