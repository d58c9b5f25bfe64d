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
// is coalesced; x_pad is zero-padded by the wrapper, so rows whose column
// runs off the matrix read zeros (a bounds check on x_pad's length guards
// against a caller's short padding; it never fires on the plan's path).
// The offsets and the optional per-diagonal scales are small device arrays
// (the TPU kernel
// baked them in as static tuples); every thread of a block reads the same
// entry, which the L1 broadcasts.  The products are added in ascending
// diagonal order, as the Pallas kernel does.
#include "common.cuh"

template <typename T, typename A>
__global__ void dia_spmv_kernel(const T* __restrict__ data, int64_t ld,
                                const int32_t* __restrict__ offsets,
                                const float* __restrict__ scales, int nd,
                                const A* __restrict__ x_pad, int64_t n_xpad,
                                int64_t pad0, A* __restrict__ y, int64_t n) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  A acc = 0;
  for (int k = 0; k < nd; ++k) {
    const int64_t c = row + pad0 + offsets[k];
    const A xv = (c >= 0 && c < n_xpad) ? __ldg(x_pad + c) : (A)0;  // guard only
    A contrib = widen<A>(data[k * ld + row]) * xv;
    if (scales != nullptr) contrib *= (A)scales[k];
    acc += contrib;
  }
  y[row] = acc;
}

extern "C" int dia_spmv(int vcode, int acc64, const void* data, int64_t ld,
                        const void* offsets, const void* scales, int nd,
                        const void* x_pad, int64_t n_xpad, int64_t pad0,
                        void* y, int64_t n, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, A)                                                         \
  dia_spmv_kernel<T, A><<<grid_for(n), kBlock, 0, s>>>(                      \
      (const T*)data, ld, (const int32_t*)offsets, (const float*)scales, nd, \
      (const A*)x_pad, n_xpad, pad0, (A*)y, n)
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
