// Kernel 2, the DIA SpMV (design and bound: dia_spmv.cu), and its host
// launcher.  Included by dia_spmv.cu, whose entry point takes a padded x,
// and by plan_launch.cu, whose record passes the unpadded x with pad0 = 0
// and n_xpad = N.
#pragma once

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
    const A xv = (c >= 0 && c < n_xpad) ? __ldg(x_pad + c) : (A)0;  // the edges' zeros
    A contrib = widen<A>(data[k * ld + row]) * xv;
    if (scales != nullptr) contrib *= (A)scales[k];
    acc += contrib;
  }
  y[row] = acc;
}

// Launch kernel 2 on stream s.  Returns cudaErrorInvalidValue for a value /
// accumulator pair with no instance, else 0: the caller reads the launch's
// own error with cudaGetLastError.
static inline int launch_dia_spmv(int vcode, int acc64, const void* data, int64_t ld,
                                  const void* offsets, const void* scales, int nd,
                                  const void* x_pad, int64_t n_xpad, int64_t pad0, void* y,
                                  int64_t n, cudaStream_t s) {
  if (n == 0) return 0;
#define LAUNCH(T, A)                                                         \
  dia_spmv_kernel<T, A><<<grid_for(n), kBlock, 0, s>>>(                      \
      (const T*)data, ld, (const int32_t*)offsets, (const float*)scales, nd, \
      (const A*)x_pad, n_xpad, pad0, (A*)y, n)
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
  return 0;
}
