// CSR (the paper's CRS) SpMV for Hopper.
//
// Replaces: repro/kernels/csr_spmv.py::csr_rowsplit_arrays (the Pallas kernel
// _csr_rowsplit_kernel) with the per-row scale applied outside it in
// repro/kernels/csr.py.  The one-hot (T, E, R) contraction is how the TPU's
// matrix unit does a tiny segment sum; here a row is reduced with warp
// shuffles instead, and row_ptr / col_idx / val are read as they are, with
// no padded slabs.
//
// Bound: memory.  One SpMV streams val (1-8 B) and col_idx (4 B) per nonzero
// plus row_ptr, x and y: on the N = 1,201,200 Holstein surrogate (16.8 M
// nnz) ~144 MB in f32, so ~43 us at the H100 SXM's 3.35 TB/s.
//
// Design: a sub-warp of L lanes per row (L = 4..32, the power of two the
// wrapper picks from the mean row length: 16 for ~14 nnz/row).  The lanes
// walk the row's nonzeros L apart, so a sub-warp reads L neighbouring
// values and column ids per step, then reduce with __shfl_down_sync inside
// the sub-warp.  Every thread of a warp reaches the shuffles -- rows past
// the end contribute zeros -- so the full mask is always valid.  Lane 0
// applies the per-row scale to the finished sum and writes y in original
// row order.
#include "common.cuh"

template <typename T, typename A, int L>
__global__ void csr_spmv_kernel(const int32_t* __restrict__ row_ptr,
                                const int32_t* __restrict__ col,
                                const T* __restrict__ val,
                                const float* __restrict__ scale,
                                const A* __restrict__ x, A* __restrict__ y,
                                int64_t n_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = t / L;
  const int lane = (int)(threadIdx.x % L);
  A acc = 0;
  if (row < n_rows) {
    const int hi = row_ptr[row + 1];
    for (int i = row_ptr[row] + lane; i < hi; i += L) {
      acc += widen<A>(val[i]) * __ldg(x + col[i]);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off, L);
  }
  if (lane == 0 && row < n_rows) {
    y[row] = scale != nullptr ? acc * (A)scale[row] : acc;
  }
}

template <typename T, typename A>
static int launch_csr(int lanes, const void* row_ptr, const void* col,
                      const void* val, const void* scale, const void* x,
                      void* y, int64_t n_rows, cudaStream_t s) {
  const unsigned grid = grid_for(n_rows * lanes);
#define CSR_ARGS                                                           \
  (const int32_t*)row_ptr, (const int32_t*)col, (const T*)val,             \
      (const float*)scale, (const A*)x, (A*)y, n_rows
  switch (lanes) {
    case 4: csr_spmv_kernel<T, A, 4><<<grid, kBlock, 0, s>>>(CSR_ARGS); break;
    case 8: csr_spmv_kernel<T, A, 8><<<grid, kBlock, 0, s>>>(CSR_ARGS); break;
    case 16: csr_spmv_kernel<T, A, 16><<<grid, kBlock, 0, s>>>(CSR_ARGS); break;
    case 32: csr_spmv_kernel<T, A, 32><<<grid, kBlock, 0, s>>>(CSR_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CSR_ARGS
  return 0;
}

extern "C" int csr_spmv(int vcode, int acc64, int lanes, const void* row_ptr,
                        const void* col, const void* val, const void* scale,
                        const void* x, void* y, int64_t n_rows, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
#define LAUNCH(T, A) \
  rc = launch_csr<T, A>(lanes, row_ptr, col, val, scale, x, y, n_rows, s)
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
