// SELL-C-sigma SpMV for Hopper.
//
// Replaces: repro/kernels/sell_spmv.py::sell_spmv_arrays (the Pallas kernel
// _sell_kernel), together with the per-chunk scale of repro/kernels/sell.py
// and the inverse-permutation gather sell_spmv_scatter around it.
//
// Bound: memory.  One SpMV streams every stored slot once -- val (1-8 B) and
// col (4 B) for sum_c w_c * C slots, zero padding included -- plus the
// chunk table, the permutation, x and y.  On the N = 1,201,200 Holstein
// surrogate (16.8 M nnz) that is at least 8 B/nnz in f32, ~134 MB, so at
// least ~40 us at the H100 SXM's 3.35 TB/s (less on a card whose power
// limit holds it below that rate).
// x (4.8 MB in f32) stays resident in the 50 MB L2, so its gathers cost L2
// traffic, not device-memory traffic.
//
// Design: one thread per row of a chunk, C rows per chunk, kBlock / C chunks
// per block (32 for C = 8, 2 for C = 128).  Each thread walks only its own
// chunk's width -- the flat chunk_ptr / chunk_width layout, not the Pallas
// kernel's globally padded (nc, W, C) view, so no slot beyond the chunk's
// own width is read.  Within a chunk a slab is column-major, so the C
// threads of a chunk read C neighbouring addresses on every step.  x is read
// through the read-only path (__ldg).  The per-chunk scale and the inverse
// permutation are fused into the store: y[perm[slot]] = scale * acc, which
// is the reference's gather because perm is a bijection on the real rows.
#include "common.cuh"

template <typename T, typename A>
__global__ void sell_spmv_kernel(const int64_t* __restrict__ chunk_ptr,
                                 const int32_t* __restrict__ chunk_width,
                                 const int32_t* __restrict__ col,
                                 const T* __restrict__ val,
                                 const float* __restrict__ scale,
                                 const int32_t* __restrict__ perm,
                                 const A* __restrict__ x, A* __restrict__ y,
                                 int64_t n_chunks, int C, int64_t n_rows) {
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t c = slot / C;
  if (c >= n_chunks) return;
  const int lane = (int)(slot - c * C);
  const int w = chunk_width[c];
  int64_t p = chunk_ptr[c] + lane;
  A acc = 0;
  for (int j = 0; j < w; ++j, p += C) {
    acc += widen<A>(val[p]) * __ldg(x + col[p]);
  }
  if (scale != nullptr) acc *= (A)scale[c];
  const int32_t row = perm[slot];
  if (row < n_rows) y[row] = acc;
}

extern "C" int sell_spmv(int vcode, int acc64, const void* chunk_ptr,
                         const void* chunk_width, const void* col,
                         const void* val, const void* scale, const void* perm,
                         const void* x, void* y, int64_t n_chunks, int C,
                         int64_t n_rows, void* stream) {
  const int64_t threads = n_chunks * (int64_t)C;
  if (threads == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, A)                                                        \
  sell_spmv_kernel<T, A><<<grid_for(threads), kBlock, 0, s>>>(              \
      (const int64_t*)chunk_ptr, (const int32_t*)chunk_width,               \
      (const int32_t*)col, (const T*)val, (const float*)scale,              \
      (const int32_t*)perm, (const A*)x, (A*)y, n_chunks, C, n_rows)
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
