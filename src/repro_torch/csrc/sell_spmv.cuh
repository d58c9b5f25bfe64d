// Kernel 1, the SELL-C-sigma SpMV (design and bound: sell_spmv.cu), and its
// host launcher.  Included by sell_spmv.cu and by plan_launch.cu, whose
// record launches it after the DIA kernel with add set.
#pragma once

#include "common.cuh"

constexpr int kSellBudget = 512;                     // stored slots (and rows) of a chunk block
constexpr int kSellPerThread = kSellBudget / kBlock;  // 2 loads in flight a thread
constexpr int kLoneAhead = 4;                        // loads ahead in a lone chunk's walk

// the finished row: scale, then store at the row's original position, or
// add to the value there (base, loaded ahead)
template <typename A>
__device__ __forceinline__ void sell_store(A acc, A scale, int add, A base, int32_t row,
                                           A* y, int64_t n_rows) {
  acc *= scale;
  if (row < n_rows) y[row] = add ? base + acc : acc;
}

// one chunk alone in its block, of any width: G groups of C lanes (C <= 256)
template <typename T, typename A>
__device__ void sell_lone_chunk(int64_t c, int64_t s0, int w, int C,
                                const int32_t* __restrict__ col, const T* __restrict__ val,
                                const float* __restrict__ scale,
                                const int32_t* __restrict__ perm, const A* __restrict__ x,
                                A* y, int add, int64_t n_rows, A* partial) {
  const int tid = threadIdx.x;
  const A sc = scale != nullptr ? (A)scale[c] : (A)1;
  if (C > kBlock) {  // a thread a row, lanes in passes
    for (int lane = tid; lane < C; lane += kBlock) {
      A acc = 0;
      for (int j = 0; j < w; ++j) {
        const int64_t p = s0 + (int64_t)j * C + lane;
        acc += widen<A>(ld_stream(val + p)) * __ldg(x + ld_stream(col + p));
      }
      const int32_t row = perm[c * C + lane];
      sell_store(acc, sc, add, add && row < n_rows ? y[row] : (A)0, row, y, n_rows);
    }
    return;
  }
  const int G = kBlock / C, g = tid / C, lane = tid % C;
  A acc = 0;
  if (g < G) {
    // group g reads slots g, g + G, ...: the G * C threads read one
    // contiguous run of the slab per step
    for (int j0 = g; j0 < w; j0 += kLoneAhead * G) {
      int32_t cc[kLoneAhead];
      T vv[kLoneAhead];
#pragma unroll
      for (int u = 0; u < kLoneAhead; ++u) {
        const int j = j0 + u * G;
        if (j < w) {
          const int64_t p = s0 + (int64_t)j * C + lane;
          cc[u] = ld_stream(col + p);
          vv[u] = ld_stream(val + p);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoneAhead; ++u)
        if (j0 + u * G < w) acc += widen<A>(vv[u]) * __ldg(x + cc[u]);
    }
  }
  partial[tid] = acc;
  __syncthreads();
  if (tid < C) {
    A s = 0;
    for (int k = 0; k < G; ++k) s += partial[k * C + tid];
    const int32_t row = perm[c * C + tid];
    sell_store(s, sc, add, add && row < n_rows ? y[row] : (A)0, row, y, n_rows);
  }
}

template <typename T, typename A>
__global__ void __launch_bounds__(kBlock)
sell_block_kernel(const int64_t* __restrict__ chunk_ptr,
                  const int32_t* __restrict__ chunk_width, const int32_t* __restrict__ col,
                  const T* __restrict__ val, const float* __restrict__ scale,
                  const int32_t* __restrict__ perm, const A* __restrict__ x, A* y, int add,
                  const int32_t* __restrict__ blocks, int64_t n_chunks, int C,
                  int64_t n_rows) {
  __shared__ A prod[kSellBudget];
  const int tid = threadIdx.x;
  const int64_t c0 = blocks[blockIdx.x], c1 = blocks[blockIdx.x + 1];
  if (c0 < 0 || c1 <= c0 || c1 > n_chunks) return;  // never so for a checked ChunkBlocks
  const int64_t s0 = chunk_ptr[c0], s1 = chunk_ptr[c1];
  if (c1 - c0 == 1) {
    sell_lone_chunk<T, A>(c0, s0, chunk_width[c0], C, col, val, scale, perm, x, y, add,
                          n_rows, prod);
    return;
  }
  const int64_t nrows = (c1 - c0) * C;
  if (s1 - s0 > kSellBudget || nrows > kSellBudget) {  // not a sell_chunk_blocks partition
    for (int64_t r = tid; r < nrows; r += kBlock) {
      const int32_t row = perm[c0 * C + r];
      if (row < n_rows) y[row] = (A)__longlong_as_double(0x7ff8000000000000ll);  // NaN
    }
    return;
  }
  const int span = (int)(s1 - s0);
  // the first pass's row: its slab offset, width, scale, original row and
  // the value it adds to, loaded ahead of the stream
  int off = 0, w = 0;
  int32_t row = (int32_t)n_rows;
  A sc = 1, base = 0;
  auto load_row = [&](int64_t r) {
    const int64_t c = c0 + r / C;
    const int lane = (int)(r % C);
    off = (int)(chunk_ptr[c] - s0) + lane;
    w = chunk_width[c];
    row = perm[c * C + lane];
    if (scale != nullptr) sc = (A)scale[c];
  };
  if (tid < nrows) load_row(tid);
  int32_t cc[kSellPerThread];
  T vv[kSellPerThread];
#pragma unroll
  for (int k = 0; k < kSellPerThread; ++k) {  // independent loads, all in flight
    const int i = tid + k * kBlock;
    if (i < span) {
      cc[k] = ld_stream(col + s0 + i);
      vv[k] = ld_stream(val + s0 + i);
    }
  }
  if (add && tid < nrows && row < n_rows) base = y[row];
#pragma unroll
  for (int k = 0; k < kSellPerThread; ++k) {
    const int i = tid + k * kBlock;
    if (i < span) prod[i] = widen<A>(vv[k]) * __ldg(x + cc[k]);
  }
  __syncthreads();
  for (int64_t r = tid; r < nrows; r += kBlock) {  // one pass unless nrows > 256
    if (r >= kBlock) {
      load_row(r);
      base = add && row < n_rows ? y[row] : (A)0;
    }
    A acc = 0;
    for (int j = 0; j < w; ++j) acc += prod[off + j * C];
    sell_store(acc, sc, add, base, row, y, n_rows);
  }
}

// Launch kernel 1 on stream s.  blocks: the n_blocks + 1 first chunks of
// kernels/sell_spmv.py::ChunkBlocks, checked on the host to partition
// [0, n_chunks) within kSellBudget.  add: y holds the values to add to (the
// hybrid plan's DIA output), updated in place.  Returns
// cudaErrorInvalidValue for sizes the grid cannot take or a value /
// accumulator pair with no instance, else 0: the caller reads the launch's
// own error with cudaGetLastError.
static inline int launch_sell_spmv(int vcode, int acc64, const void* chunk_ptr,
                                   const void* chunk_width, const void* col, const void* val,
                                   const void* scale, const void* perm, const void* x, void* y,
                                   int add, int64_t n_chunks, int C, int64_t n_rows,
                                   const void* blocks, int64_t n_blocks, cudaStream_t s) {
  if (n_blocks < 0 || n_blocks > 0x7fffffff || C < 1 || n_rows < 0 || n_rows > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
#define LAUNCH(T, A)                                                                  \
  sell_block_kernel<T, A><<<(unsigned)n_blocks, kBlock, 0, s>>>(                      \
      (const int64_t*)chunk_ptr, (const int32_t*)chunk_width, (const int32_t*)col,   \
      (const T*)val, (const float*)scale, (const int32_t*)perm, (const A*)x, (A*)y,   \
      add, (const int32_t*)blocks, n_chunks, C, n_rows)
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
  return 0;
}
