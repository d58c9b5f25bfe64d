// Multi-vector SELL-C-sigma (SpMM) for Hopper: Y = A X for K right-hand
// sides, X (N, K) row-major.
//
// Replaces: repro/kernels/sell_spmv.py::sell_spmm_arrays (the Pallas kernel
// _sell_mm_kernel), together with the per-chunk scale of repro/kernels/sell.py
// and the inverse-permutation gather sell_spmm_scatter around it.
//
// Bound: the gathers of X.  The matrix (val 1-8 B + col 4 B a stored slot)
// is streamed once for each tile of K, X (N, K) read and Y written once;
// but every stored slot gathers K values of X, nnz * K * 8 B in f64 (8.6 GB
// at K = 64 on the N = 1,201,200 Holstein surrogate), which only the 50 MB
// L2 can serve at speed.  The first design walked the chunks in storage
// order: with sigma = N the rows are sorted by length, so each of the
// surrogate's 27 length classes swept the whole +-24,024-column band of X
// again, and X came from HBM once a class -- the kernel ran at the rate of
// re-reading X (2.62 ms at K = 64 on an H100 80GB HBM3 at 700 W, PERF.md).
// chip_smoke.py times both orders (PERF.md).
//
// Design:
// * the chunks are visited in original-row order: the host schedule
//   (kernels/sell_spmv.py::ChunkSchedule, one per container) lists chunk ids
//   by the first original row they hold.  The sigma sort is stable, so every
//   length class is walked in step with the others, and the CTAs that run
//   together gather from one window of X (the band plus the rows in flight).
//   Chunks stay whole, so the matrix stream stays coalesced;
// * K is a grid dimension (blockIdx.y): a tile of at most 256 bytes of each
//   X row (32 f64 / 64 f32 columns), so the live window of X stays a few MB
//   and fits L2; each tile walks the row once;
// * a thread owns CT neighbouring columns of one row (up to 32 bytes, one
//   sector), read with 16-byte loads, and tpr = tile / CT threads share a
//   row.  val / col are loaded once a slot for CT columns, four slots' loads
//   in flight before their products;
// * each row's sum runs in slot order, and the per-chunk scale and the
//   inverse permutation are fused into the store, Y[perm[slot], k] = scale *
//   acc: two calls give the same bits.  The accumulator follows acc_dtype(val,
//   X): f64 X accumulates in f64.
#include <cstring>

#include "common.cuh"

constexpr int kUnroll = 4;  // slots whose loads are in flight together

// CT consecutive values of type A at p into v: 16-byte (or narrower) loads;
// p is aligned to min(16, CT * sizeof(A)) bytes
template <typename A, int CT>
__device__ __forceinline__ void load_cols(const A* __restrict__ p, A (&v)[CT]) {
  constexpr int kBytes = CT * (int)sizeof(A);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
      memcpy(reinterpret_cast<char*>(v) + 16 * i, &raw, 16);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    memcpy(v, &raw, 8);
  } else {
    v[0] = __ldg(p);
  }
}

template <typename A, int CT>
__device__ __forceinline__ void store_cols(A* __restrict__ p, const A (&v)[CT]) {
  constexpr int kBytes = CT * (int)sizeof(A);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      uint4 raw;
      memcpy(&raw, reinterpret_cast<const char*>(v) + 16 * i, 16);
      reinterpret_cast<uint4*>(p)[i] = raw;
    }
  } else if constexpr (kBytes == 8) {
    uint2 raw;
    memcpy(&raw, v, 8);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    p[0] = v[0];
  }
}

// One CUDA block of kBlock threads takes kBlock / tpr consecutive rows of
// the schedule order (row q * C + lane of schedule entry q) and columns
// [blockIdx.y * tpr * CT, +tpr * CT) of X.  K % CT == 0, so a thread's CT
// columns are all inside K or all outside it.
template <typename T, typename A, int CT>
__global__ void __launch_bounds__(kBlock)
sell_spmm_kernel(const int64_t* __restrict__ chunk_ptr, const int32_t* __restrict__ chunk_width,
                 const int32_t* __restrict__ col, const T* __restrict__ val,
                 const float* __restrict__ scale, const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ order, const A* __restrict__ X,
                 A* __restrict__ Y, int64_t n_chunks, int C, int64_t n_rows, int K, int tpr) {
  const int rows_per_block = kBlock / tpr;
  const int64_t pos = (int64_t)blockIdx.x * rows_per_block + threadIdx.x / tpr;
  const int k0 = (blockIdx.y * tpr + (int)(threadIdx.x % tpr)) * CT;
  const int64_t q = pos / C;
  if (q >= n_chunks || k0 >= K) return;
  const int lane = (int)(pos - q * C);
  const int64_t c = order[q];
  const int32_t row = perm[c * C + lane];
  if (row >= n_rows) return;  // a pad row of the last chunk: nothing to store
  const int w = chunk_width[c];
  const int32_t* cp = col + chunk_ptr[c] + lane;
  const T* vp = val + chunk_ptr[c] + lane;
  A acc[CT];
#pragma unroll
  for (int i = 0; i < CT; ++i) acc[i] = 0;
  int j = 0;
  for (; j + kUnroll <= w; j += kUnroll) {
    int32_t cc[kUnroll];
    T vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cc[u] = ld_stream(cp + (int64_t)(j + u) * C);
      vv[u] = ld_stream(vp + (int64_t)(j + u) * C);
    }
    A xv[kUnroll][CT];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_cols<A, CT>(X + (int64_t)cc[u] * K + k0, xv[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const A a = widen<A>(vv[u]);
#pragma unroll
      for (int i = 0; i < CT; ++i) acc[i] += a * xv[u][i];
    }
  }
  for (; j < w; ++j) {
    const int32_t cc = ld_stream(cp + (int64_t)j * C);
    const A a = widen<A>(ld_stream(vp + (int64_t)j * C));
    A xv[CT];
    load_cols<A, CT>(X + (int64_t)cc * K + k0, xv);
#pragma unroll
    for (int i = 0; i < CT; ++i) acc[i] += a * xv[i];
  }
  if (scale != nullptr) {
    const A s = (A)scale[c];
#pragma unroll
    for (int i = 0; i < CT; ++i) acc[i] *= s;
  }
  store_cols<A, CT>(Y + (int64_t)row * K + k0, acc);
}

// ct: columns a thread (1, 2, 4, or 8 with an f32 accumulator), with
// K % ct == 0 and X, Y 16-byte aligned for ct > 1; tpr: threads a row, a
// power of two <= 8 (kernels/sell_spmv.py::sell_spmm_launch picks both).
extern "C" int sell_spmm(int vcode, int acc64, const void* chunk_ptr, const void* chunk_width,
                         const void* col, const void* val, const void* scale, const void* perm,
                         const void* order, const void* X, void* Y, int64_t n_chunks, int C,
                         int64_t n_rows, int K, int ct, int tpr, void* stream) {
  const int max_ct = acc64 ? 4 : 8;
  if (C <= 0 || K <= 0 || ct <= 0 || ct > max_ct || (ct & (ct - 1)) != 0 || K % ct != 0 ||
      tpr <= 0 || tpr > 8 || (tpr & (tpr - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (ct > 1 && (((uintptr_t)X | (uintptr_t)Y) & 15) != 0) return (int)cudaErrorInvalidValue;
  const int64_t rows = n_chunks * (int64_t)C;
  if (rows == 0 || n_rows == 0) return 0;
  const int64_t gx = (rows + kBlock / tpr - 1) / (kBlock / tpr);
  const int gy = (K + tpr * ct - 1) / (tpr * ct);
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH_CT(T, A, CT)                                                                  \
  sell_spmm_kernel<T, A, CT><<<grid, kBlock, 0, s>>>(                                        \
      (const int64_t*)chunk_ptr, (const int32_t*)chunk_width, (const int32_t*)col,           \
      (const T*)val, (const float*)scale, (const int32_t*)perm, (const int32_t*)order,       \
      (const A*)X, (A*)Y, n_chunks, C, n_rows, K, tpr)
#define LAUNCH(T, A)                                   \
  switch (ct) {                                        \
    case 1: LAUNCH_CT(T, A, 1); break;                 \
    case 2: LAUNCH_CT(T, A, 2); break;                 \
    case 4: LAUNCH_CT(T, A, 4); break;                 \
    default: LAUNCH_CT(T, A, (sizeof(A) == 4 ? 8 : 4)); \
  }
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
#undef LAUNCH_CT
  return (int)cudaGetLastError();
}
