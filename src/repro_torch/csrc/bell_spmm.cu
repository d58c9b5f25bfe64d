// BELL (block-ELL) block-sparse SpMM for Hopper: Y = A X, A stored as
// nbpp dense (bm, bk) block slots per block row, X (K, N) row-major.
//
// Replaces: repro/kernels/bsr_spmm.py::bell_spmm_arrays (the Pallas kernel
// _bell_kernel: a (nbr, nbpp) grid that revisits the output block and adds
// one MXU product per slot), and the lane-padded SpMV of repro/kernels/bsr.py
// that runs through it.  The per-block scale of an int8 / fp8 container --
// the reference's xla entry, repro/kernels/bsr.py::bsr_spmv/bsr_spmm -- is
// fused: slot (i, j) adds scale[i, j] * (block @ X panel).
//
// Bound: memory at decode widths.  Each stored block is read once (bm * bk
// values) with its column id, X and Y once; the padding slots of the BELL
// slab are skipped (row_nblocks), so the bytes are those of the BSR
// container, not of its padded pack.  At Gemma-7B FFN width (24576 x 3072,
// 18,432 f32 (8, 128) blocks, 75.5 MB) the 2 * 18.9 M * N operations reach
// the f32 non-tensor peak (67 TFLOP/s) above N ~ 45 columns; below it the
// block stream bounds the kernel.
//
// Design: one CUDA block of 256 threads per (block row, tile of nt
// columns).  The block row's stored slots are walked S at a time: the S
// blocks (contiguous in the BELL slab, bm * bk values each; f32 and f64
// read 16 bytes at a time) are widened to the accumulator on their way
// into shared memory, and the X panels they meet (bk rows x nt columns
// each) follow, so several loads per thread are in flight between two
// barriers -- one slot per stage left the kernel waiting on memory latency
// at 6-16 slots per block row (PERF.md, chip run 2, PR 13), and a warp per
// block row reading straight from device memory was slower still at these
// shapes.  It still reaches only about half of the byte bound at N = 1
// (PERF.md).  Each output (r, n..n+rn) is owned
// by a group of G neighbouring lanes that split the bk sum, and the G
// partial sums meet in a shuffle reduction after the last slot.  At N = 1
// (one decode token) an (8, 128) block row gives 8 outputs: G = 32, so each
// warp owns one row of the block and its lanes run along bk -- the whole
// block row is busy, where a thread per output would leave 31 of 32 lanes
// of a warp idle.  At wide N a thread owns rn = 4 columns of one row and
// reads each block value once for all four.  Block shape (bm, bk) and N are
// runtime values; the host (kernels/bsr_spmm.py::bell_launch) picks nt, G,
// rn and S so that the outputs fit the block's threads and the staging fits
// 48 KB of shared memory.  Nothing is carried between CUDA blocks, and the
// accumulator follows acc_dtype(blocks, X): f64 when either is f64.
#include <cstring>

#include "common.cuh"

constexpr int kThreads = 256;

// values of type T in one 16-byte load
template <typename T>
constexpr int kPerVec = (int)(16 / sizeof(T));

template <typename T, typename A, int RN>
__global__ void __launch_bounds__(kThreads)
bell_spmm_kernel(const int32_t* __restrict__ bcols, const T* __restrict__ blocks,
                 const float* __restrict__ scale,
                 const int32_t* __restrict__ row_nblocks,
                 const A* __restrict__ X, A* __restrict__ Y, int nbpp, int bm,
                 int bk, int64_t n_rows, int N, int nt, int G, int S, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ntc = (nt + RN - 1) / RN;         // thread columns of the tile
  const int ntp = ntc * RN;
  const int belems = bm * bk, xelems = bk * ntp;
  A* blk_s = reinterpret_cast<A*>(smem_raw);  // S x (bm, bk), widened
  A* x_s = blk_s + S * belems;                // S x (bk, RN, ntc): column q of group c
  const int64_t i = blockIdx.x / n_tiles;     // block row
  const int n0 = (int)(blockIdx.x - i * n_tiles) * nt;
  const int tid = threadIdx.x;
  const int o = tid / G, g = tid - o * G;
  const bool active = o < bm * ntc;
  const int r = active ? o / ntc : 0, c = active ? o - (o / ntc) * ntc : 0;
  const int k_step = kThreads / ntp, nn_step = kThreads - k_step * ntp;
  const int e_first = tid / ntp, nn_first = tid - e_first * ntp;
  const int s_first = e_first / bk, k_first = e_first - s_first * bk;
  A acc[RN];
#pragma unroll
  for (int q = 0; q < RN; ++q) acc[q] = 0;
  const int len = row_nblocks != nullptr ? row_nblocks[i] : nbpp;
  for (int j0 = 0; j0 < len; j0 += S) {
    const int ns = min(S, len - j0);
    const int64_t slot0 = i * nbpp + j0;
    // the stage's ns blocks are contiguous in the slab: 16-byte loads of f32
    // and f64 values where the range allows (narrower values are widened
    // one by one, which spreads the decoding over all threads)
    const T* src = blocks + slot0 * belems;
    const int nvals = ns * belems;
    if (sizeof(T) >= 4 && nvals % kPerVec<T> == 0 && ((uintptr_t)src & 15) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      for (int e = tid; e < nvals / kPerVec<T>; e += kThreads) {
        T t[kPerVec<T>];
        const uint4 raw = __ldg(s4 + e);
        memcpy(t, &raw, sizeof(raw));
#pragma unroll
        for (int v = 0; v < kPerVec<T>; ++v) blk_s[e * kPerVec<T> + v] = widen<A>(t[v]);
      }
    } else {
      for (int e = tid; e < nvals; e += kThreads) blk_s[e] = widen<A>(src[e]);
    }
    const A* xp = X;
    // the X panels: element (s, k, nn) of the stage, walked kThreads at a
    // time with the indices carried along (a division only where a step
    // crosses into another slot)
    for (int s = s_first, k = k_first, nn = nn_first, cur = -1; s < ns;) {
      if (s != cur) {  // the slot's X block row, looked up once per slot
        cur = s;
        xp = X + (int64_t)bcols[slot0 + s] * bk * N;
      }
      const int n = n0 + nn;
      x_s[s * xelems + (k * RN + nn % RN) * ntc + nn / RN] =
          (nn < nt && n < N) ? xp[(int64_t)k * N + n] : (A)0;
      nn += nn_step;
      k += k_step;
      if (nn >= ntp) {
        nn -= ntp;
        ++k;
      }
      if (k >= bk) {
        s += k / bk;
        k %= bk;
      }
    }
    __syncthreads();
    if (active) {
      for (int s = 0; s < ns; ++s) {
        const A* bs = blk_s + s * belems + r * bk;
        const A* xs = x_s + s * xelems + c;
        A p[RN];
#pragma unroll
        for (int q = 0; q < RN; ++q) p[q] = 0;
        for (int k = g; k < bk; k += G) {
          const A a = bs[k];
#pragma unroll
          for (int q = 0; q < RN; ++q) p[q] += a * xs[(k * RN + q) * ntc];
        }
        const A sc = scale != nullptr ? (A)scale[slot0 + s] : (A)1;
#pragma unroll
        for (int q = 0; q < RN; ++q) acc[q] += sc * p[q];
      }
    }
    __syncthreads();
  }
  // the G lanes of a group are neighbours in one warp (G divides 32)
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < RN; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
  }
  const int64_t row = i * bm + r;
  if (active && g == 0 && row < n_rows) {
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      const int nn = c * RN + q, n = n0 + nn;
      if (nn < nt && n < N) Y[row * N + n] = acc[q];
    }
  }
}

extern "C" int bell_spmm(int vcode, int acc64, const void* bcols,
                         const void* blocks, const void* scale,
                         const void* row_nblocks, const void* X, void* Y,
                         int64_t nbr, int nbpp, int bm, int bk, int64_t n_rows,
                         int N, int nt, int G, int rn, int S, void* stream) {
  if (bm <= 0 || bk <= 0 || nt <= 0 || N <= 0 || G <= 0 || G > 32 || (G & (G - 1)) != 0 ||
      (rn != 1 && rn != 4) || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int ntc = (nt + rn - 1) / rn;
  if ((int64_t)bm * ntc * G > kThreads) return (int)cudaErrorInvalidValue;
  const int n_tiles = (N + nt - 1) / nt;
  const int64_t grid = nbr * n_tiles;
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t acc_bytes = acc64 ? sizeof(double) : sizeof(float);
  const size_t smem = ((size_t)bm * bk + (size_t)bk * ntc * rn) * acc_bytes * S;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH_RN(T, A, RN)                                                     \
  bell_spmm_kernel<T, A, RN><<<(unsigned)grid, kThreads, smem, s>>>(            \
      (const int32_t*)bcols, (const T*)blocks, (const float*)scale,             \
      (const int32_t*)row_nblocks, (const A*)X, (A*)Y, nbpp, bm, bk, n_rows, N, \
      nt, G, S, n_tiles)
#define LAUNCH(T, A)          \
  if (rn == 4) {              \
    LAUNCH_RN(T, A, 4);       \
  } else {                    \
    LAUNCH_RN(T, A, 1);       \
  }
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
#undef LAUNCH_RN
  return (int)cudaGetLastError();
}
