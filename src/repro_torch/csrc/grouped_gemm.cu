// Grouped (MoE expert) GEMM for Hopper: Y[tile t] = X[tile t] @ W[e_t] for
// X (T, D) sorted by expert and group-padded to bt rows, W (E, D, F).
//
// Replaces: repro/kernels/moe_gemm.py::grouped_gemm_arrays (the Pallas
// kernel _gg_kernel: a (T/bt, F/bf) grid whose W block is chosen by the
// scalar-prefetched tile -> expert map).
//
// Bound: at the DeepSeek-V2-Lite expert width (E = 64, D = 2048, F = 1408,
// ~16,384 padded rows) the f32 product is bound by operations: 2 T D F =
// 94.5 GFLOP over the 67 TFLOP/s f32 non-tensor peak, against 0.95 GB of
// X + W + Y at 3.35 TB/s.  In bf16 the bytes (X + W + Y once) bound it on
// paper, since the tensor cores would do the operations in a tenth of that
// time; this kernel does them on the f32 pipes, so it sits far from that
// bound -- a wgmma kernel is later work.
//
// Design: a plain shared-memory tiled GEMM.  A CUDA block of 256 threads
// (16 x 16) computes a (bm, 64) tile of Y, bm the largest divisor of bt up
// to 64, so that the tile's rows belong to one expert: the block reads
// tile_expert once and walks that expert's W from device memory.  D is
// walked 16 at a time: the (bm, 16) X tile and the (16, 64) W tile are
// widened to f32 into shared memory, and each thread accumulates an RM x 4
// register tile (RM = bm / 16 rows, rounded up; 4 neighbouring columns),
// reading each operand from shared memory as one vector per k step.  f32
// and bf16 inputs, f32 accumulation; the output is result_type(X, W) (f32,
// or bf16 rounded to nearest even when both inputs are bf16).  Ragged D and
// F edges are masked; T is a multiple of bt, so rows need no mask beyond
// the tile.
#include "common.cuh"

enum GemmCode { G_F32 = 0, G_BF16 = 1 };

constexpr int kGemmThreads = 256;
constexpr int kBN = 64;  // columns of a tile
constexpr int kBK = 16;  // depth of one shared-memory stage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_bits v) { return widen_f(v); }

__device__ __forceinline__ void store_out(float* y, float v) { *y = v; }
// round to nearest even, NaN kept quiet (as torch's float -> bfloat16)
__device__ __forceinline__ void store_out(bf16_bits* y, float v) {
  unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    y->b = 0x7fc0;
    return;
  }
  u += 0x7fffu + ((u >> 16) & 1u);
  y->b = (uint16_t)(u >> 16);
}

template <typename TX, typename TW, typename TO, int RM>
__global__ void __launch_bounds__(kGemmThreads)
grouped_gemm_kernel(const int32_t* __restrict__ tile_expert, const TX* __restrict__ X,
                    const TW* __restrict__ W, TO* __restrict__ Y, int D, int F, int E,
                    int bt, int bm) {
  constexpr int kRows = 16 * RM;
  __shared__ __align__(16) float As[kBK][kRows + 4];  // [k][m]; +4 spreads the stores
  __shared__ __align__(16) float Bs[kBK][kBN];        // [k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t m0 = (int64_t)blockIdx.y * bm;
  const int n0 = blockIdx.x * kBN;
  const int64_t e = tile_expert[m0 / bt];
  if (e < 0 || e >= E) {  // a routing table the wrapper could not check: NaN, not a stray read
    for (int idx = threadIdx.x; idx < bm * kBN; idx += kGemmThreads) {
      const int mm = idx / kBN, n = n0 + idx - mm * kBN;
      if (n < F) store_out(&Y[(m0 + mm) * F + n], __uint_as_float(0x7fc00000u));
    }
    return;
  }
  const TW* We = W + e * (int64_t)D * F;
  float acc[RM][4];
#pragma unroll
  for (int q = 0; q < RM; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[q][p] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    for (int idx = threadIdx.x; idx < kRows * kBK; idx += kGemmThreads) {
      const int mm = idx / kBK, kk = idx - mm * kBK;  // neighbours along D
      float v = 0.f;
      if (mm < bm && k0 + kk < D) v = to_f32(X[(m0 + mm) * D + k0 + kk]);
      As[kk][mm] = v;
    }
    for (int idx = threadIdx.x; idx < kBK * kBN; idx += kGemmThreads) {
      const int kk = idx / kBN, nn = idx - kk * kBN;  // neighbours along F
      float v = 0.f;
      if (k0 + kk < D && n0 + nn < F) v = to_f32(We[(int64_t)(k0 + kk) * F + n0 + nn]);
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      float a[RM];
      if constexpr (RM == 4) {
        const float4 v = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      } else if constexpr (RM == 2) {
        const float2 v = *reinterpret_cast<const float2*>(&As[kk][ty * 2]);
        a[0] = v.x; a[1] = v.y;
      } else {
        a[0] = As[kk][ty];
      }
      // explicit fused multiply-adds: the sources build with --fmad=false,
      // which would otherwise split each into two instructions here
#pragma unroll
      for (int q = 0; q < RM; ++q) {
        acc[q][0] = __fmaf_rn(a[q], b.x, acc[q][0]);
        acc[q][1] = __fmaf_rn(a[q], b.y, acc[q][1]);
        acc[q][2] = __fmaf_rn(a[q], b.z, acc[q][2]);
        acc[q][3] = __fmaf_rn(a[q], b.w, acc[q][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < RM; ++q) {
    const int mm = ty * RM + q;
    if (mm >= bm) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int n = n0 + tx * 4 + p;
      if (n < F) store_out(&Y[(m0 + mm) * F + n], acc[q][p]);
    }
  }
}

extern "C" int grouped_gemm(int xcode, int wcode, int ocode, const void* tile_expert,
                            const void* X, const void* W, void* Y, int64_t T, int D,
                            int F, int E, int bt, int bm, void* stream) {
  if (bt <= 0 || bm <= 0 || bm > 64 || bt % bm != 0 || T % bt != 0 || D <= 0 || F <= 0 ||
      E <= 0)
    return (int)cudaErrorInvalidValue;
  // the output is result_type(X, W): bf16 only when both inputs are bf16
  if (ocode != ((xcode == G_BF16 && wcode == G_BF16) ? G_BF16 : G_F32))
    return (int)cudaErrorInvalidValue;
  const int64_t row_tiles = T / bm;
  if (row_tiles == 0) return 0;
  if (row_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((F + kBN - 1) / kBN), (unsigned)row_tiles);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH_RM(TX, TW, TO, RM)                                            \
  grouped_gemm_kernel<TX, TW, TO, RM><<<grid, kGemmThreads, 0, s>>>(          \
      (const int32_t*)tile_expert, (const TX*)X, (const TW*)W, (TO*)Y, D, F, \
      E, bt, bm)
#define LAUNCH(TX, TW, TO)         \
  if (bm > 32) {                   \
    LAUNCH_RM(TX, TW, TO, 4);      \
  } else if (bm > 16) {            \
    LAUNCH_RM(TX, TW, TO, 2);      \
  } else {                         \
    LAUNCH_RM(TX, TW, TO, 1);      \
  }
  if (xcode == G_F32 && wcode == G_F32) {
    LAUNCH(float, float, float);
  } else if (xcode == G_BF16 && wcode == G_BF16) {
    LAUNCH(bf16_bits, bf16_bits, bf16_bits);
  } else if (xcode == G_F32 && wcode == G_BF16) {
    LAUNCH(float, bf16_bits, float);
  } else if (xcode == G_BF16 && wcode == G_F32) {
    LAUNCH(bf16_bits, float, float);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
#undef LAUNCH_RM
  return (int)cudaGetLastError();
}
