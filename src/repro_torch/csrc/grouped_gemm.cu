// Grouped (MoE expert) GEMM for Hopper: Y[tile t] = X[tile t] @ W[e_t] for
// X (T, D) sorted by expert and group-padded to bt rows, W (E, D, F).
//
// Replaces: repro/kernels/moe_gemm.py::grouped_gemm_arrays (the Pallas
// kernel _gg_kernel: a (T/bt, F/bf) grid whose W block is chosen by the
// scalar-prefetched tile -> expert map).
//
// Bound: at the DeepSeek-V2-Lite expert width (E = 64, D = 2048, F = 1408,
// 16,384 padded rows) the f32 product is bound by operations: 2 T D F =
// 94.5 GFLOP over the 67 TFLOP/s f32 non-tensor peak (1.41 ms), against
// 0.95 GB of X + W + Y at 3.35 TB/s.  In bf16 the tensor cores do the same
// operations in 0.096 ms at 989 TFLOP/s, so the bytes bound it: W is 369 MB
// of the 482 MB the call must move (0.144 ms).
//
// Design: two kernels, and the wrapper's gemm_plan picks one by rule.
//
// * gemm_wgmma_kernel (bf16 x bf16 -> bf16, bt % 64 == 0, D % 8 == 0,
//   F % 8 == 0): a CTA owns a (BM, 128) tile of Y, BM = 128 (bt % 128 ==
//   0) or 64, with f32 accumulators in registers.  One producer warp keeps
//   TMA loads in flight through a ring of 6 shared-memory stages, each a
//   K step of 64: the (BM, 64) X tile (2-D tensor map over (T, D), K-major)
//   and the (64, 128) W tile as two (64, 64) boxes of a 3-D tensor map over
//   (E, D, F), F contiguous, which wgmma reads as a transposed (MN-major)
//   B, so W is never transposed on the host.  Both use the 128-byte
//   swizzle; a stage completes on an mbarrier (transaction bytes) and is
//   released by the consumers on a second one.  BM / 64 consumer
//   warpgroups each issue wgmma.mma_async m64n128k16 over their 64 rows.
//   Ragged D and F edges are zero-filled by TMA on load and masked on
//   store.  The epilogue rounds to bf16 (nearest even), stages the tile in
//   shared memory and stores 16 bytes a thread.  At the DeepSeek shape it
//   moves about two thirds of the byte bound's rate; two CTAs an SM (three
//   stages), 64-row tiles and one wgmma group kept in flight across K steps
//   were no faster there, a deeper ring a few percent.
// * gemm_simt_kernel (f32, the mixed f32/bf16 cases, and every shape
//   outside the rule above): a register-tiled GEMM on the f32 pipes with
//   explicit fused multiply-adds (no TF32).  256 threads own a (bm, 128)
//   tile, bm <= 128, each an 8 x 8 (at bm > 64) register tile: 64 FMAs per
//   16 shared-memory reads, A and B fragments read as float4.  D is walked
//   16 deep through two shared-memory stages: an f32 W tile arrives by
//   cp.async (16 bytes a thread), X is read into registers and stored
//   k-major (transposed), bf16 widened on the way, while the other stage is
//   multiplied.  Any bt, ragged D and F (16-byte paths when D % 4 == 0 and
//   F % 4 == 0, element paths otherwise).
//
// Both kernels read tile_expert once per CTA: bm divides bt, so a tile's
// rows belong to one expert.  The grid runs the column tiles of one row
// tile next to each other and the row tiles of one expert one after
// another, so each W[e] (5.8 MB in bf16) comes from device memory about
// once and from L2 for its other row tiles.  An expert id out of range
// gives NaN rows, never a stray read.  f32 accumulation; the output is
// result_type(X, W).
#include "common.cuh"
#include "ring.cuh"

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is reached at run time

#include <type_traits>

enum GemmCode { G_F32 = 0, G_BF16 = 1 };
enum GemmPath { P_SIMT = 0, P_WGMMA = 1 };
// returned as kTensorMapError + CUresult when cuTensorMapEncodeTiled fails
constexpr int kTensorMapError = 1 << 20;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_bits v) { return widen_f(v); }

// round to nearest even, NaN kept quiet (as torch's float -> bfloat16)
__device__ __forceinline__ uint16_t bf16_rne(float v) {
  unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}
__device__ __forceinline__ void store_out(float* y, float v) { *y = v; }
__device__ __forceinline__ void store_out(bf16_bits* y, float v) { y->b = bf16_rne(v); }

// NaN over the (rows, cols) tile at (m0, n0) of Y: a routing table the
// wrapper could not check gives NaN rows, not a stray read
template <typename TO>
__device__ void fill_nan(TO* Y, int64_t m0, int n0, int rows, int cols, int F) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int mm = idx / cols, n = n0 + idx - mm * cols;
    if (n < F) store_out(&Y[(m0 + mm) * F + n], __uint_as_float(0x7fc00000u));
  }
}

// ===========================================================================
// SIMT: f32 pipes, register-tiled
// ===========================================================================

constexpr int kSimtThreads = 256;
constexpr int kBN = 128;  // columns of a tile (both kernels)
constexpr int kBK = 16;   // depth of one SIMT shared-memory stage

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four neighbouring elements as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16_bits* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// RM rows of the thread's register tile: RM = 8 covers 128 rows as two
// groups of four (ty*4 + q and 64 + ty*4 + q), so both A reads are float4
template <int RM>
__device__ __forceinline__ int tile_row(int ty, int r) {
  if constexpr (RM == 8) return r < 4 ? ty * 4 + r : 64 + ty * 4 + (r - 4);
  return ty * RM + r;
}

template <typename TX, typename TW, typename TO, int RM, bool VEC>
__global__ void __launch_bounds__(kSimtThreads)
gemm_simt_kernel(const int32_t* __restrict__ tile_expert, const TX* __restrict__ X,
                 const TW* __restrict__ W, TO* __restrict__ Y, int D, int F, int E, int bt,
                 int bm) {
  constexpr int kRows = 16 * RM;  // rows of the shared-memory tile (>= bm)
  constexpr int kAP = kRows + 4;  // pitch of As; +4 spreads the transposed stores
  // the f32 W tile goes straight to shared memory by cp.async; bf16 or
  // unaligned W, and every X tile, pass through registers
  constexpr bool kBAsync = std::is_same<TW, float>::value && VEC;
  constexpr int kAChunks = (kRows * 4 + kSimtThreads - 1) / kSimtThreads;  // 4-wide, VEC
  constexpr int kRA = VEC ? kAChunks * 4 : RM;
  constexpr int kRB = kBK * kBN / kSimtThreads;  // 8
  __shared__ __align__(16) float As[2][kBK][kAP];  // [stage][k][m]
  __shared__ __align__(16) float Bs[2][kBK][kBN];  // [stage][k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.y * bm;
  const int n0 = blockIdx.x * kBN;
  const int64_t e = tile_expert[m0 / bt];
  if (e < 0 || e >= E) {
    fill_nan(Y, m0, n0, bm, kBN, F);
    return;
  }
  const TW* We = W + e * (int64_t)D * F;
  float ra[kRA], rb[kRB];

  auto load_a = [&](int k0) {
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < kAChunks; ++j) {
        const int idx = tid + j * kSimtThreads;
        const int mm = idx >> 2, kq = (idx & 3) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (idx < kRows * 4 && mm < bm && k0 + kq < D) v = load4(X + (m0 + mm) * D + k0 + kq);
        ra[4 * j] = v.x; ra[4 * j + 1] = v.y; ra[4 * j + 2] = v.z; ra[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int idx = tid + j * kSimtThreads;
        const int mm = idx >> 4, kk = idx & 15;
        ra[j] = (mm < bm && k0 + kk < D) ? to_f32(X[(m0 + mm) * D + k0 + kk]) : 0.f;
      }
    }
  };
  auto store_a = [&](int buf) {
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < kAChunks; ++j) {
        const int idx = tid + j * kSimtThreads;
        const int mm = idx >> 2, kq = (idx & 3) * 4;
        if (idx < kRows * 4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) As[buf][kq + q][mm] = ra[4 * j + q];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int idx = tid + j * kSimtThreads;
        As[buf][idx & 15][idx >> 4] = ra[j];
      }
    }
  };
  auto load_b = [&](int k0, int buf) {
    if constexpr (kBAsync) {
#pragma unroll
      for (int j = 0; j < kRB / 4; ++j) {
        const int idx = tid + j * kSimtThreads;
        const int kk = idx >> 5, nq = (idx & 31) * 4;
        const bool in = k0 + kk < D && n0 + nq < F;  // F % 4 == 0: all four or none
        cp_async16(&Bs[buf][kk][nq], in ? (const void*)(We + (int64_t)(k0 + kk) * F + n0 + nq)
                                        : (const void*)We, in);
      }
      cp_async_commit();
    } else if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < kRB / 4; ++j) {
        const int idx = tid + j * kSimtThreads;
        const int kk = idx >> 5, nq = (idx & 31) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + kk < D && n0 + nq < F) v = load4(We + (int64_t)(k0 + kk) * F + n0 + nq);
        rb[4 * j] = v.x; rb[4 * j + 1] = v.y; rb[4 * j + 2] = v.z; rb[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRB; ++j) {
        const int idx = tid + j * kSimtThreads;
        const int kk = idx >> 7, nn = idx & 127;
        rb[j] = (k0 + kk < D && n0 + nn < F) ? to_f32(We[(int64_t)(k0 + kk) * F + n0 + nn])
                                             : 0.f;
      }
    }
  };
  auto store_b = [&](int buf) {
    if constexpr (kBAsync) {
      return;
    } else if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < kRB / 4; ++j) {
        const int idx = tid + j * kSimtThreads;
        *reinterpret_cast<float4*>(&Bs[buf][idx >> 5][(idx & 31) * 4]) =
            make_float4(rb[4 * j], rb[4 * j + 1], rb[4 * j + 2], rb[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRB; ++j) {
        const int idx = tid + j * kSimtThreads;
        Bs[buf][idx >> 7][idx & 127] = rb[j];
      }
    }
  };

  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  const int nk = (D + kBK - 1) / kBK;
  load_a(0);
  load_b(0, 0);
  store_a(0);
  store_b(0);
  if constexpr (kBAsync) cp_async_wait_all();
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < nk;
    if (more) {  // the next stage's loads are in flight while this one is multiplied
      load_a((t + 1) * kBK);
      load_b((t + 1) * kBK, buf ^ 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[RM], b[8];
      if constexpr (RM == 8) {
        const float4 u = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
        const float4 v = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
        a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
        a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
      } else if constexpr (RM == 4) {
        const float4 u = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
        a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
      } else if constexpr (RM == 2) {
        const float2 u = *reinterpret_cast<const float2*>(&As[buf][kk][ty * 2]);
        a[0] = u.x; a[1] = u.y;
      } else {
        a[0] = As[buf][kk][ty];
      }
      const float4 p = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 q = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      b[0] = p.x; b[1] = p.y; b[2] = p.z; b[3] = p.w;
      b[4] = q.x; b[5] = q.y; b[6] = q.z; b[7] = q.w;
      // explicit fused multiply-adds: the sources build with --fmad=false,
      // which would otherwise split each into two instructions here
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
    }
    if (more) {
      store_a(buf ^ 1);
      store_b(buf ^ 1);
      if constexpr (kBAsync) cp_async_wait_all();
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int mm = tile_row<RM>(ty, r);
    if (mm >= bm) continue;
    TO* yrow = Y + (m0 + mm) * F;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = n0 + g * 64 + tx * 4;
      if constexpr (std::is_same<TO, float>::value && VEC) {
        if (n < F)
          *reinterpret_cast<float4*>(yrow + n) = make_float4(
              acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2], acc[r][4 * g + 3]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (n + p < F) store_out(&yrow[n + p], acc[r][4 * g + p]);
      }
    }
  }
}

// ===========================================================================
// wgmma + TMA: bf16 tensor cores
// ===========================================================================

constexpr int kWgBK = 64;     // K step: one 128-byte swizzle row of bf16
constexpr int kWgStages = 6;  // TMA ring depth (6 beat 3, 4 and 5 at the DeepSeek shape)
constexpr int kWgPitch = kBN * 2 + 16;  // bytes of a staged output row (padded)

template <int BM>
struct WgShape {
  static constexpr int kConsumers = BM / 64;  // warpgroups, 64 rows each
  static constexpr int kThreads = kConsumers * 128 + 32;  // + the producer warp
  static constexpr int kA = BM * kWgBK * 2;   // bytes of one X stage
  static constexpr int kB = kWgBK * kBN * 2;  // bytes of one W stage (two 64 x 64 boxes)
  // stages, 2 mbarriers a stage, and slack to align the ring to 1024 bytes
  static constexpr int kSmem = kWgStages * (kA + kB) + 2 * kWgStages * 8 + 1024;
  static_assert(BM * kWgPitch <= kWgStages * (kA + kB), "epilogue tile must fit the ring");
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1 in bits
// 62-63); addresses and offsets in 16-byte units
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it cannot see that the hardware writes them later)
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x 128, f32) += A(64 x 16, K-major) * B(16 x 128, MN-major), bf16 in
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BM>
__global__ void __launch_bounds__(WgShape<BM>::kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmX, const __grid_constant__ CUtensorMap tmW,
                  const int32_t* __restrict__ tile_expert, bf16_bits* __restrict__ Y, int D,
                  int F, int E, int bt) {
  using S = WgShape<BM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sA = base, sB = base + kWgStages * S::kA;
  const uint32_t bars = sB + kWgStages * S::kB;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kWgStages + s); };
  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int e = tile_expert[m0 / bt];
  if (e < 0 || e >= E) {
    fill_nan(Y, m0, n0, BM, kBN, F);
    return;
  }
  const int nk = (D + kWgBK - 1) / kWgBK;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), S::kConsumers * 4);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= S::kConsumers * 128) {  // producer warp: one thread issues every load
    if (tid == S::kConsumers * 128) {
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % kWgStages;
        mbar_wait(empty(s), ((ks / kWgStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full(s), S::kA + S::kB);
        tma_load_2d(sA + s * S::kA, &tmX, full(s), ks * kWgBK, (int)m0);
        tma_load_3d(sB + s * S::kB, &tmW, full(s), n0, ks * kWgBK, e);
        tma_load_3d(sB + s * S::kB + S::kB / 2, &tmW, full(s), n0 + 64, ks * kWgBK, e);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the tile, all 128 columns
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % kWgStages;
    mbar_wait(full(s), (ks / kWgStages) & 1);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // A: 64 K-major rows of 128 bytes, 8-row groups 1024 bytes apart, k16
      // steps 32 bytes along the swizzled row; B: MN-major, 8-row k groups
      // 1024 bytes apart, the two 64-column boxes 8192 bytes apart, k16
      // steps two groups (2048 bytes)
      const uint64_t da = wg_desc(sA + s * S::kA + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = wg_desc(sB + s * S::kB + kk * 2048, 8192, 1024);
      wgmma_m64n128k16(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty(s));
  }

  // epilogue: every consumer is past its last wgmma, so the ring is free;
  // stage the bf16 tile there (rows padded by 16 bytes), then 16 bytes a
  // thread to Y
  asm volatile("bar.sync 1, %0;\n" ::"r"(S::kConsumers * 128) : "memory");
  const int row = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) {  // accumulator layout: n8 block i, column pair (lane % 4)
    const int col = i * 8 + (lane % 4) * 2;
    const uint32_t lo = (uint32_t)bf16_rne(acc[4 * i]) | ((uint32_t)bf16_rne(acc[4 * i + 1]) << 16);
    const uint32_t hi =
        (uint32_t)bf16_rne(acc[4 * i + 2]) | ((uint32_t)bf16_rne(acc[4 * i + 3]) << 16);
    *reinterpret_cast<uint32_t*>(gbase + row * kWgPitch + col * 2) = lo;
    *reinterpret_cast<uint32_t*>(gbase + (row + 8) * kWgPitch + col * 2) = hi;
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(S::kConsumers * 128) : "memory");
  for (int idx = tid; idx < BM * (kBN / 8); idx += S::kConsumers * 128) {
    const int r = idx / (kBN / 8), c = idx % (kBN / 8);
    const int n = n0 + c * 8;  // F % 8 == 0: a chunk of 8 is all in or all out
    if (n < F)
      *reinterpret_cast<uint4*>(Y + (m0 + r) * F + n) =
          *reinterpret_cast<const uint4*>(gbase + r * kWgPitch + c * 16);
  }
}

// ===========================================================================
// host side
// ===========================================================================

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: reached through the runtime's
// entry-point lookup, so the library needs no -lcuda
static EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

template <int BM>
static int launch_wgmma(const void* tile_expert, const void* X, const void* W, void* Y,
                        int64_t T, int D, int F, int E, int bt, cudaStream_t s) {
  using S = WgShape<BM>;
  if (((uintptr_t)X | (uintptr_t)W | (uintptr_t)Y) & 15) return (int)cudaErrorMisalignedAddress;
  EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tmX, tmW;
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t xdim[2] = {(cuuint64_t)D, (cuuint64_t)T};
  const cuuint64_t xstride[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {(cuuint32_t)kWgBK, (cuuint32_t)BM};
  CUresult r = enc(&tmX, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(X), xdim,
                   xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTensorMapError + (int)r;
  const cuuint64_t wdim[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t wstride[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)kWgBK, 1};
  r = enc(&tmW, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(W), wdim, wstride, wbox,
          ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTensorMapError + (int)r;
  const cudaError_t a = cudaFuncSetAttribute(
      gemm_wgmma_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((unsigned)((F + kBN - 1) / kBN), (unsigned)(T / BM));
  gemm_wgmma_kernel<BM><<<grid, S::kThreads, S::kSmem, s>>>(
      tmX, tmW, (const int32_t*)tile_expert, (bf16_bits*)Y, D, F, E, bt);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW, typename TO, int RM>
static void launch_simt_rm(dim3 grid, bool vec, const void* tile_expert, const void* X,
                           const void* W, void* Y, int D, int F, int E, int bt, int bm,
                           cudaStream_t s) {
#define SIMT_ARGS                                                                        \
  (const int32_t*)tile_expert, (const TX*)X, (const TW*)W, (TO*)Y, D, F, E, bt, bm
  if (vec) {
    gemm_simt_kernel<TX, TW, TO, RM, true><<<grid, kSimtThreads, 0, s>>>(SIMT_ARGS);
  } else {
    gemm_simt_kernel<TX, TW, TO, RM, false><<<grid, kSimtThreads, 0, s>>>(SIMT_ARGS);
  }
#undef SIMT_ARGS
}

template <typename TX, typename TW, typename TO>
static void launch_simt(const void* tile_expert, const void* X, const void* W, void* Y,
                        int64_t T, int D, int F, int E, int bt, int bm, cudaStream_t s) {
  const dim3 grid((unsigned)((F + kBN - 1) / kBN), (unsigned)(T / bm));
  // 16-byte paths need rows that start on 16 bytes (8 for bf16)
  const bool vec = D % 4 == 0 && F % 4 == 0 &&
                   (((uintptr_t)X | (uintptr_t)W | (uintptr_t)Y) & 15) == 0;
  if (bm > 64) {
    launch_simt_rm<TX, TW, TO, 8>(grid, vec, tile_expert, X, W, Y, D, F, E, bt, bm, s);
  } else if (bm > 32) {
    launch_simt_rm<TX, TW, TO, 4>(grid, vec, tile_expert, X, W, Y, D, F, E, bt, bm, s);
  } else if (bm > 16) {
    launch_simt_rm<TX, TW, TO, 2>(grid, vec, tile_expert, X, W, Y, D, F, E, bt, bm, s);
  } else {
    launch_simt_rm<TX, TW, TO, 1>(grid, vec, tile_expert, X, W, Y, D, F, E, bt, bm, s);
  }
}

// path: P_SIMT or P_WGMMA, chosen by the wrapper's gemm_plan; bm rows and
// kBN columns a CTA.  Returns a cudaError_t, or kTensorMapError +
// the CUresult of a failed tensor-map encode.
extern "C" int grouped_gemm(int path, int xcode, int wcode, int ocode, const void* tile_expert,
                            const void* X, const void* W, void* Y, int64_t T, int D, int F,
                            int E, int bt, int bm, void* stream) {
  if (bt <= 0 || bm <= 0 || bm > 128 || bt % bm != 0 || T % bt != 0 || D <= 0 || F <= 0 ||
      E <= 0)
    return (int)cudaErrorInvalidValue;
  // the output is result_type(X, W): bf16 only when both inputs are bf16
  if (ocode != ((xcode == G_BF16 && wcode == G_BF16) ? G_BF16 : G_F32))
    return (int)cudaErrorInvalidValue;
  if (T / bm > 65535) return (int)cudaErrorInvalidConfiguration;
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (path == P_WGMMA) {
    if (xcode != G_BF16 || wcode != G_BF16 || D % 8 != 0 || F % 8 != 0 ||
        (bm != 128 && bm != 64))
      return (int)cudaErrorInvalidValue;
    return bm == 128 ? launch_wgmma<128>(tile_expert, X, W, Y, T, D, F, E, bt, s)
                     : launch_wgmma<64>(tile_expert, X, W, Y, T, D, F, E, bt, s);
  }
  if (path != P_SIMT) return (int)cudaErrorInvalidValue;
  if (xcode == G_F32 && wcode == G_F32) {
    launch_simt<float, float, float>(tile_expert, X, W, Y, T, D, F, E, bt, bm, s);
  } else if (xcode == G_BF16 && wcode == G_BF16) {
    launch_simt<bf16_bits, bf16_bits, bf16_bits>(tile_expert, X, W, Y, T, D, F, E, bt, bm, s);
  } else if (xcode == G_F32 && wcode == G_BF16) {
    launch_simt<float, bf16_bits, float>(tile_expert, X, W, Y, T, D, F, E, bt, bm, s);
  } else if (xcode == G_BF16 && wcode == G_F32) {
    launch_simt<bf16_bits, float, float>(tile_expert, X, W, Y, T, D, F, E, bt, bm, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
