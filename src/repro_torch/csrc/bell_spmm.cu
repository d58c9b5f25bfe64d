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
// Bound: memory at decode widths, the f32 pipes at wide N.  Each stored
// block is read once (bm * bk values) with its column id, X and Y once; the
// padding slots of the BELL slab are skipped (row_nblocks), so the bytes are
// those of the BSR container.  At Gemma-7B FFN width (24576 x 3072, 18,432
// f32 (8, 128) blocks, 75.5 MB) the 2 * 18.9 M * N operations reach the f32
// non-tensor peak (67 TFLOP/s) above N ~ 45 columns; below it the block
// stream bounds the kernel.  The first design staged each slot through
// registers between two __syncthreads, element by element for X, in at most
// 48 KB: at N = 64 one slot a stage, five shared-memory loads for four FMAs,
// 3.6 TFLOP/s on an H100 80GB HBM3 at 700 W (PERF.md).
//
// Design: warp-specialised CTAs that walk the work items in turn
// (kernels/bsr_spmm.py::bell_launch picks the geometry; the grid is twice
// the CTAs that fit the SMs, so a second wave evens out the tail of block
// rows of unequal length).
// * A work item is (block row, tile of ntile columns).  One producer warp
//   fills a ring of S stages in dynamic shared memory, a stage a stored
//   slot: the block (bm * bk contiguous values, kept in their storage type)
//   and its X panel (bk * ntile contiguous values: the wrapper passes X as
//   (n_tiles, K, ntile) panels when a tile does not span N), each by one
//   1-D bulk copy (TMA) completed on the stage's "full" mbarrier (one copy
//   a row of the panel was slower, PERF.md).  Pieces that are
//   not 16-byte multiples or aligned are copied by the producer's lanes.
//   The producer loads an item's column ids one a lane and the next item's
//   length ahead, and runs ahead across block rows, so one row's products
//   and store overlap the next row's loads.
// * 8 consumer warps compute from shared memory into registers, releasing
//   a stage on its "empty" mbarrier.  Three mappings:
//   - decode (N < 8): a thread owns one output, G lanes of a warp split bk;
//   - wide, 2 rows x 16 bytes of columns a thread (4 f32 / 2 f64), G lanes
//     of a warp split bk (N = 8 in f32);
//   - wide, 8 rows x 16 bytes a thread (4 or more column groups): a
//     quarter-warp's lanes take neighbouring 16-byte pieces of one X row
//     (no bank conflicts at a 256-byte pitch, where lanes along bk would read
//     one bank group 8 times), bk is split over 32 / CL lanes and GW warps;
//     at N = 64, (8, 128): one 16-byte X load and 8 block values for 32 FMAs.
//   A k step loads all its values before its FMAs and tests no row: the
//   block's rows are padded to a multiple of RM in the stage (a padded row
//   sums garbage that is never stored).  Narrow values are widened as they
//   are read.  After a row's last slot the partial sums meet in a shuffle
//   tree, then (GW > 1) across warps in order through shared memory.
// Sums run in a fixed order (slot, k within a lane, the shuffle tree, the
// warps), so two calls give the same bits.  Products are fused
// multiply-adds.  The accumulator follows acc_dtype(blocks, X): f64 when
// either is f64.
#include <algorithm>
#include <cstring>

#include "common.cuh"
#include "ring.cuh"

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 16 * kMaxStages;  // a full and an empty mbarrier a stage
constexpr int kSmemMax = 232448;            // a CTA's dynamic shared memory on sm_90
constexpr int kWideRows = 8;                // rows a thread on the wide path

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return __fma_rn(a, b, c); }

struct BellGeom {
  int nbpp, bm, bk, ntile, n_tiles, G, S, stage, blk_pad, red_bytes;
  int CL, UH, GW;  // wide path: lanes along the units, warps along them, warps along bk
  int N, K;
  int64_t n_rows, n_items;
  bool bulk_b, bulk_x;
};

__device__ __forceinline__ int row_len(const int32_t* __restrict__ row_nblocks, int64_t i,
                                       int nbpp) {
  const int len = row_nblocks != nullptr ? row_nblocks[i] : nbpp;
  return max(0, min(len, nbpp));
}

// X is the (n_tiles, K, ntile) panel layout: item tile t of block column b
// reads rows [b * bk, +bk) of tile t, bk * ntile contiguous values (the
// wrapper passes X itself when one tile spans all of N)
template <typename T, typename A, int CW, int RM, bool SCALED>
__global__ void __launch_bounds__(kThreads)
bell_spmm_kernel(const int32_t* __restrict__ bcols, const T* __restrict__ blocks,
                 const float* __restrict__ scale, const int32_t* __restrict__ row_nblocks,
                 const A* __restrict__ X, A* __restrict__ Y, const BellGeom g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t bar0 = smem_u32(smem_raw);
  auto full = [&](int s) { return bar0 + 8u * (uint32_t)s; };
  auto empty = [&](int s) { return bar0 + 8u * (uint32_t)(kMaxStages + s); };
  A* red = reinterpret_cast<A*>(smem_raw + kBarBytes);  // the wide path's cross-warp sums
  unsigned char* ring = smem_raw + kBarBytes + g.red_bytes;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < g.S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int belems = g.bm * g.bk, xelems = g.bk * g.ntile;

  if (warp == kConsumerWarps) {  // ---- producer warp ----
    int u = 0;
    int64_t it = blockIdx.x;
    int len = it < g.n_items ? row_len(row_nblocks, it / g.n_tiles, g.nbpp) : 0;
    for (; it < g.n_items; it += gridDim.x) {
      const int64_t i = it / g.n_tiles;
      const int t = (int)(it - i * g.n_tiles);
      const int64_t nxt = it + gridDim.x;  // the next item's length, loaded early
      const int len_next = nxt < g.n_items ? row_len(row_nblocks, nxt / g.n_tiles, g.nbpp) : 0;
      for (int j0 = 0; j0 < len; j0 += 32) {
        // the column ids of up to 32 slots, one a lane, in one load
        const int jn = min(32, len - j0);
        const int32_t bcol_l = lane < jn ? bcols[i * g.nbpp + j0 + lane] : 0;
        for (int jj = 0; jj < jn; ++jj, ++u) {
          const int32_t bcol = __shfl_sync(0xffffffffu, bcol_l, jj);
          const int s = u % g.S;
          if (lane == 0) mbar_wait(empty(s), ((u / g.S) & 1) ^ 1);  // the first round passes
          __syncwarp();
          const T* bsrc = blocks + (i * g.nbpp + j0 + jj) * belems;
          const A* xsrc = X + ((int64_t)t * g.K + (int64_t)bcol * g.bk) * g.ntile;
          unsigned char* st = ring + (size_t)s * g.stage;
          T* bdst = reinterpret_cast<T*>(st);
          A* xdst = reinterpret_cast<A*>(st + g.blk_pad);
          // pieces a bulk copy cannot take (not 16-byte multiples or aligned)
          if (!g.bulk_b)
            for (int e = lane; e < belems; e += 32) bdst[e] = bsrc[e];
          if (!g.bulk_x)
            for (int e = lane; e < xelems; e += 32) xdst[e] = xsrc[e];
          __syncwarp();
          if (lane == 0) {
            const uint32_t bbytes = g.bulk_b ? (uint32_t)(belems * sizeof(T)) : 0u;
            const uint32_t xbytes = g.bulk_x ? (uint32_t)(xelems * sizeof(A)) : 0u;
            mbar_expect_tx(full(s), bbytes + xbytes);
            if (bbytes) bulk_g2s(smem_u32(bdst), bsrc, bbytes, full(s));
            if (xbytes) bulk_g2s(smem_u32(xdst), xsrc, xbytes, full(s));
          }
        }
      }
      len = len_next;
    }
    return;
  }

  // ---- consumer warps ----
  // lanes along bk (RM < kWideRows): unit = (row group, column group) of
  // the tile, G lanes of one warp split bk.  quarter-warp columns (RM ==
  // kWideRows): lane = gi * CL + cl, warp = gw * UH + uh; unit uh of the
  // (row group, column chunk) grid holds CL column groups, so a quarter-warp
  // reads CL neighbouring 16-byte pieces of an X row (no bank conflicts);
  // the G = (32 / CL) * GW lanes of a column group split bk.
  constexpr bool kQuarter = RM == kWideRows;
  const int n_cg = g.ntile / CW;
  int r0, c, gs;
  int cl = 0, gi = 0, gw = 0, uh = 0;
  if constexpr (!kQuarter) {
    const int unit = tid / g.G;
    gs = tid - unit * g.G;
    r0 = unit / n_cg * RM;
    c = unit % n_cg;
  } else {
    cl = lane % g.CL, gi = lane / g.CL, gw = warp / g.UH, uh = warp - gw * g.UH;
    const int nch = (n_cg + g.CL - 1) / g.CL;
    const int rg = uh / nch;
    c = (uh - rg * nch) * g.CL + cl;
    r0 = rg * RM;
    gs = gi + (32 / g.CL) * gw;
  }
  const bool active = r0 < g.bm && c < n_cg;
  int u = 0;
  int64_t it = blockIdx.x;
  int len = it < g.n_items ? row_len(row_nblocks, it / g.n_tiles, g.nbpp) : 0;
  for (; it < g.n_items; it += gridDim.x) {
    const int64_t i = it / g.n_tiles;
    const int n0 = (int)(it - i * g.n_tiles) * g.ntile;
    const int64_t nxt = it + gridDim.x;
    const int len_next = nxt < g.n_items ? row_len(row_nblocks, nxt / g.n_tiles, g.nbpp) : 0;
    A acc[RM][CW];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < CW; ++q) acc[r][q] = 0;
    for (int j = 0; j < len; ++j, ++u) {
      const int s = u % g.S;
      mbar_wait(full(s), (u / g.S) & 1);
      if (active) {
        const unsigned char* st = ring + (size_t)s * g.stage;
        const T* bs = reinterpret_cast<const T*>(st) + r0 * g.bk;
        const A* xs = reinterpret_cast<const A*>(st + g.blk_pad) + c * CW;
        A p[RM][CW];  // the slot's own sums when it carries a scale
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < CW; ++q) p[r][q] = 0;
        // the block's rows are padded to a multiple of RM in the stage, so
        // no row needs a test; a row past bm sums garbage nobody stores
#pragma unroll 2
        for (int k = gs; k < g.bk; k += g.G) {
          A xv[CW], a[RM];
          if constexpr (CW * sizeof(A) == 16) {
            const uint4 raw = *reinterpret_cast<const uint4*>(xs + k * g.ntile);
            memcpy(xv, &raw, 16);
          } else {
            xv[0] = xs[k * g.ntile];
          }
#pragma unroll
          for (int r = 0; r < RM; ++r) a[r] = widen<A>(bs[r * g.bk + k]);
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int q = 0; q < CW; ++q) {
              if constexpr (SCALED) p[r][q] = fma_acc(a[r], xv[q], p[r][q]);
              else acc[r][q] = fma_acc(a[r], xv[q], acc[r][q]);
            }
        }
        if constexpr (SCALED) {
          const A sc = (A)scale[i * g.nbpp + j];
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int q = 0; q < CW; ++q) acc[r][q] = fma_acc(sc, p[r][q], acc[r][q]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
    // the partial sums of an output meet: lanes of one warp in a shuffle
    // tree, then (wide, GW > 1) the warps in order through shared memory
    bool owner;
    if constexpr (!kQuarter) {
      for (int off = g.G / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < CW; ++q) acc[r][q] += __shfl_xor_sync(0xffffffffu, acc[r][q], off);
      }
      owner = gs == 0;
    } else {
      for (int off = 16; off >= g.CL; off >>= 1) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < CW; ++q) acc[r][q] += __shfl_xor_sync(0xffffffffu, acc[r][q], off);
      }
      if (g.GW > 1) {
        A* mine = red + ((warp * g.CL + cl) * RM) * CW;
        if (gi == 0)
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int q = 0; q < CW; ++q) mine[r * CW + q] = acc[r][q];
        asm volatile("bar.sync 1, %0;\n" ::"r"(kConsumers) : "memory");
        if (gw == 0 && gi == 0)
          for (int w2 = 1; w2 < g.GW; ++w2) {
            const A* other = red + (((w2 * g.UH + uh) * g.CL + cl) * RM) * CW;
#pragma unroll
            for (int r = 0; r < RM; ++r)
#pragma unroll
              for (int q = 0; q < CW; ++q) acc[r][q] += other[r * CW + q];
          }
        asm volatile("bar.sync 1, %0;\n" ::"r"(kConsumers) : "memory");  // red is free again
      }
      owner = gw == 0 && gi == 0;
    }
    if (active && owner) {
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int64_t row = i * g.bm + r0 + r;
        if (r0 + r >= g.bm || row >= g.n_rows) continue;
#pragma unroll
        for (int q = 0; q < CW; ++q) {
          const int n = n0 + c * CW + q;
          if (n < g.N) Y[row * g.N + n] = acc[r][q];
        }
      }
    }
    len = len_next;
  }
}

template <typename T, typename A, int CW, int RM, bool SCALED>
static int launch(const void* bcols, const void* blocks, const void* scale,
                  const void* row_nblocks, const void* X, void* Y, const BellGeom& g,
                  size_t smem, cudaStream_t s) {
  auto kern = bell_spmm_kernel<T, A, CW, RM, SCALED>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // two CTAs for every one that fits: the second wave evens out the tail of
  // block rows of unequal length
  const int64_t grid = std::min<int64_t>(g.n_items, 2 * (int64_t)per_sm * sms);
  kern<<<(unsigned)grid, kThreads, smem, s>>>((const int32_t*)bcols, (const T*)blocks,
                                              (const float*)scale, (const int32_t*)row_nblocks,
                                              (const A*)X, (A*)Y, g);
  return (int)cudaGetLastError();
}

// X: the (n_tiles, K, ntile) panel layout (X itself when ntile == N), K its
// rows.  cw, rm: columns and rows a thread -- (1, 1) decode, (16 bytes of
// the accumulator, 2) with the lanes along bk, (16 bytes, 8) with the lanes
// along the columns; G: lanes that split bk (a power of two <= 32 in one
// warp, or (32 / cl) * gw); cl, uh, gw: the last path's lanes along the
// column groups, warps along the units and warps along bk (uh * gw == 8);
// S: ring stages.  kernels/bsr_spmm.py::bell_launch picks them; they are
// checked here.
extern "C" int bell_spmm(int vcode, int acc64, const void* bcols, const void* blocks,
                         const void* scale, const void* row_nblocks, const void* X, void* Y,
                         int64_t nbr, int nbpp, int bm, int bk, int64_t n_rows, int K, int N,
                         int cw, int rm, int ntile, int G, int cl, int uh, int gw, int S,
                         void* stream) {
  const int acc = acc64 ? 8 : 4;
  const bool wide = cw == 16 / acc, quarter = wide && rm == kWideRows;
  if (bm <= 0 || bk <= 0 || K <= 0 || K % bk != 0 || N <= 0 || nbpp <= 0 || ntile <= 0 ||
      S <= 0 || S > kMaxStages || ntile % cw != 0 ||
      !((cw == 1 && rm == 1) || (wide && (rm == 2 || rm == kWideRows))))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (N + ntile - 1) / ntile, n_cg = ntile / cw;
  if (quarter) {
    const int nch = (n_cg + cl - 1) / cl;
    if (cl <= 0 || cl > 8 || (cl & (cl - 1)) != 0 || uh <= 0 || gw <= 0 ||
        uh * gw != kConsumerWarps || (bm + rm - 1) / rm * nch > uh || G != (32 / cl) * gw)
      return (int)cudaErrorInvalidValue;
  } else if (G <= 0 || G > 32 || (G & (G - 1)) != 0 ||
             (int64_t)((bm + rm - 1) / rm) * n_cg * G > kConsumers) {
    return (int)cudaErrorInvalidValue;
  }
  int vbytes = 0;
  switch (vcode) {
    case V_F64: vbytes = 8; break;
    case V_F32: vbytes = 4; break;
    case V_BF16: case V_F16: vbytes = 2; break;
    default: vbytes = 1;
  }
  BellGeom g;
  g.nbpp = nbpp, g.bm = bm, g.bk = bk, g.ntile = ntile, g.n_tiles = n_tiles, g.G = G;
  g.S = S, g.CL = cl, g.UH = uh, g.GW = gw, g.N = N, g.K = K, g.n_rows = n_rows;
  g.n_items = nbr * n_tiles;
  const int64_t bbytes = (int64_t)bm * bk * vbytes, xbytes = (int64_t)bk * ntile * acc;
  // the block's rows padded to a multiple of rm: a thread's rows need no test
  g.blk_pad = (int)(((int64_t)(bm + rm - 1) / rm * rm * bk * vbytes + 15) / 16 * 16);
  const int64_t stage = g.blk_pad + (xbytes + 15) / 16 * 16;
  g.red_bytes = quarter ? kConsumerWarps * cl * kWideRows * cw * acc : 0;
  const size_t smem = kBarBytes + g.red_bytes + (size_t)S * stage;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  g.stage = (int)stage;
  g.bulk_b = bbytes % 16 == 0 && ((uintptr_t)blocks & 15) == 0;
  g.bulk_x = xbytes % 16 == 0 && ((uintptr_t)X & 15) == 0;
  if (g.n_items == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
#define LAUNCH_V(T, A, CW, RM)                                                            \
  rc = scale != nullptr                                                                   \
           ? launch<T, A, CW, RM, true>(bcols, blocks, scale, row_nblocks, X, Y, g, smem, s) \
           : launch<T, A, CW, RM, false>(bcols, blocks, scale, row_nblocks, X, Y, g, smem, s)
#define LAUNCH(T, A)                                      \
  if (quarter) {                                          \
    LAUNCH_V(T, A, (16 / (int)sizeof(A)), kWideRows);     \
  } else if (wide) {                                      \
    LAUNCH_V(T, A, (16 / (int)sizeof(A)), 2);             \
  } else {                                                \
    LAUNCH_V(T, A, 1, 1);                                 \
  }
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
#undef LAUNCH_V
  return rc;
}
