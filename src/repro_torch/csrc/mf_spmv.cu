// Matrix-free generated-operator SpMV for Hopper.
//
// Replaces: repro/kernels/matrix_free.py::mf_spmv_arrays (the Pallas kernel
// _mf_kernel).
//
// y[row] = sum over the diagonals k, in ascending offset order, of
// v_k(row) * x[row + off_k], where v_k is a stored lane (a dense DIA row) or
// a generated constant kept only on rows with lo <= row % p < hi (p != 0).
//
// Bound: memory.  Column indices are never stored (col = row + offset) and a
// generated diagonal streams no values, so one SpMV moves the stored lanes,
// x and y.  On laplacian_2d(1100, 1100) (five generated diagonals) that is
// x and y alone, 19.4 MB in f64.  On the exact L = 6 Holstein-Hubbard
// operator (13 stored lanes, 8 generated diagonals, 1,679,616 rows) the
// lanes streamed as f64 would be 174.7 MB of 201.6 MB; they hold 41 distinct
// nonzero values, so they are read as 1-byte codes: 21.8 MB of lanes, 48.7 MB
// a call (0.0335 ms against the streamed lanes' 0.0770 on an H100).
//
// Design:
// * Stored lanes come in one of two forms, chosen from the operator's values
//   when they reach the card (kernels/matrix_free.py::mf_lanes).  Coded: where the
//   lanes hold at most 255 distinct nonzero bit patterns, a byte a row a
//   lane indexes a table of at most kMaxValues values (entry 0 is +0.0),
//   staged into shared memory beside the descriptor, widened to the
//   accumulator.  Streamed: any other lanes, read as they are stored.  Both
//   multiply by the same widened value, so the two forms give equal bits.
// * The descriptor is an array of MfDiag, packed and checked on the host
//   once per operator (MfLaunch), staged into shared memory once per CTA:
//   the row loop reads it from there, never from device memory.
// * Rows and columns are 32-bit (the host refuses 2^31 or more).  A masked
//   diagonal's phase row % p costs one 32-bit multiply-high: the host
//   computes magic and shift with row / p == umulhi(2 * row, magic) >> shift
//   for every row below 2^31.
// * Each thread sums R rows, kBlock apart, so every x load is coalesced
//   across a warp: R = kRows (2) on streamed lanes, where 2 rows beat 1, 4
//   and 8; R = kCodeRows (4) on coded lanes.  The host lays the codes out by
//   CTA tiles of kBlock * R rows, a thread's R codes of a lane side by side,
//   so they arrive as one R-byte word and a warp reads 32 such words back to
//   back (python -m repro_torch.testing.mf_ablation times both choices).
//   Lanes and codes stream in with evict-first loads (__ldcs) and y goes out
//   with evict-first stores (__stcs), so x stays in L2 while they pass.
// * x is read unpadded: a column outside [0, ncols) reads a zero in
//   registers, which is what the reference's zero padding gives.
// * Each row is summed into one accumulator in ascending offset order,
//   product then add (nvcc --fmad=false), as the plain version does, the
//   product taken where a value is 0 too (a non-finite x propagates): the
//   two agree to rounding of the same sums, and two calls give equal bits.
#include "common.cuh"

//! One diagonal as MfLaunch packs it (40 bytes; field order and widths are
//! MF_DIAG in kernels/matrix_free.py).
struct MfDiag {
  int32_t off;      // col = row + off
  int32_t lane;     // stored lane index, or -1 for a generated diagonal
  uint32_t p;       // period of the rule; 0: no mask
  uint32_t lo, hi;  // keep the rows with lo <= row % p < hi
  uint32_t magic;   // row / p == __umulhi(row << 1, magic) >> shift
  uint32_t shift;
  uint32_t unused;
  double gen;       // the generated constant, rounded through the storage type
};
static_assert(sizeof(MfDiag) == 40, "MfDiag must match MF_DIAG of matrix_free.py");

constexpr int kRows = 2;          // rows a thread on streamed lanes, kBlock apart
constexpr int kCodeRows = 4;      // rows a thread on coded lanes (CODE_ROWS of matrix_free.py)
constexpr int kMaxDiags = 256;    // MAX_DIAGS of matrix_free.py
constexpr int kMaxValues = 256;   // a byte's codes (MAX_CODES + 1 of matrix_free.py)

// One thread's R codes of a lane, as one R-byte evict-first load.
template <int R> struct CodeWord;
template <> struct CodeWord<1> { using T = unsigned char; };
template <> struct CodeWord<2> { using T = unsigned short; };
template <> struct CodeWord<4> { using T = unsigned int; };
template <> struct CodeWord<8> { using T = unsigned long long; };

template <int R>
__device__ __forceinline__ uint64_t ld_codes(const uint8_t* p) {
  return (uint64_t)__ldcs(reinterpret_cast<const typename CodeWord<R>::T*>(p));
}

__device__ __forceinline__ uint32_t mf_phase(uint32_t row, const MfDiag& d) {
  const uint32_t q = __umulhi(row << 1, d.magic) >> d.shift;
  return row - q * d.p;
}

// kCoded: stored lanes as codes (codes, values, nv; ld the bytes of a code
// lane), else as values (data, ld the elements of a lane).
template <typename T, typename A, bool kCoded>
__global__ void __launch_bounds__(kBlock)
mf_spmv_kernel(const T* __restrict__ data, int64_t ld, const uint8_t* __restrict__ codes,
               const T* __restrict__ values, int nv, const MfDiag* __restrict__ desc, int nd,
               const A* __restrict__ x, uint32_t ncols, A* __restrict__ y, uint32_t n) {
  constexpr int R = kCoded ? kCodeRows : kRows;
  extern __shared__ MfDiag sdesc[];
  A* sval = reinterpret_cast<A*>(sdesc + nd);  // kMaxValues entries when coded
  for (int k = threadIdx.x; k < nd; k += kBlock) sdesc[k] = desc[k];
  if constexpr (kCoded) {
    // a code past the table reads NaN
    for (int k = threadIdx.x; k < kMaxValues; k += kBlock)
      sval[k] = k < nv ? widen<A>(values[k]) : (A)nan("");
  }
  __syncthreads();
  const MfDiag* dd = sdesc;
  const uint32_t base = blockIdx.x * (uint32_t)(kBlock * R) + threadIdx.x;
  // this thread's word of codes in each code lane
  const uint32_t word = (blockIdx.x * (uint32_t)kBlock + threadIdx.x) * (uint32_t)R;
  uint32_t row[R];
  bool live[R];
  A acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = base + r * kBlock;
    live[r] = row[r] < n;
    acc[r] = 0;
  }
  for (int k = 0; k < nd; ++k) {
    const MfDiag d = dd[k];
    A xv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // row + off lies in (-2^31, 2^32): as uint32 a column below 0 is >= 2^31
      const int32_t c = (int32_t)(row[r] + (uint32_t)d.off);
      const bool inb = (uint32_t)c < ncols;
      xv[r] = (live[r] && inb) ? __ldg(x + c) : (A)0;
    }
    if (d.lane >= 0) {
      if constexpr (kCoded) {
        const uint64_t w = ld_codes<R>(codes + d.lane * ld + word);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += sval[(w >> (8 * r)) & 0xFFu] * xv[r];
      } else {
        const T* lane = data + d.lane * ld;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const A v = live[r] ? widen<A>(ld_stream(lane + row[r])) : (A)0;
          acc[r] += v * xv[r];
        }
      }
    } else {
      const A g = (A)d.gen;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        A contrib = g * xv[r];
        if (d.p != 0) {
          const uint32_t ph = mf_phase(row[r], d);
          if (ph < d.lo || ph >= d.hi) contrib = 0;
        }
        acc[r] += contrib;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (live[r]) __stcs(y + row[r], acc[r]);
}

// codes == NULL: the lanes stream from data (ld elements apart).  Else they
// are codes (ld bytes apart, ld a whole number of kBlock * kCodeRows tiles
// covering n) into the nv (1 .. kMaxValues) entries of values; data unused.
extern "C" int mf_spmv(int vcode, int acc64, const void* data, int64_t ld, const void* codes,
                       const void* values, int nv, const void* desc, int nd, const void* x,
                       int64_t ncols, void* y, int64_t n, void* stream) {
  if (n == 0) return 0;
  if (nd < 0 || nd > kMaxDiags || n >= (1LL << 31) || ncols >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool coded = codes != nullptr;
  const int64_t tile = (int64_t)kBlock * (coded ? kCodeRows : kRows);
  const int64_t grid = (n + tile - 1) / tile;
  if (coded && (nv < 1 || nv > kMaxValues || ld % tile != 0 || ld < grid * tile))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)nd * sizeof(MfDiag);
#define LAUNCH_AS(T, A, C, SMEM)                                                        \
  mf_spmv_kernel<T, A, C><<<(unsigned)grid, kBlock, SMEM, s>>>(                         \
      (const T*)data, ld, (const uint8_t*)codes, (const T*)values, nv,                  \
      (const MfDiag*)desc, nd, (const A*)x, (uint32_t)ncols, (A*)y, (uint32_t)n)
#define LAUNCH(T, A)                                                                    \
  if (coded) LAUNCH_AS(T, A, true, smem + kMaxValues * sizeof(A));                      \
  else LAUNCH_AS(T, A, false, smem)
  // int8 and fp8 storage have no per-group scale home here: not instantiated
  if (acc64) {
    switch (vcode) {
      case V_F64: LAUNCH(double, double); break;
      case V_F32: LAUNCH(float, double); break;
      case V_BF16: LAUNCH(bf16_bits, double); break;
      case V_F16: LAUNCH(__half, double); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (vcode) {
      case V_F32: LAUNCH(float, float); break;
      case V_BF16: LAUNCH(bf16_bits, float); break;
      case V_F16: LAUNCH(__half, float); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef LAUNCH
#undef LAUNCH_AS
  return (int)cudaGetLastError();
}
