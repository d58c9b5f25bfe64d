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
// x and y alone, 19.4 MB in f64; on the exact L = 6 Holstein-Hubbard
// operator (13 stored lanes, 8 generated diagonals, 1,679,616 rows) 201.6 MB.
//
// Design:
// * The descriptor is an array of MfDiag, packed and checked on the host
//   once per operator (kernels/matrix_free.py::MfLaunch), staged into shared
//   memory once per CTA: the row loop reads it from there, never from
//   device memory.
// * Rows and columns are 32-bit (the host refuses 2^31 or more).  A masked
//   diagonal's phase row % p costs one 32-bit multiply-high: the host
//   computes magic and shift with row / p == umulhi(2 * row, magic) >> shift
//   for every row below 2^31.
// * Each thread sums kRows rows, kBlock apart, so every load is coalesced
//   across a warp and 2 * kRows independent loads are in flight a diagonal
//   (2 rows beat 1, 4 and 8 on the exact operator: python -m
//   repro_torch.testing.mf_ablation).
//   Stored lanes stream in with evict-first loads (__ldcs) and y goes out
//   with evict-first stores (__stcs), so x stays in L2 while the lanes pass.
// * x is read unpadded: a column outside [0, ncols) reads a zero in
//   registers, which is what the reference's zero padding gives.
// * Each row is summed into one accumulator in ascending offset order,
//   product then add (nvcc --fmad=false), as the plain version does: the
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

constexpr int kRows = 2;        // rows a thread, kBlock apart
constexpr int kMaxDiags = 256;  // MAX_DIAGS of matrix_free.py

__device__ __forceinline__ uint32_t mf_phase(uint32_t row, const MfDiag& d) {
  const uint32_t q = __umulhi(row << 1, d.magic) >> d.shift;
  return row - q * d.p;
}

template <typename T, typename A>
__global__ void __launch_bounds__(kBlock)
mf_spmv_kernel(const T* __restrict__ data, int64_t ld, const MfDiag* __restrict__ desc,
               int nd, const A* __restrict__ x, uint32_t ncols, A* __restrict__ y,
               uint32_t n) {
  extern __shared__ MfDiag sdesc[];
  for (int k = threadIdx.x; k < nd; k += kBlock) sdesc[k] = desc[k];
  __syncthreads();
  const MfDiag* dd = sdesc;
  const uint32_t base = blockIdx.x * (uint32_t)(kBlock * kRows) + threadIdx.x;
  uint32_t row[kRows];
  bool live[kRows];
  A acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row[r] = base + r * kBlock;
    live[r] = row[r] < n;
    acc[r] = 0;
  }
  for (int k = 0; k < nd; ++k) {
    const MfDiag d = dd[k];
    A xv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // row + off lies in (-2^31, 2^32): as uint32 a column below 0 is >= 2^31
      const int32_t c = (int32_t)(row[r] + (uint32_t)d.off);
      const bool inb = (uint32_t)c < ncols;
      xv[r] = (live[r] && inb) ? __ldg(x + c) : (A)0;
    }
    if (d.lane >= 0) {
      const T* lane = data + d.lane * ld;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const A v = live[r] ? widen<A>(ld_stream(lane + row[r])) : (A)0;
        acc[r] += v * xv[r];
      }
    } else {
      const A g = (A)d.gen;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
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
  for (int r = 0; r < kRows; ++r)
    if (live[r]) __stcs(y + row[r], acc[r]);
}

extern "C" int mf_spmv(int vcode, int acc64, const void* data, int64_t ld, const void* desc,
                       int nd, const void* x, int64_t ncols, void* y, int64_t n,
                       void* stream) {
  if (n == 0) return 0;
  if (nd < 0 || nd > kMaxDiags || n >= (1LL << 31) || ncols >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((n + kBlock * kRows - 1) / (kBlock * kRows));
  const size_t smem = (size_t)nd * sizeof(MfDiag);
#define LAUNCH(T, A)                                                                    \
  mf_spmv_kernel<T, A><<<grid, kBlock, smem, s>>>((const T*)data, ld, (const MfDiag*)desc, \
                                                  nd, (const A*)x, (uint32_t)ncols, (A*)y, \
                                                  (uint32_t)n)
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
  return (int)cudaGetLastError();
}
