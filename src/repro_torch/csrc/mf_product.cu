// Generated electron x phonon SpMV for Hopper: the Holstein-Hubbard
// Hamiltonian, total phonon cap included, from its model's tables.
//
// Replaces: repro/kernels/matrix_free.py::mf_spmv_arrays where its diagonal
// descriptor cannot hold the operator.  A cap on the total phonon count makes
// the ladder's column offsets depend on the state (2001 distinct diagonals at
// the paper's N = 1,201,200, against the 256 a descriptor takes), so that
// operator could only run stored; the JAX package has no kernel for it.
//
// With P phonon states, row e * P + p (electron state e, phonon state p):
//   y[eP + p] = d(e, p) x[eP + p]
//             + sum_i c_i(e) (s+_i(p) x[eP + up_i(p)] + s-_i(p) x[eP + dn_i(p)])
//             + sum_h v_h(e) x[t_h(e) P + p]
// d = U docc(e) + omega0 sum_i n_i(p), c_i(e) = g omega0 n_i(e),
// s+ = sqrt(n_i(p) + 1), s- = sqrt(n_i(p)), v_h = -t times the Jordan-Wigner
// sign; a ladder step outside the basis has no rank and adds nothing.
//
// Bound: memory.  No entry is stored, so an SpMV must move x once and y once:
// 2 * 8 * N bytes, 19.2 MB at N = 1,201,200 (5.74 us at 3.35 TB/s).  x
// (9.6 MB) stays resident in the 50 MB L2.  What limits the kernel is the
// number of load instructions a row (the SM's memory pipe) and the traffic
// from L2: the hops read ~7 other segments of x a row block (69 MB at HMeP,
// coalesced), the phonon records 32 bytes a row.
//
// Design:
// * A block takes one electron state e (blockIdx.y) and kThreads * kRows
//   consecutive phonon ranks (blockIdx.x); a thread sums kRows rows kThreads
//   apart, so every load of x[t P + p] is coalesced across a warp and kRows
//   of them are in flight at once (2 rows beat 1 and 4 at HMeP on an H100
//   SXM at 700 W: 21.9 us a call against 25.1 and 24.2).
// * What depends on e alone is read once a block, not once a row: the
//   couplings times sqrt(n) as a table in shared memory (c_i(e) sqrt(n),
//   the product the plain version forms), the diagonal's electron part, each
//   hop's target and value (once a thread for its kRows rows).
// * A phonon state's ladder is one 32-byte record (six 16-bit up / down
//   rank pairs, six 8-bit occupations), two 16-byte loads a row.
// * A site with no electron (c_i(e) = 0) and the hop list's padding are
//   skipped for the whole block; a ladder step outside the basis adds 0.0.
// * f64 throughout, product then add (nvcc --fmad=false), in the plain
//   version's order: the diagonal, then site by site the phonon raised and
//   lowered, then the hops in table order; the two give equal values (a
//   skipped term can leave a -0.0 where the plain version's +0.0 made +0.0).
// * No atomics, no allocation, no host read: a CUDA graph can capture it.
#include "common.cuh"

constexpr int kSites = 6;           // MAX_SITES of kernels/mf_product.py
constexpr int kSqrt = 32;           // SQRT_TABLE: sqrt(n) for n < 32
constexpr int kThreads = 256;
constexpr int kRows = 2;            // rows a thread
constexpr uint32_t kNone = 0xFFFF;  // no rank: the step leaves the basis

//! A phonon state's ladder (RECORD_WORDS of kernels/mf_product.py): words 0-5
//! hold site i's up rank in the low and down rank in the high 16 bits, words
//! 6-7 the six occupations, one byte each.
struct __align__(16) PhRecord {
  uint4 a, b;
};
static_assert(sizeof(PhRecord) == 32, "PhRecord must match RECORD_WORDS of mf_product.py");

__global__ void __launch_bounds__(kThreads)
mf_spmv_kernel_product(const double* __restrict__ el_diag, const double* __restrict__ el_coup,
                       const int32_t* __restrict__ hop_tgt, const double* __restrict__ hop_val,
                       const PhRecord* __restrict__ ph, const double* __restrict__ sqrt_n,
                       double omega0, int n_ph, int L, int H, const double* __restrict__ x,
                       double* __restrict__ y) {
  __shared__ double s_cs[kSites][kSqrt];  // c_i(e) * sqrt(n)
  const int e = blockIdx.y;
  for (int k = threadIdx.x; k < kSites * kSqrt; k += kThreads) {
    const int i = k / kSqrt;
    s_cs[i][k % kSqrt] = i < L ? __ldg(el_coup + e * L + i) * __ldg(sqrt_n + k % kSqrt) : 0.0;
  }
  __syncthreads();
  const double* xe = x + (size_t)e * n_ph;
  const double de = __ldg(el_diag + e);
  const int p0 = blockIdx.x * (kThreads * kRows) + threadIdx.x;
  uint32_t w[kRows][8];
  double acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int p = p0 + r * kThreads;
    if (p < n_ph) {
      const PhRecord* q = ph + p;
      const uint4 a = __ldg(&q->a), b = __ldg(&q->b);
      w[r][0] = a.x; w[r][1] = a.y; w[r][2] = a.z; w[r][3] = a.w;
      w[r][4] = b.x; w[r][5] = b.y; w[r][6] = b.z; w[r][7] = b.w;
      int nsum = 0;
#pragma unroll
      for (int i = 0; i < kSites; ++i) nsum += (w[r][6 + i / 4] >> (8 * (i % 4))) & 0xFF;
      const double d = de + omega0 * (double)nsum;
      acc[r] = d != 0.0 ? d * __ldg(xe + p) : 0.0;
    }
  }
#pragma unroll
  for (int i = 0; i < kSites; ++i) {
    if (i >= L || s_cs[i][1] == 0.0) continue;  // the same for the whole block
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (p0 + r * kThreads < n_ph) {
        const uint32_t up = w[r][i] & 0xFFFF, dn = w[r][i] >> 16;
        const uint32_t o = (w[r][6 + i / 4] >> (8 * (i % 4))) & 0xFF;
        const double tu = up != kNone ? s_cs[i][o + 1] * __ldg(xe + up) : 0.0;
        acc[r] += tu;
        const double td = dn != kNone ? s_cs[i][o] * __ldg(xe + dn) : 0.0;
        acc[r] += td;
      }
    }
  }
  for (int h = 0; h < H; ++h) {
    const int t = __ldg(hop_tgt + e * H + h);
    if (t < 0) break;  // padding comes last
    const double v = __ldg(hop_val + e * H + h);
    const double* xt = x + (size_t)t * n_ph;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (p0 + r * kThreads < n_ph) acc[r] += v * __ldg(xt + p0 + r * kThreads);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (p0 + r * kThreads < n_ph) y[(size_t)e * n_ph + p0 + r * kThreads] = acc[r];
}

extern "C" int mf_product(const void* el_diag, const void* el_coup, const void* hop_tgt,
                          const void* hop_val, const void* ph_record, const void* sqrt_n,
                          double omega0, int n_el, int n_ph, int n_sites, int n_hops,
                          const void* x, void* y, void* stream) {
  if (n_el < 0 || n_ph < 0 || n_hops < 0) return (int)cudaErrorInvalidValue;
  if ((int64_t)n_el * n_ph == 0) return 0;
  if (n_sites < 1 || n_sites > kSites || n_ph >= (int)kNone || n_el > 65535)
    return (int)cudaErrorInvalidValue;
  const int per_block = kThreads * kRows;
  const dim3 grid((unsigned)((n_ph + per_block - 1) / per_block), (unsigned)n_el);
  mf_spmv_kernel_product<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)el_diag, (const double*)el_coup, (const int32_t*)hop_tgt,
      (const double*)hop_val, (const PhRecord*)ph_record, (const double*)sqrt_n, omega0, n_ph,
      n_sites, n_hops, (const double*)x, (double*)y);
  return (int)cudaGetLastError();
}
