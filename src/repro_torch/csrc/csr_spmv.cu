// CSR (the paper's CRS) SpMV for Hopper.
//
// Replaces: repro/kernels/csr_spmv.py::csr_rowsplit_arrays (the Pallas kernel
// _csr_rowsplit_kernel) with the per-row scale applied outside it in
// repro/kernels/csr.py.  The one-hot (T, E, R) contraction is how the TPU's
// matrix unit does a tiny segment sum; here rows are summed from shared
// memory instead, and row_ptr / col_idx / val are read as they are, with no
// padded slabs.
//
// Bound: memory.  One SpMV streams val (1-8 B) and col_idx (4 B) per nonzero
// plus row_ptr, x and y: on the N = 1,201,200 Holstein surrogate (16.8 M
// nnz) ~158 MB with f32 values and an f64 x, so ~47 us at the H100 SXM's
// 3.35 TB/s.  A sub-warp per row (the first design) kept too few bytes in
// flight at ~14 nonzeros a row -- three dependent round trips a thread for
// one or two nonzeros -- and ran at 27 % of that bound: latency, not
// bandwidth, held it.
//
// Design: row blocks balanced by nonzeros (CSR-stream / CSR-vector, after
// Greathouse and Daga's CSR-Adaptive).  The host partition
// (kernels/csr_spmv.py::csr_row_blocks, cached per container) cuts the rows
// into blocks of whole rows holding at most kCsrBudget nonzeros (and rows),
// a longer row alone.  A CUDA block of 256 threads takes one row block:
// * several rows (CSR-stream): the block's contiguous nonzero span is read
//   coalesced, kPerThread independent col/val loads a thread in flight at
//   once (cache-streaming), then the x gathers; the products land in shared
//   memory in the accumulator type; then each row is summed from shared
//   memory by L lanes (the largest power of two up to 32 with L * rows <=
//   256, at least 1: two lanes for the ~73 rows of a surrogate block) with
//   a shuffle tree;
// * one row (CSR-vector): all 256 threads walk the row, however long, and
//   reduce across the warps (shuffles, then the 8 warp sums in order).
// Both orders are fixed by the partition, so two calls give the same bits
// (no floating-point atomics).  The per-row scale multiplies the finished
// sum, and y is written in original row order.  With the round trips gone,
// the x gathers bound the kernel on the surrogate: ~40 % of its nonzeros
// fall at random within a band of +-24,024 columns, one 32-byte sector of
// L2 traffic each.  A budget of 1024 beat 2048 there, and a persistent,
// software-pipelined variant and a thread-per-row gather were slower.
#include "common.cuh"

constexpr int kCsrBudget = 1024;                 // nonzeros (and rows) of a row block
constexpr int kPerThread = kCsrBudget / kBlock;  // 4 loads in flight a thread

template <typename T, typename A>
__global__ void __launch_bounds__(kBlock)
csr_rowblock_kernel(const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
                    const T* __restrict__ val, const float* __restrict__ scale,
                    const A* __restrict__ x, A* __restrict__ y,
                    const int32_t* __restrict__ blocks, int n_rows) {
  __shared__ A prod[kCsrBudget];
  __shared__ A warp_sum[kBlock / 32];
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = blocks[blockIdx.x], r1 = blocks[blockIdx.x + 1];
  if (r0 < 0 || r1 < r0 || r1 > n_rows) return;  // never so for a checked RowBlocks
  const int i0 = row_ptr[r0], i1 = row_ptr[r1];
  const int nrows = r1 - r0;

  if (nrows == 1) {  // CSR-vector: one row of any length
    A acc = 0;
#pragma unroll 4
    for (int i = i0 + tid; i < i1; i += kBlock)
      acc += widen<A>(ld_stream(val + i)) * __ldg(x + ld_stream(col + i));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) warp_sum[tid / 32] = acc;
    __syncthreads();
    if (tid == 0) {
      A s = 0;
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) s += warp_sum[w];
      y[r0] = scale != nullptr ? s * (A)scale[r0] : s;
    }
    return;
  }

  // CSR-stream: whole rows, at most kCsrBudget nonzeros and rows
  if (i1 - i0 > kCsrBudget || nrows > kCsrBudget) {  // not a csr_row_blocks partition
    for (int r = r0 + tid; r < r1; r += kBlock)
      y[r] = (A)__longlong_as_double(0x7ff8000000000000ll);  // NaN
    return;
  }
  int L = 32;  // lanes a row: uniform over the block, so the shuffles see full warps
  while (L > 1 && L * nrows > kBlock) L >>= 1;
  const int rows_per_pass = kBlock / L, sub = tid % L;
  // the first pass's row bounds, loaded beside the matrix
  int ra = 0, rb = 0;
  if (tid / L < nrows) {
    ra = row_ptr[r0 + tid / L] - i0;
    rb = row_ptr[r0 + tid / L + 1] - i0;
  }
  int c[kPerThread];
  T v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {  // independent loads, all in flight
    const int i = i0 + tid + j * kBlock;
    if (i < i1) {
      c[j] = ld_stream(col + i);
      v[j] = ld_stream(val + i);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = i0 + tid + j * kBlock;
    prod[tid + j * kBlock] = i < i1 ? widen<A>(v[j]) * __ldg(x + c[j]) : (A)0;
  }
  __syncthreads();
  for (int rb0 = 0; rb0 < nrows; rb0 += rows_per_pass) {  // one pass unless nrows > 256 / L
    const int r = rb0 + tid / L;
    if (rb0 > 0 && r < nrows) {
      ra = row_ptr[r0 + r] - i0;
      rb = row_ptr[r0 + r + 1] - i0;
    }
    A acc = 0;
    if (r < nrows)
      for (int k = ra + sub; k < rb; k += L) acc += prod[k];
    for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, L);
    if (sub == 0 && r < nrows) y[r0 + r] = scale != nullptr ? acc * (A)scale[r0 + r] : acc;
  }
}

// blocks: the n_blocks + 1 first rows of kernels/csr_spmv.py::RowBlocks,
// checked on the host to partition [0, n_rows) within kCsrBudget.
extern "C" int csr_spmv(int vcode, int acc64, const void* row_ptr,
                        const void* col, const void* val, const void* scale,
                        const void* x, void* y, int64_t n_rows, const void* blocks,
                        int64_t n_blocks, void* stream) {
  if (n_blocks < 0 || n_blocks > 0x7fffffff || n_rows < 0 ||
      n_rows > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, A)                                                               \
  csr_rowblock_kernel<T, A><<<(unsigned)n_blocks, kBlock, 0, s>>>(                  \
      (const int32_t*)row_ptr, (const int32_t*)col, (const T*)val, (const float*)scale, \
      (const A*)x, (A*)y, (const int32_t*)blocks, (int)n_rows)
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
