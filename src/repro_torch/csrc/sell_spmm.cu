// Multi-vector SELL-C-sigma (SpMM) for Hopper: Y = A X for K right-hand
// sides in one pass over the matrix.
//
// Replaces: repro/kernels/sell_spmv.py::sell_spmm_arrays (the Pallas kernel
// _sell_mm_kernel), together with the per-chunk scale of repro/kernels/sell.py
// and the inverse-permutation gather sell_spmm_scatter around it.
//
// Bound: memory.  The matrix (val 1-8 B + col 4 B per stored slot, padding
// included) is streamed once for all K columns; X (N, K) is read and Y
// (N, K) written once, in the accumulator type.  On the N = 1,201,200
// Holstein surrogate (16.8 M nnz, f32 values, f64 X) the matrix is ~8 B per
// slot and X + Y are 2 * 9.6 MB per column, so the bound moves from the
// matrix stream (K = 1) towards the vector stream (K >= ~8), and at every
// K the 2 nnz K operations at 34 TFLOP/s (f64, outside the tensor cores)
// stay below the byte time.
//
// Design: the flat chunk layout that sell_spmv.cu consumes -- each chunk
// walks its own width from chunk_ptr, no global padding as in the Pallas
// kernel.  A group of kt lanes (kt = 32 for K >= 32, else the next power of
// two >= K) works on one chunk row; a warp holds 32 / kt neighbouring rows
// of a chunk.  The lanes of a group run along K: X is row-major, so the
// gather of row col is one contiguous K-vector, and the group's lanes read
// neighbouring addresses.  val[p] and col[p] are the same for every lane of
// a group (one broadcast load).  K > 32 loops over tiles of 32 columns and
// walks the row again (its val / col are then L1 hits).  Nothing is staged
// in shared memory: X does not fit it, and one accumulator per thread is
// the only register state, so any K is taken.  The per-chunk scale and the
// inverse permutation are fused into the store, Y[perm[slot], k] =
// scale * acc, as in sell_spmv.cu.  The accumulator follows acc_dtype(val,
// X): f64 X accumulates in f64.
#include "common.cuh"

template <typename T, typename A>
__global__ void sell_spmm_kernel(const int64_t* __restrict__ chunk_ptr,
                                 const int32_t* __restrict__ chunk_width,
                                 const int32_t* __restrict__ col,
                                 const T* __restrict__ val,
                                 const float* __restrict__ scale,
                                 const int32_t* __restrict__ perm,
                                 const A* __restrict__ X, A* __restrict__ Y,
                                 int64_t n_chunks, int C, int64_t n_rows,
                                 int K, int kt) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t slot = t / kt;
  const int kl = (int)(t - slot * kt);
  const int64_t c = slot / C;
  if (c >= n_chunks) return;
  const int32_t row = perm[slot];
  if (row >= n_rows) return;  // a pad row of the last chunk: nothing to store
  const int lane = (int)(slot - c * C);
  const int w = chunk_width[c];
  const int64_t p0 = chunk_ptr[c] + lane;
  for (int k = kl; k < K; k += kt) {
    A acc = 0;
    int64_t p = p0;
    for (int j = 0; j < w; ++j, p += C) {
      acc += widen<A>(val[p]) * __ldg(X + (int64_t)col[p] * K + k);
    }
    if (scale != nullptr) acc *= (A)scale[c];
    Y[(int64_t)row * K + k] = acc;
  }
}

extern "C" int sell_spmm(int vcode, int acc64, const void* chunk_ptr,
                         const void* chunk_width, const void* col,
                         const void* val, const void* scale, const void* perm,
                         const void* X, void* Y, int64_t n_chunks, int C,
                         int64_t n_rows, int K, int kt, void* stream) {
  if (kt <= 0 || kt > 32 || (kt & (kt - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int64_t threads = n_chunks * (int64_t)C * kt;
  if (threads == 0 || K == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, A)                                                        \
  sell_spmm_kernel<T, A><<<grid_for(threads), kBlock, 0, s>>>(              \
      (const int64_t*)chunk_ptr, (const int32_t*)chunk_width,               \
      (const int32_t*)col, (const T*)val, (const float*)scale,              \
      (const int32_t*)perm, (const A*)X, (A*)Y, n_chunks, C, n_rows, K, kt)
  SPMV_DISPATCH(vcode, acc64, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
