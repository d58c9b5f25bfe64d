// The paper's microbenchmark pair for Hopper: the STREAM triad and the
// indirect scalar-product body (ISSCP / IRSCP), two entry points.
//
// Replaces: repro/kernels/gather_bench.py::stream_triad (the Pallas kernel
// _triad_kernel) and repro/kernels/gather_bench.py::gather_scp (the Pallas
// kernel _gather_kernel).
//
// Bound: memory, both.  stream_triad moves 4 n values (a, b, c read, o
// written; a GPU store allocates no line, so there is no fourth read) and
// does 2 n operations: at n = 2^26 f32 that is 1.07 GB, ~320 us at the
// H100 SXM's 3.35 TB/s, far beyond the 50 MB L2.  Its measured rate is the
// card's calibration bandwidth for the balance model.  gather_scp streams a
// and idx and writes o (n (2 vb + 4) bytes, as the reference's
// traffic_model counts), and gathers x[idx]: every touched element of x
// costs a 32-byte sector read once it is out of L2, so at a stride of 8
// f32 values or more the gather moves 8x the bytes it uses -- the paper's
// access-granule penalty.
//
// Design: the triad (after a first design that walked a grid-stride loop
// over SMs x 8 blocks, one vector of each array in flight a thread, and
// trailed torch.addcmul by 3 %) makes one pass over contiguous tiles, the
// grid sized to the work.  A block of 256 threads owns a tile of
// kTriadUnroll x 256 vectors -- 16-byte float4 / double2 when all four
// pointers are 16-byte aligned, else single values -- and each thread loads
// its kTriadUnroll vectors of a, b and c (neighbouring threads on
// neighbouring vectors, a warp 512 contiguous bytes a load) before its
// first store, so 3 x kTriadUnroll independent 16-byte loads a thread are
// in flight.  Loads and stores are evict-first (__ldcs / __stcs): each byte
// is touched once.  8 vectors a thread ran level with torch.addcmul; 1, 2,
// 4 and 16 within 0.5 % of it.  The last tile is masked, and the n mod 4
// (f32) or n mod 2 (f64) values past the last whole vector are done one by
// one.
// gather_scp: a grid-stride loop with a tail, so any n works (the Pallas
// kernels needed n % tile == 0); it streams a and idx with neighbouring
// threads on neighbouring elements and reads x through the read-only path
// (__ldg): at the paper's sizes x is far larger than shared memory, and
// usually than L2, so no staging would hold it.  The reduction of o stays
// outside, as in the reference, so the streamed traffic stays comparable to
// the triad's.
// Built with --fmad=false: b + a*c rounds the product and then the sum, as
// the plain PyTorch version does.
#include "common.cuh"

constexpr int kTriadUnroll = 8;  // vectors of each array a thread, all loaded before a store

__device__ __forceinline__ float triad_v(float a, float b, float c) { return b + a * c; }
__device__ __forceinline__ double triad_v(double a, double b, double c) { return b + a * c; }
__device__ __forceinline__ float4 triad_v(float4 a, float4 b, float4 c) {
  return make_float4(b.x + a.x * c.x, b.y + a.y * c.y, b.z + a.z * c.z,
                     b.w + a.w * c.w);
}
__device__ __forceinline__ double2 triad_v(double2 a, double2 b, double2 c) {
  return make_double2(b.x + a.x * c.x, b.y + a.y * c.y);
}

// V: T itself, or the 16-byte vector of T; nv vectors, then (for a vector
// V) the scalar tail [nv * W, n) by the first block
template <typename T, typename V>
__global__ void __launch_bounds__(kBlock)
stream_triad_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ c, T* __restrict__ o, int64_t n) {
  constexpr int W = sizeof(V) / sizeof(T);
  const int64_t nv = n / W;
  const V* av = reinterpret_cast<const V*>(a);
  const V* bv = reinterpret_cast<const V*>(b);
  const V* cv = reinterpret_cast<const V*>(c);
  V* ov = reinterpret_cast<V*>(o);
  const int64_t i0 = (int64_t)blockIdx.x * (kTriadUnroll * kBlock) + threadIdx.x;
  V ra[kTriadUnroll], rb[kTriadUnroll], rc[kTriadUnroll];
#pragma unroll
  for (int u = 0; u < kTriadUnroll; ++u) {
    const int64_t i = i0 + u * kBlock;
    if (i < nv) {
      ra[u] = __ldcs(av + i);
      rb[u] = __ldcs(bv + i);
      rc[u] = __ldcs(cv + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kTriadUnroll; ++u) {
    const int64_t i = i0 + u * kBlock;
    if (i < nv) __stcs(ov + i, triad_v(ra[u], rb[u], rc[u]));
  }
  if (W > 1 && blockIdx.x == 0) {
    const int64_t t = nv * W + threadIdx.x;
    if (t < n) o[t] = b[t] + a[t] * c[t];
  }
}

template <typename T>
__global__ void gather_scp_kernel(const T* __restrict__ a,
                                  const int32_t* __restrict__ idx,
                                  const T* __restrict__ x, T* __restrict__ o,
                                  int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    o[i] = a[i] * __ldg(x + idx[i]);
  }
}

extern "C" int stream_triad(int f64, const void* a, const void* b,
                            const void* c, void* o, int64_t n, int vec,
                            void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t width = vec ? 16 / (f64 ? 8 : 4) : 1;
  const int64_t tiles = (n / width + kTriadUnroll * kBlock - 1) / (kTriadUnroll * kBlock);
  const unsigned grid = (unsigned)(tiles > 0 ? tiles : 1);  // n < width: the tail alone
#define LAUNCH(T, V)                                                            \
  stream_triad_kernel<T, V><<<grid, kBlock, 0, s>>>((const T*)a, (const T*)b,   \
                                                    (const T*)c, (T*)o, n)
  if (f64) {
    if (vec) LAUNCH(double, double2); else LAUNCH(double, double);
  } else {
    if (vec) LAUNCH(float, float4); else LAUNCH(float, float);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int gather_scp(int f64, const void* a, const void* idx,
                          const void* x, void* o, int64_t n, int blocks,
                          void* stream) {
  if (n == 0) return 0;
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64) {
    gather_scp_kernel<double><<<blocks, kBlock, 0, s>>>(
        (const double*)a, (const int32_t*)idx, (const double*)x, (double*)o, n);
  } else {
    gather_scp_kernel<float><<<blocks, kBlock, 0, s>>>(
        (const float*)a, (const int32_t*)idx, (const float*)x, (float*)o, n);
  }
  return (int)cudaGetLastError();
}
