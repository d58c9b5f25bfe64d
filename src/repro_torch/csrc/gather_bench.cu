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
// Design: a grid-stride loop with a tail, so any n works (the Pallas kernels
// needed n % tile == 0).  The triad reads and writes 16-byte vectors (float4,
// double2) when all four pointers are 16-byte aligned, then finishes the
// tail element by element; one thread's vector is 4 (f32) or 2 (f64)
// neighbouring values, so a warp reads 512 contiguous bytes per load.
// gather_scp streams a and idx with neighbouring threads on neighbouring
// elements and reads x through the read-only path (__ldg): at the paper's
// sizes x is far larger than shared memory, and usually than L2, so no
// staging would hold it.  The reduction of o stays outside, as in the
// reference, so the streamed traffic stays comparable to the triad's.
// Built with --fmad=false: b + a*c rounds the product and then the sum, as
// the plain PyTorch version does.
#include "common.cuh"

__device__ __forceinline__ float4 triad_v(float4 a, float4 b, float4 c) {
  return make_float4(b.x + a.x * c.x, b.y + a.y * c.y, b.z + a.z * c.z,
                     b.w + a.w * c.w);
}
__device__ __forceinline__ double2 triad_v(double2 a, double2 b, double2 c) {
  return make_double2(b.x + a.x * c.x, b.y + a.y * c.y);
}

template <typename T, typename V>
__global__ void stream_triad_kernel(const T* __restrict__ a,
                                    const T* __restrict__ b,
                                    const T* __restrict__ c, T* __restrict__ o,
                                    int64_t n, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    constexpr int W = sizeof(V) / sizeof(T);
    const int64_t nv = n / W;
    const V* av = reinterpret_cast<const V*>(a);
    const V* bv = reinterpret_cast<const V*>(b);
    const V* cv = reinterpret_cast<const V*>(c);
    V* ov = reinterpret_cast<V*>(o);
    for (int64_t i = tid; i < nv; i += stride) {
      ov[i] = triad_v(__ldg(av + i), __ldg(bv + i), __ldg(cv + i));
    }
    head = nv * W;
  }
  for (int64_t i = head + tid; i < n; i += stride) o[i] = b[i] + a[i] * c[i];
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
                            int blocks, void* stream) {
  if (n == 0) return 0;
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64) {
    stream_triad_kernel<double, double2><<<blocks, kBlock, 0, s>>>(
        (const double*)a, (const double*)b, (const double*)c, (double*)o, n, vec);
  } else {
    stream_triad_kernel<float, float4><<<blocks, kBlock, 0, s>>>(
        (const float*)a, (const float*)b, (const float*)c, (float*)o, n, vec);
  }
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
