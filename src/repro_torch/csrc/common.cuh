// Shared pieces of the SpMV kernels: storage types, widening to the
// accumulator, and the (storage, accumulator) dispatch of the C entry points.
//
// Storage is one of f64, f32, bf16, f16, fp8 e4m3 (fn) and int8; the
// accumulator is f32, or f64 when the storage or x is f64 (the acc_dtype
// rule of kernels/accum.py).  The wrappers pass x already in the
// accumulator type, so every kernel reads x as A and widens only the stored
// values.  The codes below match VALUE_CODES in kernels/cuda_build.py.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum ValueCode { V_F64 = 0, V_F32 = 1, V_BF16 = 2, V_F16 = 3, V_FP8E4M3 = 4, V_INT8 = 5 };

// bf16 and fp8 travel as raw bits: the widening below is exact and needs no
// conversion header.
struct bf16_bits { uint16_t b; };
struct fp8e4m3_bits { uint8_t b; };

__device__ __forceinline__ float widen_f(double v) { return (float)v; }
__device__ __forceinline__ float widen_f(float v) { return v; }
__device__ __forceinline__ float widen_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen_f(bf16_bits v) {
  return __uint_as_float(((unsigned)v.b) << 16);
}
// e4m3fn: bias 7, no infinities, S.1111.111 is NaN, exponent 0 subnormal.
__device__ __forceinline__ float widen_f(fp8e4m3_bits v) {
  const unsigned s = v.b >> 7, e = (v.b >> 3) & 0xFu, m = v.b & 0x7u;
  if (e == 0xFu && m == 0x7u) return __uint_as_float(0x7fc00000u);
  float mag = e == 0 ? (float)m * 0.001953125f  // m/8 * 2^-6
                     : __uint_as_float(((e + 120u) << 23) | (m << 20));
  return s ? -mag : mag;
}

template <typename A, typename T>
__device__ __forceinline__ A widen(T v) { return (A)widen_f(v); }
template <>
__device__ __forceinline__ double widen<double, double>(double v) { return v; }

// Cache-streaming loads (evict first) of a matrix stream read once, so that
// L1 and L2 keep the vector the kernel gathers from
__device__ __forceinline__ int32_t ld_stream(const int32_t* p) { return __ldcs(p); }
__device__ __forceinline__ double ld_stream(const double* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ __half ld_stream(const __half* p) { return __ldcs(p); }
__device__ __forceinline__ int8_t ld_stream(const int8_t* p) {
  return (int8_t)__ldcs(reinterpret_cast<const signed char*>(p));
}
__device__ __forceinline__ bf16_bits ld_stream(const bf16_bits* p) {
  return bf16_bits{__ldcs(reinterpret_cast<const unsigned short*>(p))};
}
__device__ __forceinline__ fp8e4m3_bits ld_stream(const fp8e4m3_bits* p) {
  return fp8e4m3_bits{__ldcs(reinterpret_cast<const unsigned char*>(p))};
}

// Instantiate LAUNCH(T, A) for the (storage code, acc64) pair, or return
// cudaErrorInvalidValue for a pair the acc_dtype rule excludes (f64 storage
// with an f32 accumulator) or an unknown code.
#define SPMV_DISPATCH(vcode, acc64, LAUNCH)                      \
  do {                                                           \
    if (acc64) {                                                 \
      switch (vcode) {                                           \
        case V_F64: LAUNCH(double, double); break;               \
        case V_F32: LAUNCH(float, double); break;                \
        case V_BF16: LAUNCH(bf16_bits, double); break;           \
        case V_F16: LAUNCH(__half, double); break;               \
        case V_FP8E4M3: LAUNCH(fp8e4m3_bits, double); break;     \
        case V_INT8: LAUNCH(int8_t, double); break;              \
        default: return (int)cudaErrorInvalidValue;             \
      }                                                          \
    } else {                                                     \
      switch (vcode) {                                           \
        case V_F32: LAUNCH(float, float); break;                 \
        case V_BF16: LAUNCH(bf16_bits, float); break;            \
        case V_F16: LAUNCH(__half, float); break;                \
        case V_FP8E4M3: LAUNCH(fp8e4m3_bits, float); break;      \
        case V_INT8: LAUNCH(int8_t, float); break;               \
        default: return (int)cudaErrorInvalidValue;              \
      }                                                          \
    }                                                            \
  } while (0)

constexpr int kBlock = 256;

inline unsigned grid_for(int64_t threads) {
  return (unsigned)((threads + kBlock - 1) / kBlock);
}
