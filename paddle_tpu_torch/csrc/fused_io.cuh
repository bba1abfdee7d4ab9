// Loads, stores and roundings shared by the fused small-op kernels
// (fused_norm.cu, rope.cu, swiglu.cu, softmax_cross_entropy.cu): every
// value is held in fp32 in registers, whatever the dtype in memory.
// Dtype codes as ops/_fused_io.py's DTYPE_CODES: 0 fp32, 1 bf16, 2 fp16.
// ldv<8> / stv<8> move 8 elements with 16-byte accesses (the caller makes
// sure the address is 16-byte aligned); ldv<1> / stv<1> one element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float rnd(float v, int dt) {
  if (dt == BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (dt == F16) return __half2float(__float2half_rn(v));
  return v;
}

__device__ __forceinline__ float from16(uint32_t bits, int dt) {
  return dt == BF16 ? __uint_as_float(bits << 16)
                    : __half2float(__ushort_as_half((unsigned short)bits));
}

__device__ __forceinline__ uint32_t to16(float v, int dt) {
  return dt == BF16 ? (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v))
                    : (uint32_t)__half_as_ushort(__float2half_rn(v));
}

template <int V>
__device__ __forceinline__ void ldv(const void* p, long long i, int dt,
                                    float (&x)[V]) {
  if constexpr (V == 8) {
    if (dt == F32) {
      const float4 a = *reinterpret_cast<const float4*>(
          static_cast<const float*>(p) + i);
      const float4 b = *reinterpret_cast<const float4*>(
          static_cast<const float*>(p) + i + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
      const uint4 r = *reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(p) + i);
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[2 * j] = from16(w[j] & 0xffffu, dt);
        x[2 * j + 1] = from16(w[j] >> 16, dt);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      x[j] = dt == F32 ? static_cast<const float*>(p)[i + j]
                       : from16(static_cast<const uint16_t*>(p)[i + j], dt);
  }
}

template <int V>
__device__ __forceinline__ void stv(void* p, long long i, int dt,
                                    const float (&x)[V]) {
  if constexpr (V == 8) {
    if (dt == F32) {
      float* q = static_cast<float*>(p) + i;
      *reinterpret_cast<float4*>(q) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(q + 4) = make_float4(x[4], x[5], x[6], x[7]);
    } else {
      uint4 r;
      r.x = to16(x[0], dt) | (to16(x[1], dt) << 16);
      r.y = to16(x[2], dt) | (to16(x[3], dt) << 16);
      r.z = to16(x[4], dt) | (to16(x[5], dt) << 16);
      r.w = to16(x[6], dt) | (to16(x[7], dt) << 16);
      *reinterpret_cast<uint4*>(static_cast<uint16_t*>(p) + i) = r;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (dt == F32)
        static_cast<float*>(p)[i + j] = x[j];
      else
        static_cast<uint16_t*>(p)[i + j] = (uint16_t)to16(x[j], dt);
    }
  }
}

}  // namespace
