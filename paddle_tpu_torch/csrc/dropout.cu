// Hidden dropout (paddle's upscale_in_train and downscale_in_infer), with
// an optional residual add (fused_dropout_add), forward and backward, for
// Hopper (sm_90a). The port's own kernel: the JAX package draws hidden
// dropout masks with jax.random inside XLA-fused jnp
// (paddle_tpu/nn/functional dropout, paddle_tpu/incubate/nn_functional.py
// fused_dropout_add :130-142), no pallas_call.
//
// The mask is never stored. Element i (its flat row-major index in x) is
// kept where the lowbias32 hash of B0 (keep_elem in flash_attention.cu,
// keep_mask_reference in ops/flash_attention.py), keyed on (seed, the
// stream constant STREAM in place of bh, row = i >> 32, col = i mod 2^32),
// has its top 24 bits times 2^-24 below keep_prob (fp32 1 - p). The seed is
// read from device memory (the low 32 bits of an int64), so a captured CUDA
// graph draws the seed each replay's step wrote there, and the backward
// regenerates the forward's mask from the same seed.
//
// What it computes (rnd(v, t): v rounded to dtype t):
//   d   = keep ? (upscale ? rnd(x inv_keep, x's dtype) : x) : 0
//   out = residual ? rnd(d + r, out's dtype) : d
// and the backward, dy of out's dtype:
//   dx  = keep ? (upscale ? rnd(rnd(dy, x's dtype) inv_keep, x's dtype)
//                         : rnd(dy, x's dtype)) : 0
// (inv_keep = fp32 1 / (1 - p); the residual's gradient is dy itself, cast
// by the wrapper). Bound: bytes (forward reads x (and r) and writes out;
// backward reads dy and writes dx). Design: one pass, 8 elements a thread
// with 16-byte accesses when the size and addresses allow it, else 1.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

// "HIDD": the bh term of the hidden-dropout stream (ops/dropout.py STREAM)
constexpr uint32_t STREAM = 0x48494444u;

struct Args {
  const void *x, *r, *dy;
  void *out, *dx;
  const uint32_t* seed_ptr;
  long long n;
  float keep_prob, inv_keep;
  int upscale, x_dt, r_dt, out_dt;
};

__device__ __forceinline__ bool keep(uint32_t base, unsigned long long i,
                                     float keep_prob) {
  uint32_t h = ((uint32_t)(i >> 32) * 0x9E3779B1u) ^
               ((uint32_t)i * 0x85EBCA77u) ^ base;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return (float)(h >> 8) * (1.0f / 16777216.0f) < keep_prob;
}

template <int V>
__global__ void __launch_bounds__(256) dropout_fwd_kernel(Args a) {
  const long long i0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i0 >= a.n) return;
  const uint32_t base = (*a.seed_ptr * 0xC2B2AE3Du) ^ (STREAM * 0x27D4EB2Fu);
  float x[V], o[V];
  ldv<V>(a.x, i0, a.x_dt, x);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool k = keep(base, (unsigned long long)(i0 + j), a.keep_prob);
    o[j] = !k ? 0.f : a.upscale ? rnd(__fmul_rn(x[j], a.inv_keep), a.x_dt)
                                : x[j];
  }
  if (a.r != nullptr) {
    float r[V];
    ldv<V>(a.r, i0, a.r_dt, r);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = rnd(__fadd_rn(o[j], r[j]), a.out_dt);
  }
  stv<V>(a.out, i0, a.out_dt, o);
}

template <int V>
__global__ void __launch_bounds__(256) dropout_bwd_kernel(Args a) {
  const long long i0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i0 >= a.n) return;
  const uint32_t base = (*a.seed_ptr * 0xC2B2AE3Du) ^ (STREAM * 0x27D4EB2Fu);
  float g[V], dx[V];
  ldv<V>(a.dy, i0, a.out_dt, g);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool k = keep(base, (unsigned long long)(i0 + j), a.keep_prob);
    const float gx = rnd(g[j], a.x_dt);
    dx[j] = !k ? 0.f : a.upscale ? rnd(__fmul_rn(gx, a.inv_keep), a.x_dt)
                                 : gx;
  }
  stv<V>(a.dx, i0, a.x_dt, dx);
}

unsigned grid_of(long long n, int vec) {
  return (unsigned)((n / vec + 255) / 256);
}

}  // namespace

extern "C" int dropout_fwd(const void* x, const void* r, void* out,
                           const void* seed, long long n, float keep_prob,
                           float inv_keep, int upscale, int x_dt, int r_dt,
                           int out_dt, int vec, void* stream) {
  if (n == 0) return cudaSuccess;
  Args a{x, r, nullptr, out, nullptr, static_cast<const uint32_t*>(seed),
         n, keep_prob, inv_keep, upscale, x_dt, r_dt, out_dt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    dropout_fwd_kernel<8><<<grid_of(n, 8), 256, 0, st>>>(a);
  else
    dropout_fwd_kernel<1><<<grid_of(n, 1), 256, 0, st>>>(a);
  return cudaGetLastError();
}

extern "C" int dropout_bwd(const void* dy, void* dx, const void* seed,
                           long long n, float keep_prob, float inv_keep,
                           int upscale, int x_dt, int out_dt, int vec,
                           void* stream) {
  if (n == 0) return cudaSuccess;
  Args a{nullptr, nullptr, dy, nullptr, dx,
         static_cast<const uint32_t*>(seed), n, keep_prob, inv_keep,
         upscale, x_dt, 0, out_dt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    dropout_bwd_kernel<8><<<grid_of(n, 8), 256, 0, st>>>(a);
  else
    dropout_bwd_kernel<1><<<grid_of(n, 1), 256, 0, st>>>(a);
  return cudaGetLastError();
}
