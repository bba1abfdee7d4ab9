// softmax(x + mask) over the last axis, and its upper-triangle variant,
// forward and backward, for Hopper (sm_90a): paddle.incubate's
// softmax_mask_fuse and softmax_mask_fuse_upper_triangle. The port's own
// kernel: the JAX package computes both with XLA-fused jnp
// (paddle_tpu/incubate/nn_functional.py :283, :411-430), no pallas_call.
// CUDA rather than Triton, so that every kernel of the port builds one way.
//
// What it computes, per row of Lk values, in fp32 (x and mask in any float
// dtype, the output in x's):
//   l_j = x_j + m_j                     (softmax_mask_fuse)
//   l_j = j > i + (Lk - Lq) ? -1e30 : x_j  (upper triangle: query row i,
//                                        bottom-right causal, as the JAX
//                                        package's jnp.tril(.., k - q))
//   y_j = rnd(exp(l_j - max l) / sum_k exp(l_k - max l), x's dtype)
// and the backward from the saved output y and dy:
//   dx_j = rnd(y_j (dy_j - sum_k dy_k y_k), x's dtype)
// The mask is read at its own strides over (batch, head, query row): a mask
// of shape (B, 1, Lq, Lk) serves every head without being expanded.
//
// Bound: bytes (forward reads x and the mask and writes y; backward reads y
// and dy and writes dx). Design: one warp a row, 4 rows a block; each lane
// walks the row at a stride of 32 elements, three passes over it (max, sum,
// write), the later two from L1.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fused_io.cuh"

namespace {

struct Args {
  const void *x, *m, *y, *dy;
  void *out, *dx;
  long long rows;
  int lk, lq, heads, causal, x_dt, m_dt;
  long long m_sb, m_sh, m_sq;   // mask strides (elements) of b, h, q
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float logit(const Args& a, long long xo,
                                       long long mo, int q, int j) {
  float x[1];
  ldv<1>(a.x, xo + j, a.x_dt, x);
  if (a.causal) return j > q + (a.lk - a.lq) ? -1e30f : x[0];
  float m[1];
  ldv<1>(a.m, mo + j, a.m_dt, m);
  return __fadd_rn(x[0], m[0]);
}

__global__ void __launch_bounds__(128) softmax_mask_fwd_kernel(Args a) {
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.rows) return;
  const int q = (int)(row % a.lq);
  const long long bh = row / a.lq;
  const long long xo = row * a.lk;
  const long long mo = a.causal ? 0
      : (bh / a.heads) * a.m_sb + (bh % a.heads) * a.m_sh + q * a.m_sq;
  float mx = -INFINITY;
  for (int j = lane; j < a.lk; j += 32) mx = fmaxf(mx, logit(a, xo, mo, q, j));
  mx = warp_max(mx);
  float s = 0.f;
  for (int j = lane; j < a.lk; j += 32)
    s = __fadd_rn(s, expf(__fsub_rn(logit(a, xo, mo, q, j), mx)));
  s = warp_sum(s);
  for (int j = lane; j < a.lk; j += 32) {
    float o[1] = {rnd(__fdiv_rn(expf(__fsub_rn(logit(a, xo, mo, q, j), mx)), s),
                      a.x_dt)};
    stv<1>(a.out, xo + j, a.x_dt, o);
  }
}

__global__ void __launch_bounds__(128) softmax_mask_bwd_kernel(Args a) {
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.rows) return;
  const long long o = row * a.lk;
  float s = 0.f;
  for (int j = lane; j < a.lk; j += 32) {
    float y[1], g[1];
    ldv<1>(a.y, o + j, a.x_dt, y);
    ldv<1>(a.dy, o + j, a.x_dt, g);
    s = __fadd_rn(s, __fmul_rn(y[0], g[0]));
  }
  s = warp_sum(s);
  for (int j = lane; j < a.lk; j += 32) {
    float y[1], g[1];
    ldv<1>(a.y, o + j, a.x_dt, y);
    ldv<1>(a.dy, o + j, a.x_dt, g);
    float d[1] = {rnd(__fmul_rn(y[0], __fsub_rn(g[0], s)), a.x_dt)};
    stv<1>(a.dx, o + j, a.x_dt, d);
  }
}

}  // namespace

// x, out: (rows, lk) contiguous, rows = B heads lq; the mask (causal = 0)
// at element strides m_sb, m_sh, m_sq over (b, h, q) and 1 over keys
extern "C" int softmax_mask_fwd(const void* x, const void* m, void* out,
                                long long rows, int lk, int lq, int heads,
                                long long m_sb, long long m_sh,
                                long long m_sq, int causal, int x_dt,
                                int m_dt, void* stream) {
  if (rows == 0 || lk == 0) return cudaSuccess;
  Args a{x, m, nullptr, nullptr, out, nullptr, rows, lk, lq, heads, causal,
         x_dt, m_dt, m_sb, m_sh, m_sq};
  softmax_mask_fwd_kernel<<<(unsigned)((rows + 3) / 4), 128, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int softmax_mask_bwd(const void* y, const void* dy, void* dx,
                                long long rows, int lk, int x_dt,
                                void* stream) {
  if (rows == 0 || lk == 0) return cudaSuccess;
  Args a{nullptr, nullptr, y, dy, nullptr, dx, rows, lk, 1, 1, 0, x_dt, 0,
         0, 0, 0};
  softmax_mask_bwd_kernel<<<(unsigned)((rows + 3) / 4), 128, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
