// act(y + b), the bias add and activation of a linear layer's epilogue
// (act: identity, ReLU, GELU erf form, GELU tanh form), forward and
// backward, for Hopper (sm_90a). The port's own kernel: the JAX package
// leaves matmul + bias + activation to XLA's fusion (paddle_tpu/incubate/
// nn_functional.py fused_linear_activation :212, nn/transformer.py's
// linear1 -> activation), no pallas_call.
//
// What it computes, per element, in the plain version's order and roundings
// (rnd(v, t): v rounded to dtype t; torch's op-math is fp32):
//   h = rnd(y + b, h's dtype)            (no bias: h = y)
//   a = rnd(h, a's dtype)                (the activation's input cast)
//   out = rnd(act(a), a's dtype)
// with act written as torch's CUDA kernels write it (ActivationGeluKernel.cu,
// relu), and the backward, recomputing a from the saved y and b (no
// activation is saved):
//   gh = rnd(rnd(dy act'(a), a's dtype), h's dtype)
//   dy_y = rnd(gh, y's dtype)
//   db   = rnd(sum over rows of gh, b's dtype)
// The bias gradient is a sum over up to 24,576 rows: each block of ROWS
// rows writes its fp32 column partial, and bias_act_fold_kernel adds the
// partials in a fixed order (8 strided sums of a column's partials, then
// those 8 in order), so every launch gives the same bits.
//
// With a bias row period P (the expert-choice MoE's per-expert bias, b of
// shape (E, 1, I) over E x C rows: P = C), row r takes bias row r / P, and
// the backward's row blocks never cross a period, so each bias row's
// gradient folds its own blocks' partials in the same fixed order; P = 0
// is one bias row for all rows (the blocks and the fold as without it).
//
// Bound: bytes (forward reads y and writes out; backward reads y and dy and
// writes dy_y). Design: one pass, 8 elements a thread with 16-byte accesses
// when the rows allow it, else 1.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fused_io.cuh"

namespace {

enum { IDENTITY = 0, RELU = 1, GELU = 2, GELU_TANH = 3 };
constexpr int ROWS = 16;      // rows a backward block sums into a partial
constexpr int THREADS = 128;

struct Args {
  const void *y, *b, *dy;
  void *out, *dyy;
  float* part;
  long long rows, period;  // period: rows a bias row serves (0: all)
  int n, act, y_dt, b_dt, h_dt, a_dt;
};

__device__ __forceinline__ float act_fwd(float x, int act) {
  if (act == RELU) return x > 0.f ? x : 0.f;
  if (act == GELU) {
    const float alpha = (float)M_SQRT1_2;
    return x * 0.5f * (1.f + erff(x * alpha));
  }
  if (act == GELU_TANH) {
    const float beta = (float)(M_SQRT2 * M_2_SQRTPI * 0.5);
    const float kappa = 0.044715f;
    const float x_cube = x * x * x;
    const float inner = beta * (x + kappa * x_cube);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  return x;
}

__device__ __forceinline__ float act_bwd(float dy, float x, int act) {
  if (act == RELU) return x > 0.f ? dy : 0.f;
  if (act == GELU) {
    const float beta = (float)(M_2_SQRTPI * M_SQRT1_2 * 0.5);
    const float alpha = (float)M_SQRT1_2;
    const float cdf = 0.5f * (1.f + erff(x * alpha));
    const float pdf = expf(-0.5f * x * x) * beta;
    return dy * (cdf + x * pdf);
  }
  if (act == GELU_TANH) {
    const float beta = (float)(M_SQRT2 * M_2_SQRTPI * 0.5);
    const float kappa = 0.044715f;
    const float x_sq = x * x;
    const float x_cube = x_sq * x;
    const float inner = beta * (x + kappa * x_cube);
    const float tanh_inner = tanhf(inner);
    const float left = 0.5f * x;
    const float right = 1.f + tanh_inner;
    const float left_derivative = 0.5f * right;
    const float tanh_derivative = 1.f - tanh_inner * tanh_inner;
    const float inner_derivative = beta * (1.f + 3.f * kappa * x_sq);
    const float right_derivative = left * tanh_derivative * inner_derivative;
    return dy * (left_derivative + right_derivative);
  }
  return dy;
}

// a = rnd(rnd(y + b, h_dt), a_dt) for V columns starting at c
template <int V>
__device__ __forceinline__ void pre_act(const Args& a, long long row, int c,
                                        float (&v)[V]) {
  ldv<V>(a.y, row * a.n + c, a.y_dt, v);
  if (a.b != nullptr) {
    float b[V];
    ldv<V>(a.b, (a.period ? row / a.period : 0) * a.n + c, a.b_dt, b);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = rnd(__fadd_rn(v[j], b[j]), a.h_dt);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = rnd(v[j], a.a_dt);
}

template <int V>
__global__ void __launch_bounds__(256) bias_act_fwd_kernel(Args a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = a.n / V;
  const long long row = t / per_row;
  if (row >= a.rows) return;
  const int c = (int)(t % per_row) * V;
  float v[V], o[V];
  pre_act<V>(a, row, c, v);
#pragma unroll
  for (int j = 0; j < V; ++j) o[j] = rnd(act_fwd(v[j], a.act), a.a_dt);
  stv<V>(a.out, row * a.n + c, a.a_dt, o);
}

// grid (row blocks of ROWS within each bias period, column blocks of
// THREADS * V): dy_y, and each block's fp32 column sums of dy_y into
// part[row block][column]; bpp blocks a period of p rows
template <int V>
__global__ void __launch_bounds__(THREADS) bias_act_bwd_kernel(Args a,
                                                               long long p,
                                                               int bpp) {
  const int c = (blockIdx.y * THREADS + threadIdx.x) * V;
  if (c >= a.n) return;
  const long long e = blockIdx.x / bpp;
  const long long r0 = e * p + (long long)(blockIdx.x % bpp) * ROWS;
  const long long r1 = min(min(r0 + ROWS, e * p + p), a.rows);
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (long long row = r0; row < r1; ++row) {
    float v[V], g[V];
    pre_act<V>(a, row, c, v);
    ldv<V>(a.dy, row * a.n + c, a.a_dt, g);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float gh = rnd(rnd(act_bwd(g[j], v[j], a.act), a.a_dt), a.h_dt);
      acc[j] = __fadd_rn(acc[j], gh);
      g[j] = rnd(gh, a.y_dt);
    }
    stv<V>(a.dyy, row * a.n + c, a.y_dt, g);
  }
  if (a.part != nullptr) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      a.part[(long long)blockIdx.x * a.n + c + j] = acc[j];
  }
}

// db[e, c] = rnd(sum of bias row e's row blocks' partials, b's dtype): a
// block of 256 threads takes 32 columns of one bias row (grid.y); its 8
// warps each sum the partials i = w, w + 8, ... of their column in order,
// and warp 0 adds the 8 sums in order
__global__ void __launch_bounds__(256) bias_act_fold_kernel(
    const float* __restrict__ part, void* db, int blocks, int n, int b_dt) {
  __shared__ float sums[8][32];
  const int tx = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  part += (long long)blockIdx.y * blocks * n;
  db = static_cast<char*>(db) +
       (long long)blockIdx.y * n * (b_dt == F32 ? 4 : 2);
  float s = 0.f;
  if (c < n)
    for (int i = w; i < blocks; i += 8)
      s = __fadd_rn(s, part[(long long)i * n + c]);
  sums[w][tx] = s;
  __syncthreads();
  if (w != 0 || c >= n) return;
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) t = __fadd_rn(t, sums[j][tx]);
  float o[1] = {t};
  stv<1>(db, c, b_dt, o);
}

}  // namespace

// period: rows a bias row serves (b holds rows / period bias rows), 0: one
// bias row for all rows
extern "C" int bias_act_fwd(const void* y, const void* b, void* out,
                            long long rows, long long period, int n, int act,
                            int y_dt, int b_dt, int h_dt, int a_dt, int vec,
                            void* stream) {
  Args a{y, b, nullptr, out, nullptr, nullptr, rows, period, n, act, y_dt,
         b_dt, h_dt, a_dt};
  const long long threads = rows * (n / vec);
  if (threads == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((threads + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    bias_act_fwd_kernel<8><<<grid, 256, 0, st>>>(a);
  else
    bias_act_fwd_kernel<1><<<grid, 256, 0, st>>>(a);
  return cudaGetLastError();
}

// part: fp32 scratch of (rows / p) x ceil(p / 16) x n, p = period or rows
// (ops/bias_act.py ROWS; unused without b); db (rows / p, n)
extern "C" int bias_act_bwd(const void* y, const void* b, const void* dy,
                            void* dyy, float* part, void* db, long long rows,
                            long long period, int n, int act, int y_dt,
                            int b_dt, int h_dt, int a_dt, int vec,
                            void* stream) {
  if (rows == 0 || n == 0) return cudaSuccess;
  Args a{y, b, dy, nullptr, dyy, b != nullptr ? part : nullptr, rows, period,
         n, act, y_dt, b_dt, h_dt, a_dt};
  const long long p = period ? period : rows;
  const int bpp = (int)((p + ROWS - 1) / ROWS);
  const unsigned bias_rows = (unsigned)((rows + p - 1) / p);
  const dim3 grid(bias_rows * bpp,
                  (unsigned)((n / vec + THREADS - 1) / THREADS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    bias_act_bwd_kernel<8><<<grid, THREADS, 0, st>>>(a, p, bpp);
  else
    bias_act_bwd_kernel<1><<<grid, THREADS, 0, st>>>(a, p, bpp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || b == nullptr) return err;
  bias_act_fold_kernel<<<dim3((n + 31) / 32, bias_rows), 256, 0, st>>>(
      part, db, bpp, n, b_dt);
  return cudaGetLastError();
}
