// RMSNorm and LayerNorm over the last axis, with the pre-norm residual (and
// bias) add, forward and backward, for Hopper (sm_90a). The port's own
// kernel: the JAX package computes these with XLA-fused jnp
// (paddle_tpu/ops/nn_ops.py rms_norm and layer_norm, and
// paddle_tpu/incubate/nn_functional.py fused_rms_norm and fused_layer_norm,
// :23-91), no pallas_call; upstream Paddle backs the fused ones with CUDA
// kernels (paddle/phi/kernels/fusion/).
//
// What it computes, per row of `cols` elements (every value held in fp32,
// rnd(v, t) rounding v to the dtype t and back):
//   h  = x, or with an add: rnd(rnd(x, A) + rnd(pre_bias, A), A), then
//        rnd(h + rnd(residual, A), A); h is written to res_out (dtype A)
//   hn = rnd(h, T)                           the norm's input (fp32 math)
//   RMS: r = rsqrt(mean(hn^2) + eps), n = hn r
//   LN:  mu = mean(hn), r = rsqrt(mean((hn - mu)^2) + eps), n = (hn - mu) r
//   plain order (the port's rms_norm / layer_norm, the weight after the
//   cast): y = rnd(rnd(rnd(n, T) w, P) + b, P)
//   fused order (incubate's fused_*_norm, the weight before the cast):
//   y = rnd(n w + b, P)
// with w and b rounded to their cast dtypes first. mean (LN) and r are kept
// per row for the backward, which gives
//   gn = the gradient of n (plain: rnd(rnd(g w, P), T); fused: g w)
//   dh = r (gn - mean(gn) [LN] - n mean(gn n)), rounded to T, then with an
//        add to A, plus the gradient of res_out, rounded to A
// and the weight, bias and pre-bias gradients as per-block partial sums
// (fp32, one column per thread, rows in the block's fixed order) that a
// second kernel folds in block order: no atomics, so every launch on the
// same inputs gives the same bits.
//
// Bound: bytes. Forward one read of x (and residual), one write of y (and
// res_out); backward one read of dy, h (and d res_out), one write of dx.
// Design: the forward takes one row per block, 16-byte vector loads (8
// elements a thread for 2-byte dtypes) when every row starts 16-byte
// aligned, hn kept in shared memory between the statistics and the output
// pass; the backward walks rows with a grid of at most NBLK blocks so that
// the partial sums stay small, gn and n in shared memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

// Sum over the block, the same value in every thread: lane 0 of each warp
// folds its warp's xor tree, warp 0 folds the warps in order and lane 0's
// result is broadcast. blockDim.x is a multiple of 32.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

struct FwdArgs {
  const void *x, *res, *pb, *w, *b;
  void *out, *res_out;
  float *mean, *rstd;
  long long rows;
  int cols;
  int x_dt, res_dt, pb_dt, w_dt, w_cast, b_dt, b_cast, out_dt, add_dt,
      norm_dt, ln, fused;
  float eps;
};

template <int V>
__global__ void __launch_bounds__(1024) norm_fwd_kernel(FwdArgs a) {
  extern __shared__ float sh[];  // hn of this row, then the reduction slots
  float* red = sh + a.cols;
  const long long row = blockIdx.x;
  const bool has_add = a.res != nullptr || a.pb != nullptr;
  float s1 = 0.f, s2 = 0.f;
  for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V) {
    float h[V];
    ldv<V>(a.x, row * a.cols + c, a.x_dt, h);
    if (has_add) {
#pragma unroll
      for (int j = 0; j < V; ++j) h[j] = rnd(h[j], a.add_dt);
      if (a.pb != nullptr) {
        float t[V];
        ldv<V>(a.pb, c, a.pb_dt, t);
#pragma unroll
        for (int j = 0; j < V; ++j)
          h[j] = rnd(__fadd_rn(h[j], rnd(t[j], a.add_dt)), a.add_dt);
      }
      if (a.res != nullptr) {
        float t[V];
        ldv<V>(a.res, row * a.cols + c, a.res_dt, t);
#pragma unroll
        for (int j = 0; j < V; ++j)
          h[j] = rnd(__fadd_rn(h[j], rnd(t[j], a.add_dt)), a.add_dt);
      }
      stv<V>(a.res_out, row * a.cols + c, a.add_dt, h);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = rnd(h[j], a.norm_dt);
      sh[c + j] = v;
      s1 += v;
      s2 += v * v;
    }
  }
  float mu = 0.f, var;
  if (a.ln) {
    mu = __fdiv_rn(block_sum(s1, red), (float)a.cols);
    float s = 0.f;
    for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = __fsub_rn(sh[c + j], mu);
        s += d * d;
      }
    }
    var = __fdiv_rn(block_sum(s, red), (float)a.cols);
  } else {
    var = __fdiv_rn(block_sum(s2, red), (float)a.cols);
  }
  const float r = __frsqrt_rn(__fadd_rn(var, a.eps));
  if (threadIdx.x == 0) {
    if (a.ln) a.mean[row] = mu;
    a.rstd[row] = r;
  }
  for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V) {
    float w[V], b[V], y[V];
    if (a.w != nullptr) ldv<V>(a.w, c, a.w_dt, w);
    if (a.b != nullptr) ldv<V>(a.b, c, a.b_dt, b);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float n = __fmul_rn(a.ln ? __fsub_rn(sh[c + j], mu) : sh[c + j], r);
      float v;
      if (a.fused) {
        v = n;
        if (a.w != nullptr) v = __fmul_rn(v, rnd(w[j], a.w_cast));
        if (a.b != nullptr) v = __fadd_rn(v, rnd(b[j], a.b_cast));
      } else {
        v = rnd(n, a.norm_dt);
        if (a.w != nullptr) v = rnd(__fmul_rn(v, rnd(w[j], a.w_cast)), a.out_dt);
        if (a.b != nullptr) v = rnd(__fadd_rn(v, rnd(b[j], a.b_cast)), a.out_dt);
      }
      y[j] = rnd(v, a.out_dt);
    }
    stv<V>(a.out, row * a.cols + c, a.out_dt, y);
  }
}

struct BwdArgs {
  const void *dy, *dres, *h, *w;
  const float *mean, *rstd;
  void* dx;
  float *pw, *pb, *ppb;  // [gridDim.x][cols] partial sums, or null
  long long rows;
  int cols;
  int dy_dt, dres_dt, h_dt, w_dt, w_cast, dx_dt, out_dt, add_dt, norm_dt,
      has_add, ln, fused;
};

template <int V>
__global__ void __launch_bounds__(1024) norm_bwd_kernel(BwdArgs a) {
  extern __shared__ float sh[];
  float* gn_s = sh;              // gn of this row
  float* n_s = sh + a.cols;      // n of this row
  float* acc = sh + 2 * a.cols;  // dw, db, dpb partials, then red
  float* aw = a.pw != nullptr ? acc : nullptr;
  float* ab = a.pb != nullptr ? acc + a.cols : nullptr;
  float* apb = a.ppb != nullptr ? acc + 2 * a.cols : nullptr;
  float* red = acc + 3 * a.cols;
  for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (aw) aw[c + j] = 0.f;
      if (ab) ab[c + j] = 0.f;
      if (apb) apb[c + j] = 0.f;
    }
  const float inv_cols = 1.f / (float)a.cols;
  for (long long row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const float mu = a.ln ? a.mean[row] : 0.f;
    const float r = a.rstd[row];
    float sa = 0.f, sb = 0.f;
    for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V) {
      float g[V], hv[V], w[V];
      ldv<V>(a.dy, row * a.cols + c, a.dy_dt, g);
      ldv<V>(a.h, row * a.cols + c, a.h_dt, hv);
      if (a.w != nullptr) ldv<V>(a.w, c, a.w_dt, w);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float hn = rnd(hv[j], a.norm_dt);
        const float n = __fmul_rn(a.ln ? __fsub_rn(hn, mu) : hn, r);
        float gn;
        if (a.fused) {
          gn = a.w != nullptr ? __fmul_rn(g[j], rnd(w[j], a.w_cast)) : g[j];
          if (aw) aw[c + j] += __fmul_rn(g[j], n);
        } else {
          gn = a.w != nullptr
                   ? rnd(rnd(__fmul_rn(g[j], rnd(w[j], a.w_cast)), a.out_dt),
                         a.norm_dt)
                   : rnd(g[j], a.norm_dt);
          if (aw) aw[c + j] += rnd(__fmul_rn(g[j], rnd(n, a.norm_dt)), a.out_dt);
        }
        if (ab) ab[c + j] += g[j];
        gn_s[c + j] = gn;
        n_s[c + j] = n;
        sa += gn * n;
        sb += gn;
      }
    }
    const float ma = block_sum(sa, red) * inv_cols;
    const float mb = a.ln ? block_sum(sb, red) * inv_cols : 0.f;
    for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V) {
      float d[V], v[V];
      if (a.dres != nullptr) ldv<V>(a.dres, row * a.cols + c, a.dres_dt, d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = __fsub_rn(__fsub_rn(gn_s[c + j], mb),
                                  __fmul_rn(n_s[c + j], ma));
        float x = rnd(__fmul_rn(r, t), a.norm_dt);
        if (a.has_add) {
          x = rnd(x, a.add_dt);
          if (a.dres != nullptr) x = rnd(__fadd_rn(x, d[j]), a.add_dt);
        }
        if (apb) apb[c + j] += x;
        v[j] = x;
      }
      stv<V>(a.dx, row * a.cols + c, a.dx_dt, v);
    }
  }
  const long long base = (long long)blockIdx.x * a.cols;
  for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (aw) a.pw[base + c + j] = aw[c + j];
      if (ab) a.pb[base + c + j] = ab[c + j];
      if (apb) a.ppb[base + c + j] = apb[c + j];
    }
}

// out[c] = the sum of part[0..nblk)[c] in block order, rounded to p_dt,
// then to cast_dt, stored as out_dt
__global__ void partial_fold_kernel(const float* __restrict__ part, int nblk,
                                    int cols, void* out, int out_dt, int p_dt,
                                    int cast_dt) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int i = 0; i < nblk; ++i) s = __fadd_rn(s, part[(long long)i * cols + c]);
  s = rnd(rnd(s, p_dt), cast_dt);
  float v[1] = {s};
  stv<1>(out, c, out_dt, v);
}

int threads_for(int cols, int vec) {
  int t = (cols / vec + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int fused_norm_fwd(const void* x, const void* res, const void* pb,
                              const void* w, const void* b, void* out,
                              void* res_out, void* mean, void* rstd,
                              long long rows, int cols, int x_dt, int res_dt,
                              int pb_dt, int w_dt, int w_cast, int b_dt,
                              int b_cast, int out_dt, int add_dt, int norm_dt,
                              int ln, int fused, int vec, float eps,
                              void* stream) {
  FwdArgs a{x, res, pb, w, b, out, res_out, static_cast<float*>(mean),
            static_cast<float*>(rstd), rows, cols, x_dt, res_dt, pb_dt, w_dt,
            w_cast, b_dt, b_cast, out_dt, add_dt, norm_dt, ln, fused, eps};
  const int threads = threads_for(cols, vec);
  const size_t smem = (size_t)(cols + 32) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec == 8) {
    if ((err = set_smem(norm_fwd_kernel<8>, smem)) != cudaSuccess) return err;
    norm_fwd_kernel<8><<<(unsigned)rows, threads, smem, st>>>(a);
  } else {
    if ((err = set_smem(norm_fwd_kernel<1>, smem)) != cudaSuccess) return err;
    norm_fwd_kernel<1><<<(unsigned)rows, threads, smem, st>>>(a);
  }
  return cudaGetLastError();
}

extern "C" int fused_norm_bwd(const void* dy, const void* dres, const void* h,
                              const void* mean, const void* rstd,
                              const void* w, void* dx, void* part_w,
                              void* part_b, void* part_pb, void* dw, void* db,
                              void* dpb, long long rows, int cols, int nblk,
                              int dy_dt, int dres_dt, int h_dt, int w_dt,
                              int w_cast, int dx_dt, int b_cast, int b_dt,
                              int pb_cast, int pb_dt, int out_dt, int add_dt,
                              int norm_dt, int has_add, int ln, int fused,
                              int vec, void* stream) {
  BwdArgs a{dy, dres, h, w, static_cast<const float*>(mean),
            static_cast<const float*>(rstd), dx, static_cast<float*>(part_w),
            static_cast<float*>(part_b), static_cast<float*>(part_pb), rows,
            cols, dy_dt, dres_dt, h_dt, w_dt, w_cast, dx_dt, out_dt, add_dt,
            norm_dt, has_add, ln, fused};
  const int threads = threads_for(cols, vec);
  const size_t smem = (size_t)(5 * cols + 32) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec == 8) {
    if ((err = set_smem(norm_bwd_kernel<8>, smem)) != cudaSuccess) return err;
    norm_bwd_kernel<8><<<nblk, threads, smem, st>>>(a);
  } else {
    if ((err = set_smem(norm_bwd_kernel<1>, smem)) != cudaSuccess) return err;
    norm_bwd_kernel<1><<<nblk, threads, smem, st>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the plain order rounds each product to P before the sum, and the sum to
  // P after it (a bf16 sum's rounding); the fused order sums fp32 products
  const int fold_p = fused ? F32 : out_dt;
  const unsigned grid = (unsigned)((cols + 255) / 256);
  if (dw != nullptr)
    partial_fold_kernel<<<grid, 256, 0, st>>>(static_cast<float*>(part_w),
                                              nblk, cols, dw, w_dt, fold_p,
                                              w_cast);
  if (db != nullptr)
    partial_fold_kernel<<<grid, 256, 0, st>>>(static_cast<float*>(part_b),
                                              nblk, cols, db, b_dt, fold_p,
                                              b_cast);
  if (dpb != nullptr)
    partial_fold_kernel<<<grid, 256, 0, st>>>(static_cast<float*>(part_pb),
                                              nblk, cols, dpb, pb_dt, add_dt,
                                              pb_cast);
  return cudaGetLastError();
}
