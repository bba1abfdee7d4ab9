// Hard-label softmax cross-entropy over the last axis, forward and backward,
// for Hopper (sm_90a). The port's own kernel: the JAX package computes it
// with XLA-fused jnp (paddle_tpu/ops/loss_ops.py cross_entropy), no
// pallas_call.
//
// The logits are (B, L, V) at row strides (sb, sl), the last axis
// contiguous, in bf16, fp16 or fp32, read where they lie: the causal LM
// loss reads rows l < L_used of the model's logits (logits[:, :-1, :]) with
// no copy. Labels are (B, L_used) int32 or int64 at strides (lb, ll). Per
// used row, in fp32 (each logit rounded first to the dtype the op casts it
// to):
//   m = max x, logs = log(sum exp(x - m))      (one online pass)
//   loss = -((x[label] - m) - logs), 0 where label == ignore_index (when
//          ignore_index >= 0; the row then does not count)
// and a second kernel folds the rows in a fixed order:
//   out = [sum(loss) / max(count, 1), count]
// The backward reads the loss's gradient g from device memory and writes,
// for every row of the (B, L, V) logits (rows l >= L_used and rows that do
// not count get 0):
//   dx = p w - w [at the label],  p = exp((x - m) - logs), w = g / max(count, 1)
// rounded to the logits' dtype: what the fp32 cast's backward rounds to.
// Nothing is atomic, so every launch gives the same bits.
//
// Bound: bytes (forward: one read of the logits; backward: one read and one
// write). Design: one block per row, 16-byte vector loads when the rows
// allow it, a running (max, sum) per thread folded over the block.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

constexpr int THREADS = 256;

// (m, s) += (m2, s2): the running max and the sum of exp(x - max)
__device__ __forceinline__ void fold(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = __fadd_rn(__fmul_rn(s, expf(m - mx)), __fmul_rn(s2, expf(m2 - mx)));
  m = mx;
}

struct Args {
  const void *x, *lab;
  float *m, *logs, *loss, *valid, *out;
  const float* g;
  void* dx;
  long long nb, sb, sl, lb, ll, ignore;
  int L, L_used, V, x_dt, x_cast, lab_dt;
};

__device__ __forceinline__ long long label_at(const Args& a, long long b,
                                              long long l) {
  const long long i = b * a.lb + l * a.ll;
  return a.lab_dt == 0 ? (long long)static_cast<const int*>(a.lab)[i]
                       : static_cast<const long long*>(a.lab)[i];
}

template <int V>
__global__ void __launch_bounds__(THREADS) ce_fwd_kernel(Args a) {
  __shared__ float red_m[THREADS / 32], red_s[THREADS / 32];
  const long long r = blockIdx.x;
  const long long b = r / a.L_used, l = r % a.L_used;
  const long long xo = b * a.sb + l * a.sl;
  float m = -INFINITY, s = 0.f;
  for (int c = threadIdx.x * V; c < a.V; c += THREADS * V) {
    float v[V];
    ldv<V>(a.x, xo + c, a.x_dt, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = rnd(v[j], a.x_cast);
      if (t > m) {
        s = __fadd_rn(__fmul_rn(s, expf(m - t)), 1.f);
        m = t;
      } else if (m > -INFINITY) {
        s = __fadd_rn(s, expf(t - m));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    fold(m, s, m2, s2);
  }
  if ((threadIdx.x & 31) == 0) {
    red_m[threadIdx.x >> 5] = m;
    red_s[threadIdx.x >> 5] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  m = red_m[0];
  s = red_s[0];
  for (int w = 1; w < THREADS / 32; ++w) fold(m, s, red_m[w], red_s[w]);
  const float logs = logf(s);
  const long long lab = label_at(a, b, l);
  const bool valid = a.ignore < 0 || lab != a.ignore;
  float loss = 0.f;
  if (valid) {
    if (lab < 0 || lab >= a.V) {
      loss = __int_as_float(0x7fc00000);  // a label outside the vocabulary
    } else {
      float xl[1];
      ldv<1>(a.x, xo + lab, a.x_dt, xl);
      loss = -__fsub_rn(__fsub_rn(rnd(xl[0], a.x_cast), m), logs);
    }
  }
  a.m[r] = m;
  a.logs[r] = logs;
  a.loss[r] = loss;
  a.valid[r] = valid ? 1.f : 0.f;
}

__global__ void __launch_bounds__(1024) ce_mean_kernel(Args a) {
  __shared__ float red_l[32], red_c[32];
  const long long n = a.nb * a.L_used;
  float sl = 0.f, sc = 0.f;
  for (long long r = threadIdx.x; r < n; r += blockDim.x) {
    sl = __fadd_rn(sl, a.loss[r]);
    sc = __fadd_rn(sc, a.valid[r]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sl += __shfl_xor_sync(0xffffffffu, sl, o);
    sc += __shfl_xor_sync(0xffffffffu, sc, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red_l[threadIdx.x >> 5] = sl;
    red_c[threadIdx.x >> 5] = sc;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  sl = 0.f;
  sc = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    sl = __fadd_rn(sl, red_l[w]);
    sc = __fadd_rn(sc, red_c[w]);
  }
  a.out[0] = __fdiv_rn(sl, fmaxf(sc, 1.f));
  a.out[1] = sc;
}

template <int V>
__global__ void __launch_bounds__(THREADS) ce_bwd_kernel(Args a) {
  const long long r = blockIdx.x;  // a row of the (B, L, V) logits
  const long long b = r / a.L, l = r % a.L;
  const long long ru = b * a.L_used + l;
  const bool live = l < a.L_used && a.valid[ru] != 0.f;
  float w = 0.f, m = 0.f, logs = 0.f;
  long long lab = -1;
  if (live) {
    w = __fdiv_rn(*a.g, fmaxf(a.out[1], 1.f));
    m = a.m[ru];
    logs = a.logs[ru];
    lab = label_at(a, b, l);
  }
  const long long xo = b * a.sb + l * a.sl;
  for (int c = threadIdx.x * V; c < a.V; c += THREADS * V) {
    float v[V];
    if (live) {
      ldv<V>(a.x, xo + c, a.x_dt, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float p = expf(__fsub_rn(__fsub_rn(rnd(v[j], a.x_cast), m), logs));
        float d = __fmul_rn(p, w);
        if (c + j == lab) d = __fsub_rn(d, w);
        v[j] = rnd(d, a.x_cast);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    stv<V>(a.dx, r * a.V + c, a.x_dt, v);
  }
}

}  // namespace

// x_cast: the dtype the op casts the logits to (fp32 under AMP's black
// list); lab_dt: 0 int32, 1 int64; ignore: ignore_index, honoured when >= 0.
// m, logs, loss, valid: fp32 scratch of B * L_used; out: fp32 [2].
extern "C" int ce_fwd(const void* x, const void* lab, void* m, void* logs,
                      void* loss, void* valid, void* out, long long nb,
                      int L_used, int V, long long sb, long long sl,
                      long long lb, long long ll, long long ignore, int x_dt,
                      int x_cast, int lab_dt, int vec, void* stream) {
  Args a{x, lab, static_cast<float*>(m), static_cast<float*>(logs),
         static_cast<float*>(loss), static_cast<float*>(valid),
         static_cast<float*>(out), nullptr, nullptr, nb, sb, sl, lb, ll,
         ignore, L_used, L_used, V, x_dt, x_cast, lab_dt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned rows = (unsigned)(nb * L_used);
  if (rows > 0) {
    if (vec == 8)
      ce_fwd_kernel<8><<<rows, THREADS, 0, st>>>(a);
    else
      ce_fwd_kernel<1><<<rows, THREADS, 0, st>>>(a);
  }
  ce_mean_kernel<<<1, 1024, 0, st>>>(a);
  return cudaGetLastError();
}

// g: the fp32 gradient of the mean (device); dx: (B, L, V) contiguous in
// the logits' dtype.
extern "C" int ce_bwd(const void* x, const void* lab, const void* m,
                      const void* logs, const void* valid, const void* out,
                      const void* g, void* dx, long long nb, int L, int L_used,
                      int V, long long sb, long long sl, long long lb,
                      long long ll, long long ignore, int x_dt, int x_cast,
                      int lab_dt, int vec, void* stream) {
  Args a{x, lab, const_cast<float*>(static_cast<const float*>(m)),
         const_cast<float*>(static_cast<const float*>(logs)), nullptr,
         const_cast<float*>(static_cast<const float*>(valid)),
         const_cast<float*>(static_cast<const float*>(out)),
         static_cast<const float*>(g), dx, nb, sb, sl, lb, ll, ignore, L,
         L_used, V, x_dt, x_cast, lab_dt};
  const unsigned rows = (unsigned)(nb * L);
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    ce_bwd_kernel<8><<<rows, THREADS, 0, st>>>(a);
  else
    ce_bwd_kernel<1><<<rows, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}
