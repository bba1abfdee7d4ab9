// The multi-tensor AdamW update for Hopper (sm_90a): one launch updates
// every parameter of a model, laid out as one flat buffer each for the fp32
// master, the fp32 moments m and v, the gradient and the (fp32, bf16 or
// fp16) parameter. The port's own kernel: the JAX package gets this fusion
// from XLA (paddle_tpu/optimizer/__init__.py, Adam._fused_step), so it
// replaces no Pallas function.
//
// What it computes, in place, for each element of the flat buffers:
//   g = grad (fp32), clipped to [lo, hi] (ClipGradByValue) or times the
//       global-norm scale (ClipGradByGlobalNorm), when asked
//   m' = b1 m + (1 - b1) g,  v' = b2 v + ((1 - b2) g) g
//   master' = master (1 - lr wd) - (lr (m' / c1)) / (sqrt(v' / c2) + eps)
//   param' = master' rounded to the parameter's dtype (bf16, fp16: to
//            nearest; Adam._fused_step rounds stochastically only a bf16
//            flat buffer without masters, which this layout never is)
// in Adam._fused_step's order. lr, decay = 1 - lr wd, c1 = 1 - b1^t,
// c2 = 1 - b2^t, the NaN gate and the global-norm scale are read from
// device memory, a block of fp32 the optimizer fills on the device each
// step (ops/q8_adam.py SCALARS): a captured CUDA graph then reads each
// replay's own. Where the gate is 0 (a non-finite loss under the NaN gate)
// the kernel writes nothing.
//
// With per-tensor tables (parameter groups' LR scales, AdamW's lr_ratio
// and apply_decay_param_fun), each tensor's slice has its own lr = lr_t *
// scale[j] and decay = 1 - lr * wd where its flag is set (else none): the
// thread finds its tensor j by a binary search of the slices' ends (every
// slice starts on a 64-element boundary, so a thread's 8 elements share
// one), the same operations as the optimizer's per-parameter scalars.
//
// Every product, quotient, sum and square root is written with the
// round-to-nearest intrinsics, which nvcc never contracts into an FMA: the
// kernel does its plain version's exact fp32 operations in its order, so
// master, m, v and the parameter agree bit for bit.
//
// Design: a thread takes 8 consecutive elements (one 16-byte vector of
// bf16 or fp16, two of fp32 per buffer), 256 threads a block, one pass;
// every load is issued before the arithmetic. Bytes an element with a
// 16-bit gradient and parameter: 14 read (grad 2, master, m, v 4 each), 14
// written.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;

// the block of device scalars (ops/q8_adam.py SCALARS), in this order
enum { SC_LR, SC_DECAY, SC_C1, SC_C2, SC_GATE, SC_GSCALE };

struct Consts {
  float eps, b1, b2, omb1, omb2, lo, hi, wd;
  int has_wd, clip_value, grad_scale;
};

// the per-tensor tables, or seg_end null: every tensor takes the block's
// lr and decay
struct Tables {
  const long long* seg_end;  // (n_seg) end of each slice in the flat buffers
  const float* scale;        // (n_seg) lr scale
  const float* decays;       // (n_seg) 1: decays, 0: does not
  int n_seg;
  long long base;            // flat index of element 0 of this launch
};

struct NoParam {};  // the parameter is the master itself (fp32 models)

__device__ __forceinline__ void load8(const float* __restrict__ p, long i,
                                      float (&x)[PER]) {
  const float4 a = *reinterpret_cast<const float4*>(p + i);
  const float4 b = *reinterpret_cast<const float4*>(p + i + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      long i, float (&x)[PER]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p + i);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const __half* __restrict__ p, long i,
                                      float (&x)[PER]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p + i);
  const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __half22float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* __restrict__ p, long i,
                                       const float (&x)[PER]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + i + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ p, long i,
                                       const float (&x)[PER]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8(__half* __restrict__ p, long i,
                                       const float (&x)[PER]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __half2 h = __floats2half2_rn(x[2 * j], x[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8(NoParam*, long, const float (&)[PER]) {}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void put(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put(__half* p, long i, float x) { p[i] = __float2half_rn(x); }
__device__ __forceinline__ void put(NoParam*, long, float) {}

struct Step {
  float lr, decay, c1, c2, gs;
};

__device__ __forceinline__ Step step_scalars(const float* __restrict__ dsc) {
  return Step{dsc[SC_LR], dsc[SC_DECAY], dsc[SC_C1], dsc[SC_C2], dsc[SC_GSCALE]};
}

// the step's scalars for flat element i: the tensor's own lr and decay
// where there are tables (has_wd false: the tensor does not decay)
__device__ __forceinline__ Step tensor_scalars(Step st, const Tables& tb,
                                               long i, const Consts& k,
                                               int& has_wd) {
  if (tb.seg_end == nullptr) return st;
  const long long gi = tb.base + i;
  int lo = 0, hi = tb.n_seg - 1;
  while (lo < hi) {  // first slice whose end lies past gi
    const int mid = (lo + hi) >> 1;
    if (tb.seg_end[mid] > gi) hi = mid; else lo = mid + 1;
  }
  st.lr = __fmul_rn(st.lr, tb.scale[lo]);
  has_wd = has_wd && tb.decays[lo] != 0.f;
  if (has_wd) st.decay = __fsub_rn(1.f, __fmul_rn(st.lr, k.wd));
  return st;
}

// one element: m, v and master in place, the new master returned
__device__ __forceinline__ float adam_elem(float g, float& m, float& v,
                                           float master, const Step& st,
                                           const Consts& k, int has_wd) {
  if (k.clip_value) g = g < k.lo ? k.lo : (g > k.hi ? k.hi : g);
  if (k.grad_scale) g = __fmul_rn(g, st.gs);
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  const float mh = __fdiv_rn(m, st.c1);
  const float vh = __fdiv_rn(v, st.c2);
  const float u = has_wd ? __fmul_rn(master, st.decay) : master;
  return __fsub_rn(u, __fdiv_rn(__fmul_rn(st.lr, mh),
                                __fadd_rn(__fsqrt_rn(vh), k.eps)));
}

template <typename TP, typename TG>
__global__ void __launch_bounds__(THREADS)
multi_tensor_adam_kernel(float* __restrict__ master, float* __restrict__ m,
                         float* __restrict__ v, TP* __restrict__ param,
                         const TG* __restrict__ grad, long n,
                         const float* __restrict__ dsc, Consts k, Tables tb) {
  const long i0 = ((long)blockIdx.x * THREADS + threadIdx.x) * PER;
  if (i0 >= n) return;
  if (i0 + PER <= n) {
    float g[PER], p[PER], mm[PER], vv[PER];
    load8(grad, i0, g);
    load8(master, i0, p);
    load8(m, i0, mm);
    load8(v, i0, vv);
    // the step's scalars, read while the data loads are in flight
    if (dsc[SC_GATE] == 0.f) return;  // the step is withheld: write nothing
    int has_wd = k.has_wd;
    const Step st = tensor_scalars(step_scalars(dsc), tb, i0, k, has_wd);
#pragma unroll
    for (int e = 0; e < PER; ++e)
      p[e] = adam_elem(g[e], mm[e], vv[e], p[e], st, k, has_wd);
    store8(m, i0, mm);
    store8(v, i0, vv);
    store8(master, i0, p);
    store8(param, i0, p);
    return;
  }
  if (dsc[SC_GATE] == 0.f) return;
  for (long i = i0; i < n; ++i) {  // the ragged tail
    int has_wd = k.has_wd;
    const Step st = tensor_scalars(step_scalars(dsc), tb, i, k, has_wd);
    float mm = m[i], vv = v[i];
    const float p = adam_elem(to_f32(grad[i]), mm, vv, master[i], st, k, has_wd);
    m[i] = mm;
    v[i] = vv;
    master[i] = p;
    put(param, i, p);
  }
}

template <typename TP, typename TG>
cudaError_t launch(void* master, void* m, void* v, void* param,
                   const void* grad, long n, const float* dsc,
                   const Consts& k, const Tables& tb, cudaStream_t s) {
  const long per_block = (long)THREADS * PER;
  const long blocks = (n + per_block - 1) / per_block;
  multi_tensor_adam_kernel<TP, TG><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<float*>(master), static_cast<float*>(m),
      static_cast<float*>(v), static_cast<TP*>(param),
      static_cast<const TG*>(grad), n, dsc, k, tb);
  return cudaGetLastError();
}

template <typename TP>
cudaError_t launch_grad(int grad_dtype, void* master, void* m, void* v,
                        void* param, const void* grad, long n,
                        const float* dsc, const Consts& k, const Tables& tb,
                        cudaStream_t s) {
  if (grad_dtype == 0)
    return launch<TP, float>(master, m, v, param, grad, n, dsc, k, tb, s);
  if (grad_dtype == 1)
    return launch<TP, __nv_bfloat16>(master, m, v, param, grad, n, dsc, k, tb, s);
  return launch<TP, __half>(master, m, v, param, grad, n, dsc, k, tb, s);
}

}  // namespace

// master, m, v fp32 (n,); grad (n,) fp32 (grad_dtype 0), bf16 (1) or fp16
// (2); param (n,) fp32 (param_dtype 0), bf16 (1) or fp16 (2), or none (-1:
// the parameters are views of the master). scalars points to 6 fp32 on the
// device: lr, decay = 1 - lr * wd (used if has_wd), c1, c2, the gate (0:
// write nothing) and
// the global-norm scale (used if grad_scale). clip_value clips g to [lo,
// hi] first. omb1 = 1 - b1, omb2 = 1 - b2, rounded to fp32 by the caller.
// seg_end (n_seg int64, the flat end of each tensor's slice), scale and
// decays (n_seg fp32) are the per-tensor tables, or seg_end null; base is
// the flat index of this launch's element 0 and wd the decay coefficient
// the tables' decay uses. Every pointer 16-byte aligned. Returns a
// cudaError_t (0 on success).
extern "C" int multi_tensor_adam(void* master, void* m, void* v, void* param,
                                 const void* grad, long long n, int param_dtype,
                                 int grad_dtype, const void* scalars, float eps,
                                 float b1, float b2, float omb1, float omb2,
                                 int has_wd, int grad_scale, int clip_value,
                                 float lo, float hi, const void* seg_end,
                                 const void* scale, const void* decays,
                                 int n_seg, long long base, float wd,
                                 void* stream) {
  if (n <= 0 || param_dtype < -1 || param_dtype > 2 || grad_dtype < 0 ||
      grad_dtype > 2 || (seg_end != nullptr && n_seg <= 0))
    return (int)cudaErrorInvalidValue;
  const Consts k{eps, b1, b2, omb1, omb2, lo, hi, wd, has_wd, clip_value,
                 grad_scale};
  const Tables tb{static_cast<const long long*>(seg_end),
                  static_cast<const float*>(scale),
                  static_cast<const float*>(decays), n_seg, base};
  const float* dsc = static_cast<const float*>(scalars);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (param_dtype == -1)
    return (int)launch_grad<NoParam>(grad_dtype, master, m, v, param, grad, n, dsc, k, tb, s);
  if (param_dtype == 0)
    return (int)launch_grad<float>(grad_dtype, master, m, v, param, grad, n, dsc, k, tb, s);
  if (param_dtype == 1)
    return (int)launch_grad<__nv_bfloat16>(grad_dtype, master, m, v, param, grad, n, dsc, k, tb, s);
  return (int)launch_grad<__half>(grad_dtype, master, m, v, param, grad, n, dsc, k, tb, s);
}
