// Paged decode attention for Hopper (sm_90a): the port of
// paddle_tpu/ops/paged_attention.py::_decode_kernel (launched from
// _kernel_call), the kernel every serving decode step runs once per layer.
//
// What it computes, for one layer: each batch row b attends its slot's
// cached positions [0, t[b]) read through its page-table row, plus the
// current token (k_new, v_new) at position t[b], which joins the softmax
// unquantized. Pool (P, L, 2, Hkv, ps, D) in float32, bfloat16 or int8; the
// int8 leg multiplies each page by its (page, layer, K/V, head) scale
// (scales (P, L, 2, Hkv) fp32). Online softmax in fp32; out (B, H, D) in
// q's dtype. With t[b] == 0 the output is exactly v_new.
//
// What bounds it on an H100: memory. Each live K/V element is read once and
// used for 2 * rep operations (rep = H / Hkv), far below the ~295 operations
// per byte at which bf16 tensor cores would become the limit, so the bound
// is live K/V bytes over 3.35 TB/s. Design: one block per (batch row, kv
// head), serving all rep query heads of that kv head, so each page is read
// from device memory once however many query heads share it (the TPU grid
// walked one q head per program). The block loads its own table row, t and
// layer, walks only the live pages (s * ps < t) and only the live positions
// inside the last one. Each page's K and V rows are copied into shared
// memory with 16-byte cp.async copies, double-buffered so the next page is
// in flight while this one is computed (a block's pages are sequential, so
// the longest row's page count times the per-page latency is the critical
// path). Warps split a page's positions for the q.k dot products (one lane
// per D/32 elements, shuffle reduction); one warp per q head updates the
// running max and sum; each thread owns one of the D output columns for
// the p.V accumulation. Dead pages are never touched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads per block
constexpr int NW = NT / 32;  // warps
constexpr int MAXREP = 8;    // query heads per kv head
constexpr int MAXPS = 256;   // positions per page
// dynamic shared memory for the staged pages, next to the 8.3 KB static
constexpr size_t MAX_DYN_SMEM = 192 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename TQ, typename TP, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                    const TQ* __restrict__ v_new, const TP* __restrict__ pool,
                    const float* __restrict__ scales,
                    const int* __restrict__ tables, const int* __restrict__ t,
                    TQ* __restrict__ out, int H, int Hkv, int L, int ps, int S,
                    int layer, float sm_scale) {
  constexpr int PER = D / 32;  // q/k elements per lane
  __shared__ float s_p[MAXREP][MAXPS];  // logits, then probabilities
  __shared__ float s_m[MAXREP], s_l[MAXREP], s_alpha[MAXREP], s_pt[MAXREP];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int rep = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int tb = t[b];
  const int* row = tables + (long)b * S;

  float qr[MAXREP][PER];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int i = 0; i < PER; ++i)
      qr[r][i] = r < rep
          ? to_f(q[((long)b * H + kvh * rep + r) * D + lane * PER + i]) * sm_scale
          : 0.f;
  if (tid < rep) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  __syncthreads();
  float acc[MAXREP];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) acc[r] = 0.f;

  // two buffers of one page's K and V rows, in storage type: the next
  // page's copy is in flight while this page is computed
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TP* kv_s = reinterpret_cast<TP*>(smem_raw);
  const long page_elems = (long)ps * D;
  const int npages = min((tb + ps - 1) / ps, S);
  auto stage = [&](int s) {
    const long pid = row[s];
    const int nvalid = min(ps, tb - s * ps);
    const long kbase = ((pid * L + layer) * 2 + 0) * Hkv + kvh;
    const char* gk = reinterpret_cast<const char*>(pool + kbase * page_elems);
    const char* gv = reinterpret_cast<const char*>(pool + (kbase + Hkv) * page_elems);
    char* sk = reinterpret_cast<char*>(kv_s + (s & 1) * 2 * page_elems);
    char* sv = sk + page_elems * sizeof(TP);
    const int chunks = nvalid * D * (int)sizeof(TP) / 16;
    for (int i = tid; i < chunks; i += NT) {
      cp_async16(sk + 16 * i, gk + 16 * i);
      cp_async16(sv + 16 * i, gv + 16 * i);
    }
    cp_async_commit();
  };
  if (npages > 0) stage(0);
  for (int s = 0; s < npages; ++s) {
    const long pid = row[s];
    const int nvalid = min(ps, tb - s * ps);
    const long kbase = ((pid * L + layer) * 2 + 0) * Hkv + kvh;  // (page, layer, K, head)
    const long vbase = kbase + Hkv;                              // (page, layer, V, head)
    const float ks = scales ? scales[kbase] : 1.f;
    const float vs = scales ? scales[vbase] : 1.f;
    if (s + 1 < npages) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const TP* kp = kv_s + (s & 1) * 2 * page_elems;
    const TP* vp = kp + page_elems;

    for (int pos = w; pos < nvalid; pos += NW) {
      float kk[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) kk[i] = to_f(kp[pos * D + lane * PER + i]) * ks;
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        if (r < rep) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < PER; ++i) dot = fmaf(qr[r][i], kk[i], dot);
          dot = warp_sum(dot);
          if (lane == 0) s_p[r][pos] = dot;
        }
      }
    }
    __syncthreads();

    for (int r = w; r < rep; r += NW) {
      float mx = -INFINITY;
      for (int pos = lane; pos < nvalid; pos += 32) mx = fmaxf(mx, s_p[r][pos]);
      mx = warp_max(mx);
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int pos = lane; pos < nvalid; pos += 32) {
        const float p = expf(s_p[r][pos] - m_new);
        s_p[r][pos] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        s_alpha[r] = alpha;
        s_l[r] = alpha * s_l[r] + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int r = 0; r < MAXREP; ++r)
        if (r < rep) acc[r] *= s_alpha[r];
#pragma unroll 4
      for (int pos = 0; pos < nvalid; ++pos) {
        const float vv = to_f(vp[pos * D + tid]) * vs;
#pragma unroll
        for (int r = 0; r < MAXREP; ++r)
          if (r < rep) acc[r] = fmaf(s_p[r][pos], vv, acc[r]);
      }
    }
    __syncthreads();
  }

  // position t: the current token, unquantized
  if (w == 0) {
    float kk[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i)
      kk[i] = to_f(k_new[((long)b * Hkv + kvh) * D + lane * PER + i]);
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r < rep) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) dot = fmaf(qr[r][i], kk[i], dot);
        dot = warp_sum(dot);
        if (lane == 0) {
          const float m_old = s_m[r];
          const float m_new = fmaxf(m_old, dot);
          const float alpha = expf(m_old - m_new);
          const float pt = expf(dot - m_new);
          s_alpha[r] = alpha;
          s_pt[r] = pt;
          s_l[r] = alpha * s_l[r] + pt;
        }
      }
    }
  }
  __syncthreads();
  if (tid < D) {
    const float vn = to_f(v_new[((long)b * Hkv + kvh) * D + tid]);
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r < rep) {
        const float o = (s_alpha[r] * acc[r] + s_pt[r] * vn) / fmaxf(s_l[r], 1e-30f);
        out[((long)b * H + kvh * rep + r) * D + tid] = from_f<TQ>(o);
      }
    }
  }
}

template <typename TQ, typename TP, int D>
cudaError_t launch(const void* q, const void* kn, const void* vn,
                   const void* pool, const float* scales, const int* tables,
                   const int* t, void* out, int B, int H, int Hkv, int L,
                   int ps, int S, int layer, float sm_scale,
                   cudaStream_t stream) {
  auto kern = paged_decode_kernel<TQ, TP, D>;
  const size_t smem = 4ull * ps * D * sizeof(TP);  // 2 buffers x (K, V)
  if (smem > MAX_DYN_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hkv);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kn),
      static_cast<const TQ*>(vn), static_cast<const TP*>(pool), scales,
      tables, t, static_cast<TQ*>(out), H, Hkv, L, ps, S, layer, sm_scale);
  return cudaGetLastError();
}

template <typename TQ, int D>
cudaError_t dispatch_pool(int pool_dtype, const void* q, const void* kn,
                          const void* vn, const void* pool,
                          const float* scales, const int* tables, const int* t,
                          void* out, int B, int H, int Hkv, int L, int ps,
                          int S, int layer, float sm_scale,
                          cudaStream_t stream) {
  switch (pool_dtype) {
    case 0:
      return launch<TQ, float, D>(q, kn, vn, pool, scales, tables, t, out, B,
                                  H, Hkv, L, ps, S, layer, sm_scale, stream);
    case 1:
      return launch<TQ, __nv_bfloat16, D>(q, kn, vn, pool, scales, tables, t,
                                          out, B, H, Hkv, L, ps, S, layer,
                                          sm_scale, stream);
    case 2:
      return launch<TQ, int8_t, D>(q, kn, vn, pool, scales, tables, t, out, B,
                                   H, Hkv, L, ps, S, layer, sm_scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new and out share it).
// pool_dtype: 0 = float32, 1 = bfloat16, 2 = int8 (then scales is required).
// Returns a cudaError_t (0 on success).
extern "C" int paged_decode(const void* q, const void* k_new,
                            const void* v_new, const void* pool,
                            const void* scales, const void* tables,
                            const void* t, void* out, int B, int H, int Hkv,
                            int D, int L, int ps, int S, int layer,
                            int q_dtype, int pool_dtype, float sm_scale,
                            void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAXREP || ps <= 0 ||
      ps > MAXPS || layer < 0 || layer >= L || (pool_dtype == 2) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const int* tab = static_cast<const int*>(tables);
  const int* tt = static_cast<const int*>(t);
  if (q_dtype == 0 && D == 128)
    return (int)dispatch_pool<float, 128>(pool_dtype, q, k_new, v_new, pool, sc, tab, tt, out,
                                          B, H, Hkv, L, ps, S, layer, sm_scale, s);
  if (q_dtype == 0 && D == 64)
    return (int)dispatch_pool<float, 64>(pool_dtype, q, k_new, v_new, pool, sc, tab, tt, out,
                                         B, H, Hkv, L, ps, S, layer, sm_scale, s);
  if (q_dtype == 1 && D == 128)
    return (int)dispatch_pool<__nv_bfloat16, 128>(pool_dtype, q, k_new, v_new, pool, sc, tab,
                                                  tt, out, B, H, Hkv, L, ps, S, layer,
                                                  sm_scale, s);
  if (q_dtype == 1 && D == 64)
    return (int)dispatch_pool<__nv_bfloat16, 64>(pool_dtype, q, k_new, v_new, pool, sc, tab,
                                                 tt, out, B, H, Hkv, L, ps, S, layer,
                                                 sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
