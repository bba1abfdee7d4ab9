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
// What bounds it on an H100: bytes. Each live K/V element is read once and
// used for 2 * rep operations (rep = H / Hkv), far below the ~295
// operations per byte at which the tensor cores would become the limit, so
// the bound is live K/V bytes over 3.35 TB/s. The kernel's design is about
// keeping enough of those bytes in flight on every SM, whatever the rows'
// lengths ("flash-decoding"):
//
// - Split the rows' pages across blocks. paged_decode_split_kernel runs a
//   block per (batch row, kv head) and chunk of `pps` pages (grid
//   (B * Hkv, nsplit)); the host picks pps from the table width and B * Hkv
//   only, never from t, so the launch needs no sync. A block serves all rep
//   query heads of its kv head, so each page is read once however many
//   heads share it. A split whose first page is past t[b] exits at once;
//   the combine derives the live splits from t[b] and never reads its
//   partial. One long row thus becomes many short blocks instead of one
//   block whose page walk sets the kernel's time.
// - Copies without thread work. One head's K (or V) page of one layer is
//   one contiguous run of ps * D * item bytes, so one producer thread
//   issues one cp.async.bulk per page and K/V into a ring of stages in
//   shared memory, counted in bytes on the stage's `full` mbarrier (only
//   the page's live rows: nvalid * D * item, a multiple of 16). The ring
//   keeps the split's next pages in flight while the consumer warps compute.
// - No block barrier per page. Four consumer warps own positions: a
//   position's row is read by D * item / 16 lanes with 16-byte (int8: 8-byte)
//   shared-memory loads, so a warp takes one to four positions a step. q
//   for all rep heads lives in registers (pre-scaled by 1/sqrt(D) * log2 e:
//   the softmax runs on exp2). Each lane keeps its own running max, sum and
//   accumulator for its columns; int8 pages are converted without I2F and
//   scaled in registers (the K scale on the logit, the V scale on the
//   probability). A warp releases
//   a stage on its `empty` mbarrier; the warps meet once, at the end of the
//   split, to merge through shared memory and write the split's fp32
//   partial (m, l, o[D]) of each q head to scratch (B, H, nsplit, D + 2).
//   At rep up to 8 the products stay on the CUDA cores: even at rep 8 a
//   position costs about 2 * rep * D * 2 operations for D * item * 2 bytes,
//   within the issue rate the byte stream leaves (mma.sync would need q
//   padded to 16 rows and the probabilities re-laid between its two
//   products).
//
// paged_decode_combine_kernel, a block per (batch row, kv head), folds the
// row's live splits in split order (so repeated launches agree bit for bit),
// then the current token, as the JAX _finish step does, and writes out in
// q's dtype. With no live split (t == 0) it computes v_new * 1 / 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NCW = 4;                   // consumer warps
constexpr int NT = (NCW + 1) * 32;       // and one producer warp
constexpr int NT_COMBINE = 128;
constexpr int MAXREP = 8;                // query heads per kv head
constexpr int MAXPS = 256;               // positions per page
constexpr int MAX_STAGES = 4;
constexpr size_t RING_BUDGET = 64 * 1024;  // ring bytes a block aims at
constexpr size_t MAX_DYN_SMEM = 227 * 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// elements a lane reads from a row with one shared-memory load
template <typename TP> struct Lane { static constexpr int EPL = 8; };
template <> struct Lane<float> { static constexpr int EPL = 4; };

__device__ __forceinline__ void load_row(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// float(c) = (2^23 + c + 128) - (2^23 + 128), exactly: the biased byte
// permuted into 2^23's mantissa, then one subtraction (no quarter-rate I2F)
__device__ __forceinline__ void load_row(const int8_t* p, float (&x)[8]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {a.x ^ 0x80808080u, a.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7540 + i % 4)) - 8388736.f;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Wait until the phase of parity `phase` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(phase) : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <typename TP, int D, int REPB>
__global__ void __launch_bounds__(NT)
paged_decode_split_kernel(const void* __restrict__ q, int q_bf16,
                          const TP* __restrict__ pool,
                          const float* __restrict__ scales,
                          const int* __restrict__ tables,
                          const int* __restrict__ t, float* __restrict__ part,
                          int H, int Hkv, int L, int ps, int S, int layer,
                          int pps, int nstage, float qscale) {
  constexpr int EPL = Lane<TP>::EPL;
  constexpr int LPR = D / EPL;    // lanes per position: 8, 16 or 32
  constexpr int RPW = 32 / LPR;   // positions per warp and step
  constexpr int G = NCW * RPW;    // positions per block and step
  constexpr int W = D + 2;        // a partial: m, l, o[D]

  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int rep = H / Hkv;
  const int tb = t[b];
  const int p0 = split * pps;
  const int np = min(pps, min((tb + ps - 1) / ps, S) - p0);
  if (np <= 0) return;  // a dead split: the combine never reads its partial
  const int* row = tables + (long)b * S + p0;

  // ring: stage s holds a K page, then a V page; then the warps' merge
  // area (NCW, REPB, W) fp32; then nstage `full` and nstage `empty` barriers
  extern __shared__ __align__(16) unsigned char smem[];
  const int page_elems = ps * D;
  const TP* ring = reinterpret_cast<const TP*>(smem);
  float* mrg = reinterpret_cast<float*>(smem + 2ull * nstage * page_elems * sizeof(TP));
  const uint32_t bar0 = smem_u32(mrg + NCW * REPB * W);
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (nstage + s); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nstage; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCW) {
    // producer: one thread copies the split's pages, live rows only
    if (lane == 0) {
      for (int i = 0; i < np; ++i) {
        const int s = i % nstage;
        mbar_wait(empty(s), ((i / nstage) & 1) ^ 1);  // first pass: free
        const long kbase = (((long)row[i] * L + layer) * 2) * Hkv + kvh;
        const uint32_t bytes = min(ps, tb - (p0 + i) * ps) * D * (uint32_t)sizeof(TP);
        const uint32_t dst = smem_u32(ring + 2 * s * page_elems);
        mbar_expect_tx(full(s), 2 * bytes);
        bulk_copy(dst, pool + kbase * page_elems, bytes, full(s));
        bulk_copy(dst + page_elems * (uint32_t)sizeof(TP),
                  pool + (kbase + Hkv) * page_elems, bytes, full(s));
      }
    }
    return;
  }

  const int grp = lane / LPR, col = (lane % LPR) * EPL;
  float qr[REPB][EPL], m[REPB], l[REPB], acc[REPB][EPL];
#pragma unroll
  for (int r = 0; r < REPB; ++r) {
    const long qo = ((long)b * H + kvh * rep + min(r, rep - 1)) * D + col;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float x = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[qo + e])
                             : static_cast<const float*>(q)[qo + e];
      qr[r][e] = x * qscale;
      acc[r][e] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int i = 0; i < np; ++i) {
    const int s = i % nstage;
    const int nvalid = min(ps, tb - (p0 + i) * ps);
    float ks = 1.f, vs = 1.f;
    if (scales != nullptr) {
      const long kbase = (((long)row[i] * L + layer) * 2) * Hkv + kvh;
      ks = scales[kbase];
      vs = scales[kbase + Hkv];
    }
    mbar_wait(full(s), (i / nstage) & 1);
    const TP* kp = ring + 2 * s * page_elems;
    const TP* vp = kp + page_elems;
    for (int r0 = warp * RPW; r0 < nvalid; r0 += G) {  // warp-uniform
      const int pos = r0 + grp;
      const bool ok = pos < nvalid;
      float kk[EPL], vv[EPL];
      if (ok) {
        load_row(kp + pos * D + col, kk);
        load_row(vp + pos * D + col, vv);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kk[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < REPB; ++r) {
        if (r < rep) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot = fmaf(qr[r][e], kk[e], dot);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(FULL, dot, off);
          if (ok) {
            const float sc = dot * ks;
            const float mn = fmaxf(m[r], sc);
            const float a = exp2f(m[r] - mn);  // 0 while m is -inf
            const float p = exp2f(sc - mn);
            l[r] = fmaf(l[r], a, p);
            const float pv = p * vs;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(acc[r][e], a, pv * vv[e]);
            m[r] = mn;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // merge the warp's position groups (lanes LPR apart hold the same columns)
#pragma unroll
  for (int r = 0; r < REPB; ++r) {
    if (r < rep) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) {
        const float mo = __shfl_xor_sync(FULL, m[r], off);
        const float lo = __shfl_xor_sync(FULL, l[r], off);
        const float mn = fmaxf(m[r], mo);
        const float a = m[r] == -INFINITY ? 0.f : exp2f(m[r] - mn);
        const float ao = mo == -INFINITY ? 0.f : exp2f(mo - mn);
        l[r] = l[r] * a + lo * ao;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float x = __shfl_xor_sync(FULL, acc[r][e], off);
          acc[r][e] = acc[r][e] * a + x * ao;
        }
        m[r] = mn;
      }
    }
  }
  if (grp == 0) {
    float* mw = mrg + warp * REPB * W;
#pragma unroll
    for (int r = 0; r < REPB; ++r) {
      if (r < rep) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) mw[r * W + 2 + col + e] = acc[r][e];
        if (lane == 0) {
          mw[r * W] = m[r];
          mw[r * W + 1] = l[r];
        }
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(NCW * 32) : "memory");  // consumers only

  // the split's partial of each q head: m = the warps' max, l and o their
  // rescaled sums, warps in order
  for (int idx = threadIdx.x; idx < rep * W; idx += NCW * 32) {
    const int r = idx / W, c = idx % W;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NCW; ++w) mx = fmaxf(mx, mrg[(w * REPB + r) * W]);
    float val = mx;
    if (c > 0) {
      val = 0.f;
#pragma unroll
      for (int w = 0; w < NCW; ++w) {
        const float mw = mrg[(w * REPB + r) * W];
        if (mw != -INFINITY) val = fmaf(exp2f(mw - mx), mrg[(w * REPB + r) * W + c], val);
      }
    }
    part[(((long)b * H + kvh * rep + r) * nsplit + split) * W + c] = val;
  }
}

template <typename TQ, int D>
__global__ void __launch_bounds__(NT_COMBINE)
paged_decode_combine_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                            const TQ* __restrict__ v_new,
                            const float* __restrict__ part,
                            const int* __restrict__ t, TQ* __restrict__ out,
                            int H, int Hkv, int ps, int S, int pps, int nsplit,
                            float qscale) {
  constexpr int PER = D / 32;
  constexpr int W = D + 2;
  __shared__ float s_t[MAXREP];  // the current token's logit, log2 units
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int rep = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long kvo = ((long)b * Hkv + kvh) * D;
  for (int r = warp; r < rep; r += NT_COMBINE / 32) {
    const long qo = ((long)b * H + kvh * rep + r) * D;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      dot = fmaf(to_f(q[qo + lane * PER + i]), to_f(k_new[kvo + lane * PER + i]), dot);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
    if (lane == 0) s_t[r] = dot * qscale;
  }
  __syncthreads();
  const int live = min((t[b] + ps - 1) / ps, S);
  const int nlive = (live + pps - 1) / pps;  // the splits that wrote a partial
  for (int idx = threadIdx.x; idx < rep * D; idx += NT_COMBINE) {
    const int r = idx / D, c = idx % D;
    const long h = (long)b * H + kvh * rep + r;
    const float* pr = part + h * nsplit * W;
    float mx = s_t[r];
    for (int sp = 0; sp < nlive; ++sp) mx = fmaxf(mx, pr[sp * W]);
    float num = 0.f, den = 0.f;
    for (int sp = 0; sp < nlive; ++sp) {
      const float* pp = pr + sp * W;
      const float a = exp2f(pp[0] - mx);
      den = fmaf(a, pp[1], den);
      num = fmaf(a, pp[2 + c], num);
    }
    const float at = exp2f(s_t[r] - mx);
    den += at;
    num = fmaf(at, to_f(v_new[kvo + c]), num);
    out[h * D + c] = from_f<TQ>(num / den);
  }
}

template <typename TP, int D, int REPB>
cudaError_t launch_split(const void* q, int q_bf16, const void* pool,
                         const float* scales, const int* tables, const int* t,
                         float* part, int B, int H, int Hkv, int L, int ps,
                         int S, int layer, int pps, int nsplit, float qscale,
                         cudaStream_t stream) {
  auto kern = paged_decode_split_kernel<TP, D, REPB>;
  const size_t stage = 2ull * ps * D * sizeof(TP);  // a K and a V page
  const int nstage = (int)std::min<size_t>(
      std::min<size_t>(MAX_STAGES, pps), std::max<size_t>(2, RING_BUDGET / stage));
  const size_t smem = nstage * stage + sizeof(float) * NCW * REPB * (D + 2) + 16ull * nstage;
  if (smem > MAX_DYN_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(B * Hkv, nsplit), NT, smem, stream>>>(
      q, q_bf16, static_cast<const TP*>(pool), scales, tables, t, part, H,
      Hkv, L, ps, S, layer, pps, nstage, qscale);
  return cudaGetLastError();
}

template <typename TP, int D>
cudaError_t dispatch_rep(int rep, const void* q, int q_bf16, const void* pool,
                         const float* scales, const int* tables, const int* t,
                         float* part, int B, int H, int Hkv, int L, int ps,
                         int S, int layer, int pps, int nsplit, float qscale,
                         cudaStream_t s) {
#define PAGED_SPLIT(REPB)                                                       \
  launch_split<TP, D, REPB>(q, q_bf16, pool, scales, tables, t, part, B, H, Hkv, \
                            L, ps, S, layer, pps, nsplit, qscale, s)
  if (rep == 1) return PAGED_SPLIT(1);
  if (rep == 2) return PAGED_SPLIT(2);
  if (rep <= 4) return PAGED_SPLIT(4);
  return PAGED_SPLIT(8);
#undef PAGED_SPLIT
}

template <int D>
cudaError_t dispatch_pool(int pool_dtype, int rep, const void* q, int q_bf16,
                          const void* pool, const float* scales,
                          const int* tables, const int* t, float* part, int B,
                          int H, int Hkv, int L, int ps, int S, int layer,
                          int pps, int nsplit, float qscale, cudaStream_t s) {
  switch (pool_dtype) {
    case 0:
      return dispatch_rep<float, D>(rep, q, q_bf16, pool, scales, tables, t, part, B, H,
                                    Hkv, L, ps, S, layer, pps, nsplit, qscale, s);
    case 1:
      return dispatch_rep<__nv_bfloat16, D>(rep, q, q_bf16, pool, scales, tables, t, part,
                                            B, H, Hkv, L, ps, S, layer, pps, nsplit,
                                            qscale, s);
    case 2:
      return dispatch_rep<int8_t, D>(rep, q, q_bf16, pool, scales, tables, t, part, B, H,
                                     Hkv, L, ps, S, layer, pps, nsplit, qscale, s);
  }
  return cudaErrorInvalidValue;
}

template <typename TQ, int D>
cudaError_t launch_combine(const void* q, const void* kn, const void* vn,
                           const float* part, const int* t, void* out, int B,
                           int H, int Hkv, int ps, int S, int pps, int nsplit,
                           float qscale, cudaStream_t stream) {
  paged_decode_combine_kernel<TQ, D><<<B * Hkv, NT_COMBINE, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kn),
      static_cast<const TQ*>(vn), part, t, static_cast<TQ*>(out), H, Hkv, ps,
      S, pps, nsplit, qscale);
  return cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new and out share it).
// pool_dtype: 0 = float32, 1 = bfloat16, 2 = int8 (then scales is required).
// part: fp32 scratch of B * H * nsplit * (D + 2) floats, nsplit =
// ceil(S / pps). Launches the split kernel, then the combine, on `stream`.
// Returns a cudaError_t (0 on success).
extern "C" int paged_decode(const void* q, const void* k_new,
                            const void* v_new, const void* pool,
                            const void* scales, const void* tables,
                            const void* t, void* part, void* out, int B, int H,
                            int Hkv, int D, int L, int ps, int S, int layer,
                            int pps, int nsplit, int q_dtype, int pool_dtype,
                            float sm_scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAXREP || ps <= 0 ||
      ps > MAXPS || S <= 0 || layer < 0 || layer >= L || pps <= 0 ||
      nsplit != (S + pps - 1) / pps || nsplit > 65535 || (q_dtype != 0 && q_dtype != 1) ||
      (D != 64 && D != 128) || (pool_dtype == 2) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const int* tab = static_cast<const int*>(tables);
  const int* tt = static_cast<const int*>(t);
  float* pt = static_cast<float*>(part);
  const float qscale = sm_scale * LOG2E;
  const int rep = H / Hkv;
  cudaError_t err =
      D == 128 ? dispatch_pool<128>(pool_dtype, rep, q, q_dtype, pool, sc, tab, tt, pt, B, H,
                                    Hkv, L, ps, S, layer, pps, nsplit, qscale, s)
               : dispatch_pool<64>(pool_dtype, rep, q, q_dtype, pool, sc, tab, tt, pt, B, H,
                                   Hkv, L, ps, S, layer, pps, nsplit, qscale, s);
  if (err != cudaSuccess) return (int)err;
  if (q_dtype == 0)
    err = D == 128 ? launch_combine<float, 128>(q, k_new, v_new, pt, tt, out, B, H, Hkv, ps,
                                                S, pps, nsplit, qscale, s)
                   : launch_combine<float, 64>(q, k_new, v_new, pt, tt, out, B, H, Hkv, ps,
                                               S, pps, nsplit, qscale, s);
  else
    err = D == 128 ? launch_combine<__nv_bfloat16, 128>(q, k_new, v_new, pt, tt, out, B, H,
                                                        Hkv, ps, S, pps, nsplit, qscale, s)
                   : launch_combine<__nv_bfloat16, 64>(q, k_new, v_new, pt, tt, out, B, H,
                                                       Hkv, ps, S, pps, nsplit, qscale, s);
  return (int)err;
}
