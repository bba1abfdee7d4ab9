// Variants of K2 (csrc/rope.cu) that the shipped kernel chose against,
// built beside it by tools/ab_rope_swiglu_variants.py to measure each
// choice on the card; nothing else builds or calls them. The file includes
// the shipped source, so every variant shares its helpers, arguments and
// launch plan, and computes the same bits:
// - k2_any: the kernel with every dtype code read at run time (RopeAny),
//   in place of the instantiations with the O2, serving or fp32 codes
//   fixed;
// - k2_unr2: two heads a lane at a time (four 16-byte loads in flight),
//   in place of UNR = 1;
// - k2_bulk: each warp's item (its position's heads, every tensor's run of
//   them contiguous) copied into shared memory by one cp.async.bulk a run
//   on the warp's mbarrier, then turned from there, in place of each
//   lane's own 16-byte loads (16-byte vectors only).
// Each entry takes rope()'s arguments.

#include "rope.cu"

namespace {

enum { ANY = 0, UNR2 = 1, BULK = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int V, int BWD, int HALF, class Dt>
__global__ void __launch_bounds__(THREADS, 1) rope_bulk_kernel(RopeArgs args) {
  const RopeArgs a = fixed<Dt>(args);
  extern __shared__ float4 bulk_sh[];
  __shared__ uint64_t bars[THREADS / 32];
  const unsigned warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned item = blockIdx.x * (THREADS / 32) + warp;
  if (item >= a.items) return;
  const unsigned es = a.in_dt == F32 ? 4 : 2;
  unsigned char* buf = reinterpret_cast<unsigned char*>(bulk_sh) +
                       (size_t)warp * a.heads_per_part * a.D * es;
  const unsigned bl = item / a.parts;
  const unsigned first = (item - bl * a.parts) * a.heads_per_part;
  const unsigned all = a.heads[0] + a.heads[1] + a.heads[2];
  const unsigned end =
      first + a.heads_per_part < all ? first + a.heads_per_part : all;
  const uint32_t bar = smem_u32(&bars[warp]);
  if (lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, (end - first) * a.D * es);
    unsigned h = first, lo = 0;
    uint32_t off = 0;
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const unsigned hi = lo + a.heads[w];
      if (h < end && h < hi) {
        const unsigned n = (end < hi ? end : hi) - h;
        const unsigned char* src =
            static_cast<const unsigned char*>(a.in[w]) +
            (size_t)((bl * a.heads[w] + (h - lo)) * a.D) * es;
        bulk_copy(smem_u32(buf + off), src, n * a.D * es, bar);
        off += n * a.D * es;
        h += n;
      }
      lo = hi;
    }
  }
  __syncwarp();
  const unsigned slot = lane / a.lph, sub = lane - slot * a.lph;
  long long pos;
  if (a.pos == nullptr)
    pos = a.offset + bl % (unsigned)a.L;
  else
    pos = a.pos_dt == 0 ? (long long)static_cast<const int*>(a.pos)[bl]
                        : static_cast<const long long*>(a.pos)[bl];
  const long long cs = pos * a.cs_stride;
  mbar_wait(bar, 0);
  if (slot >= a.hpw) return;
  for (unsigned c = sub; c < a.cph; c += a.lph) {
    const int p0 = (int)c * V;
    float c1[V], c2[V], s1[V], s2[V];
    load_tables<V, HALF, Dt>(a, cs, p0, c1, c2, s1, s2);
    for (unsigned h = first + slot; h < end; h += a.hpw) {
      unsigned base;
      const int which = head_tensor(a, bl, h, base);
      float x1[V], x2[V], y1[V], y2[V];
      load_pairs<V>(a, buf, (h - first) * a.D, p0, x1, x2);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float a1 = cast<Dt::in, Dt::in_cast>(x1[j], a.in_cast);
        const float a2 = cast<Dt::in, Dt::in_cast>(x2[j], a.in_cast);
        if constexpr (BWD) {
          y1[j] = __fadd_rn(__fmul_rn(a1, c1[j]), __fmul_rn(a2, s2[j]));
          y2[j] = __fsub_rn(__fmul_rn(a2, c2[j]), __fmul_rn(a1, s1[j]));
        } else {
          y1[j] = __fsub_rn(__fmul_rn(a1, c1[j]), __fmul_rn(a2, s1[j]));
          y2[j] = __fadd_rn(__fmul_rn(a2, c2[j]), __fmul_rn(a1, s2[j]));
        }
        y1[j] = cast<Dt::in_cast, Dt::out>(y1[j], a.in_cast);
        y2[j] = cast<Dt::in_cast, Dt::out>(y2[j], a.in_cast);
      }
      void* out = which == 0 ? a.out[0] : which == 1 ? a.out[1] : a.out[2];
      store_pairs<V>(a, out, base, p0, y1, y2);
    }
  }
}

template <int KIND, int V, int BWD, int HALF, class Dt>
cudaError_t vlaunch(const RopeArgs& a, unsigned grid, cudaStream_t st) {
  if constexpr (KIND == ANY) {
    rope_kernel<V, BWD, HALF, UNR, RopeAny><<<grid, THREADS, 0, st>>>(a);
  } else if constexpr (KIND == UNR2) {
    rope_kernel<V, BWD, HALF, 2, Dt><<<grid, THREADS, 0, st>>>(a);
  } else {
    const size_t smem = (size_t)(THREADS / 32) * a.heads_per_part * a.D *
                        (a.in_dt == F32 ? 4 : 2);
    cudaError_t err = cudaFuncSetAttribute(
        rope_bulk_kernel<V, BWD, HALF, Dt>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    rope_bulk_kernel<V, BWD, HALF, Dt><<<grid, THREADS, smem, st>>>(a);
  }
  return cudaGetLastError();
}

template <int KIND, int V, int BWD, int HALF>
cudaError_t vdt(const RopeArgs& a, unsigned grid, cudaStream_t st) {
  if (fits<RopeO2>(a)) return vlaunch<KIND, V, BWD, HALF, RopeO2>(a, grid, st);
  if (fits<RopeServe>(a))
    return vlaunch<KIND, V, BWD, HALF, RopeServe>(a, grid, st);
  if (fits<RopeF32>(a)) return vlaunch<KIND, V, BWD, HALF, RopeF32>(a, grid, st);
  return vlaunch<KIND, V, BWD, HALF, RopeAny>(a, grid, st);
}

template <int KIND>
int entry(const void* q, const void* k, const void* v, void* oq, void* ok,
          void* ov, int positions, int heads_q, int heads_k, int heads_v,
          int L, int D, const void* cos, const void* sin, long long cs_stride,
          int cs_width, int cs_dt, int cs_cast, const void* pos, int pos_dt,
          long long offset, int in_dt, int in_cast, int out_dt, int neox,
          int bwd, int vec, int grid, int threads, int parts,
          int heads_per_part, int lph, int hpw, void* stream) {
  if (positions == 0 || heads_q + heads_k + heads_v == 0) return cudaSuccess;
  if (threads != THREADS || vec != 8) return cudaErrorInvalidValue;
  RopeArgs a{{q, k, v},
             {oq, ok, ov},
             {heads_q, heads_k, heads_v},
             L,
             D,
             cos,
             sin,
             pos,
             cs_stride,
             offset,
             cs_width,
             cs_dt,
             cs_cast,
             pos_dt,
             in_dt,
             in_cast,
             out_dt,
             neox,
             (unsigned)positions * (unsigned)parts,
             (unsigned)parts,
             (unsigned)heads_per_part,
             (unsigned)lph,
             (unsigned)hpw,
             (unsigned)(D / 2 / vec)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool half = cs_width == D / 2;
  const unsigned g = (unsigned)grid;
  if (bwd)
    return half ? vdt<KIND, 8, 1, 1>(a, g, st) : vdt<KIND, 8, 1, 0>(a, g, st);
  return half ? vdt<KIND, 8, 0, 1>(a, g, st) : vdt<KIND, 8, 0, 0>(a, g, st);
}

}  // namespace

#define K2_VARIANT(NAME, KIND)                                               \
  extern "C" int NAME(                                                      \
      const void* q, const void* k, const void* v, void* oq, void* ok,      \
      void* ov, int positions, int heads_q, int heads_k, int heads_v,       \
      int L, int D, const void* cos, const void* sin, long long cs_stride,  \
      int cs_width, int cs_dt, int cs_cast, const void* pos, int pos_dt,    \
      long long offset, int in_dt, int in_cast, int out_dt, int neox,       \
      int bwd, int vec, int grid, int threads, int parts,                   \
      int heads_per_part, int lph, int hpw, int nch, void* stream) {        \
    (void)nch;                                                              \
    return entry<KIND>(q, k, v, oq, ok, ov, positions, heads_q, heads_k,    \
                       heads_v, L, D, cos, sin, cs_stride, cs_width, cs_dt, \
                       cs_cast, pos, pos_dt, offset, in_dt, in_cast, out_dt, \
                       neox, bwd, vec, grid, threads, parts, heads_per_part, \
                       lph, hpw, stream);                                   \
  }

K2_VARIANT(k2_any, ANY)
K2_VARIANT(k2_unr2, UNR2)
K2_VARIANT(k2_bulk, BULK)
