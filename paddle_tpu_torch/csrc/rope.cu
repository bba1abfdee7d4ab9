// Rotary position embedding, forward and backward, for Hopper (sm_90a): up
// to three tensors (q, k and v of fused_rotary_position_embedding; q and k
// of the Llama attention) rotated in one launch. The port's own kernel: the
// JAX package rotates with XLA-fused jnp (paddle_tpu/models/llama.py
// apply_rotary, paddle_tpu/incubate/nn_functional.py
// fused_rotary_position_embedding, :94-167), no pallas_call.
//
// A tensor is (B, L, H, D), contiguous, rows of D elements. A row at
// sequence index l of batch b sits at position pos = positions[b, l] (an
// int32 or int64 tensor on the device: the decode step's t, never read on
// the host) or offset + l. Each element pair (x1, x2), the halves
// (j, j + D/2) in the neox style or (2j, 2j + 1) interleaved, turns by the
// angle of its frequency:
//   y1 = x1 c1 - x2 s1,   y2 = x2 c2 + x1 s2
// and the backward turns the gradient back (the transpose):
//   dx1 = g1 c1 + g2 s2,  dx2 = g2 c2 - g1 s1
// c and s are read from cos/sin tables with a row per position, D/2 wide
// (c1 = c2 = cos[pos, j]) or D wide (c1 = cos[pos, e1], c2 = cos[pos, e2]),
// rounded first to the dtype the op casts them to. The math is fp32, each
// product and sum rounded once (no FMA: the plain version's order), and the
// result rounded once to the output dtype.
//
// Bound: bytes (each element read once and written once; the tables are a
// few hundred KB and stay in L2). Design (ops/rope.py's launch_plan sizes
// every launch):
// - Work is mapped by position: a warp owns an item, one (b, l) position
//   and a run of its heads (all of them when there are enough positions to
//   fill the card; Llama's 40 q and k heads), across the tensors. At one
//   position the heads of a tensor are H x D contiguous elements.
// - A lane keeps one chunk of V pairs (V = 8: 16-byte loads) for every head
//   it visits, so it reads and rounds its slice of the position's cos and
//   sin row once, into registers, and turns the same pairs of `hpw` heads a
//   warp step (D = 128: 8 lanes a head, 4 heads a step), a head's two
//   16-byte loads (x1 and x2) in flight at a time. On an H100 that beat
//   two heads at a time (four loads in flight, 106-110 registers) by 9%
//   at Llama's shapes and 14% at a 7B tail prefill, and came within 1-3%
//   of copying each warp's heads into shared memory by cp.async.bulk on an
//   mbarrier (tools/ab_rope_swiglu_variants.py).
// - The position is read once an item, from the offset or the device
//   positions; the item's position and heads come from 32-bit divisions
//   once a warp, and element offsets are 32-bit (the wrapper raises for a
//   tensor of 2^31 elements or more).
// - The dtype sets of the paths are instantiations with their codes fixed
//   (RopeDt: straight-line loads, stores and roundings, the roundings that
//   are no-ops left out): AMP O2 (bf16 rows, fp32 tables cast to bf16;
//   Llama training, forward and backward), serving (bf16 rows, fp32 tables
//   uncast) and fp32; any other set reads its codes at run time. The
//   backward and the table's width (D/2 or D) are template flags.
// - Rows that cannot take 16-byte loads (V = 1) take the same kernel with
//   a pair a chunk; a lane may then hold more than one chunk of a head
//   (nch), its table values reloaded for each.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps a CTA, an item each
constexpr int UNR = 1;        // heads a lane loads before it turns them

struct RopeArgs {
  const void* in[3];
  void* out[3];
  int heads[3];  // H of each tensor (0: absent)
  int L, D;
  const void *cos, *sin, *pos;
  long long cs_stride, offset;
  int cs_width, cs_dt, cs_cast, pos_dt, in_dt, in_cast, out_dt, neox;
  // the launch plan: items (positions x parts), heads an item, lanes a
  // head, heads a warp step, chunks (of V pairs) a head
  unsigned items, parts, heads_per_part, lph, hpw, cph;
};

// Dtype codes a kernel is built for (-1: the argument's), overwritten into
// the arguments (fixed()) so that the common sets compile to straight code.
template <int IN, int INC, int CS, int CSC, int OUT>
struct RopeDt {
  static constexpr int in = IN, in_cast = INC, cs = CS, cs_cast = CSC,
                       out = OUT;
};
// AMP O2 (Llama training, forward and backward; incubate under O2)
using RopeO2 = RopeDt<BF16, BF16, F32, BF16, BF16>;
// serving: bf16 rows, fp32 tables uncast
using RopeServe = RopeDt<BF16, BF16, F32, F32, BF16>;
using RopeF32 = RopeDt<F32, F32, F32, F32, F32>;
using RopeAny = RopeDt<-1, -1, -1, -1, -1>;

__host__ __device__ __forceinline__ int pick(int fixed, int arg) {
  return fixed >= 0 ? fixed : arg;
}

template <class Dt>
__device__ __forceinline__ RopeArgs fixed(RopeArgs a) {
  a.in_dt = pick(Dt::in, a.in_dt);
  a.in_cast = pick(Dt::in_cast, a.in_cast);
  a.cs_dt = pick(Dt::cs, a.cs_dt);
  a.cs_cast = pick(Dt::cs_cast, a.cs_cast);
  a.out_dt = pick(Dt::out, a.out_dt);
  return a;
}

template <class Dt>
bool fits(const RopeArgs& a) {
  return pick(Dt::in, a.in_dt) == a.in_dt &&
         pick(Dt::in_cast, a.in_cast) == a.in_cast &&
         pick(Dt::cs, a.cs_dt) == a.cs_dt &&
         pick(Dt::cs_cast, a.cs_cast) == a.cs_cast &&
         pick(Dt::out, a.out_dt) == a.out_dt;
}

// rnd(v, to) for a value read as `from`; left out where both are fixed and
// equal (a value read from a dtype is exact in it)
template <int FROM, int TO>
__device__ __forceinline__ float cast(float v, int to) {
  if constexpr (FROM >= 0 && FROM == TO) return v;
  return rnd(v, to);
}

// this lane's V pairs at chunk p0 of the position's table rows, rounded to
// the cast: c1/s1 for the first element of each pair, c2/s2 the second
template <int V, int HALF, class Dt>
__device__ __forceinline__ void load_tables(const RopeArgs& a, long long cs,
                                            int p0, float (&c1)[V],
                                            float (&c2)[V], float (&s1)[V],
                                            float (&s2)[V]) {
  const int half = a.D / 2;
  if constexpr (HALF) {
    ldv<V>(a.cos, cs + p0, a.cs_dt, c1);
    ldv<V>(a.sin, cs + p0, a.cs_dt, s1);
  } else if (a.neox) {
    ldv<V>(a.cos, cs + p0, a.cs_dt, c1);
    ldv<V>(a.sin, cs + p0, a.cs_dt, s1);
    ldv<V>(a.cos, cs + p0 + half, a.cs_dt, c2);
    ldv<V>(a.sin, cs + p0 + half, a.cs_dt, s2);
  } else {
    float e[2 * V], f[2 * V];
    ldv<V>(a.cos, cs + 2 * p0, a.cs_dt, *reinterpret_cast<float(*)[V]>(e));
    ldv<V>(a.cos, cs + 2 * p0 + V, a.cs_dt,
           *reinterpret_cast<float(*)[V]>(e + V));
    ldv<V>(a.sin, cs + 2 * p0, a.cs_dt, *reinterpret_cast<float(*)[V]>(f));
    ldv<V>(a.sin, cs + 2 * p0 + V, a.cs_dt,
           *reinterpret_cast<float(*)[V]>(f + V));
#pragma unroll
    for (int j = 0; j < V; ++j) {
      c1[j] = e[2 * j];
      c2[j] = e[2 * j + 1];
      s1[j] = f[2 * j];
      s2[j] = f[2 * j + 1];
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    c1[j] = cast<Dt::cs, Dt::cs_cast>(c1[j], a.cs_cast);
    s1[j] = cast<Dt::cs, Dt::cs_cast>(s1[j], a.cs_cast);
    if constexpr (HALF) {
      c2[j] = c1[j];
      s2[j] = s1[j];
    } else {
      c2[j] = cast<Dt::cs, Dt::cs_cast>(c2[j], a.cs_cast);
      s2[j] = cast<Dt::cs, Dt::cs_cast>(s2[j], a.cs_cast);
    }
  }
}

// head h of the position (the tensors' heads in order): the tensor, and in
// base the element offset of the head's row in it
__device__ __forceinline__ int head_tensor(const RopeArgs& a, unsigned bl,
                                           unsigned h, unsigned& base) {
  const unsigned h0 = a.heads[0], h01 = h0 + a.heads[1];
  const int which = h < h0 ? 0 : h < h01 ? 1 : 2;
  const unsigned t = h - (which == 0 ? 0u : which == 1 ? h0 : h01);
  const unsigned hw = which == 0 ? h0 : which == 1 ? (unsigned)a.heads[1]
                                                   : (unsigned)a.heads[2];
  base = (bl * hw + t) * (unsigned)a.D;
  return which;
}

template <int V>
__device__ __forceinline__ void load_pairs(const RopeArgs& a, const void* in,
                                           unsigned base, int p0,
                                           float (&x1)[V], float (&x2)[V]) {
  if (a.neox) {
    ldv<V>(in, base + p0, a.in_dt, x1);
    ldv<V>(in, base + p0 + a.D / 2, a.in_dt, x2);
  } else {
    float e[2 * V];
    ldv<V>(in, base + 2 * p0, a.in_dt, *reinterpret_cast<float(*)[V]>(e));
    ldv<V>(in, base + 2 * p0 + V, a.in_dt,
           *reinterpret_cast<float(*)[V]>(e + V));
#pragma unroll
    for (int j = 0; j < V; ++j) {
      x1[j] = e[2 * j];
      x2[j] = e[2 * j + 1];
    }
  }
}

template <int V>
__device__ __forceinline__ void store_pairs(const RopeArgs& a, void* out,
                                            unsigned base, int p0,
                                            const float (&y1)[V],
                                            const float (&y2)[V]) {
  if (a.neox) {
    stv<V>(out, base + p0, a.out_dt, y1);
    stv<V>(out, base + p0 + a.D / 2, a.out_dt, y2);
  } else {
    float e[2 * V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      e[2 * j] = y1[j];
      e[2 * j + 1] = y2[j];
    }
    stv<V>(out, base + 2 * p0, a.out_dt, *reinterpret_cast<float(*)[V]>(e));
    stv<V>(out, base + 2 * p0 + V, a.out_dt,
           *reinterpret_cast<float(*)[V]>(e + V));
  }
}

template <int V, int BWD, int HALF, int U, class Dt>
__global__ void __launch_bounds__(THREADS, 2) rope_kernel(RopeArgs args) {
  const RopeArgs a = fixed<Dt>(args);
  const unsigned item = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (item >= a.items) return;
  const unsigned lane = threadIdx.x & 31;
  const unsigned slot = lane / a.lph, sub = lane - slot * a.lph;
  if (slot >= a.hpw) return;
  const unsigned bl = item / a.parts;  // the (b, l) position's row
  const unsigned first = (item - bl * a.parts) * a.heads_per_part;
  const unsigned all = a.heads[0] + a.heads[1] + a.heads[2];
  const unsigned end =
      first + a.heads_per_part < all ? first + a.heads_per_part : all;
  long long pos;
  if (a.pos == nullptr)
    pos = a.offset + bl % (unsigned)a.L;
  else
    pos = a.pos_dt == 0 ? (long long)static_cast<const int*>(a.pos)[bl]
                        : static_cast<const long long*>(a.pos)[bl];
  const long long cs = pos * a.cs_stride;
  const unsigned step = a.hpw;
  for (unsigned c = sub; c < a.cph; c += a.lph) {
    const int p0 = (int)c * V;
    float c1[V], c2[V], s1[V], s2[V];
    load_tables<V, HALF, Dt>(a, cs, p0, c1, c2, s1, s2);
    for (unsigned h = first + slot; h < end; h += U * step) {
      float x1[U][V], x2[U][V];
      unsigned base[U];
      int which[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        which[u] = -1;
        if (h + u * step < end) {
          which[u] = head_tensor(a, bl, h + u * step, base[u]);
          const void* in = which[u] == 0   ? a.in[0]
                           : which[u] == 1 ? a.in[1]
                                           : a.in[2];
          load_pairs<V>(a, in, base[u], p0, x1[u], x2[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (which[u] < 0) continue;
        float y1[V], y2[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float a1 = cast<Dt::in, Dt::in_cast>(x1[u][j], a.in_cast);
          const float a2 = cast<Dt::in, Dt::in_cast>(x2[u][j], a.in_cast);
          if constexpr (BWD) {
            y1[j] = __fadd_rn(__fmul_rn(a1, c1[j]), __fmul_rn(a2, s2[j]));
            y2[j] = __fsub_rn(__fmul_rn(a2, c2[j]), __fmul_rn(a1, s1[j]));
          } else {
            y1[j] = __fsub_rn(__fmul_rn(a1, c1[j]), __fmul_rn(a2, s1[j]));
            y2[j] = __fadd_rn(__fmul_rn(a2, c2[j]), __fmul_rn(a1, s2[j]));
          }
          // rounded to the cast, then stored as the output dtype (the
          // store rounds alone where the two are one fixed dtype)
          y1[j] = cast<Dt::in_cast, Dt::out>(y1[j], a.in_cast);
          y2[j] = cast<Dt::in_cast, Dt::out>(y2[j], a.in_cast);
        }
        void* out = which[u] == 0   ? a.out[0]
                    : which[u] == 1 ? a.out[1]
                                    : a.out[2];
        store_pairs<V>(a, out, base[u], p0, y1, y2);
      }
    }
  }
}

template <int V, int BWD, int HALF, class Dt>
cudaError_t launch(const RopeArgs& a, unsigned grid, cudaStream_t st) {
  rope_kernel<V, BWD, HALF, UNR, Dt><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

template <int V, int BWD, int HALF>
cudaError_t launch_dt(const RopeArgs& a, unsigned grid, cudaStream_t st) {
  if constexpr (V == 8) {
    if (fits<RopeO2>(a)) return launch<V, BWD, HALF, RopeO2>(a, grid, st);
    if (fits<RopeServe>(a)) return launch<V, BWD, HALF, RopeServe>(a, grid, st);
    if (fits<RopeF32>(a)) return launch<V, BWD, HALF, RopeF32>(a, grid, st);
  }
  return launch<V, BWD, HALF, RopeAny>(a, grid, st);
}

template <int V>
cudaError_t launch_v(const RopeArgs& a, int bwd, unsigned grid,
                     cudaStream_t st) {
  const bool half = a.cs_width == a.D / 2;
  if (bwd)
    return half ? launch_dt<V, 1, 1>(a, grid, st)
                : launch_dt<V, 1, 0>(a, grid, st);
  return half ? launch_dt<V, 0, 1>(a, grid, st)
              : launch_dt<V, 0, 0>(a, grid, st);
}

}  // namespace

// in_cast: the dtype the op casts the tensors to (the forward's output
// rounds to it; the backward's gradient rounds to it, then to out_dt, the
// inputs' own dtype). pos_dt: 0 int32, 1 int64 (pos null: offset + l).
// positions: B * L; heads_*: H of each tensor (0: absent); grid, threads
// and the rest: ops/rope.py's launch plan (items = positions x parts).
extern "C" int rope(const void* q, const void* k, const void* v, void* oq,
                    void* ok, void* ov, int positions, int heads_q,
                    int heads_k, int heads_v, int L, int D, const void* cos,
                    const void* sin, long long cs_stride, int cs_width,
                    int cs_dt, int cs_cast, const void* pos, int pos_dt,
                    long long offset, int in_dt, int in_cast, int out_dt,
                    int neox, int bwd, int vec, int grid, int threads,
                    int parts, int heads_per_part, int lph, int hpw, int nch,
                    void* stream) {
  if (positions == 0 || heads_q + heads_k + heads_v == 0) return cudaSuccess;
  if (threads != THREADS || nch * lph * vec < D / 2)
    return cudaErrorInvalidValue;
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
  if (vec == 8) return launch_v<8>(a, bwd, (unsigned)grid, st);
  return launch_v<1>(a, bwd, (unsigned)grid, st);
}
