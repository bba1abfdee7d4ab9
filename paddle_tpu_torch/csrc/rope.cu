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
// few hundred KB and stay in L2). Design: a thread turns 8 pairs with
// 16-byte loads when the rows allow it, else 1.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

struct RopeArgs {
  const void* in[3];
  void* out[3];
  long long rows[3];  // B * L * H of each tensor (0: absent)
  int heads[3];
  int L, D;
  const void *cos, *sin, *pos;
  long long cs_stride, offset;
  int cs_width, cs_dt, cs_cast, pos_dt, in_dt, in_cast, out_dt, neox, bwd;
};

template <int V>
__global__ void __launch_bounds__(256) rope_kernel(RopeArgs a) {
  const int per_row = a.D / 2 / V;  // threads a row
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long row = t / per_row;
  int which = 0;
  while (which < 3 && row >= a.rows[which]) row -= a.rows[which++];
  if (which == 3) return;
  const int p0 = (int)(t % per_row) * V;  // first pair of this thread
  const long long bl = row / a.heads[which];
  long long pos;
  if (a.pos == nullptr)
    pos = a.offset + bl % a.L;
  else
    pos = a.pos_dt == 0 ? (long long)static_cast<const int*>(a.pos)[bl]
                        : static_cast<const long long*>(a.pos)[bl];
  const long long cs = pos * a.cs_stride;
  const int half = a.D / 2;
  float x1[V], x2[V], c1[V], c2[V], s1[V], s2[V];
  const void* in = a.in[which];
  const long long base = row * a.D;
  if (a.neox) {
    ldv<V>(in, base + p0, a.in_dt, x1);
    ldv<V>(in, base + p0 + half, a.in_dt, x2);
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
  if (a.cs_width == half) {
    ldv<V>(a.cos, cs + p0, a.cs_dt, c1);
    ldv<V>(a.sin, cs + p0, a.cs_dt, s1);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      c2[j] = c1[j];
      s2[j] = s1[j];
    }
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
  float y1[V], y2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float a1 = rnd(x1[j], a.in_cast), a2 = rnd(x2[j], a.in_cast);
    const float cc1 = rnd(c1[j], a.cs_cast), cc2 = rnd(c2[j], a.cs_cast);
    const float ss1 = rnd(s1[j], a.cs_cast), ss2 = rnd(s2[j], a.cs_cast);
    if (a.bwd) {
      y1[j] = __fadd_rn(__fmul_rn(a1, cc1), __fmul_rn(a2, ss2));
      y2[j] = __fsub_rn(__fmul_rn(a2, cc2), __fmul_rn(a1, ss1));
    } else {
      y1[j] = __fsub_rn(__fmul_rn(a1, cc1), __fmul_rn(a2, ss1));
      y2[j] = __fadd_rn(__fmul_rn(a2, cc2), __fmul_rn(a1, ss2));
    }
    y1[j] = rnd(y1[j], a.in_cast);
    y2[j] = rnd(y2[j], a.in_cast);
  }
  void* out = a.out[which];
  if (a.neox) {
    stv<V>(out, base + p0, a.out_dt, y1);
    stv<V>(out, base + p0 + half, a.out_dt, y2);
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

}  // namespace

// in_cast: the dtype the op casts the tensors to (the forward's output
// rounds to it; the backward's gradient rounds to it, then to out_dt, the
// inputs' own dtype). pos_dt: 0 int32, 1 int64 (pos null: offset + l).
extern "C" int rope(const void* q, const void* k, const void* v, void* oq,
                    void* ok, void* ov, long long rows_q, long long rows_k,
                    long long rows_v, int heads_q, int heads_k, int heads_v,
                    int L, int D, const void* cos, const void* sin,
                    long long cs_stride, int cs_width, int cs_dt, int cs_cast,
                    const void* pos, int pos_dt, long long offset, int in_dt,
                    int in_cast, int out_dt, int neox, int bwd, int vec,
                    void* stream) {
  RopeArgs a{{q, k, v}, {oq, ok, ov}, {rows_q, rows_k, rows_v},
             {heads_q, heads_k, heads_v}, L, D, cos, sin, pos, cs_stride,
             offset, cs_width, cs_dt, cs_cast, pos_dt, in_dt, in_cast, out_dt,
             neox, bwd};
  const long long threads = (rows_q + rows_k + rows_v) * (D / 2 / vec);
  if (threads == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((threads + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    rope_kernel<8><<<grid, 256, 0, st>>>(a);
  else
    rope_kernel<1><<<grid, 256, 0, st>>>(a);
  return cudaGetLastError();
}
