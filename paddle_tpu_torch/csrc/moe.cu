// K9 moe_route: the Mixture-of-Experts dispatch and combine by index, for
// Hopper (sm_90a). The port's own kernel: the JAX package routes with
// XLA-fused jnp, no pallas_call: one-hot einsums over (tokens, experts,
// capacity) in MoELayer (paddle_tpu/incubate/moe.py:75-77, :153, :169) and
// a gather and a scatter-add in the expert-choice MoE (paddle_tpu/incubate/
// nn.py:230, :236-238). A one-hot einsum does S E C M multiply-adds to move
// S k rows; these kernels move the rows.
//
// The routing is a table built on the device by the wrapper (ops/moe.py
// Routes): route r of token t lies in [ptr[t], ptr[t + 1]), in route order
// (a token-choice gate: first choice, second choice; expert choice: expert
// order); slot[r] is its slot e * cap + c in the experts' (E, cap, M) rows,
// or -1 for a dropped route; slot_route[s] is the route of slot s, or -1 for
// an empty slot; route_token[r] its token; gate[r] its weight (fp32).
//
// moe_gather_sum_kernel, token-major (the combine's forward and the
// dispatch's backward): for each token, over its routes in route order,
//   v = y[slot]                       (a row of the experts' output)
//   v = rnd(v + bias[slot / cap], h)  (with a per-expert bias row)
//   v = rnd(v * gate[r], p)           (with gates)
//   acc = rnd(acc + rnd(v, a), a)     (from 0)
//   out[t] = rnd(acc, out)
// a = fp32 accumulates in fp32 and writes once (MoELayer's fp32 einsums);
// a = the output's dtype rounds every add as the JAX package's bf16
// scatter-add does (expert choice). Each add is an IEEE operation of its
// own (no FMA), in the plain version's order: fp32 results are bit-equal.
//
// moe_slot_rows_kernel, slot-major (the dispatch's forward and the
// combine's backward): for each slot s with route r and token t,
//   out[s] = rnd(src[t] (* gate[r]), out), 0 for an empty slot
//   dgate[r] = sum over columns of rnd(y[s] + bias, h) * src[t]  (fp32)
// the dot summed per thread in column order, then across the block's
// threads in a fixed tree: every launch gives the same bits. No output row
// is written by two blocks, so neither kernel needs an atomic.
//
// Bound: bytes. The gather reads each live route's row once and writes
// each token's row once; the slot kernel reads the routed token's row (and
// y's row for the gate gradient) and writes each slot's row once. Design:
// one block per row, 8 columns a thread with 16-byte accesses when the rows
// allow it, else 1.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

constexpr int THREADS = 128;

struct Gather {
  const void* y;       // (slots, m)
  const void* bias;    // (experts, m) or null
  const int* ptr;      // (tokens + 1)
  const int* slot;     // (routes)
  const float* gate;   // (routes) or null
  void* out;           // (tokens, m)
  long long tokens;
  int m, cap, y_dt, b_dt, h_dt, p_dt, a_dt, out_dt;
};

// grid (tokens, column blocks of THREADS * V)
template <int V>
__global__ void __launch_bounds__(THREADS) moe_gather_sum_kernel(Gather a) {
  const long long t = blockIdx.x;
  const int c = (blockIdx.y * THREADS + threadIdx.x) * V;
  if (c >= a.m) return;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  const int r0 = a.ptr[t], r1 = a.ptr[t + 1];
  for (int r = r0; r < r1; ++r) {
    const int s = a.slot[r];
    if (s < 0) continue;  // a dropped route
    float v[V];
    ldv<V>(a.y, (long long)s * a.m + c, a.y_dt, v);
    if (a.bias != nullptr) {
      float b[V];
      ldv<V>(a.bias, (long long)(s / a.cap) * a.m + c, a.b_dt, b);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = rnd(__fadd_rn(v[j], b[j]), a.h_dt);
    }
    if (a.gate != nullptr) {
      const float g = a.gate[r];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = rnd(__fmul_rn(v[j], g), a.p_dt);
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      acc[j] = rnd(__fadd_rn(acc[j], rnd(v[j], a.a_dt)), a.a_dt);
  }
  stv<V>(a.out, t * a.m + c, a.out_dt, acc);
}

struct Rows {
  const void* src;         // (tokens, m)
  const int* slot_route;   // (slots)
  const int* route_token;  // (routes)
  const float* gate;       // (routes) or null
  void* out;               // (slots, m)
  const void* y;           // (slots, m) or null: no gate gradient
  const void* bias;        // (experts, m) or null
  float* dgate;            // (routes) or null
  long long slots;
  int m, cap, src_dt, out_dt, y_dt, b_dt, h_dt;
};

// one block a slot, its threads over the row's columns
template <int V>
__global__ void __launch_bounds__(THREADS) moe_slot_rows_kernel(Rows a) {
  __shared__ float warp_sums[THREADS / 32];
  const long long s = blockIdx.x;
  const int r = a.slot_route[s];
  const long long row = s * a.m;
  if (r < 0) {  // an empty slot: a zero row
    float z[V];
#pragma unroll
    for (int j = 0; j < V; ++j) z[j] = 0.f;
    for (int c = threadIdx.x * V; c < a.m; c += THREADS * V)
      stv<V>(a.out, row + c, a.out_dt, z);
    return;
  }
  const long long src_row = (long long)a.route_token[r] * a.m;
  const float g = a.gate != nullptr ? a.gate[r] : 1.f;
  float dot = 0.f;
  for (int c = threadIdx.x * V; c < a.m; c += THREADS * V) {
    float x[V], o[V];
    ldv<V>(a.src, src_row + c, a.src_dt, x);
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = a.gate != nullptr ? __fmul_rn(x[j], g) : x[j];
    stv<V>(a.out, row + c, a.out_dt, o);
    if (a.y != nullptr) {
      float w[V];
      ldv<V>(a.y, row + c, a.y_dt, w);
      if (a.bias != nullptr) {
        float b[V];
        ldv<V>(a.bias, (long long)(s / a.cap) * a.m + c, a.b_dt, b);
#pragma unroll
        for (int j = 0; j < V; ++j) w[j] = rnd(__fadd_rn(w[j], b[j]), a.h_dt);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) dot = __fadd_rn(dot, __fmul_rn(w[j], x[j]));
    }
  }
  if (a.y == nullptr) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dot = __fadd_rn(dot, __shfl_down_sync(0xffffffffu, dot, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = dot;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total = __fadd_rn(total, warp_sums[w]);
    a.dgate[r] = total;
  }
}

}  // namespace

// y (slots, m), bias (experts, m) or null, ptr (tokens + 1) int32, slot
// (routes) int32, gate (routes) fp32 or null, out (tokens, m). Dtype codes
// as fused_io.cuh (0 fp32, 1 bf16, 2 fp16) for y, bias, the bias add h, the
// gate product p, the accumulation a and the output. vec 8 needs m % 8 == 0
// and 16-byte aligned rows. Returns a cudaError_t (0 on success).
extern "C" int moe_gather_sum(const void* y, const void* bias, const int* ptr,
                              const int* slot, const float* gate, void* out,
                              long long tokens, int m, int cap, int y_dt,
                              int b_dt, int h_dt, int p_dt, int a_dt,
                              int out_dt, int vec, void* stream) {
  if (tokens == 0 || m == 0) return cudaSuccess;
  Gather a{y, bias, ptr, slot, gate, out, tokens, m, cap, y_dt, b_dt, h_dt,
           p_dt, a_dt, out_dt};
  const dim3 grid((unsigned)tokens,
                  (unsigned)((m / vec + THREADS - 1) / THREADS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    moe_gather_sum_kernel<8><<<grid, THREADS, 0, st>>>(a);
  else
    moe_gather_sum_kernel<1><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// src (tokens, m), slot_route (slots) int32, route_token (routes) int32,
// gate (routes) fp32 or null, out (slots, m); with y (slots, m) (and bias
// (experts, m) or null) also dgate (routes) fp32, the gate gradient of each
// live route. Returns a cudaError_t (0 on success).
extern "C" int moe_slot_rows(const void* src, const int* slot_route,
                             const int* route_token, const float* gate,
                             void* out, const void* y, const void* bias,
                             float* dgate, long long slots, int m, int cap,
                             int src_dt, int out_dt, int y_dt, int b_dt,
                             int h_dt, int vec, void* stream) {
  if (slots == 0 || m == 0) return cudaSuccess;
  Rows a{src, slot_route, route_token, gate, out, y, bias, dgate, slots, m,
         cap, src_dt, out_dt, y_dt, b_dt, h_dt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    moe_slot_rows_kernel<8><<<(unsigned)slots, THREADS, 0, st>>>(a);
  else
    moe_slot_rows_kernel<1><<<(unsigned)slots, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}
