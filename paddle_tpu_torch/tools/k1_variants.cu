// Variants of K1 (csrc/fused_norm.cu) that the shipped kernel chose
// against, built beside it by tools/ab_norm_variants.py to measure each
// choice on the card; nothing else builds or calls them. The file includes
// the shipped source, so every variant shares its helpers, arguments and
// launch plan, and computes the same bits:
// - k1_fwd_any, k1_bwd_any: the row-group and block-per-row kernels with
//   every dtype code read at run time (FwdAny, BwdAny), in place of the
//   instantiations with the AMP O2 or all-bf16 codes fixed;
// - k1_fwd_cp_async: the row-group forward with every thread copying its
//   own 16-byte chunks of the rows ahead by cp.async (waiting on its own
//   copy groups), in place of one cp.async.bulk copy a row on the stage's
//   mbarrier (the launch plan's mbarrier bytes go unused).
// Each entry takes fused_norm_fwd's or fused_norm_bwd's arguments and
// leaves what it has no variant for to them.

#include "fused_norm.cu"

namespace {

// this thread's 16-byte chunks of row r of x (and the residual) into a
// stage, by cp.async
template <int NC>
__device__ __forceinline__ void fwd_copy_chunks(const FwdArgs& a,
                                                unsigned char* st, long long r,
                                                int t, int gthreads) {
  const int xs = esize(a.x_dt);
  const unsigned char* xr =
      static_cast<const unsigned char*>(a.x) + r * a.cols * xs;
  unsigned char* rst = st + (size_t)a.cols * xs;
  const int rs = esize(a.res_dt);
  const unsigned char* rr =
      a.res != nullptr
          ? static_cast<const unsigned char*>(a.res) + r * a.cols * rs
          : nullptr;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = (t + k * gthreads) * 8;
    if (c < a.cols) {
      copy_chunk(st, xr, c, xs);
      if (rr != nullptr) copy_chunk(rst, rr, c, rs);
    }
  }
}

template <int NC, class D>
__global__ void __launch_bounds__(RING_THREADS, RING_FWD_CTAS)
    norm_fwd_cp_async_kernel(FwdArgs args, Ring p) {
  const FwdArgs a = fixed<D>(args);
  extern __shared__ float4 ring_sh[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(ring_sh);
  const int gthreads = p.gwarps * 32;
  const int grp = threadIdx.x / gthreads, t = threadIdx.x - grp * gthreads;
  const int lane = threadIdx.x & 31, wig = t >> 5;
  unsigned char* ring = sm + (size_t)grp * p.stages * p.stage_bytes;
  const long long first = (long long)blockIdx.x * p.rows_per_cta;
  const long long end =
      first + p.rows_per_cta < a.rows ? first + p.rows_per_cta : a.rows;
  const long long r0 = first + grp;
  const bool has_add = a.res != nullptr || a.pb != nullptr;
  const bool has_w = a.w != nullptr;
  const int xs = esize(a.x_dt);
  for (int s = 0; s < p.stages - 1; ++s) {
    const long long r = r0 + (long long)s * p.groups;
    if (r < end) fwd_copy_chunks<NC>(a, ring + (size_t)s * p.stage_bytes, r, t,
                               gthreads);
    cp_commit();
  }
  // the vectors while the first rows are on their way
  float* ws = reinterpret_cast<float*>(sm + (size_t)p.groups * p.stages *
                                                p.stage_bytes);
  const float* bs = ws + a.cols;
  const float* ps = bs + a.cols;
  float* red = stage_vectors(a, ws) + grp * RED_FLOATS;
  __syncthreads();
  int cur = 0, slot = 0;
  for (long long r = r0; r < end; r += p.groups) {
    const long long ahead = r + (long long)(p.stages - 1) * p.groups;
    const int nxt = cur == 0 ? p.stages - 1 : cur - 1;
    if (ahead < end) fwd_copy_chunks<NC>(a, ring + (size_t)nxt * p.stage_bytes,
                                   ahead, t, gthreads);
    cp_commit();
    cp_wait(p.stages - 1);  // row r's copies (this thread's) have landed
    const unsigned char* st = ring + (size_t)cur * p.stage_bytes;
    const unsigned char* rst = st + (size_t)a.cols * xs;
    float hv[NC][8];
    float s1 = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (t + k * gthreads) * 8;
      if (c < a.cols) {
        float h[8];
        ldv<8>(st, c, a.x_dt, h);
        if (has_add) {
          float pv[8];
          lds8(ps, c, pv);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            h[j] = rnd(__fadd_rn(rnd(h[j], a.add_dt), pv[j]), a.add_dt);
          if (a.res != nullptr) {
            float u[8];
            ldv<8>(rst, c, a.res_dt, u);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              h[j] = rnd(__fadd_rn(h[j], rnd(u[j], a.add_dt)), a.add_dt);
          }
          stv<8>(a.res_out, r * a.cols + c, a.add_dt, h);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = rnd(h[j], a.norm_dt);
          hv[k][j] = v;
          s1 += v;
          sq = __fmaf_rn(v, v, sq);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) hv[k][j] = 0.f;
      }
    }
    float mu = 0.f, var;
    if (a.ln) {
      mu = __fdiv_rn(group_sum(s1, red, slot, p.gwarps, grp, wig, lane),
                     (float)a.cols);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if ((t + k * gthreads) * 8 < a.cols) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = __fsub_rn(hv[k][j], mu);
            s = __fmaf_rn(d, d, s);
          }
        }
      }
      var = __fdiv_rn(group_sum(s, red, slot, p.gwarps, grp, wig, lane),
                      (float)a.cols);
    } else {
      var = __fdiv_rn(group_sum(sq, red, slot, p.gwarps, grp, wig, lane),
                      (float)a.cols);
    }
    const float rs = __frsqrt_rn(__fadd_rn(var, a.eps));
    if (t == 0) {
      if (a.ln) a.mean[r] = mu;
      a.rstd[r] = rs;
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (t + k * gthreads) * 8;
      if (c < a.cols) {
        float y[8], wv[8], bv[8];
        lds8(ws, c, wv);
        lds8(bs, c, bv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float n =
              __fmul_rn(a.ln ? __fsub_rn(hv[k][j], mu) : hv[k][j], rs);
          // an absent weight is 1 and bias -0; the plain order rounds the
          // product to P only where there is a weight
          float v;
          if (a.fused) {
            v = __fadd_rn(__fmul_rn(n, wv[j]), bv[j]);
          } else {
            v = rnd(n, a.norm_dt);
            const float vw = rnd(__fmul_rn(v, wv[j]), a.out_dt);
            v = rnd(__fadd_rn(has_w ? vw : v, bv[j]), a.out_dt);
          }
          y[j] = rnd(v, a.out_dt);
        }
        stv<8>(a.out, r * a.cols + c, a.out_dt, y);
      }
    }
    cur = cur + 1 == p.stages ? 0 : cur + 1;
  }
  cp_wait(0);
}

template <class D>
cudaError_t fwd_cp_async(int nc, int grid, int threads, int smem,
                         cudaStream_t st, const FwdArgs& a, const Ring& p) {
  if (nc == 1)
    return launch(norm_fwd_cp_async_kernel<1, D>, true, grid, threads, smem,
                  st, a, p);
  if (nc == 2)
    return launch(norm_fwd_cp_async_kernel<2, D>, true, grid, threads, smem,
                  st, a, p);
  return cudaErrorInvalidValue;
}

}  // namespace

#define K1_FWD_PARAMS                                                        \
  const void *x, const void *res, const void *pb, const void *w,             \
      const void *b, void *out, void *res_out, void *mean, void *rstd,       \
      long long rows, int cols, int x_dt, int res_dt, int pb_dt, int w_dt,   \
      int w_cast, int b_dt, int b_cast, int out_dt, int add_dt, int norm_dt, \
      int ln, int fused, int vec, float eps, int ring, int grid, int threads, \
      int smem, int gwarps, int groups, int nc, int stages, int stage_bytes, \
      long long rows_per_cta, void *stream
#define K1_FWD_ARGS                                                          \
  x, res, pb, w, b, out, res_out, mean, rstd, rows, cols, x_dt, res_dt,      \
      pb_dt, w_dt, w_cast, b_dt, b_cast, out_dt, add_dt, norm_dt, ln, fused, \
      vec, eps, ring, grid, threads, smem, gwarps, groups, nc, stages,       \
      stage_bytes, rows_per_cta, stream

extern "C" int k1_fwd_any(K1_FWD_PARAMS) {
  FwdArgs a{x, res, pb, w, b, out, res_out, static_cast<float*>(mean),
            static_cast<float*>(rstd), rows, cols, x_dt, res_dt, pb_dt, w_dt,
            w_cast, b_dt, b_cast, out_dt, add_dt, norm_dt, ln, fused, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ring)
    return fwd_ring<FwdAny>(nc, grid, threads, smem, st, a,
                            Ring{rows_per_cta, gwarps, groups, stages,
                                 stage_bytes});
  if (nc > 0) return fwd_row<FwdAny>(nc, grid, threads, st, a);
  return fused_norm_fwd(K1_FWD_ARGS);
}

extern "C" int k1_fwd_cp_async(K1_FWD_PARAMS) {
  if (!ring) return fused_norm_fwd(K1_FWD_ARGS);
  FwdArgs a{x, res, pb, w, b, out, res_out, static_cast<float*>(mean),
            static_cast<float*>(rstd), rows, cols, x_dt, res_dt, pb_dt, w_dt,
            w_cast, b_dt, b_cast, out_dt, add_dt, norm_dt, ln, fused, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Ring p{rows_per_cta, gwarps, groups, stages, stage_bytes};
  if (fits<FwdO2>(a))
    return fwd_cp_async<FwdO2>(nc, grid, threads, smem, st, a, p);
  if (fits<FwdO2F32Res>(a))
    return fwd_cp_async<FwdO2F32Res>(nc, grid, threads, smem, st, a, p);
  if (fits<FwdBf16>(a))
    return fwd_cp_async<FwdBf16>(nc, grid, threads, smem, st, a, p);
  return fwd_cp_async<FwdAny>(nc, grid, threads, smem, st, a, p);
}

extern "C" int k1_bwd_any(
    const void* dy, const void* dres, const void* h, const void* mean,
    const void* rstd, const void* w, void* dx, void* part_w, void* part_b,
    void* part_pb, void* dw, void* db, void* dpb, long long rows, int cols,
    int grid, int dy_dt, int dres_dt, int h_dt, int w_dt, int w_cast,
    int dx_dt, int b_cast, int b_dt, int pb_cast, int pb_dt, int out_dt,
    int add_dt, int norm_dt, int has_add, int ln, int fused, int vec,
    int ring, int threads, int smem, int gwarps, int groups, int nc,
    int stages, int stage_bytes, long long rows_per_cta, void* stream) {
  if (!ring)
    return fused_norm_bwd(dy, dres, h, mean, rstd, w, dx, part_w, part_b,
                          part_pb, dw, db, dpb, rows, cols, grid, dy_dt,
                          dres_dt, h_dt, w_dt, w_cast, dx_dt, b_cast, b_dt,
                          pb_cast, pb_dt, out_dt, add_dt, norm_dt, has_add,
                          ln, fused, vec, ring, threads, smem, gwarps, groups,
                          nc, stages, stage_bytes, rows_per_cta, stream);
  BwdArgs a{dy, dres, h, w, static_cast<const float*>(mean),
            static_cast<const float*>(rstd), dx, static_cast<float*>(part_w),
            static_cast<float*>(part_b), static_cast<float*>(part_pb), rows,
            cols, dy_dt, dres_dt, h_dt, w_dt, w_cast, dx_dt, out_dt, add_dt,
            norm_dt, has_add, ln, fused};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bwd_ring<BwdAny>(
      nc, grid, threads, smem, st, a,
      Ring{rows_per_cta, gwarps, groups, stages, stage_bytes});
  if (err != cudaSuccess) return err;
  return fold_partials(a, grid, dw, db, dpb, b_dt, b_cast, pb_dt, pb_cast,
                       st);
}
