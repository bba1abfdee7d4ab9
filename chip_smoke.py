#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``).

    python3 chip_smoke.py [--only PHASE[,PHASE...]]

(``--only``: the build and the named phases of ``PHASES``, with no kernels
line; without it every phase runs.) Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``. It builds every kernel in ``paddle_tpu_torch/csrc`` from source
(and requires that the SASS of every bf16 and fp16 flash kernel, forward,
dq and dk/dv, holds wgmma and TMA instructions) and runs, printing one JSON
line per phase:

* serving: holds the flash-prefill and paged-decode kernels against their
  plain PyTorch versions at the shapes the serving path gives them (the
  tail prefill's Lq < Lk among them); holds each bucket's decode CUDA graph
  against an eager step on a 2-layer full-width fp32 model, native and
  int8 pools (equal tokens, bit-equal pools, launches counted per replay,
  and a replay with a stale ``t`` rejected); serves Llama-2-7B at full
  width (random bf16 weights from a seed, 32 layers) through the
  continuous-batching engine three times, every decode step a graph
  replay, then once more under ``torch.profiler``, and profiles one decode
  step eager and replayed; serves 16 requests sharing a 1024-token prefix
  with prefix sharing on and off (shared pages unchanged, tail K/V against
  the unshared run's); and checks that engine and ``generate`` agree token
  for token on a 2-layer full-width fp32 model, a shared-prefix pair
  among the prompts;
* the fused inference stack (``FusedMultiTransformer``, the JAX package's
  other serving model): ``fmt_check`` runs two layers at full width
  (hidden 2560, 20 heads, inter 6912) in fp32 and holds every B1, K1 and
  K6 launch of its bidirectional and causal prefills and every B6 launch
  of eight eager decode steps over bf16 and int8 pools against their
  plain versions, the prefill against the CPU's, the ``seq_offset`` tail
  against the full causal prefill, engine tokens against the per-token
  dense reference loop, and each bucket's decode graph against an eager
  step with its launches per replay; ``fmt_kernel_times`` times B1, B6,
  K1 and K6 at the FMT serving shapes; ``serve_fmt`` serves
  ``bench_generation.py --serving`` at its defaults (22 layers, bf16, 16
  requests of 512 tokens, 64 new, buckets 1, 4, 16) three times, times a
  bucket-16 replay beside its byte bound, holds every request against
  the bs=1 per-token reference (``serve_fmt_parity``: run free as the
  bench does, and fed the engine's transcript, the engine's logits
  against the reference's at each position, every differing pick a
  tie), and runs the bench's 90% overlap prefix leg with sharing on and
  off (equal transcripts);
* the prefill graphs (every admission's prefill on a card is a replay of
  the engine's CUDA graph of its key ``(start, n)``): ``serve_llama2_7b``
  and ``serve_fmt`` capture theirs at warm-up, the prefix phases before
  their timed runs, ``engine_vs_generate`` and ``fmt_check`` at first
  use; ``prefill_graph_check`` holds replays against the eager prefill
  body at full width (Llama-2-7B full prefills of 128, 564 and 1000
  tokens and tails of 16 and 256 over a 1024-token prefix; the FMT
  stack's 512-token prefills and a 64-token tail at 448; bf16 and int8
  pools): first token and pages bit-equal, shared prefix pages
  unchanged, a moved pool rejected, CUDA-event and host times and host
  calls each way;
* training: holds the forward-with-lse, the flash backward (dq, dk/dv) and
  the int8 AdamW kernels against their plain versions (and shows that the
  check rejects a copy of the flash kernels that skip a tile, and that
  three launches of the forward and of each backward kernel on the same
  inputs agree bit for bit), trains
  the 1.59B Llama of ``bench.py`` (full width and depth, batch 6, seq 4096,
  AMP O2 bf16, int8 AdamW without master weights) for 2 warm-up and 4
  timed steps, profiles one more step, and trains a 2-layer full-width
  fp32 model on the card and on the CPU side by side;
* segment ids and dropout: holds the SEGS, DROP and SEGS+DROP
  instantiations of B1-B4 against their plain versions, reads the dropout
  mask (B0) back out of every kernel and holds it against
  ``keep_mask_reference`` bit for bit, requires three identical launches
  and the rejection of a planted dk/dv that keys the mask on the kv head,
  times the variants at ERNIE's attention shape, runs
  ``flash_attn_unpadded`` on packed lengths, trains ERNIE-3.0-base at
  full size (``bench_ernie.py``'s traffic, then B=8 L=512; 2 warm-up, 10
  timed and one profiled step each), and compares two full-width fp32
  ERNIE layers with attention dropout on the card and on the CPU;
* the train step as one CUDA graph: holds the multi-tensor AdamW kernel
  against its plain version at ERNIE-3.0-base's 117,946,370 parameters
  (and a closed NaN gate that must write nothing), timed beside
  ``torch._fused_adamw_``; checks ``jit.capture_step``'s contract on two
  full-width fp32 ERNIE layers (eager and captured trajectories agree, a
  graph with frozen attention seeds must not, the LR follows the
  scheduler with no recapture, a NaN batch changes no state,
  ``scheduler.step()`` in the update raises, a new shape captures again,
  launches per replay, a host-reading step runs eagerly); trains
  ERNIE-3.0-base captured with the fine-tune recipe (multi-tensor AdamW,
  warm-up and linear decay, global-norm clip, NaN gate) on both legs
  beside the same recipe's eager tier, and runs the Llama step of
  ``bench.py`` captured with ``iters_per_call=4`` after its eager steps;
* the fused small ops (``fused_ops_check``): holds the norm (RMSNorm and
  LayerNorm with the residual add), RoPE, SwiGLU and cross-entropy
  kernels, forward and backward, against their plain versions at the
  Llama, ERNIE and serving shapes in fp32 and bf16 (the norm also at the
  FMT stack's prefill and decode, row groups of one and four warps, a
  width with no 8-element vectors and MAX_COLS in fp32, its block-per-row
  path), requires three bit-equal launches of each and the rejection of
  a planted copy of each (the norm: a forward that drops columns from its
  statistics, a fold that drops a partial), and times them beside their
  bound, plain version and library call, with the card's own time from
  CUDA events over a captured graph of calls (``graph_ms``;
  ``fused_norm_timing``: the norm's forward and backward at its four
  paths' shapes, split by kernel by ``torch.profiler`` where it keeps
  every record; ``rope_timing`` and ``swiglu_timing``: RoPE and SwiGLU
  at Llama's O2 training shapes and a Llama-2-7B decode step and tail
  prefill, three readings a case); the Llama, ERNIE and serving phases then count
  their launches (the Llama step's against the per-step counts of
  ``llama_fused_per_step``);
* ERNIE's small ops (``ernie_ops_check``): holds the embedding (K5),
  bias-and-activation (K6), dropout (K7) and masked-softmax (K8) kernels,
  forward and backward, against their plain versions at ERNIE's four
  tables, linear1 output, hidden dropout and attention scores (and
  Llama's embedding), K5 and K7 bit for bit, requires three bit-equal
  launches of each and the rejection of a planted copy of each, and times
  them beside bound, plain version and library call (the library's
  backward as its forward and backward captured together less the
  forward; ``softmax_mask_timing`` and ``bias_act_timing``: K8 at ERNIE's
  scores and the upper triangle, K6 at ERNIE's O2 and fp32 epilogues, the
  FMT prefill and decode epilogues and the MoE's bias period, three
  readings a case; ``embedding_timing``: K5's backward at ERNIE's four
  tables and Llama's, with its split by kernel); ``incubate_check``
  drives ``incubate``'s fused layers at ERNIE's width (card against CPU,
  then O2 training, counting K6-K8); the ERNIE phases count K5-K7 a step;
* Mixture-of-Experts (``moe_check``): holds the routing kernel K9
  (dispatch and combine, forward and backward, token choice at capacity
  1536 with dropped routes and expert choice with a per-expert bias and
  bf16 per-add rounding, 8192 tokens x 4096, 16 experts) bit for bit
  against its plain version (the gate gradient within MOE_DGATE_RTOL),
  requires three bit-equal launches and the rejection of a planted
  combine, and holds K6 with a bias row period; ``train_moe_jamba2``
  trains a pre-LN MoE block at AI21-Jamba2-Mini's expert widths (hidden
  4096, 16 experts of 14336, top-2; 1.88 B parameters; 4 x 2048 tokens,
  AMP O2, multi-tensor AdamW in two parameter groups with
  ``apply_decay_param_fun``) eagerly and captured, the replay bit-equal
  to the eager step on the same inputs; ``ec_moe_jamba2`` runs
  ``FusedEcMoe`` at those widths beside its products' bound;
  ``moe_vs_cpu`` holds a narrow block and an EC-MoE on the card against
  the CPU; ``grad_scaler_check`` runs ``amp.GradScaler`` in an fp16 O1
  step eager and captured with a planted ``inf``;
* serving under failure (the engine's fault sites, watchdog, bounded
  prefill replay and drain, through its graphs): ``serve_chaos_check``
  runs a seeded fault schedule and one device stall (a
  ``torch.cuda._sleep`` queued before a decode replay, so the token
  read-back waits on the card) at Llama-2-7B's width, 2 fp32 layers,
  native and int8 pools with a shared 1024-token prefix: a hung trip
  whose slots replayed, every Future typed, tokens equal to the no-fault
  run's, no page leaked, shared pages unchanged, exact accounting,
  launches as counted, a parseable flight dump, a retried step's pool
  bit-equal to one step, and outcomes, fault trace and counters equal to
  the CPU engine's under a deterministic schedule; ``serve_chaos_7b``
  serves the 7B traffic under fire with observability, tracing and the
  scrape endpoint on (``/metrics`` equal to the snapshot, ``/healthz``
  listing the engine); ``obs_overhead_7b`` serves it with everything off
  and on, interleaved, and requires a decode step with observability off
  to make no more host launch calls than ``decode_step_profile``'s;
* fp16 end to end: the flash checks hold fp16 B1 at the Llama-2-7B
  serving shapes, B2-B4 at bench.py's (three bit-equal launches, the
  planted copy rejected, times beside SDPA at fp16) and fp16's range in
  the backward (``flash_fp16_range_check``: a loss-scaled dO, and |dS| past
  65504 with fp16-sized results), the variant checks fp16 SEGS and
  SEGS+DROP (B0's bits read back through them) and their times at
  ERNIE's shape; ``paged_check`` fp16 q on fp16, bf16 and int8 pools;
  ``multi_tensor_adam_check`` fp16 parameters and gradients; K1-K8 fp16
  cases at their paths' shapes (K6's fp16 GELU against ``F.gelu`` on every
  fp16 value); ``serve_llama2_7b_fp16`` serves serve_7b's traffic with
  the 7B weights cast to fp16 (``compute_dtype="float16"``, a native fp16
  pool, the bf16 leg's gates); ``train_ernie3_base_fp16`` fine-tunes
  ERNIE-3.0-base under O2 fp16 with ``GradScaler(2**15)``, eager and
  captured from one state, the two bit-equal with equal loss-scale
  histories.

* the serving front door (``serve_router_7b``): a ``FrontDoor`` over a
  ``Router`` over two Llama-2-7B engines in this process (each its own
  stream and pool, one model's weights), serve_7b's 16 prompts posted by 16
  client threads (8 SSE, 8 unary) three times, the same traffic through
  ``Router.submit``, once more with an unwarmed prompt length captured
  under load, a drain of one replica mid-traffic and its restore, and the
  shared-prefix traffic placed by prefix affinity
  (``serve_router_7b_prefix``): 200s, one terminal event a stream, first
  tokens equal to serve_7b's, each engine's replay and launch accounting
  summed equal to the global counters, no page leaked; the fleet
  (``serve_fleet_7b_width``): two worker processes of the 7B's widths at 4
  layers behind the router and a front door, first tokens against the same
  model in this process, a SIGKILL after streamed tokens (every admitted
  stream 503 ``RpcTransportError``, the queued request failed over and
  completed, no token twice, one respawn that rejoins and serves, its split
  printed) and a SIGTERM that drains and exits 0.

* the rest of the optimizer: ``multi_tensor_adam_check`` also holds the
  multi-tensor AdamW kernel's forms at the 1.59B Llama's 1,591,308,800
  parameters bit for bit against its plain version (bf16 moments beside
  an fp32 master; the master-free bf16 storage rounded stochastically and
  to nearest; two launches at their flat offsets drawing one launch's
  bits; a closed gate), timed beside their byte bounds and
  ``torch._fused_adamw_``; ``train_llama_1p6b_bf16_state`` trains
  ``bench.py``'s Llama on ``bench_llama.py --state bf16``'s optimizer
  (multi-tensor AdamW, bf16 moments, no masters, O2 without master
  weights: 6 bytes of state a parameter) for 2 warm-up and 4 timed steps,
  profiles one more, and runs 5 calls on the eager tier and through
  ``jit.capture_step`` from one saved state, bit-equal;
  ``optimizer_zoo_check`` steps each optimizer of the JAX package's list
  (and AdamW's other new forms) 5 times on one full-width ERNIE-3.0-base
  layer on the card, against the same steps of the plain path on the CPU
  and, all but ``LBFGS``, captured bit-equal.

* the dense decode tier, Transformer-base and the loss ops:
  ``serve_7b_dense`` serves Llama-2-7B at full width on the dense
  stacked-cache tier (``paged_attention="off"``, max_len 1024) and on the
  paged tier, 16 x 512 tokens and 64 new each (tok/s, TTFT, TPOT, memory,
  the path counter), holds one bucket-16 replay of each tier from one pool
  state (next tokens equal but at the paged tier's 2-ulp ties, 7 more
  teacher-forced steps within a logits drift, the pools bit-equal away
  from ``t``), times both replays and the gather, serves a request on an
  engine demoted at page 8 (the JAX package's tiling rule refuses it) and
  sees page 512 refused at construction; ``serve_fmt_dense`` serves the FMT stack's
  2 layers on the dense tier under ``serve_fmt_parity``'s gate;
  ``loss_ops_check`` holds K4's smoothed, weighted, summed, unreduced and
  out-of-vocabulary forms against their plain version at (16384, 37000)
  bf16 and times them; ``train_transformer_base`` trains
  ``nn.Transformer()`` at its defaults (Transformer-base) under O2 with
  label smoothing, eager then captured from one state (bit-equal), its MFU
  from ``paddle_tpu_torch.flops``, and a 2 + 2-layer fp32 copy on the card
  against the CPU.

* ResNet-50 on K10 (the batch-norm kernel): ``batch_norm_check`` holds
  K10 against its plain version at the stem's, layer 1's and layer 4's
  shapes and an NHWC view, bf16 under O2 and fp32, training and eval, with
  each fused tail (output, running buffers, statistics and every
  gradient), every case on its planner's 16-byte route, three launches
  bit-equal and a planted fault rejected on a case of each route
  (channels first, channels last), and times each form beside its byte
  bound and ``F.batch_norm``;
  ``train_resnet50`` trains ``vision.models.resnet50`` at
  ``bench_resnet.py``'s settings (batch 64, 224 x 224, O2 bf16, Momentum)
  eager and captured from one state (bit-equal, cuDNN deterministic),
  profiles one step by family, times the eval forward, holds an fp32 copy
  on the card against the CPU and times the step's conv and pool library
  calls.

* PP-YOLOE-l on K11 (greedy NMS) and K10's swish tails: ``nms_check``
  holds K11 bit-equal to its plain version at PP-YOLOE-l's
  ``multiclass_nms`` (640 problems of 1000), ``nms`` over 8400 boxes
  (with categories and ``top_k``) and odd sizes, three launches
  bit-equal, a planted fault rejected, and times it; ``batch_norm_check``
  also holds the swish and add-swish forms at the detector's NHWC shapes;
  ``serve_ppyoloe`` serves ``PPYOLOEConfig.l(80)`` (batch 8, 640 x 640,
  fp32) through ``predict`` at PaddleDetection's NMS settings (p50,
  images/s, memory, launches, the output bit-equal to the same call on
  the plain NMS, one call profiled) and holds a -s copy on the card
  against the CPU; ``train_ppyoloe`` trains it for 6 eager Adam steps
  (p50, images/s, MFU against the fp32 peak, the four losses) with the
  first step held against the same step on the plain batch norm, and
  profiles a step and the loss alone.

The line before the last lists each kernel with its launches on its path's
run, error, times and bound, with the card's own time of each kernel and
its library call (``device_ms``, ``library_device_ms``: ``graph_ms``) and,
for the port's own kernels, the wrapper's host time too; the last line is ``{"ok": true,
"device": {...}}``. Any failed check raises and the script exits non-zero; without a
card it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# kernel vs plain, elementwise |out - ref| <= atol + rtol * |ref|, keyed by
# (kernel, output dtype). bf16 outputs are one rounding (half an ulp,
# <= 2^-9 relative) from the fp32 plain version. The paged kernel does its
# products in fp32 (max-abs 0.00098 seen), so its limit is 2x the output
# rounding and tight enough to catch one skipped 64-position page. fp32
# outputs differ only by summation order. lse is fp32 from either flash
# kernel: the bf16 kernel forms the same exact bf16 products and differs
# from the plain version only in summation order. fp16 outputs round to 11
# bits: the paged limits are the bf16 ones scaled by 2^-3 and rounded up
# (max-abs 0.00049 seen at fp16 q on the 7B decode shape on an H100),
# still past one skipped page.
TOL = {("paged", "bfloat16"): (2e-3, 4e-3),
       ("paged", "float16"): (5e-4, 1e-3),
       ("flash", "float32"): (1e-4, 1e-4),
       ("paged", "float32"): (1e-4, 1e-4),
       ("lse", "bfloat16"): (1e-4, 1e-5),
       ("lse", "float16"): (1e-4, 1e-5),
       ("lse", "float32"): (1e-4, 1e-5),
       ("flash_bwd", "float32"): (1e-4, 1e-4)}
# bf16 flash outputs (K1/B2 out, B3 dq, B4 dk and dv) are held against their
# size: for every tile of 64 sequence rows of every (batch, head),
# ||out - ref|| / ||ref|| <= limit. The kernels round P (and dS in the
# backward) to bf16 for their tensor-core products and round the output:
# 0.0025-0.0030 seen in every case on random inputs, the output rounding
# alone 0.0027. An absolute limit holds small elements loosely: at L=4096
# a typical element of out or of a gradient is about 0.03 to 0.06. fp16
# rounds P, dS (by each row's power of two) and the output to 11 bits:
# 0.0003-0.0005 seen on random inputs and on a loss-scaled dO on an H100.
# The largest seen, 0.0026, was a tile whose one live row sees one key:
# there dS = dP' - delta, two equal sums whose difference is the fp16
# rounding of out, and the wrapper's fp32 delta sums in another order than
# the plain version's (replaying the kernel's own arithmetic with the plain
# delta gives 0 there). So 5e-3; the planted faults stay near 0.2-0.6.
REL_TOL = {("flash", "bfloat16"): 1e-2,
           ("flash_bwd", "bfloat16"): 1e-2,
           ("flash", "float16"): 5e-3,
           ("flash_bwd", "float16"): 5e-3}
# serve_prefix_7b holds each request's tail K/V, written by a tail prefill
# over the shared prefix, against the unshared run's, per layer as
# ||shared - unshared|| / ||unshared||. Layer 0 depends on the tail's own
# tokens and positions only: bit-equal. Above it the runs differ only by
# rounding: cuBLAS takes other algorithms at M = tail than at M = prompt
# (seen at tails under 128 rows; from 121 rows up every layer was
# bit-equal), and the difference compounds through the residual stream, so
# layer l may be l bf16 roundings (2^-8 relative) off. A wrong prefix read
# or RoPE offset is off by order 1 at layer 0 or 1.
KV_ROUNDING_PER_LAYER = 2.0 ** -8
# Copies of the kernel sources with faults planted, each inserted before
# its anchor (copy, anchor, fault); a copy is named "<source>" or
# "<source>:<tag>", one build of csrc/<source>.cu with its faults. In the
# copy of csrc/flash_attention.cu one fault in each bf16 kernel: the
# forward's consumers skip the K/V tile at Lk/2 and dq's skip the K tile at
# Lk/2 (their scores are masked), dk/dv's skip the Q tile at Lq/2;
# flash_train_check requires that REL_TOL rejects all three at L=4096. In
# "flash_attention:b0" the dropout variant of dk/dv keys B0 on the kv head
# instead of the query head; flash_segs_dropout_check requires that
# REL_TOL rejects it at a GQA case. In csrc/paged_attention.cu the combine
# skips each row's second live split; paged_check requires that TOL rejects
# it at bf16_h32. K1 has two: its row-group forward leaves the last 256
# columns out of the RMS statistics, and its fold skips the second CTA's
# partial, so that FUSED_TOL must reject the output and dw. K2-K4
# (fused_ops_check) and K5-K8 (ernie_ops_check) each have one: K5's
# backward drops the second row of every piece (caught on the all-zero
# ids), K6's lookup forward (ERNIE's O2 epilogue) and its computed forward
# (the fp16 epilogue) zero one output of each vector of the middle row,
# K7 flips one element's keep, K8
# drops one mask column; K5 and K7 must fail bit-equality, K6 and K8
# FUSED_TOL. K9 (moe_check): the token-major sum skips each token's second
# route, so the combine must fail bit-equality. K10 (batch_norm_check): the
# statistics' fold, which both routes' partials go through, skips block 1's
# partial, so K10_TOL must reject the output, the running buffers and the
# statistics of a case on each route. K11
# (nms_check): the sweep
# reads row 2's mask words for row 1, so keep must fail bit-equality.
PLANTED_FAULTS = (
    ("flash_attention",
     "  if (n0 + FW_BN > min(Lk, wg_end)) {\n",
     "  if (n0 == (Lk / 2) / FW_BN * FW_BN) {\n"
     "#pragma unroll\n"
     "    for (int i = 0; i < FW_BN / 2; ++i) s[i] = -INFINITY;\n"
     "  }\n"),
    ("flash_attention",
     "  if (n0 + BW_BN > min(Lk, wg_end)) {\n",
     "  if (n0 == (Lk / 2) / BW_BN * BW_BN) {\n"
     "#pragma unroll\n"
     "    for (int i = 0; i < BW_BN / 2; ++i) s[i] = -INFINITY;\n"
     "  }\n"),
    ("flash_attention",
     "      if (causal && q0 + BW_BN - 1 + shift < kw) {\n",
     "      if (q0 == (Lq / 2) / BW_BN * BW_BN) {\n"
     "        mbar_arrive(bar_empty(s));\n"
     "        continue;\n"
     "      }\n"),
    ("flash_attention:b0",
     "        const uint32_t keep = dkv_keep_bits(keep_base(sd.seed, bh), q0, kr0, kr1, t,\n",
     "        bh = b * Hkv + kvh;  // planted: keyed on the kv head\n"),
    ("paged_attention",
     "      const float a = exp2f(pp[0] - mx);\n",
     "      if (sp == 1) continue;\n"),
    ("fused_norm",
     "          sq = __fmaf_rn(v, v, sq);\n",
     "          if (c + j >= a.cols - 256) continue;\n"),
    ("fused_norm",
     "      s = __fadd_rn(s, part[(long long)i * f.cols + c]);\n",
     "      if (i == 1) continue;\n"),
    ("rope",
     "  const long long cs = pos * a.cs_stride;\n",
     "  if (pos == 5) pos = 6;\n"),
    ("swiglu",
     "    store<V, Dt::y>(a.y, yo[k], a.y_dt, y);\n",
     "    if (yo[k] / a.d == a.vecs / (a.d / V) / 2) y[0] = 0.f;\n"),
    ("softmax_cross_entropy",
     "    float v[V];\n    ldv<V>(a.x, xo + c, a.x_dt, v);\n",
     "    if (c / (THREADS * V) == 1) continue;\n"),
    ("embedding",
     "          add_row<V>(acc, x, w_dt);\n",
     "          if (i == 1) return;\n"),
    ("bias_act",
     "          store<V, BF16>(a.out, o, a.a_dt, out);\n",
     "          if (r.r0 + i == a.rows / 2) out[0] = 0.f;\n"),
    ("bias_act",
     "      store<V, Dt::a>(a.out, (row + u) * a.n + r.c, a.a_dt, o);\n",
     "      if (row + u == a.rows / 2) o[0] = 0.f;\n"),
    ("dropout",
     "    o[j] = !k ? 0.f : a.upscale ? rnd(__fmul_rn(x[j], a.inv_keep), a.x_dt)\n",
     "    if (i0 + j == 4097) {\n"
     "      o[j] = k ? 0.f : x[j];\n"
     "      continue;\n"
     "    }\n"),
    ("softmax_mask",
     "  return __fadd_rn(x, m);\n",
     "  if (j == 5) m = 0.f;\n"),
    ("moe",
     "    if (s < 0) continue;  // a dropped route\n",
     "    if (r == r0 + 1) continue;\n"),
    ("batch_norm",
     "      chan(n, m, M2, __ldcg(pq), __ldcg(pq + g.C), __ldcg(pq + 2 * g.C));\n",
     "      if (q == 1) continue;\n"),
    ("nms",
     "      for (int q = w + lane; q < words; q += 32) removed[q] |= row[q];\n",
     "      if (i == 1) row += words;\n"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def tile_rel_err(torch, out, ref, tile: int = 64) -> float:
    """Largest ||out - ref|| / ||ref|| over the tiles of ``tile`` sequence
    rows of each (batch, head) of two ``(B, L, H, D)`` tensors."""
    b, n, h, d = ref.shape
    pad = (0, 0, 0, 0, 0, -n % tile)
    e2, r2 = (torch.nn.functional.pad(x, pad).view(b, -1, tile, h, d)
              .square().sum((2, 4))
              for x in (out.float() - ref.float(), ref.float()))
    return float((e2 / r2.clamp_min(1e-30)).sqrt().max())


def require_unseen_rows_zero(torch, fa, out, lse, lq: int, lk: int,
                             causal: bool, what: str) -> None:
    """Causal with Lq > Lk: the first Lq - Lk query rows see no key; they
    must give out exactly 0 and (when given) lse exactly ``LSE_MASKED``."""
    unseen = lq - lk if causal else 0
    if unseen <= 0:
        return
    require(not bool(out[:, :unseen].any()),
            f"{what}: rows that see no key are not 0")
    require(lse is None or bool((lse[:, :, :unseen] == fa.LSE_MASKED).all()),
            f"{what}: rows that see no key have an lse other than "
            f"{fa.LSE_MASKED}")


def check_close(torch, out, ref, kernel: str, what: str,
                dtype: str = None) -> dict:
    """Require out within REL_TOL or TOL of ref (keyed by the kernel and
    ``dtype``, default out's dtype); return the max-abs and the reference's
    RMS, and the largest tile error where REL_TOL holds it."""
    dt = dtype or dtype_name(out.dtype)
    diff = (out.float() - ref.float()).abs()
    res = {"max_abs": diff.max().item(),
           "ref_rms": ref.float().square().mean().sqrt().item()}
    finite = bool(torch.isfinite(out.float()).all())
    if (kernel, dt) in REL_TOL:
        limit = REL_TOL[kernel, dt]
        res["tile_rel"] = tile_rel_err(torch, out, ref)
        require(finite and res["tile_rel"] <= limit,
                f"{what}: tile ||out - ref|| / ||ref|| {res['tile_rel']} "
                f"beyond {limit} (max-abs {res['max_abs']})")
    else:
        atol, rtol = TOL[kernel, dt]
        require(finite and bool((diff <= atol + rtol * ref.float().abs()).all()),
                f"{what}: max-abs {res['max_abs']} beyond {atol} + {rtol} * |ref|")
    return res


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sample_card(period_ms: int = 200):
    """Sample the card's SM clock, power draw and temperature with
    ``nvidia-smi`` every ``period_ms`` until the returned function is
    called; it stops the sampler and returns min/median/max of each."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", str(period_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop():
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        rows = []
        for ln in out.splitlines():
            try:
                rows.append([float(x) for x in ln.split(",")])
            except ValueError:
                continue
        summary = {"samples": len(rows)}
        for i, key in enumerate(("sm_mhz", "power_w", "temp_c")):
            vals = sorted(r[i] for r in rows)
            summary[key] = ([vals[0], statistics.median(vals), vals[-1]]
                            if vals else None)
        return summary
    return stop


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# phase 2: flash prefill kernel against its plain version
# ---------------------------------------------------------------------------

def check_flash(torch, fa, planted_lib):
    import torch.nn.functional as TF
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf, f32, h16 = torch.bfloat16, torch.float32, torch.float16
    cases = [  # name, B, H, Hkv, Lq, Lk, causal, dtype, D
        ("causal_512", 1, 32, 32, 512, 512, True, bf, 128),
        ("causal_2048", 1, 32, 32, 2048, 2048, True, bf, 128),
        ("causal_1000_ragged", 1, 32, 32, 1000, 1000, True, bf, 128),
        ("gqa_causal_1024_h32_kv8", 1, 32, 8, 1024, 1024, True, bf, 128),
        ("causal_lq256_lk1024", 1, 32, 32, 256, 1024, True, bf, 128),
        # serve_prefix_7b's tail prefills: 16-256 new rows over a resident
        # 1024-token prefix
        ("causal_lq16_lk1040", 1, 32, 32, 16, 1040, True, bf, 128),
        ("causal_lq200_lk1224", 1, 32, 32, 200, 1224, True, bf, 128),
        ("full_512", 1, 32, 32, 512, 512, False, bf, 128),
        # the edges of the 128-row tiles: generate's step (one query over a
        # grown cache), rows that see no key (out 0), D=64, one row past a
        # tile
        ("causal_lq1_lk1064", 1, 32, 32, 1, 1064, True, bf, 128),
        ("causal_lq256_lk128", 1, 32, 32, 256, 128, True, bf, 128),
        ("d64_causal_1000", 1, 32, 32, 1000, 1000, True, bf, 64),
        ("causal_129", 1, 32, 32, 129, 129, True, bf, 128),
        # the fp32 CUDA-core kernel, at the engine_vs_generate phase's
        # prefill lengths and its generate step (one query over the cache)
        ("f32_causal_37", 1, 32, 32, 37, 37, True, f32, 128),
        ("f32_causal_513", 1, 32, 32, 513, 513, True, f32, 128),
        ("f32_lq1_lk528", 1, 32, 32, 1, 528, True, f32, 128),
        # and its tail prefill over a shared 2-page prefix
        ("f32_causal_lq40_lk168", 1, 32, 32, 40, 168, True, f32, 128),
        # fp16: the Llama-2-7B fp16 serving leg's prefills and tails, and
        # the tile edges
        ("fp16_causal_1000_ragged", 1, 32, 32, 1000, 1000, True, h16, 128),
        ("fp16_causal_lq200_lk1224", 1, 32, 32, 200, 1224, True, h16, 128),
        ("fp16_causal_lq16_lk1040", 1, 32, 32, 16, 1040, True, h16, 128),
        ("fp16_causal_lq1_lk1064", 1, 32, 32, 1, 1064, True, h16, 128),
        ("fp16_causal_lq256_lk128", 1, 32, 32, 256, 128, True, h16, 128),
        ("fp16_d64_causal_1000", 1, 32, 32, 1000, 1000, True, h16, 64),
    ]
    rows = []
    for name, b, h, hkv, lq, lk, causal, dt, d in cases:
        q = torch.randn(b, lq, h, d, generator=gen, device="cuda", dtype=dt)
        k = torch.randn(b, lk, hkv, d, generator=gen, device="cuda", dtype=dt)
        v = torch.randn(b, lk, hkv, d, generator=gen, device="cuda", dtype=dt)
        out = fa.flash_attention_fwd(q, k, v, causal=causal)
        ref = fa.flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        res = check_close(torch, out, ref, "flash", f"flash {name}")
        err = res["max_abs"]
        require_unseen_rows_zero(torch, fa, out, None, lq, lk, causal, name)
        # library yardstick: torch SDPA in (B, H, L, D), K/V repeated for
        # GQA and the bottom-right causal mask given explicitly when lq != lk
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if hkv != h:
            kh = kh.repeat_interleave(h // hkv, dim=1)
            vh = vh.repeat_interleave(h // hkv, dim=1)
        mask, lib_causal = None, causal
        if causal and lq != lk:
            mask = torch.ones(lq, lk, dtype=torch.bool, device="cuda").tril(
                diagonal=lk - lq)
            lib_causal = False
        lib = lambda: TF.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=mask, is_causal=lib_causal)
        # SDPA gives NaN on rows that see no key; the kernels give 0
        lib_err = (lib().transpose(1, 2).float().nan_to_num(0.0)
                   - ref.float()).abs().max().item()
        ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=causal), 10)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, causal=causal), 3, warmup=1)
        library_ms = cuda_ms(torch, lib, 10)
        dev = graph_pair(torch, lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal), lib)
        # the launch's cost function: what the cost registry files
        flops, nbytes = fa.attention_cost("fwd", b, lq, lk, h, hkv, d,
                                          q.element_size(), causal)
        bms, by = bound(flops, nbytes, dtype_name(dt))
        row = dict(case=name, dtype=dtype_name(dt), max_abs_err=err,
                   tile_rel_err=res.get("tile_rel"), ref_rms=res["ref_rms"],
                   library_max_abs_err=lib_err,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9,
                   **dev)
        if name == "fp16_causal_1000_ragged":
            row.update(fwd_repeat_and_planted(torch, fa, planted_lib, q, k, v,
                                              ref, causal))
        emit({"phase": "flash_check", **row})
        rows.append(row)
    return rows


def fwd_repeat_and_planted(torch, fa, planted_lib, q, k, v, ref,
                           causal: bool) -> dict:
    """B1 (``flash_fwd``) three times on the same inputs, bit for bit, and
    the planted copy (its consumers skip the K/V tile at Lk/2), which
    REL_TOL must reject."""
    runs = [fa.flash_attention_fwd(q, k, v, causal=causal) for _ in range(3)]
    same = all(torch.equal(r.view(torch.int16), runs[0].view(torch.int16))
               for r in runs[1:])
    require(same, f"flash_fwd {tuple(q.shape)} {dtype_name(q.dtype)}: three "
                  f"launches on the same inputs differ")
    bad, _, run = fwd_lse_launch(torch, fa, planted_lib, q, k, v, causal,
                                 with_lse=False)
    run()
    torch.cuda.synchronize()
    rel = tile_rel_err(torch, bad, ref)
    limit = REL_TOL["flash", dtype_name(q.dtype)]
    require(rel > limit, f"planted fault in flash_fwd "
                         f"({dtype_name(q.dtype)}) passed: tile error {rel} "
                         f"<= {limit}")
    return {"bit_identical_launches": 3, "planted_tile_rel": rel}


# ---------------------------------------------------------------------------
# phase 3: paged decode kernel against its plain version
# ---------------------------------------------------------------------------

# the main contexts of the paged cases: every length from 0 to the full
# slot, page edges among them
PAGED_T = (0, 1, 63, 64, 65, 127, 300, 500, 700, 1000, 1023, 1024, 1234,
           1500, 2000, 2047)


def split_edges(pa, b: int, hkv: int, ps: int, s: int) -> list:
    """``b`` contexts at the edges of the split kernel's chunks of pages
    (``split_plan`` for this shape) and of its pages, with 0, 1 and the
    full slot."""
    pps, _ = pa.split_plan(s, b * hkv)
    edges = [k * pps * ps + d for k in range(1, s // pps + 1)
             for d in (-1, 0, 1)] + [ps - 1, ps + 1, 0, 1]
    edges = sorted({e for e in edges if 0 <= e < s * ps} | {s * ps - 1})
    return [edges[i % len(edges)] for i in range(b)]


def paged_case(torch, kvc, gen, rng, t_host, h, hkv, leg, qdt, d=128, ps=64,
               s=32, layers=2, layer=1) -> dict:
    """Inputs of one paged-decode case, on the card: a pool of every row's
    own pages in random order (``leg``: "f32", "bf16", "fp16" or "int8"
    with scales), q and the current token in ``qdt``, and the case's byte and
    operation counts for the bound (live K/V, q, out, the current token,
    tables and t, and the live pages' scales)."""
    import numpy as np
    t_host = np.asarray(t_host, np.int32)
    b = len(t_host)
    p = b * s + 1
    tables_host = np.zeros((b, s), np.int32)
    perm = rng.permutation(np.arange(1, p))
    for i, tv in enumerate(t_host):
        n = min(s, tv // ps + 1)                  # pages up to position t
        tables_host[i, :n] = perm[i * s:i * s + n]
    poolf = torch.randn(p, layers, 2, hkv, ps, d, generator=gen, device="cuda")
    if leg == "int8":
        pool, scales = kvc.quantize_pages(poolf)
    elif leg in ("bf16", "fp16"):
        pool = poolf.to(torch.bfloat16 if leg == "bf16" else torch.float16)
        scales = None
    else:
        pool, scales = poolf, None
    del poolf
    q = torch.randn(b, h, d, generator=gen, device="cuda", dtype=qdt)
    kn = torch.randn(b, hkv, d, generator=gen, device="cuda", dtype=qdt)
    vn = torch.randn(b, hkv, d, generator=gen, device="cuda", dtype=qdt)
    from paddle_tpu_torch.ops import paged_attention as pa
    args = (q, kn, vn, pool, scales, torch.as_tensor(tables_host, device="cuda"),
            torch.as_tensor(t_host, device="cuda"), layer)
    # the launch's cost function: what the cost registry files
    flops, nbytes = pa.paged_cost(q, pool, scales, args[5], args[6], ps)
    return dict(args=args, ps=ps, t_host=t_host, nbytes=nbytes, flops=flops,
                rep=h // hkv)


def paged_sdpa(torch, case):
    """The library yardstick of a paged case: SDPA over the gathered dense
    K/V (gather and current-token insert done here, before timing), span
    mask pos <= t. Returns the call as a closure."""
    import torch.nn.functional as TF
    q, kn, vn, pool, scales, tables, t, layer = case["args"]
    p, layers, _, hkv, ps, d = pool.shape
    b, s = tables.shape
    m = s * ps
    idx = tables.long() * layers + layer
    taken = pool.reshape(p * layers, 2, hkv, ps, d)[idx].to(q.dtype)
    if scales is not None:
        sc = scales.reshape(p * layers, 2, hkv)[idx]
        taken = (taken.float() * sc[..., None, None]).to(q.dtype)
    kd = taken[:, :, 0].permute(0, 2, 1, 3, 4).reshape(b, hkv, m, d).clone()
    vd = taken[:, :, 1].permute(0, 2, 1, 3, 4).reshape(b, hkv, m, d).clone()
    del taken
    ar = torch.arange(b, device="cuda")
    kd[ar, :, t.long()] = kn
    vd[ar, :, t.long()] = vn
    if case["rep"] > 1:
        kd = kd.repeat_interleave(case["rep"], dim=1)
        vd = vd.repeat_interleave(case["rep"], dim=1)
    span = (torch.arange(m, device="cuda")[None, :]
            <= t.long()[:, None])[:, None, None, :]
    qd = q[:, :, None, :]
    return lambda: TF.scaled_dot_product_attention(qd, kd, vd, attn_mask=span)


def within_tol(out, ref, kernel: str) -> bool:
    """Whether every element of out lies within TOL of ref."""
    atol, rtol = TOL[kernel, dtype_name(out.dtype)]
    diff = (out.float() - ref.float()).abs()
    return bool((diff <= atol + rtol * ref.float().abs()).all())


def check_paged(torch, pa, kvc, planted_lib):
    import numpy as np
    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf, f32, h16 = torch.bfloat16, torch.float32, torch.float16
    edges = split_edges(pa, 16, 32, 64, 32)
    # name, q heads, kv heads, pool, q dtype, D, page size, table width,
    # contexts; those in ``timed`` are timed. The fp32 leg is the engine's
    # default (compute_dtype float32, native pool), which the
    # engine_vs_generate phase runs. The rest hold the split bookkeeping:
    # contexts at and beside the edges of the chunks of pages, every row
    # at t = 0, the smallest and largest pages (D=64, so that two staged
    # pages of 256 fit), and 8 q heads on one kv head of an int8 pool.
    cases = (("bf16_h32", 32, 32, "bf16", bf, 128, 64, 32, PAGED_T),
             ("int8_h32", 32, 32, "int8", bf, 128, 64, 32, PAGED_T),
             ("bf16_gqa_h32_kv8", 32, 8, "bf16", bf, 128, 64, 32, PAGED_T),
             ("f32_h32", 32, 32, "f32", f32, 128, 64, 32, PAGED_T),
             ("bf16_split_edges", 32, 32, "bf16", bf, 128, 64, 32, edges),
             ("bf16_all_t0", 32, 32, "bf16", bf, 128, 64, 32, (0,) * 16),
             ("bf16_ps16_d64", 32, 32, "bf16", bf, 64, 16, 64,
              split_edges(pa, 16, 32, 16, 64)),
             ("bf16_ps256_d64", 32, 32, "bf16", bf, 64, 256, 8,
              split_edges(pa, 16, 32, 256, 8)),
             ("int8_rep8_h32_kv4", 32, 4, "int8", bf, 128, 64, 32, PAGED_T),
             # fp16 q: the Llama-2-7B fp16 serving leg's native pool (timed),
             # and on bf16 and int8 pools (timed), the split edges and GQA
             ("fp16_h32", 32, 32, "fp16", h16, 128, 64, 32, PAGED_T),
             ("fp16_q_bf16_pool_h32", 32, 32, "bf16", h16, 128, 64, 32,
              PAGED_T),
             ("fp16_q_int8_pool_h32", 32, 32, "int8", h16, 128, 64, 32,
              PAGED_T),
             ("fp16_split_edges", 32, 32, "fp16", h16, 128, 64, 32, edges),
             ("fp16_gqa_h32_kv8_ps16_d64", 32, 8, "fp16", h16, 64, 16, 64,
              split_edges(pa, 16, 8, 16, 64)))
    timed = {"bf16_h32", "int8_h32", "bf16_gqa_h32_kv8", "f32_h32",
             "fp16_h32", "fp16_q_bf16_pool_h32", "fp16_q_int8_pool_h32"}
    rows = []
    for name, h, hkv, leg, qdt, d, ps, s, t_host in cases:
        case = paged_case(torch, kvc, gen, rng, t_host, h, hkv, leg, qdt,
                          d=d, ps=ps, s=s)
        args = case["args"]
        out = pa.paged_attention(*args, page_size=ps)
        ref = pa.paged_attention_dense(*args, page_size=ps)
        torch.cuda.synchronize()
        err = check_close(torch, out, ref, "paged", f"paged {name}")["max_abs"]
        # rows at t = 0 attend only the current token: exactly v_new
        zero = torch.as_tensor(case["t_host"] == 0, device="cuda")
        t0_err = (out[zero].float() - args[2][zero].float().repeat_interleave(
            case["rep"], dim=1)).abs().max().item() if bool(zero.any()) else 0.0
        require(t0_err == 0.0, f"paged {name}: t=0 rows are not v_new "
                               f"({t0_err})")
        row = dict(case=name, dtype=dtype_name(qdt), pool=leg, D=d, ps=ps,
                   rep=case["rep"], split_plan=pa.split_plan(s, 16 * hkv),
                   max_abs_err=err, t0_rows=int(zero.sum()))
        if name in ("bf16_h32", "fp16_h32"):
            # the kernels have no atomics and fold splits in order
            runs = [pa.paged_attention(*args, page_size=ps) for _ in range(3)]
            same = all(torch.equal(r.view(torch.int16), runs[0].view(torch.int16))
                       for r in runs[1:])
            require(same, f"paged {name}: three launches on the same inputs "
                          f"differ")
            fn = planted_lib.paged_decode
            fn.argtypes, fn.restype = pa._ARGTYPES, ctypes.c_int
            bad = pa.call_kernel(fn, *args, page_size=ps)
            torch.cuda.synchronize()
            require(not within_tol(bad, ref, "paged"),
                    f"paged {name}: the planted fault (the combine skips "
                    f"the second live split) passed TOL")
            row.update(bit_identical_launches=3, planted_fault_max_abs=(
                bad.float() - ref.float()).abs().max().item())
        if name in timed:
            lib = paged_sdpa(torch, case)
            row.update(ms=cuda_ms(torch, lambda: pa.paged_attention(
                           *args, page_size=ps), 20),
                       plain_ms=cuda_ms(torch, lambda: pa.paged_attention_dense(
                           *args, page_size=ps), 3, warmup=1),
                       library_ms=cuda_ms(torch, lib, 20),
                       **graph_pair(torch, lambda: pa.paged_attention(
                           *args, page_size=ps), lib))
            bms, by = bound(case["flops"], case["nbytes"], dtype_name(qdt))
            row.update(bound_ms=bms, bound_by=by,
                       gbytes_per_s=case["nbytes"] / row["ms"] / 1e6)
            del lib
        emit({"phase": "paged_check", **row})
        rows.append(row)
        del case, args, out, ref
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: the engine's decode graphs against eager steps (2 layers, fp32)
# ---------------------------------------------------------------------------

def decode_case(rng, bucket: int, s: int, ps: int, num_pages: int,
                vocab: int):
    """Host arrays of one decode step of ``bucket`` rows: every row but the
    last of a bucket above 1 is live, on pages of its own (covering ``t``
    and ``t + 1``) at a random context; the last row is padding (scratch
    page, t = 0)."""
    import numpy as np
    live = bucket - 1 if bucket > 1 else 1
    tok = np.zeros((bucket, 1), np.int64)
    tables = np.zeros((bucket, s), np.int32)
    t = np.zeros((bucket,), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    for i in range(live):
        t[i] = rng.integers(0, s * ps - 1)
        n = min(s, (int(t[i]) + 1) // ps + 1)
        tables[i, :n] = perm[i * s:i * s + n]
        tok[i, 0] = rng.integers(0, vocab)
    return tok, tables, t


def graph_vs_eager(torch, pa, eng, step_fn, tok, tables, t,
                   stale_t: bool = False) -> dict:
    """One decode step of ``eng`` as a replay of its bucket's graph against
    an eager ``step_fn`` call over a clone of the pool. The replay goes
    through the engine's own step (``_decode``: copy in, replay, read
    back); with ``stale_t`` (the planted fault) ``tok`` and ``tables`` are
    copied into the graph's buffers and ``t`` is not. Page 0 is left out of
    the pool comparison: padded rows all write it, in no fixed order."""
    from paddle_tpu_torch.ops.paged_attention import PagedDecodeCache
    kv = eng.kv
    ref_pool = kv.pool.clone()
    ref_scales = kv.scales.clone() if kv.scales is not None else None
    t_d = torch.as_tensor(t, device="cuda")
    with torch.no_grad():
        want, _ = step_fn(torch.as_tensor(tok, device="cuda"),
                          PagedDecodeCache(ref_pool, torch.as_tensor(
                              tables, device="cuda"), t_d,
                              kv.config.page_size, ref_scales), t_d)
    want = want.reshape(-1).cpu().numpy()
    pa.launches.reset()
    if stale_t:
        g = eng.decode_graph(len(t))
        g.tok.copy_(torch.as_tensor(tok, device="cuda"))
        g.tables.copy_(torch.as_tensor(tables, device="cuda"))
        got = g.replay().reshape(-1).cpu().numpy()
    else:
        got = eng._decode(tok, tables, t)
    launches = pa.launches.count
    pages_equal = torch.equal(kv.pool[1:], ref_pool[1:]) and (
        ref_scales is None or torch.equal(kv.scales[1:], ref_scales[1:]))
    diff = (kv.pool[1:].float() - ref_pool[1:].float()).abs().amax(
        dim=(1, 2, 3, 4, 5))
    return {"tokens_equal": bool((got == want).all()),
            "pools_equal": bool(pages_equal),
            "pages_differing": int((diff > 0).sum()), "launches": launches}


def decode_graph_check(torch, pa, kvc) -> None:
    """For each bucket and for a native and an int8 pool: a replay of the
    engine's decode graph and an eager step over a clone of the same pool
    give equal next tokens and bit-equal pools (page 0 aside), and the
    replay counts one paged launch per layer. A replay whose ``t`` was not
    copied in must fail that check."""
    import numpy as np
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, ServingConfig
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1))
    prefill_fn, step_fn = model.serving_callables(1024)
    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for leg in ("native", "int8"):
        t0 = time.monotonic()
        eng = Engine(prefill_fn, step_fn, ServingConfig(
            num_layers=2, num_heads=cfg.num_key_value_heads,
            head_dim=cfg.head_dim, max_len=1024, max_batch=16,
            buckets=(1, 4, 16), page_size=64, compute_dtype="float32",
            kv_dtype=leg, device="cuda")).warmup()
        capture_s = time.monotonic() - t0
        kv = eng.kv
        with torch.no_grad():
            x = torch.randn(kv.pool.shape, generator=gen, device="cuda")
            if leg == "int8":
                q8, sc = kvc.quantize_pages(x)
                kv.pool.copy_(q8)
                kv.scales.copy_(sc)
            else:
                kv.pool.copy_(x)
            del x
        s, ps = kv.config.pages_per_slot, kv.config.page_size
        for b in eng.config.buckets:
            tok, tables, t = decode_case(rng, b, s, ps, kv.config.num_pages,
                                         cfg.vocab_size)
            res = graph_vs_eager(torch, pa, eng, step_fn, tok, tables, t)
            require(res["tokens_equal"] and res["pools_equal"]
                    and res["launches"] == cfg.num_hidden_layers,
                    f"decode graph {leg} bucket {b}: replay and eager step "
                    f"differ or miscount: {res}")
            emit({"phase": "decode_graph_check", "pool": leg, "bucket": b,
                  "live_rows": int((tables[:, 0] > 0).sum()),
                  "t": [int(x) for x in t], **res})
        # the planted fault: the next step at t + 1 with t left stale
        t_next = np.where(tables[:, 0] > 0, t + 1, 0).astype(np.int32)
        bad = graph_vs_eager(torch, pa, eng, step_fn, tok, tables, t_next,
                             stale_t=True)
        require(not (bad["tokens_equal"] and bad["pools_equal"]),
                f"decode graph {leg}: a replay with a stale t passed the "
                f"check: {bad}")
        emit({"phase": "decode_graph_check", "pool": leg, "planted":
              "stale_t", "caught": True, **bad,
              "capture_s_3_buckets": capture_s})
        del eng, kv
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: serve Llama-2-7B at full width, through the decode graphs
# ---------------------------------------------------------------------------

SERVE_RUNS = 3


def build_7b(torch):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    cfg.dtype = "bfloat16"
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    return model, time.monotonic() - t0


def engine_7b(model, prefill_fn, prefix_sharing: str, prompt_lens,
              compute_dtype: str = "bfloat16", **kw):
    """serve_7b's engine, its decode buckets and the full prefills of
    ``prompt_lens`` warmed (captured on the card); ``kw`` adds
    ``ServingConfig`` fields."""
    from paddle_tpu_torch.serving import Engine, ServingConfig
    cfg = model.config
    return Engine(prefill_fn, model.serving_callables(2048)[1], ServingConfig(
        num_layers=cfg.num_hidden_layers, num_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, max_len=2048, max_batch=16, page_size=64,
        compute_dtype=compute_dtype, kv_dtype="native", policy="budget",
        prefill_token_budget=2048, prefix_sharing=prefix_sharing,
        device="cuda", **kw)).warmup([int(n) for n in prompt_lens])


def stats_delta(before: dict, after: dict) -> dict:
    """``Engine.decode_stats()`` counts between two reads."""
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            out[k] = {n: c - before[k].get(n, 0) for n, c in v.items()
                      if c != before[k].get(n, 0)}
        else:
            out[k] = v - before.get(k, 0)
    return out


def keyed(replays: dict) -> dict:
    """Prefill graph replays by ``(start, n)`` with JSON keys
    ``"start+n"``."""
    return {f"{s}+{n}": c for (s, n), c in sorted(replays.items())}


# how the engine prefills on the card
PREFILL = "cuda_graph_per_key"


def prefill_graph_counts(stats: dict) -> dict:
    """Prefill graphs captured and the seconds their warm-ups and captures
    took, from ``Engine.decode_stats()`` or a delta of it."""
    return {k: stats[k] for k in ("prefill_graphs", "prefill_capture_s")}


def require_prefill_replays(stats: dict, prefills: int, captured: int,
                            what: str, keys=None) -> None:
    """Every admission one replay of a prefill graph (of ``keys`` when
    given), ``captured`` of the graphs captured inside the run."""
    replays = stats["prefill_replays"]
    require(sum(replays.values()) == prefills
            and stats["prefill_graphs"] == captured
            and (keys is None or set(replays) <= set(keys)),
            f"{what}: {prefills} prefills but prefill replays "
            f"{keyed(replays)}, {stats['prefill_graphs']} captured during "
            f"the run (want {captured})")


def left_on_card(torch, after: str) -> None:
    """After a phase: collect, empty the cache and print what stays
    allocated and reserved on the card (a phase must leave nothing)."""
    gc.collect()
    torch.cuda.empty_cache()
    stats = torch.cuda.memory_stats()
    # the segments that stay, by (stream, pool): a graph's private pool
    # stays while the graph lives; a regular segment while a block in it does
    held = {}
    for seg in torch.cuda.memory_snapshot():
        k = f"{seg.get('stream')}:{seg.get('segment_pool_id')}"
        h = held.setdefault(k, [0, 0.0, 0.0])
        h[0] += 1
        h[1] += seg["total_size"] / 1e9
        h[2] += seg["allocated_size"] / 1e9
    emit({"phase": "left_on_card", "after": after,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "reserved_gb": torch.cuda.memory_reserved() / 1e9,
          "segments": stats.get("segment.all.current"),
          "free_gb": torch.cuda.mem_get_info()[0] / 1e9,
          "held_by_stream_pool": dict(sorted(
              held.items(), key=lambda kv: -kv[1][1])[:8])})


def memory_gb(torch) -> dict:
    """Peak allocated and reserved device memory since the last reset: a
    graph's pool stays reserved between its replays."""
    return {"peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}


def run_traffic(torch, eng, prompts, new_tokens: int, between=None):
    """Submit every prompt, drive the step loop to the drain and return
    wall time, results and the engine's step counts over the run.
    ``between(eng)`` runs after the first step, inside the timed window."""
    from paddle_tpu_torch.serving import GenerationRequest
    before = eng.decode_stats()
    t0 = time.monotonic()
    futs = [eng.submit(GenerationRequest(pr, max_new_tokens=new_tokens))
            for pr in prompts]
    if between is not None:
        eng.step()
        between(eng)
    eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return wall, [f.result(timeout=0) for f in futs], stats_delta(
        before, eng.decode_stats())


def serving_numbers(results, wall: float) -> dict:
    ntok = sum(len(r.tokens) for r in results)
    return {"wall_s": wall, "tokens_per_s": ntok / wall,
            "ttft_median_s": statistics.median(r.ttft_s for r in results),
            "ttft_max_s": max(r.ttft_s for r in results),
            "tpot_median_s": statistics.median(r.tpot_s for r in results)}


def require_served(eng, results, stats, launches, vocab: int, layers: int,
                   new_tokens: int, prefills: int, what: str,
                   captured: int = 0) -> None:
    """The run's transcripts, replays and launches: every decode step a
    replay, every admission a prefill replay, ``captured`` prefill graphs
    captured inside the run (each after ``_WARM_STEPS`` eager calls, which
    launch too), and no page leaked."""
    from paddle_tpu_torch.serving.engine import _WARM_STEPS
    for r in results:
        require(len(r.tokens) == new_tokens and r.finish_reason == "length",
                f"{what}: request {r.request_id}: {len(r.tokens)} tokens, "
                f"{r.finish_reason}")
        require(all(0 <= x < vocab for x in r.tokens),
                f"{what}: request {r.request_id}: token out of range")
    steps = sum(stats["steps"].values())
    require(sum(stats["replays"].values()) == steps and steps > 0,
            f"{what}: {steps} decode steps but replays {stats['replays']}")
    require_prefill_replays(stats, prefills, captured, what)
    calls = prefills + _WARM_STEPS * stats["prefill_graphs"]
    require(launches["flash_prefill"] == calls * layers,
            f"{what}: flash launches {launches['flash_prefill']} != "
            f"{calls} prefill calls x {layers}")
    require(launches["paged_decode"] == steps * layers,
            f"{what}: paged launches {launches['paged_decode']} != {steps} "
            f"steps x {layers}")
    # K1-K3 in every prefill and decode step: two norms a layer and the
    # final one, RoPE of q and k and SwiGLU once a layer; the embedding (K5)
    # once
    per = {"fused_norm": 2 * layers + 1, "rope": layers, "swiglu": layers,
           "embedding": 1}
    calls += steps
    require(all(launches[k] == n * calls for k, n in per.items()
                if k in launches),
            f"{what}: fused launches {launches} != {per} x {calls} calls")
    require(eng.kv.outstanding_pages == 0
            and eng.kv.free_pages == eng.kv.config.num_pages - 1,
            f"{what}: pages leaked after the drain")


def serve_7b(torch, card, fa, pa, model, init_s: float):
    import numpy as np
    cfg = model.config
    prefill_fn, step_fn = model.serving_callables(2048)
    rng = np.random.default_rng(0)
    lens = rng.permutation(np.linspace(128, 1000, 16).astype(int))
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in lens]
    # warmed with the traffic's 16 prompt lengths, as the bench warms its
    # prompt: on the card each is a prefill graph captured here
    t0 = time.monotonic()
    eng = engine_7b(model, prefill_fn, "off", lens)
    warmup_s = time.monotonic() - t0
    runs = []
    fused = {k: v for k, v in step_counters().items()
             if k in ("fused_norm", "rope", "swiglu", "embedding")}
    for i in range(SERVE_RUNS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for ctr in (fa.launches, pa.launches, *fused.values()):
            ctr.reset()
        wall, results, stats = run_traffic(torch, eng, prompts, 64)
        launches = {"flash_prefill": fa.launches.count,
                    "paged_decode": pa.launches.count,
                    **{k: ctr.count for k, ctr in fused.items()}}
        require_served(eng, results, stats, launches, cfg.vocab_size,
                       cfg.num_hidden_layers, 64, 16,
                       f"serve_llama2_7b run {i + 1}")
        runs.append({**serving_numbers(results, wall),
                     "decode_steps": sum(stats["steps"].values()),
                     "batch_sizes": stats["steps"],
                     "graph_replays": stats["replays"],
                     "prefill_replays": keyed(stats["prefill_replays"]),
                     "launches": launches, **memory_gb(torch)})
        if i == 0:
            main_launches = launches
            transcripts = [r.tokens for r in results]
    spread = {k: [min(r[k] for r in runs), max(r[k] for r in runs)]
              for k in ("tokens_per_s", "ttft_median_s", "tpot_median_s")}
    emit({"phase": "serve_llama2_7b", "card": card, "layers": 32,
          "dtype": "bfloat16", "requests": 16,
          "prompt_lens": [int(x) for x in lens], "new_tokens": 64,
          "decode": "cuda_graph_per_bucket", "runs": runs,
          "spread_min_max": spread, "weights_init_s": init_s,
          "prefill": PREFILL, "warmup_s": warmup_s,
          **prefill_graph_counts(eng.decode_stats())})
    profile_serving(torch, card, eng, prompts, runs[0]["wall_s"])
    step_profile = profile_decode_step(torch, card, eng, step_fn)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    serve_7b_first_use(torch, card, fa, pa, model, prompts, fused)
    return main_launches, {
        "prompts": prompts, "lens": lens, "transcripts": transcripts,
        "graph_host_launch_calls": step_profile["graph"]["host_launch_calls"]}


def serve_7b_fp16(torch, card, fa, pa, model, served) -> dict:
    """``serve_llama2_7b_fp16``: Llama-2-7B at full width in fp16 (the
    published checkpoint's dtype) through the engine, ``compute_dtype=
    "float16"``, a native fp16 pool of 64-position pages, decode and
    prefill graphs, on serve_7b's traffic (16 requests of 128-1000 prompt
    tokens, 64 new). The weights are serve_7b's random bf16 ones cast to
    fp16 in place (one 7B build for both legs; the RoPE tables stay fp32,
    as a model built in fp16 keeps them). The bf16 leg's gates
    (``require_served``); B1 and B6 launched on the fp16 path. Returns the
    run's launches."""
    t0 = time.monotonic()
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.to(torch.float16)
    model.config.dtype = "float16"
    torch.cuda.synchronize()
    cast_s = time.monotonic() - t0
    cfg = model.config
    prompts, lens = served["prompts"], served["lens"]
    prefill_fn, _ = model.serving_callables(2048)
    t0 = time.monotonic()
    eng = engine_7b(model, prefill_fn, "off", lens, compute_dtype="float16")
    warmup_s = time.monotonic() - t0
    require(eng.kv.pool.dtype == torch.float16,
            f"serve_llama2_7b_fp16: pool {eng.kv.pool.dtype}")
    fused = {k: v for k, v in step_counters().items()
             if k in ("fused_norm", "rope", "swiglu", "embedding")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for ctr in (fa.launches, pa.launches, *fused.values()):
        ctr.reset()
    wall, results, stats = run_traffic(torch, eng, prompts, 64)
    launches = {"flash_prefill": fa.launches.count,
                "paged_decode": pa.launches.count,
                **{k: ctr.count for k, ctr in fused.items()}}
    require_served(eng, results, stats, launches, cfg.vocab_size,
                   cfg.num_hidden_layers, 64, 16, "serve_llama2_7b_fp16")
    numbers, mem = serving_numbers(results, wall), memory_gb(torch)
    emit({"phase": "serve_llama2_7b_fp16", "card": card, "layers": 32,
          "dtype": "float16", "kv_dtype": "native (float16)",
          "weights": "serve_llama2_7b's bf16 weights cast to fp16 in place",
          "cast_s": cast_s, "requests": 16,
          "prompt_lens": [int(x) for x in lens], "new_tokens": 64,
          "decode": "cuda_graph_per_bucket", "prefill": PREFILL,
          "warmup_s": warmup_s, **numbers,
          "decode_steps": sum(stats["steps"].values()),
          "batch_sizes": stats["steps"], "graph_replays": stats["replays"],
          "prefill_replays": keyed(stats["prefill_replays"]),
          "launches": launches, **mem,
          **prefill_graph_counts(eng.decode_stats())})
    profile_serving(torch, card, eng, prompts, wall,
                    phase="serve_fp16_profile")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_7b_first_use(torch, card, fa, pa, model, prompts, fused) -> None:
    """serve_7b's traffic once on a fresh engine warmed with the 128-token
    prompt only: the 15 other lengths are captured at the admissions that
    first meet them, with the live slots waiting. The cost of traffic
    whose prompt lengths were not warmed."""
    cfg = model.config
    prefill_fn, _ = model.serving_callables(2048)
    t0 = time.monotonic()
    eng = engine_7b(model, prefill_fn, "off", [128])
    warmup_s = time.monotonic() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for ctr in (fa.launches, pa.launches, *fused.values()):
        ctr.reset()
    wall, results, stats = run_traffic(torch, eng, prompts, 64)
    launches = {"flash_prefill": fa.launches.count,
                "paged_decode": pa.launches.count,
                **{k: ctr.count for k, ctr in fused.items()}}
    new_lens = len({int(p.size) for p in prompts} - {128})
    require_served(eng, results, stats, launches, cfg.vocab_size,
                   cfg.num_hidden_layers, 64, len(prompts),
                   "serve_llama2_7b_first_use", captured=new_lens)
    emit({"phase": "serve_llama2_7b_first_use", "card": card,
          "warmed_prompt_lens": [128], "prefill": PREFILL,
          **serving_numbers(results, wall),
          "decode_steps": sum(stats["steps"].values()),
          "prefill_replays": keyed(stats["prefill_replays"]),
          "captured_in_run": prefill_graph_counts(stats),
          "warmup_s": warmup_s, "launches": launches, **memory_gb(torch)})
    del eng
    gc.collect()
    torch.cuda.empty_cache()


# the kernels of K1-K8 by the names the profiler gives them
FUSED_FAMILY = (("norm_fwd_", "fused_norm"),
                ("norm_bwd_", "fused_norm"),
                ("partial_fold_kernel", "fused_norm"),
                ("rope_kernel", "rope"), ("swiglu_", "swiglu"),
                ("ce_fwd_kernel", "softmax_cross_entropy"),
                ("ce_mean_kernel", "softmax_cross_entropy"),
                ("ce_bwd_kernel", "softmax_cross_entropy"),
                ("emb_fwd_kernel", "embedding"),
                ("emb_bwd_hist_kernel", "embedding"),
                ("emb_bwd_radix_kernel", "embedding"),
                ("emb_bwd_index_kernel", "embedding"),
                ("emb_bwd_table_kernel", "embedding"),
                # an older tree's backward kernels (piece, fold), in A/B runs
                ("emb_bwd_", "embedding"),
                ("bias_act_", "bias_act"), ("dropout_fwd_kernel", "dropout"),
                ("dropout_bwd_kernel", "dropout"),
                ("softmax_mask_", "softmax_mask"))


def fused_family(low: str):
    return next((fam for key, fam in FUSED_FAMILY if key in low), None)


def kernel_family(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_prefill"
    if "paged_decode" in low:
        return "paged_decode"
    if fused_family(low):
        return fused_family(low)
    if any(s in low for s in ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")):
        return "matmul"
    return "other"


def families(kernels, per: int = 1) -> dict:
    """Device ms and calls by kernel family of profiler events, each
    divided by ``per``."""
    fams = {}
    for e in kernels:
        f = fams.setdefault(kernel_family(e.key), {"device_ms": 0.0,
                                                   "calls": 0})
        f["device_ms"] += device_us(e) / 1e3 / per
        f["calls"] += e.count / per
    return fams


def device_us(evt) -> float:
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else evt.self_cuda_time_total)


# host-side names of the work a step puts on the card: kernel launches,
# graph launches, copies and fills
HOST_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)"
                         r"|^cuLaunch")
# the engine's host spans, recorded by the wrappers of profile_serving
SPANS = ("serving.prefill", "serving.decode")


def device_ms_in_spans(torch, prof, name: str) -> float:
    """Device time of the operations that start inside a host span
    ``name``. The engine's prefill and decode calls each end in a host
    read of their tokens, so whatever the card starts inside a span is
    that call's work, graph replays included (the profiler links no
    replayed kernel to the span that launched it)."""
    import bisect
    evts = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in evts
                   if e.name == name and e.device_type == cpu)
    starts = [a for a, _ in spans]
    total = 0.0
    for e in evts:
        if e.device_type != cuda or e.name in SPANS:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= spans[i][1]:
            total += e.time_range.elapsed_us()
    return total / 1e3


def profile_serving(torch, card, eng, prompts, unprofiled_wall_s: float,
                    new_tokens: int = 64, layers: int = 32,
                    phase: str = "serve_profile"):
    """Serve the same traffic again under ``torch.profiler``; emit where the
    device time goes, and how the host's wall time splits between the
    prefills and the decode steps. The busy share is kernel time over this
    pass's wall time, which the profiler's host overhead inflates; kernel
    time over the unprofiled pass's wall is the estimate for the run
    without it."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    host_s = {name: 0.0 for name in SPANS}
    calls = {name: 0 for name in SPANS}
    real = {name: getattr(eng, "_" + name.split(".")[1]) for name in SPANS}

    def spanned(name):
        def call(*args):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = real[name](*args)
            host_s[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return call

    for name in SPANS:
        setattr(eng, "_" + name.split(".")[1], spanned(name))
    try:
        with torch.profiler.profile(activities=acts) as prof:
            wall, _, stats = run_traffic(torch, eng, prompts, new_tokens)
    finally:
        for name in SPANS:
            delattr(eng, "_" + name.split(".")[1])
    evts = prof.key_averages()
    kernels = [e for e in evts
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0 and e.key not in SPANS]
    total_s = sum(device_us(e) for e in kernels) / 1e6
    require(total_s > 0, "profiler recorded no device time")
    fams = families(kernels)
    steps = sum(stats["steps"].values())
    spans = {}
    for name in SPANS:
        in_span = device_ms_in_spans(torch, prof, name)
        spans[name] = {"calls": calls[name], "host_wall_ms": host_s[name] * 1e3,
                       "share_of_wall": host_s[name] / wall,
                       "device_ms_in_span": in_span,
                       "device_share_of_span": in_span / (host_s[name] * 1e3)}
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    emit({"phase": phase, "card": card, "wall_s": wall,
          "device_ms": total_s * 1e3, "device_busy_share": total_s / wall,
          "unprofiled_wall_s": unprofiled_wall_s,
          "device_busy_share_est_unprofiled": total_s / unprofiled_wall_s,
          "decode_steps": steps, "families": fams,
          # kernels replayed from a graph keep their names in the trace:
          # two paged kernels (split, combine) a layer a step
          "paged_calls_per_step_layer":
              fams.get("paged_decode", {"calls": 0})["calls"]
              / (steps * layers),
          "spans": spans,
          "top": [{"kernel": e.key[:90], "device_ms": device_us(e) / 1e3,
                   "calls": e.count} for e in top]})


def profile_call(torch, fn) -> dict:
    """One call of ``fn`` (after one unprofiled) under ``torch.profiler``:
    the device operations it puts on the card and the host calls that put
    them there."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    wall = time.perf_counter() - t0
    evts = prof.key_averages()
    dev = [e for e in evts if e.device_type == torch.autograd.DeviceType.CUDA
           and device_us(e) > 0]
    host = {e.key: e.count for e in evts
            if e.device_type == torch.autograd.DeviceType.CPU
            and HOST_LAUNCH.search(e.key)}
    return {"device_ops": sum(e.count for e in dev),
            "device_kernels": sum(e.count for e in dev if not
                                  e.key.startswith(("Memcpy", "Memset"))),
            "device_ms": sum(device_us(e) for e in dev) / 1e3,
            "host_launch_calls": sum(host.values()), "host_calls": host,
            "profiled_wall_ms": wall * 1e3}


def profile_decode_step(torch, card, eng, step_fn) -> None:
    """One decode step of the largest bucket, over the scratch page only
    (all rows padding), eager and as a replay of its graph, each under
    ``torch.profiler``: the device operations each puts on the card and
    the host calls that put them there."""
    import numpy as np
    from paddle_tpu_torch.ops.paged_attention import PagedDecodeCache
    b = eng.config.buckets[-1]
    s = eng.kv.config.pages_per_slot
    tok = np.zeros((b, 1), np.int64)
    tables = np.zeros((b, s), np.int32)
    t = np.zeros((b,), np.int32)
    t_d = torch.as_tensor(t, device="cuda")
    view = PagedDecodeCache(eng.kv.pool, torch.as_tensor(tables, device="cuda"),
                            t_d, eng.kv.config.page_size, eng.kv.scales)
    tok_d = torch.as_tensor(tok, device="cuda")

    def eager():
        with torch.no_grad():
            return step_fn(tok_d, view, t_d)[0].reshape(-1).cpu().numpy()

    out = {}
    for name, fn in (("eager", eager),
                     ("graph", lambda: eng._decode(tok, tables, t))):
        out[name] = profile_call(torch, fn)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name].update(
            step_ms_unprofiled=(time.perf_counter() - t1) * 100,
            step_ms_cuda_events=start.elapsed_time(end) / 10)
    require(out["graph"]["host_launch_calls"] < 10
            and out["eager"]["host_launch_calls"] > 100,
            f"decode step: host calls, eager against replay: {out}")
    emit({"phase": "decode_step_profile", "card": card, "bucket": b,
          "rows": "padding only (scratch page)", **out})
    return out


# ---------------------------------------------------------------------------
# phase 6: a shared 1024-token prefix, with and without prefix sharing
# ---------------------------------------------------------------------------

def layer_rel_err(a, b):
    """Per layer of two ``(L, 2, H, n, D)`` K/V blocks: ``||a - b|| /
    ||b||``, on the card (no host read)."""
    d = (a.float() - b.float()).flatten(1).norm(dim=1)
    return d / b.float().flatten(1).norm(dim=1)


def serve_prefix_7b(torch, card, fa, pa, kvc, model):
    """16 requests that share one 1024-token prefix (a system prompt), each
    with its own tail of 16-256 tokens, served with prefix sharing on and
    then off by engines of serve_7b's settings, every prefill key of the
    traffic captured before the timed run. The flash launches of full and
    tail prefills are counted apart from the replays of each prefill graph
    and the launches its capture recorded, and each admission's K/V at the
    tail's positions [1024, Lp) is read back from its pool pages to hold
    the two runs against each other."""
    import numpy as np
    cfg = model.config
    layers = cfg.num_hidden_layers
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (1024,), dtype=np.int32)
    tails = rng.integers(16, 257, (16,))
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, (n,), dtype=np.int32)]) for n in tails]
    prefill_fn, _ = model.serving_callables(2048)
    out, tail_kv = {}, {}
    for mode in ("on", "off"):
        kept = tail_kv[mode] = []
        # sharing on, the first request prefills whole and the others only
        # their tails over the 1024 shared positions
        t0 = time.monotonic()
        eng = engine_7b(model, prefill_fn, mode, [p.size for p in (
            prompts[:1] if mode == "on" else prompts)])
        if mode == "on":
            for pr in prompts[1:]:
                eng.prefill_graph(1024, pr.size - 1024)
        warmup_s = time.monotonic() - t0
        prefill = eng._prefill

        def read_tail(prompt, row, start=0):
            tok = prefill(prompt, row, start)
            # FIFO admission: the k-th prefill is the k-th request's
            pages = torch.as_tensor(
                row[16:eng.kv.pages_for(int(prompt.size))], device="cuda")
            kept.append(kvc.gather_pages(
                eng.kv.pool, eng.kv.scales, pages,
                torch.bfloat16)[:, :, 0, :, :prompt.size - 1024])
            return tok

        eng._prefill = read_tail
        chain = {}

        def snapshot(eng):
            pages = [eng.kv._index[h] for h in
                     kvc.prefix_chain_digests(prefix, 64)]
            chain.update(pages=pages, before=eng.kv.pool[pages].clone())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches.reset()
        pa.launches.reset()
        wall, results, stats = run_traffic(
            torch, eng, prompts, 64, snapshot if mode == "on" else None)
        flash = {"full": 0, "tail": 0}
        for (start, n), c in stats["prefill_replays"].items():
            flash["tail" if start else "full"] += c * eng.prefill_graph(
                start, n).launches.get(fa.launches, 0)
        launches = {"flash_prefill": fa.launches.count,
                    "paged_decode": pa.launches.count, "flash_by_prefill":
                    dict(flash)}
        require_served(eng, results, stats, launches, cfg.vocab_size, layers,
                       64, 16, f"serve_prefix_7b {mode}")
        requested, computed = eng.prefill_token_stats()
        row = {**serving_numbers(results, wall),
               "prefill_tokens_requested": requested,
               "prefill_tokens_computed": computed,
               "prefills": stats["prefills"],
               "prefill_replays": keyed(stats["prefill_replays"]),
               "decode_steps": sum(stats["steps"].values()),
               "batch_sizes": stats["steps"], "graph_replays": stats["replays"],
               "launches": launches, "prefix_stats": eng.kv.prefix_stats(),
               "warmup_s": warmup_s,
               **prefill_graph_counts(eng.decode_stats()),
               **memory_gb(torch), "tokens": [r.tokens for r in results]}
        require(flash["full"] + flash["tail"] == launches["flash_prefill"],
                f"serve_prefix_7b {mode}: flash launches by prefill {flash}")
        if mode == "on":
            require(computed < requested and stats["prefills"].get("tail", 0)
                    == 15 and flash["tail"] == 15 * layers,
                    f"serve_prefix_7b on: prefill tokens {computed} of "
                    f"{requested}, prefills {stats['prefills']}")
            require(torch.equal(eng.kv.pool[chain["pages"]], chain["before"]),
                    "serve_prefix_7b on: a page of the shared chain changed")
            row["shared_chain_pages_bit_equal"] = len(chain["pages"])
        else:
            require(computed == requested and flash["tail"] == 0,
                    f"serve_prefix_7b off: prefill tokens {computed} of "
                    f"{requested}")
        out[mode] = row
        # the engine's last references (the closures' cells): its pool and
        # graphs must be gone before the next mode's engine is measured
        del eng, chain, prefill
        gc.collect()
        torch.cuda.empty_cache()
    # each request's tail K/V, shared run against unshared, per layer:
    # ||shared - unshared|| / ||unshared|| over the tail's positions
    rel = torch.stack([layer_rel_err(a, b) for a, b in
                       zip(tail_kv["on"], tail_kv["off"])]).cpu()
    limit = torch.arange(layers) * KV_ROUNDING_PER_LAYER
    require(bool((rel[:, 0] == 0).all()) and bool((rel <= limit).all()),
            f"serve_prefix_7b: tail K/V of the shared run off the unshared "
            f"run's beyond rounding: per layer {rel.amax(dim=0).tolist()}")
    pairs = list(zip(out["on"].pop("tokens"), out["off"].pop("tokens")))
    same = sum(x == y for a, b in pairs for x, y in zip(a, b))
    emit({"phase": "serve_prefix_7b", "card": card, "requests": 16,
          "prefix_len": 1024, "tail_lens": [int(x) for x in tails],
          "new_tokens": 64, "shared": out["on"], "unshared": out["off"],
          "tail_kv_rel_err_by_layer": rel.amax(dim=0).tolist(),
          "tail_kv_rel_err_by_request": rel.amax(dim=1).tolist(),
          "tail_kv_rel_err_limit_per_layer": KV_ROUNDING_PER_LAYER,
          "equal_token_share": same / (16 * 64),
          "first_tokens_equal": sum(a[0] == b[0] for a, b in pairs)})
    del tail_kv
    gc.collect()
    torch.cuda.empty_cache()
    return {m: out[m]["launches"] for m in out}


# ---------------------------------------------------------------------------
# the prefill graphs: replays against the eager body, at full width
# ---------------------------------------------------------------------------

PREFILL_ITERS = 5


def prefill_graph_case(torch, eng, prompt, row, start: int,
                       profile: bool) -> dict:
    """One prefill key of ``eng``: its graph captured (timed), then one
    admission's prefill through the engine (load, replay, read back)
    against an eager ``prefill_body`` call over a clone of the pool. First
    token and every page but the scratch page 0 (which the capture's
    warm-up calls write) bit-equal; the shared prefix pages unchanged.
    CUDA-event ms of the replay and of the eager body, and the host wall
    of one admission's prefill each way; with ``profile`` the host calls
    and device operations of one of each under the profiler."""
    import types
    from paddle_tpu_torch.serving.engine import prefill_body
    kv = eng.kv
    ps = kv.config.page_size
    n = int(prompt.size) - start
    shared = [int(x) for x in row[:start // ps]]
    t0 = time.perf_counter()
    g = eng.prefill_graph(start, n)
    capture_s = time.perf_counter() - t0
    ref = types.SimpleNamespace(
        config=kv.config, pool=kv.pool.clone(),
        scales=None if kv.scales is None else kv.scales.clone())
    before = kv.pool[shared].clone()
    ids = torch.as_tensor(prompt[None, start:], dtype=torch.int64,
                          device="cuda")
    pages = torch.as_tensor(row[:kv.pages_for(int(prompt.size))],
                            device="cuda")

    def eager():
        return int(prefill_body(eng._prefill_fn, ref, ids, pages,
                                start).reshape(-1)[0])

    want = eager()
    got = eng._prefill(prompt, row, start)
    pools_equal = torch.equal(kv.pool[1:], ref.pool[1:]) and (
        kv.scales is None or torch.equal(kv.scales[1:], ref.scales[1:]))
    differing = int(((kv.pool[1:].float() - ref.pool[1:].float()).abs()
                     .amax(dim=(1, 2, 3, 4, 5)) > 0).sum())
    prefix_kept = torch.equal(kv.pool[shared], before)
    res = {"key": f"{start}+{n}", "tokens_equal": got == want,
           "pools_equal": bool(pools_equal), "pages_differing": differing,
           "shared_pages": len(shared),
           "shared_pages_unchanged": bool(prefix_kept),
           "capture_s": capture_s, "graph_capture_s": g.capture_s,
           "launches_per_replay": {c.name: k for c, k in g.launches.items()},
           "replay_ms": cuda_ms(torch, g.replay, PREFILL_ITERS),
           "eager_ms": cuda_ms(torch, eager, PREFILL_ITERS)}
    for name, fn in (("replay", lambda: eng._prefill(prompt, row, start)),
                     ("eager", eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        res[f"{name}_host_wall_ms"] = (time.perf_counter() - t0) * 1e3
    if profile:
        res["profile"] = {
            "replay": profile_call(torch, lambda: eng._prefill(
                prompt, row, start)),
            "eager": profile_call(torch, eager)}
    require(res["tokens_equal"] and res["pools_equal"] and prefix_kept,
            f"prefill graph {res['key']}: replay and eager body differ: "
            f"{res}")
    return res


def moved_pool_rejected(eng, key) -> bool:
    """The planted fault: the pool reallocated under a captured prefill
    graph; its replay must raise."""
    kv = eng.kv
    pool = kv.pool
    kv.pool = pool.clone()
    try:
        eng.prefill_graph(*key).replay()
        return False
    except RuntimeError as exc:
        return "moved" in str(exc)
    finally:
        kv.pool = pool


def capture_beside_allocations(torch, eng, start: int, n: int) -> dict:
    """A new prefill key captured while another thread of the process
    allocates device memory (each block new, so a ``cudaMalloc``) and
    launches on a stream of its own: the capture is thread-local, so
    neither side fails."""
    import threading
    stop = threading.Event()
    seen = {"allocations": 0, "during_capture": 0, "error": None}
    window = []

    def allocate():
        side = torch.cuda.Stream()
        held = []
        try:
            with torch.cuda.stream(side):
                while not stop.is_set() and len(held) < 512:
                    held.append(torch.empty(8 << 20, dtype=torch.uint8,
                                            device="cuda").fill_(1))
                    side.synchronize()
                    seen["allocations"] += 1
                    if window and not window[1:]:
                        seen["during_capture"] += 1
        except Exception as exc:  # noqa: BLE001 (reported and required)
            seen["error"] = repr(exc)
        del held

    torch.cuda.empty_cache()
    worker = threading.Thread(target=allocate)
    worker.start()
    while not seen["allocations"] and worker.is_alive():
        time.sleep(0.001)
    window.append(time.perf_counter())
    try:
        eng.prefill_graph(start, n)
    finally:
        window.append(time.perf_counter())
        stop.set()
        worker.join()
    torch.cuda.empty_cache()
    require(seen["error"] is None and seen["during_capture"] > 0,
            f"prefill graph capture beside another thread's allocations: "
            f"{seen}")
    return {**seen, "capture_window_s": window[1] - window[0]}


def evicted_key_recaptured(torch, eng, case) -> dict:
    """The engine's memory check made short for one capture: the least
    recently used prefill graph is dropped for a new key, and its own key,
    met again, is captured anew and replays equal to the eager body."""
    prompt, row, start = case
    n = int(prompt.size) - start
    lru = next(iter(eng._prefill_graphs))
    require(lru == (start, n), f"eviction check: least recently used key "
                               f"{lru}, not {(start, n)}")
    live = len(eng._prefill_graphs)
    eng._memory_short = lambda: len(eng._prefill_graphs) >= live
    try:
        eng.prefill_graph(0, 200)
    finally:
        del eng._memory_short
    stats = eng.decode_stats()
    require(lru not in eng._prefill_graphs and stats["prefill_evictions"] == 1
            and stats["prefill_graphs_live"] == live,
            f"eviction check: {list(eng._prefill_graphs)}, {stats}")
    again = prefill_graph_case(torch, eng, prompt, row, start, profile=False)
    return {"dropped": f"{lru[0]}+{lru[1]}", "recaptured": again}


def prefill_graph_check(torch, card, model, kvc) -> None:
    """Llama-2-7B (bf16, 32 layers) prefills as graph replays against the
    eager body, on a bf16 and an int8 pool: full prefills of 128, 564 and
    1000 tokens, a full prefill of a 1024-token prefix with 16 more, then
    tails of 16 and 256 tokens over its 16 shared pages (the same row
    prefix); host calls of each under the profiler on the bf16 pool; a
    replay after the pool moved rejected."""
    import numpy as np
    from paddle_tpu_torch.serving import Engine, ServingConfig
    cfg = model.config
    prefill_fn, step_fn = model.serving_callables(2048)
    rng = np.random.default_rng(12)
    prefix = rng.integers(0, cfg.vocab_size, (1024,), dtype=np.int32)

    def prompt(n, head=()):
        return np.concatenate([np.asarray(head, np.int32), rng.integers(
            0, cfg.vocab_size, (n,), dtype=np.int32)])

    for leg in ("bf16", "int8"):
        t0 = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(prefill_fn, step_fn, ServingConfig(
            num_layers=cfg.num_hidden_layers,
            num_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
            max_len=2048, max_batch=1, buckets=(1,), page_size=64,
            compute_dtype="bfloat16",
            kv_dtype="native" if leg == "bf16" else "int8",
            prefix_sharing="on", device="cuda"))
        kv = eng.kv
        own = list(range(1, kv.config.num_pages))
        cases = [(prompt(n), kv.table_row(own[:kv.pages_for(n)]), 0)
                 for n in (128, 564, 1000)]
        cases.append((prompt(16, prefix), kv.table_row(own[:17]), 0))
        cases += [(prompt(n, prefix), kv.table_row(
            own[:16] + own[17 + i * 4:17 + i * 4 + kv.pages_for(n)]), 1024)
            for i, n in enumerate((16, 256))]
        rows = []
        for pr, row, start in cases:
            rows.append(prefill_graph_case(torch, eng, pr, row, start,
                                           profile=leg == "bf16"))
            emit({"phase": "prefill_graph_check", "model": "llama2_7b",
                  "card": card, "pool": leg, "prompt_len": int(pr.size),
                  **rows[-1]})
        caught = moved_pool_rejected(eng, (1024, 16))
        require(caught, f"prefill graph {leg}: a replay over a moved pool "
                        f"was not rejected")
        extra = {}
        if leg == "bf16":
            extra["beside_allocations"] = capture_beside_allocations(
                torch, eng, 0, 300)
            extra["beside_allocations"]["replay"] = prefill_graph_case(
                torch, eng, prompt(300), kv.table_row(own[:5]), 0,
                profile=False)
            extra["eviction"] = evicted_key_recaptured(torch, eng, cases[0])
        emit({"phase": "prefill_graph_check", "model": "llama2_7b",
              "pool": leg, "planted": "pool_moved", "caught": caught,
              **extra, "keys": [r["key"] for r in rows],
              "seconds": time.monotonic() - t0,
              **prefill_graph_counts(eng.decode_stats()),
              **memory_gb(torch)})
        del eng, kv
        gc.collect()
        torch.cuda.empty_cache()


def fmt_prefill_graph_check(torch, card, stack) -> None:
    """The FMT stack's prefills (22 layers, bf16) as graph replays against
    the eager body, on a bf16 and an int8 pool: the bidirectional prefill
    of 512 tokens, and the causal one of 512 tokens followed by a tail of
    64 over its 7 shared pages (start 448); host calls under the profiler
    on the bf16 pool; a replay after the pool moved rejected."""
    import numpy as np
    rng = np.random.default_rng(13)
    base = rng.integers(0, FMT["vocab"], (448,), dtype=np.int32)
    prompts = [np.concatenate([base, rng.integers(
        0, FMT["vocab"], (64,), dtype=np.int32)]) for _ in range(2)]
    for leg in ("bf16", "int8"):
        t0 = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for causal in (False, True):
            eng = fmt_engine(stack, FMT_MAX_LEN, 1, (1,),
                             "native" if leg == "bf16" else "int8",
                             "bfloat16", causal=causal,
                             prefix_sharing="on" if causal else "off")
            kv = eng.kv
            cases = [(prompts[0], kv.table_row(list(range(1, 9))), 0)]
            if causal:
                cases.append((prompts[1], kv.table_row(
                    list(range(1, 8)) + [9]), 448))
            for pr, row, start in cases:
                rows.append(prefill_graph_case(torch, eng, pr, row, start,
                                               profile=leg == "bf16"))
                emit({"phase": "prefill_graph_check", "model": "fmt",
                      "card": card, "pool": leg,
                      "prefill": "causal" if causal else "bidirectional",
                      "prompt_len": int(pr.size), **rows[-1]})
            caught = moved_pool_rejected(eng, (start, int(pr.size) - start))
            require(caught, f"fmt prefill graph {leg}: a replay over a "
                            f"moved pool was not rejected")
            del eng, kv
            gc.collect()
            torch.cuda.empty_cache()
        emit({"phase": "prefill_graph_check", "model": "fmt", "pool": leg,
              "planted": "pool_moved", "caught": True,
              "keys": [r["key"] for r in rows],
              "seconds": time.monotonic() - t0, **memory_gb(torch)})


# ---------------------------------------------------------------------------
# phase 7: engine tokens == generate tokens (full width, 2 layers, fp32)
# ---------------------------------------------------------------------------

def agree_2layer(torch, fa, pa):
    import numpy as np
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (Engine, GenerationRequest,
                                          ServingConfig)
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (37, 128, 300, 513)]
    # a pair with a shared 2-page prefix: the second prefills its tail only
    shared = rng.integers(0, cfg.vocab_size, (128,), dtype=np.int32)
    pair = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, (n,), dtype=np.int32)]) for n in (40, 77)]
    fa.launches.reset()
    pa.launches.reset()
    refs = []
    for pr in prompts + pair:
        ids = torch.as_tensor(pr[None, :].astype(np.int64), device="cuda")
        refs.append(model.generate(ids, max_new_tokens=16)[0, pr.size:]
                    .tolist())
    gen_launches = {"flash_prefill": fa.launches.count,
                    "paged_decode": pa.launches.count}
    prefill_fn, step_fn = model.serving_callables(1024)
    # no warmup(): each bucket is captured at its first step, each prefill
    # key at the admission that first meets it
    eng = Engine(prefill_fn, step_fn, ServingConfig(
        num_layers=2, num_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, max_len=1024, max_batch=4, buckets=(1, 4),
        page_size=64, compute_dtype="float32", prefix_sharing="on",
        device="cuda"))
    fa.launches.reset()
    pa.launches.reset()
    got = []
    for batch in (prompts, pair):
        futs = [eng.submit(GenerationRequest(pr, max_new_tokens=16))
                for pr in batch]
        eng.run()
        got += [f.result(timeout=0).tokens for f in futs]
    eng_launches = {"flash_prefill": fa.launches.count,
                    "paged_decode": pa.launches.count}
    stats = eng.decode_stats()
    require(got == refs, f"engine tokens {got} != generate tokens {refs}")
    require(gen_launches["flash_prefill"] == 6 * 16 * 2
            and gen_launches["paged_decode"] == 0,
            f"generate launches {gen_launches}")
    # six prefills, each a replay of a graph captured at its admission
    # after _WARM_STEPS eager calls on the side stream; the first capture
    # after the pool's primer's
    from paddle_tpu_torch.serving.engine import _WARM_STEPS
    warm = _WARM_STEPS * stats["prefill_graphs"]
    require(eng_launches["flash_prefill"] == (6 + warm) * 2
            and eng_launches["paged_decode"] > 0
            and stats["prefill_graphs"] == 7
            and sorted(stats["prefill_replays"].values()) == [1] * 6,
            f"engine launches {eng_launches}, prefill graphs "
            f"{keyed(stats['prefill_replays'])}")
    require(stats["prefills"] == {"full": 5, "tail": 1}
            and sum(stats["replays"].values())
            == sum(stats["steps"].values()) > 0
            and eng.kv.prefix_stats()["prefix_pages_shared_total"] == 2,
            f"engine_vs_generate: prefills {stats['prefills']}, replays "
            f"{stats['replays']}, {eng.kv.prefix_stats()}")
    emit({"phase": "engine_vs_generate", "layers": 2, "dtype": "float32",
          "prompts": [int(p.size) for p in prompts + pair],
          "shared_prefix": 128, "new_tokens": 16, "identical": True,
          "decode": "cuda_graph_per_bucket", "graph_replays": stats["replays"],
          "prefills": stats["prefills"],
          "prefill_replays": keyed(stats["prefill_replays"]),
          "generate_launches": gen_launches,
          "engine_launches": eng_launches})
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# serving under failure: fault sites, the watchdog on a real device stall,
# bounded prefill replay, the drain, and observability
# ---------------------------------------------------------------------------

CHAOS_WATCHDOG_S = 0.25
CHAOS_MAX_REPLAYS = 2
# the device stall: a torch.cuda._sleep of this many watchdog budgets queued
# on the engine's stream before one decode replay
STALL_BUDGETS = 1.5
STALL_AT_REPLAY = 5
# serve_chaos_check's serving.step probability: its requests decode 16
# tokens, the suite's 3-5 (see chaos_schedule)
CHECK_STEP_PROB = 0.015
# the deterministic card-against-CPU run: four of the short prompts (37,
# 128, 200 and 90 tokens)
DET_PROMPTS = (0, 1, 4, 5)


CHAOS_COUNTERS = ("serving.requests_total", "serving.tokens_total",
                  "serving.step_retries_total", "serving.admit_retries_total",
                  "serving.replays_total", "serving.rejected_total")


def chaos_errors():
    from paddle_tpu_torch.resilience import DeadlineExceeded, FaultInjected
    from paddle_tpu_torch.serving import (DrainTimeout, EngineStopped,
                                          WatchdogTimeout)
    return (FaultInjected, WatchdogTimeout, DeadlineExceeded, DrainTimeout,
            EngineStopped)


def chaos_schedule(seed: int, delay: bool = True, step_prob: float = 0.06):
    """The seeded schedule of ``tests/test_serving_chaos.py``'s sweep, all
    four serving sites; ``delay=False`` leaves out its timing-driven
    watchdog delay. The suite's requests decode 3-5 tokens; at
    ``step_prob`` 0.06 a 64-token request meets two step faults (and
    fails) nine times in ten, so longer requests take a ``step_prob``
    scaled by their length for the same faults a request."""
    from paddle_tpu_torch.resilience import FaultSchedule
    sched = FaultSchedule(seed)
    sched.error("serving.admit", prob=0.15)
    sched.error("serving.step", prob=step_prob)
    if delay:
        sched.delay("serving.watchdog", prob=0.04, times=1, seconds=0.8)
    sched.error("serving.watchdog", prob=0.05)
    sched.error("serving.drain", prob=0.5)
    return sched


def sleep_cycles_per_s(torch) -> float:
    """``torch.cuda._sleep`` cycles a second on this card (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    torch.cuda.synchronize()
    return 100_000_000 / (start.elapsed_time(end) / 1e3)


@contextlib.contextmanager
def device_stall(torch, eng, seconds: float, cycles_per_s: float,
                 at: int = STALL_AT_REPLAY):
    """Queue ``torch.cuda._sleep`` of ``seconds`` on the engine's stream
    before the first decode graph replay of the ``at``-th decode step
    inside the block (or of the first later step that launches), so that
    step's token read-back waits on the card. Yields a dict that receives
    the request ids of the stalled step's slots."""
    from paddle_tpu_torch.serving.engine import DecodeGraph
    real_replay = DecodeGraph.replay
    real_step = eng._decode_step
    state = {"steps": 0, "step_rids": [], "stalled_rids": [], "done": False}

    def decode_step(included):
        state["steps"] += 1
        state["step_rids"] = [s.request.request_id for s in included]
        return real_step(included)

    def replay(self):
        if not state["done"] and state["steps"] >= at:
            require(torch.cuda.current_stream() == eng.stream,
                    "a decode replay off the engine's stream")
            torch.cuda._sleep(int(seconds * cycles_per_s))
            state["stalled_rids"] = list(state["step_rids"])
            state["done"] = True
        return real_replay(self)

    DecodeGraph.replay = replay
    eng._decode_step = decode_step
    try:
        yield state
    finally:
        DecodeGraph.replay = real_replay
        del eng._decode_step


def fresh_obs(obs) -> None:
    """Every series zeroed (the families and their buckets stay) and
    collection on: a run's counts from 0."""
    obs.reset()
    obs.enable()


def chaos_drive(eng, prompts, new_tokens: int, sched=None):
    """Submit, run to the drain and ``stop(drain=True)``, under ``sched``
    when given; returns the requests, their Futures and the wall
    seconds."""
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import GenerationRequest
    eng.run()                      # clears a previous drain's latch
    t0 = time.monotonic()
    with (faults.installed(sched) if sched is not None
          else contextlib.nullcontext()):
        reqs = [GenerationRequest(p, max_new_tokens=new_tokens)
                for p in prompts]
        futs = [eng.submit(r) for r in reqs]
        eng.run()
        eng.stop(drain=True, timeout=60)
    return reqs, futs, time.monotonic() - t0


def chaos_outcomes(futs):
    """Per request ``("ok", tokens)`` or ``("err", type name)``; requires
    every Future resolved, with a result or a typed error."""
    errors = chaos_errors()
    out = []
    for f in futs:
        require(f.done(), "a Future was left unresolved")
        exc = f.exception(timeout=0)
        require(exc is None or isinstance(exc, errors),
                f"a Future resolved with an untyped error: {exc!r}")
        out.append(("err", type(exc).__name__) if exc is not None
                   else ("ok", list(f.result(timeout=0).tokens)))
    return out


def require_liveness(eng, outcomes, snap, what: str) -> dict:
    """The chaos suite's invariants: no page leaked, nothing queued or
    active after the drain, each request counted under exactly one
    terminal status, replays within ``max_replays`` a request."""
    statuses = snap.get("serving.requests_total", {})
    resolved = sum(statuses.get(f"status={s}", 0) for s in (
        "completed", "failed", "shed", "cancelled"))
    completed = sum(o[0] == "ok" for o in outcomes)
    replays = snap.get("serving.replays_total", 0)
    require(eng.kv.outstanding_pages == 0
            and eng.kv.free_pages == eng.kv.config.num_pages - 1
            and eng.active_requests == 0 and eng.queue_depth == 0,
            f"{what}: pages or requests left after the drain")
    require(resolved == len(outcomes)
            and statuses.get("status=completed", 0) == completed,
            f"{what}: terminal accounting {statuses} for {len(outcomes)} "
            f"requests, {completed} completed")
    require(replays <= eng.config.max_replays * len(outcomes),
            f"{what}: {replays} replays")
    return {"statuses": statuses, "completed": completed, "replays": replays}


def require_chaos_launches(before: dict, after: dict, counts: dict,
                           layers: int, what: str) -> dict:
    """B1 once a layer per prefill call (re-prefills included) and per
    warm-up call of a capture; B6 once a layer per launched decode replay
    (tripped and retried steps included)."""
    from paddle_tpu_torch.serving.engine import _WARM_STEPS
    d = stats_delta(before, after)
    prefills = sum(d["prefill_replays"].values())
    replays = sum(d["replays"].values())
    want = {"flash_prefill": (prefills + _WARM_STEPS * d["prefill_graphs"])
            * layers, "paged_decode": replays * layers}
    require(counts == want, f"{what}: launches {counts} != {want} "
            f"({prefills} prefill replays, {d['prefill_graphs']} captures, "
            f"{replays} decode replays)")
    return {"launches": counts, "prefill_replays": prefills,
            "captured": d["prefill_graphs"],
            "captured_s": d["prefill_capture_s"], "decode_replays": replays,
            "keys_replayed": keyed(d["prefill_replays"])}


def compare_tokens(reqs, outcomes, ref) -> dict:
    """Per completed request, whether its tokens equal the no-fault run's,
    and the first position where they differ."""
    same, first = {}, {}
    for r, o, want in zip(reqs, outcomes, ref):
        if o[0] != "ok":
            continue
        same[r.request_id] = o[1] == want
        if o[1] != want:
            first[r.request_id] = next(
                (k for k, (a, b) in enumerate(zip(o[1], want)) if a != b),
                min(len(o[1]), len(want)))
    return {"equal": same, "first_differing_position": first,
            "equal_share": sum(same.values()) / max(1, len(same))}


def flight_fault_sites(path) -> list:
    doc = json.load(open(path))
    require(doc["schema"] == 1 and doc["events"], f"{path}: empty dump")
    return [e["attrs"].get("site") for e in doc["events"]
            if e["name"] == "fault"]


def retried_step_bit_equal(torch, eng, prompts) -> dict:
    """Admit ``prompts`` and step; then the same decode step twice from one
    state: once with its token read-back failing after the launch (the
    engine retries the read, never the launch), once clean. Pools (and
    scales) must be bit-equal, tokens equal."""
    from paddle_tpu_torch.serving import GenerationRequest
    eng.run()
    futs = [eng.submit(GenerationRequest(p, max_new_tokens=16))
            for p in prompts]
    while eng.queue_depth or len(eng._slots) < len(prompts):
        eng.step()
    kv = eng.kv
    pool0 = kv.pool.clone()
    sc0 = None if kv.scales is None else kv.scales.clone()
    state0 = [(s, s.t, s.last_tok, list(s.tokens), s.last_token_time)
              for s in eng._slots]
    real, failed = eng._read, []

    def flaky(out):
        if not failed:
            failed.append(1)
            raise RuntimeError("read-back failed after the launch")
        return real(out)

    eng._read = flaky
    eng.step()
    del eng._read
    retried = (kv.pool.clone(), None if sc0 is None else kv.scales.clone(),
               [list(s.tokens) for s in eng._slots])
    kv.pool.copy_(pool0)
    if sc0 is not None:
        kv.scales.copy_(sc0)
    for s, t, last, toks, lt in state0:
        s.t, s.last_tok, s.tokens, s.last_token_time = t, last, toks, lt
    eng.step()
    require(failed and torch.equal(retried[0], kv.pool)
            and (sc0 is None or torch.equal(retried[1], kv.scales))
            and retried[2] == [list(s.tokens) for s in eng._slots],
            "a retried decode step did not leave the pool bit-equal to one "
            "step")
    eng.run()
    for f in futs:
        f.result(timeout=0)
    return {"bit_equal": True, "slots": len(prompts),
            "pool_dtype": dtype_name(kv.pool.dtype)}


@contextlib.contextmanager
def trace_dir_on(trace):
    """Tracing on, dumps and exports into a temporary directory."""
    import tempfile
    old = os.environ.get("PADDLE_TPU_TRACE_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["PADDLE_TPU_TRACE_DIR"] = tmp
        trace.set_mode("on")
        trace.clear()
        trace.flight_recorder().clear()
        try:
            yield tmp
        finally:
            trace.set_mode("off")
            trace.clear()
            if old is None:
                os.environ.pop("PADDLE_TPU_TRACE_DIR", None)
            else:
                os.environ["PADDLE_TPU_TRACE_DIR"] = old


def recovery_seconds(evs) -> list:
    """Per replay: seconds from its ``serving.replay`` instant to the end
    of that request's next prefill (its re-admission), from the trace."""
    begins = {e["span"]: e for e in evs if e["kind"] == "B"
              and e["name"] == "serving.prefill"}
    ends = sorted((begins[e["span"]]["attrs"]["rid"], e["ts"]) for e in evs
                  if e["kind"] == "E" and e["span"] in begins
                  and not e["attrs"].get("error"))
    out = []
    for e in evs:
        if e["name"] == "serving.replay":
            later = [ts for rid, ts in ends
                     if rid == e["attrs"]["rid"] and ts > e["ts"]]
            if later:
                out.append(min(later) - e["ts"])
    return out


def require_stall_tripped(snap, evs, stall, outcomes, reqs, what) -> dict:
    """The device stall tripped the watchdog (hung) and every slot of the
    stalled step replayed (or failed with WatchdogTimeout past its
    budget)."""
    trips = snap.get("serving.watchdog_trips_total", {})
    replayed = {e["attrs"]["rid"] for e in evs
                if e["name"] == "serving.replay"}
    timed_out = {r.request_id for r, o in zip(reqs, outcomes)
                 if o == ("err", "WatchdogTimeout")}
    stalled = set(stall["stalled_rids"])
    require(trips.get("kind=hung", 0) >= 1 and stalled
            and stalled <= replayed | timed_out,
            f"{what}: the device stall did not trip the watchdog and replay "
            f"its slots: trips {trips}, stalled {sorted(stalled)}, "
            f"replayed {sorted(replayed)}")
    rec = recovery_seconds(evs)
    return {"trips": trips, "stalled_rids": sorted(stalled),
            "replayed_rids": sorted(replayed),
            "recovery_s": {"n": len(rec),
                           "median": statistics.median(rec) if rec else None,
                           "max": max(rec, default=None)}}


def serve_chaos_check(torch, card, fa, pa) -> None:
    """Serving under failure at Llama-2-7B's width (2 layers, fp32), native
    and int8 pools, prefix sharing on (two prompts share a 1024-token
    prefix), watchdog 0.25 s, two replays: the chaos suite's seeded
    schedule at all four fault sites (its step-fault rate scaled to 16
    tokens) plus one device stall of 1.5 budgets on the engine's stream. Requires a hung trip whose slots replayed, every Future typed,
    survivors' and replays' tokens equal to the same engine's no-fault run
    (on int8 a replay re-quantizes its pages on the prefill's grid, so its
    tokens are reported, the others required), no leaked page, the shared
    prefix pages unchanged, exact accounting, B1/B6 launches as counted, a
    ``serving_recover`` flight dump naming a fault site, a retried step's
    pool bit-equal to one step, and under one deterministic schedule the
    card's outcomes, fault trace and terminal counters equal to the CPU
    engine's on the same weights."""
    import numpy as np
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.serving import Engine, ServingConfig
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1))
    cpu_model = LlamaForCausalLM(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    rng = np.random.default_rng(14)
    shared = rng.integers(0, cfg.vocab_size, (1024,), dtype=np.int32)
    pair = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, (n,), dtype=np.int32)]) for n in (40, 77)]
    short = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
             for n in (37, 128, 300, 513, 200, 90)]
    prompts = pair + short
    cycles = sleep_cycles_per_s(torch)

    def engine(m, leg, device, watchdog_s=CHAOS_WATCHDOG_S):
        return Engine(*m.serving_callables(2048), ServingConfig(
            num_layers=2, num_heads=cfg.num_key_value_heads,
            head_dim=cfg.head_dim, max_len=2048, max_batch=16,
            page_size=64, compute_dtype="float32", kv_dtype=leg,
            prefix_sharing="on", watchdog_s=watchdog_s,
            max_replays=CHAOS_MAX_REPLAYS, device=device))

    try:
        for leg in ("native", "int8"):
            t0 = time.monotonic()
            eng = engine(model, leg, "cuda").warmup()
            _, futs, _ = chaos_drive(eng, prompts, 16)
            ref = [o[1] for o in chaos_outcomes(futs)]
            # the prefix chain the no-fault run published must not change
            chain = eng.kv.acquire_prefix(pair[0])
            eng.kv.free(chain)
            require(len(chain) == 16, f"prefix chain of {len(chain)} pages")
            chain_before = eng.kv.pool[chain].clone()
            scales_before = (None if eng.kv.scales is None
                             else eng.kv.scales[chain].clone())
            retried = retried_step_bit_equal(torch, eng, short[:4])

            fresh_obs(obs)
            with trace_dir_on(trace) as tmp:
                for c in (fa.launches, pa.launches):
                    c.reset()
                before = eng.decode_stats()
                with device_stall(torch, eng, STALL_BUDGETS
                                  * CHAOS_WATCHDOG_S, cycles) as stall:
                    sched = chaos_schedule(1, step_prob=CHECK_STEP_PROB)
                    reqs, futs, wall = chaos_drive(eng, prompts, 16, sched)
                counted = require_chaos_launches(
                    before, eng.decode_stats(),
                    {"flash_prefill": fa.launches.count,
                     "paged_decode": pa.launches.count}, 2,
                    f"serve_chaos_check {leg}")
                outcomes = chaos_outcomes(futs)
                snap = obs.snapshot()
                what = f"serve_chaos_check {leg}"
                live = require_liveness(eng, outcomes, snap, what)
                evs = trace.events()
                tripped = require_stall_tripped(snap, evs, stall, outcomes,
                                                reqs, what)
                tokens = compare_tokens(reqs, outcomes, ref)
                replayed = set(tripped["replayed_rids"])
                held = {rid: eq for rid, eq in tokens["equal"].items()
                        if leg == "native" or rid not in replayed}
                require(all(held.values()),
                        f"{what}: tokens under fire differ from the no-fault "
                        f"run: {tokens['first_differing_position']}")
                require(torch.equal(eng.kv.pool[chain], chain_before)
                        and (scales_before is None or torch.equal(
                            eng.kv.scales[chain], scales_before)),
                        f"{what}: a shared prefix page changed")
                sites = flight_fault_sites(os.path.join(
                    tmp, f"flight-{os.getpid()}-serving_recover.json"))
                require(sites and sites[-1].startswith("serving."),
                        f"{what}: flight dump fault sites {sites}")
                hung = json.load(open(os.path.join(
                    tmp, f"flight-{os.getpid()}-watchdog_hung.json")))
                require(any(e["name"] == "watchdog_trip"
                            for e in hung["events"]),
                        f"{what}: the watchdog_hung dump has no trip")
                require(trace.span_problems() == [],
                        f"{what}: {trace.span_problems()[:5]}")
            eng.stop(drain=True)
            del eng
            gc.collect()
            torch.cuda.empty_cache()

            # one deterministic schedule (no timing-driven site, watchdog
            # off) on the card and on the CPU, the same weights
            det = {}
            for name, m, dev in (("card", model, "cuda"),
                                 ("cpu", cpu_model, "cpu")):
                e = engine(m, leg, dev, watchdog_s=0)
                fresh_obs(obs)
                sched_d = chaos_schedule(3, delay=False)
                _, dfuts, _ = chaos_drive(
                    e, [short[i] for i in DET_PROMPTS], 8, sched_d)
                dsnap = obs.snapshot()
                douts = chaos_outcomes(dfuts)
                require_liveness(e, douts, dsnap, f"{what} {name}")
                det[name] = {
                    "outcomes": [o[1] if o[0] == "err" else "ok"
                                 for o in douts],
                    "trace": [list(x) for x in sched_d.trace],
                    "counters": {k: dsnap[k] for k in CHAOS_COUNTERS
                                 if k in dsnap}}
                del e
                gc.collect()
            require(det["card"] == det["cpu"],
                    f"{what}: card and CPU engines differ under one "
                    f"deterministic schedule: {det}")
            emit({"phase": "serve_chaos_check", "card": card, "pool": leg,
                  "layers": 2, "dtype": "float32", "requests": len(prompts),
                  "shared_prefix": 1024, "new_tokens": 16,
                  "watchdog_s": CHAOS_WATCHDOG_S,
                  "max_replays": CHAOS_MAX_REPLAYS,
                  "step_prob": CHECK_STEP_PROB,
                  "stall_s": STALL_BUDGETS * CHAOS_WATCHDOG_S,
                  "stall_at_replay": STALL_AT_REPLAY,
                  "fault_trace": [list(x) for x in sched.trace],
                  **tripped, **live,
                  "outcomes": [o[0] if o[0] == "ok" else o[1]
                               for o in outcomes],
                  "tokens_vs_no_fault": tokens, **counted,
                  "flight_dump_fault_sites": sites[-3:],
                  "retried_step": retried,
                  "deterministic_vs_cpu": {"equal": True, **det["card"]},
                  "wall_s": wall, "seconds": time.monotonic() - t0})
    finally:
        obs.disable()
    del model, cpu_model
    gc.collect()
    torch.cuda.empty_cache()


def chaos_7b_leg(torch, eng, fa, pa, served, sched, cycles, srv, tmp,
                 layers: int, leg: str) -> dict:
    """One run of ``serve_chaos_7b``: the traffic under ``sched`` and one
    device stall, then its gates; returns the leg's report."""
    import urllib.request
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import GenerationRequest
    what = f"serve_chaos_7b {leg}"
    fresh_obs(obs)
    trace.clear()
    for c in (fa.launches, pa.launches):
        c.reset()
    eng.run()                      # clears a previous drain's latch
    before = eng.decode_stats()
    with device_stall(torch, eng, STALL_BUDGETS * CHAOS_WATCHDOG_S,
                      cycles) as stall, faults.installed(sched):
        t1 = time.monotonic()
        reqs = [GenerationRequest(p, max_new_tokens=64)
                for p in served["prompts"]]
        futs = [eng.submit(r) for r in reqs]
        eng.run()
        wall = time.monotonic() - t1
        with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        eng.stop(drain=True, timeout=60)
    counted = require_chaos_launches(
        before, eng.decode_stats(), {"flash_prefill": fa.launches.count,
                                     "paged_decode": pa.launches.count},
        layers, what)
    outcomes = chaos_outcomes(futs)
    snap = obs.snapshot()
    live = require_liveness(eng, outcomes, snap, what)
    tripped = require_stall_tripped(snap, trace.events(), stall, outcomes,
                                    reqs, what)
    require(eng.beacon in health["components"],
            f"{what}: /healthz lists {list(health['components'])}")
    with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    scraped = obs.parse_prometheus_text(text)
    snap = obs.snapshot()
    statuses = {f'{{status="{k.split("=")[1]}"}}': v for k, v in
                snap["serving.requests_total"].items()}
    require('serving_tpot_seconds_bucket{le="0.004"}' in text
            and scraped["serving_requests_total"] == statuses
            and scraped["serving_tokens_total"][""]
            == snap["serving.tokens_total"],
            f"{what}: /metrics disagrees with obs.snapshot(): "
            f"{scraped.get('serving_requests_total')} vs {statuses}")
    path = trace.export_chrome(os.path.join(tmp, f"serving-{leg}.json"))
    doc = json.load(open(path))
    require(doc["traceEvents"] and trace.span_problems() == [],
            f"{what}: chrome export or span tree broken: "
            f"{trace.span_problems()[:5]}")
    ntok = sum(len(o[1]) for o in outcomes if o[0] == "ok")
    return {"fault_trace": [list(x) for x in sched.trace], **tripped,
            **live, "wall_s": wall, "completed_tokens_per_s": ntok / wall,
            "outcomes": [o[0] if o[0] == "ok" else o[1] for o in outcomes],
            "tokens_vs_no_fault": compare_tokens(reqs, outcomes,
                                                 served["transcripts"]),
            **counted, "ttft_hist": snap.get("serving.ttft_seconds"),
            "tpot_hist": snap.get("serving.tpot_seconds"),
            "healthz": health["status"],
            "metrics_lines": len(text.splitlines()),
            "trace_events": len(doc["traceEvents"])}


def serve_chaos_7b(torch, card, fa, pa, model, served):
    """``serve_llama2_7b``'s traffic (16 prompts of 128-1000 tokens, 64 new,
    lengths warmed; 32 layers bf16) with a 0.25 s watchdog, two replays
    and one device stall a run, observability and tracing on, the scrape
    endpoint on port 0 (the engine starts it from
    ``PADDLE_TPU_OBS_HTTP_PORT``); twice: under the chaos suite's seeded
    schedule as it is, then with its step-fault rate scaled to 64-token
    requests. Requires in each the liveness invariants, the B1/B6
    launches as counted, ``/metrics`` over loopback carrying the SLO
    bucket ``le="0.004"`` and the same ``requests_total`` statuses as
    ``obs.snapshot()``, ``/healthz`` listing the engine's beacon, and a
    parseable Chrome export with no span problem. Reports tok/s under
    fire, trips, replays, recovery seconds, the replay keys captured and
    their seconds, and the share of survivors' tokens equal to the
    no-fault run's. Returns the engine (for ``obs_overhead_7b``) and each
    run's B1/B6 launches."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import http as obs_http
    from paddle_tpu_torch.observability import trace
    t0 = time.monotonic()
    prefill_fn, _ = model.serving_callables(2048)
    cycles = sleep_cycles_per_s(torch)
    os.environ["PADDLE_TPU_OBS_HTTP_PORT"] = "0"
    fresh_obs(obs)
    legs = {}
    try:
        with trace_dir_on(trace) as tmp:
            eng = engine_7b(model, prefill_fn, "off", served["lens"],
                            watchdog_s=CHAOS_WATCHDOG_S,
                            max_replays=CHAOS_MAX_REPLAYS)
            srv = obs_http._GLOBAL
            require(srv is not None, "the engine started no scrape endpoint")
            for leg, step_prob in (("suite", 0.06),
                                   ("per_token", 0.06 * 4 / 64)):
                legs[leg] = {"step_prob": step_prob, **chaos_7b_leg(
                    torch, eng, fa, pa, served,
                    chaos_schedule(0, step_prob=step_prob), cycles, srv,
                    tmp, model.config.num_hidden_layers, leg)}
    finally:
        obs.disable()
        os.environ.pop("PADDLE_TPU_OBS_HTTP_PORT", None)
        if obs_http._GLOBAL is not None:
            obs_http._GLOBAL.close()
            obs_http._GLOBAL = None
    emit({"phase": "serve_chaos_7b", "card": card, "layers": 32,
          "dtype": "bfloat16", "requests": len(served["prompts"]),
          "new_tokens": 64, "watchdog_s": CHAOS_WATCHDOG_S,
          "max_replays": CHAOS_MAX_REPLAYS,
          "stall_s": STALL_BUDGETS * CHAOS_WATCHDOG_S, **legs,
          "seconds": time.monotonic() - t0})
    return eng, {leg: v["launches"] for leg, v in legs.items()}


OBS_RUNS = 3


def obs_overhead_7b(torch, card, eng, served) -> None:
    """The warmed ``serve_llama2_7b`` traffic three times each way,
    interleaved, on one engine: observability disabled and no watchdog
    (the default), then observability and tracing on with a 0.25 s
    watchdog. Reports tok/s, TTFT and TPOT each way, and the host calls of
    one bucket-16 decode step (``eng.step()`` with 16 live slots) each way;
    requires the disabled step to make no more launch calls than
    ``decode_step_profile``'s replayed step."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.serving import GenerationRequest, StepWatchdog
    watchdog = eng._watchdog

    def mode(on: bool) -> None:
        if eng._watchdog is not None:
            eng._watchdog.stop()
        eng._watchdog = watchdog if on else None
        (obs.enable if on else obs.disable)()
        trace.set_mode("on" if on else "off")
        trace.clear()

    def decode_step_calls() -> dict:
        futs = [eng.submit(GenerationRequest(p, max_new_tokens=64))
                for p in served["prompts"]]
        while eng.queue_depth or eng.active_requests < len(futs):
            eng.step()
        row = profile_call(torch, eng.step)
        eng.run()
        for f in futs:
            f.result(timeout=0)
        return {"host_launch_calls": row["host_launch_calls"],
                "host_calls": row["host_calls"],
                "profiled_wall_ms": row["profiled_wall_ms"]}

    require(isinstance(watchdog, StepWatchdog),
            "obs_overhead_7b: the engine has no watchdog to turn on")
    runs = {"off": [], "on": []}
    steps = {}
    fresh_obs(obs)
    try:
        eng.run()
        for i in range(OBS_RUNS):
            for name in ("off", "on"):
                mode(name == "on")
                wall, results, _ = run_traffic(torch, eng, served["prompts"],
                                               64)
                require(all(len(r.tokens) == 64 for r in results),
                        f"obs_overhead_7b {name}: short transcripts")
                runs[name].append(serving_numbers(results, wall))
        for name in ("off", "on"):
            mode(name == "on")
            steps[name] = decode_step_calls()
    finally:
        mode(False)
    require(steps["off"]["host_launch_calls"]
            <= served["graph_host_launch_calls"],
            f"obs_overhead_7b: a decode step with observability off makes "
            f"{steps['off']['host_launch_calls']} launch calls, the replayed "
            f"step of decode_step_profile "
            f"{served['graph_host_launch_calls']}")
    med = {name: {k: statistics.median(r[k] for r in rows) for k in (
        "tokens_per_s", "ttft_median_s", "tpot_median_s")}
        for name, rows in runs.items()}
    emit({"phase": "obs_overhead_7b", "card": card, "runs": runs,
          "median": med,
          "on_vs_off_tokens_per_s": med["on"]["tokens_per_s"]
          / med["off"]["tokens_per_s"],
          "decode_step_host_calls": steps,
          "decode_step_profile_host_launch_calls":
              served["graph_host_launch_calls"]})


# ---------------------------------------------------------------------------
# the serving front door: the router, the HTTP front door, the process fleet
# ---------------------------------------------------------------------------

ROUTER_RUNS = 3
# the prompt length the router engines are not warmed with (serve_7b's 16
# are linspace(128, 1000, 16)): its prefill graph is captured at its
# admission, under load
FIRST_USE_LEN = 700
SERVE_FUSED = ("fused_norm", "rope", "swiglu", "embedding")
# the fleet's workers: Llama-2-7B's widths at this depth (a respawn, with
# its process start, weights and captures, must fit the run's time limit)
FLEET_LAYERS = 4
FLEET_SEED = 0
FLEET_SPAWN_S = 300.0
# the kill scenario: every slot of the victim held by a stream of a short
# prompt and this many new tokens, so one more request waits in its queue
FLEET_HOLD_PROMPT, FLEET_HOLD_TOKENS = 48, 1900


def serve_counters(fa, pa) -> dict:
    """The launch counters the Llama serving path moves, by kernel."""
    return {"flash_prefill": fa.launches, "paged_decode": pa.launches,
            **{k: v for k, v in step_counters().items() if k in SERVE_FUSED}}


def expected_launches(stats: dict, layers: int) -> dict:
    """The launches one engine's run made by ``require_served``'s
    accounting, from its ``decode_stats()`` delta: B1 per prefill call
    (replays, and the warm-up calls of graphs captured in the run), B6 per
    decode step, K1-K3 and K5 per call."""
    from paddle_tpu_torch.serving.engine import _WARM_STEPS
    steps = sum(stats["steps"].values())
    calls = sum(stats["prefill_replays"].values()) \
        + _WARM_STEPS * stats["prefill_graphs"]
    per = {"fused_norm": 2 * layers + 1, "rope": layers, "swiglu": layers,
           "embedding": 1}
    return {"flash_prefill": calls * layers, "paged_decode": steps * layers,
            **{k: n * (calls + steps) for k, n in per.items()}}


def placed_on(router) -> dict:
    """Request id -> the replica that holds it (the last pick)."""
    out = {}
    for e in router.trace:
        if e[0] == "pick":
            out[e[1]] = e[2]
    return out


def require_router_served(engines: dict, stats: dict, per_engine: dict,
                          launches: dict, layers: int, vocab: int,
                          new_tokens: int, what: str,
                          captured=None) -> dict:
    """Each engine's run by ``require_served``'s rules (every request
    ``new_tokens`` long, every decode step a replay, every admission one
    prefill replay, ``captured`` graphs captured in the run, no page
    leaked), and the engines' expected launches summed equal to the
    process-wide counters, which both loop threads moved."""
    total = {k: 0 for k in launches}
    for name, eng in engines.items():
        st = stats[name]
        tokens = per_engine.get(name, [])
        for t in tokens:
            require(len(t) == new_tokens and all(0 <= x < vocab for x in t),
                    f"{what} {name}: a transcript of {len(t)} tokens")
        steps = sum(st["steps"].values())
        require(sum(st["replays"].values()) == steps,
                f"{what} {name}: {steps} decode steps but replays "
                f"{st['replays']}")
        require_prefill_replays(st, len(tokens),
                                (captured or {}).get(name, 0),
                                f"{what} {name}")
        for k, n in expected_launches(st, layers).items():
            total[k] += n
        require(eng.kv.outstanding_pages == 0
                and eng.kv.free_pages == eng.kv.config.num_pages - 1,
                f"{what} {name}: pages leaked")
    require(total == launches,
            f"{what}: launches {launches}, the engines' accounting sums to "
            f"{total}")
    return total


def http_generate(fd, prompt, new_tokens: int, stream: bool,
                  on_token=None) -> dict:
    """One ``POST /v1/generate`` over loopback as its client sees it: the
    status, the tokens (streamed, or the body's), the SSE terminal events,
    each streamed token's index and the client's clock at send, at each
    token and at the end."""
    import http.client
    conn = http.client.HTTPConnection(fd.host, fd.port, timeout=900)
    out = {"stream": stream, "tokens": [], "indices": [], "terminals": [],
           "stamps": []}
    try:
        body = json.dumps({"prompt": [int(x) for x in prompt],
                           "max_new_tokens": new_tokens,
                           "stream": stream}).encode()
        out["t_send"] = time.monotonic()
        conn.connect()
        out["t_connected"] = time.monotonic()
        conn.request("POST", "/v1/generate", body=body)
        resp = conn.getresponse()
        out["status"] = resp.status
        out["retry_after"] = resp.headers.get("Retry-After")
        if not stream or resp.status != 200:
            out["doc"] = json.loads(resp.read())
            out["tokens"] = list(out["doc"].get("tokens", []))
        else:
            event = "message"
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.decode().rstrip("\n")
                if line.startswith("event: "):
                    event = line[len("event: "):]
                elif line.startswith("data: "):
                    doc = json.loads(line[len("data: "):])
                    if event in ("done", "error"):
                        out["terminals"].append((event, doc))
                    else:
                        out["stamps"].append(time.monotonic())
                        out["tokens"].append(doc["token"])
                        out["indices"].append(doc["index"])
                        if on_token is not None:
                            on_token(len(out["tokens"]))
                elif not line:
                    event = "message"
        out["t_end"] = time.monotonic()
    finally:
        conn.close()
    return out


def http_traffic(fd, prompts, new_tokens: int, on_token=None):
    """Every prompt posted at once from a client thread of its own, the
    even-numbered ones streamed (SSE); returns the wall seconds and the
    clients' records in prompt order. ``on_token(i, n)`` runs on request
    i's client thread at its n-th streamed token."""
    import threading
    outs = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            outs[i] = http_generate(
                fd, prompts[i], new_tokens, i % 2 == 0,
                None if on_token is None else (lambda n: on_token(i, n)))
        except BaseException as e:           # noqa: BLE001 - re-raised
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.monotonic() - t0
    require(not errors and all(not t.is_alive() for t in threads),
            f"an HTTP client failed or hung: {errors}")
    return wall, outs


def terminal_of(out) -> tuple:
    """(status, error name or None, final tokens or None) of one client
    record: a unary body's, or an SSE stream's single terminal event."""
    if not out["stream"] or out["status"] != 200:
        doc = out["doc"]
        return out["status"], doc.get("error"), doc.get("tokens")
    require(len(out["terminals"]) == 1,
            f"an SSE stream ended with {len(out['terminals'])} terminal "
            f"events")
    kind, doc = out["terminals"][0]
    if kind == "done":
        return 200, None, doc["tokens"]
    return doc["status"], doc["error"], None


def request_id_of(out):
    if out["stream"] and out["status"] == 200:
        return out["terminals"][0][1].get("request_id")
    return out["doc"].get("request_id")


def require_http_ok(outs, what: str) -> list:
    """Every response 200, every stream one ``done`` whose tokens are the
    streamed ones, each index once in order; returns the transcripts."""
    got = []
    for i, o in enumerate(outs):
        status, err, tokens = terminal_of(o)
        require(status == 200, f"{what}: request {i} answered {status} "
                               f"({err})")
        if o["stream"]:
            require(o["tokens"] == tokens
                    and o["indices"] == list(range(len(tokens))),
                    f"{what}: request {i}'s streamed tokens differ from its "
                    f"done event's")
        got.append(list(tokens))
    return got


def http_numbers(outs, wall: float) -> dict:
    """tok/s over the traffic's wall time; TTFT and TPOT medians as the
    clients saw them (the streamed requests' own clocks), and as the
    engines measured them (every request's result)."""
    sse = [o for o in outs if o["stream"] and len(o["stamps"]) > 1]
    docs = [o["terminals"][0][1] if o["stream"] else o["doc"] for o in outs]
    return {"wall_s": wall,
            "tokens_per_s": sum(len(o["tokens"]) for o in outs) / wall,
            "client_ttft_median_s": statistics.median(
                o["stamps"][0] - o["t_send"] for o in sse),
            "client_ttft_max_s": max(o["stamps"][0] - o["t_send"]
                                     for o in sse),
            "client_connect_max_s": max(o["t_connected"] - o["t_send"]
                                        for o in outs),
            "client_tpot_median_s": statistics.median(
                (o["stamps"][-1] - o["stamps"][0]) / (len(o["stamps"]) - 1)
                for o in sse),
            "engine_ttft_median_s": statistics.median(
                d["ttft_s"] for d in docs),
            "engine_tpot_median_s": statistics.median(
                d["tpot_s"] for d in docs)}


def transcript_agreement(got, want) -> dict:
    """Whole transcripts equal to ``want``'s, and each other one's first
    differing position."""
    first_diff = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                       min(len(a), len(b)))
                  for a, b in zip(got, want) if a != b]
    return {"equal_transcript_share": sum(a == b for a, b in zip(got, want))
            / len(want),
            "first_differing_positions": first_diff}


def router_submit_traffic(router, prompts, new_tokens: int, extra=None):
    """The traffic through ``Router.submit`` (no HTTP): every prompt
    submitted at once, each token stamped on the engine's loop thread;
    ``extra`` (a prompt) is submitted once four requests have their first
    token, under load. Returns wall seconds, the requests, their results
    and the token stamps."""
    import threading
    from paddle_tpu_torch.serving import GenerationRequest
    stamps = {}
    started = threading.Event()
    first = set()

    def stamp(rid, tok):
        stamps.setdefault(rid, []).append(time.monotonic())
        first.add(rid)
        if len(first) >= 4:
            started.set()

    t0 = time.monotonic()
    reqs = [GenerationRequest(p, max_new_tokens=new_tokens, stream=stamp)
            for p in prompts]
    futs = [router.submit(r) for r in reqs]
    if extra is not None:
        require(started.wait(timeout=120), "no first tokens under load")
        reqs.append(GenerationRequest(extra, max_new_tokens=new_tokens,
                                      stream=stamp))
        futs.append(router.submit(reqs[-1]))
    results = [f.result(timeout=600) for f in futs]
    return time.monotonic() - t0, reqs, results, stamps


def router_engines(model, names, prefix_sharing: str, prompt_lens):
    """One serve_7b engine per name (its own ``ServingConfig.name`` and
    ``serving_callables``, the one model's weights), warmed."""
    out = {}
    for name in names:
        prefill_fn, _ = model.serving_callables(2048)
        out[name] = engine_7b(model, prefill_fn, prefix_sharing, prompt_lens,
                              name=name)
    return out


def serve_router_7b(torch, card, fa, pa, model, served) -> dict:
    """``serve_router_7b``: a ``FrontDoor`` over a ``Router`` over two
    in-process serve_7b engines ``a`` and ``b`` (Llama-2-7B, 32 layers,
    bf16, page 64, max_len 2048, max_batch 16, budget policy; each its own
    ``serving_callables(2048)`` over the one model, warmed with the
    traffic's 16 lengths), serve_7b's 16 prompts (128-1000 tokens, 64 new)
    posted by 16 client threads over loopback, 8 streamed (SSE) and 8
    unary, three times; then the same traffic through ``Router.submit``
    with one more prompt of an unwarmed length submitted under load (its
    prefill graph captured while both loops run); a drain of ``b`` after
    the first streamed token, then ``b`` restored and one request placed on
    it; and serve_prefix_7b's shared-prefix traffic with prefix sharing on
    (prefix-affine placement). Gates: 200s, one terminal event a stream
    carrying the streamed tokens, first tokens equal to serve_7b's,
    ``require_served``'s accounting on each engine with the launches
    summed equal to the global counters, both replicas used, no page
    leaked, the drain typed. Returns the first HTTP run's launches."""
    import numpy as np
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import FrontDoor, Router, RouterConfig
    t_phase = time.monotonic()
    cfg = model.config
    layers, vocab = cfg.num_hidden_layers, cfg.vocab_size
    prompts, lens = served["prompts"], served["lens"]
    want = served["transcripts"]
    counters = serve_counters(fa, pa)
    # the engines beat their /healthz beacons (a replica whose beacon goes
    # stale leaves the rotation) with observability on
    fresh_obs(obs)
    t0 = time.monotonic()
    engines = router_engines(model, ("a", "b"), "off", lens)
    warmup_s = time.monotonic() - t0
    router = Router(list(engines.items()), RouterConfig(seed=0))
    fd = FrontDoor(router)
    router.start()
    runs = []

    def measured(drive, captured=None):
        """Run ``drive()`` with every counter from 0; returns its result,
        each engine's stats delta and the launches."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        before = {n: e.decode_stats() for n, e in engines.items()}
        result = drive()
        torch.cuda.synchronize()
        stats = {n: stats_delta(before[n], e.decode_stats())
                 for n, e in engines.items()}
        return result, stats, {k: c.count for k, c in counters.items()}

    def engine_rows(stats):
        return {n: {"decode_steps": sum(s["steps"].values()),
                    "batch_sizes": s["steps"], "graph_replays": s["replays"],
                    "prefill_replays": keyed(s["prefill_replays"]),
                    **prefill_graph_counts(s)} for n, s in stats.items()}

    try:
        for i in range(ROUTER_RUNS):
            n_picks = len(router.trace)
            (wall, outs), stats, launches = measured(
                lambda: http_traffic(fd, prompts, 64))
            got = require_http_ok(outs, f"serve_router_7b run {i + 1}")
            require([t[0] for t in got] == [t[0] for t in want],
                    f"serve_router_7b run {i + 1}: first tokens differ from "
                    f"serve_llama2_7b's (same prefill graph keys)")
            where = placed_on(router)
            by_engine = {n: [] for n in engines}
            for o, t in zip(outs, got):
                by_engine[where[request_id_of(o)]].append(t)
            require(all(by_engine.values()),
                    f"serve_router_7b run {i + 1}: a replica took no "
                    f"request: {[len(v) for v in by_engine.values()]}")
            total = require_router_served(
                engines, stats, by_engine, launches, layers, vocab, 64,
                f"serve_router_7b run {i + 1}")
            runs.append({**http_numbers(outs, wall),
                         "placed": {n: len(v) for n, v in by_engine.items()},
                         "engines": engine_rows(stats), "launches": launches,
                         **transcript_agreement(got, want),
                         "trace_entries": len(router.trace) - n_picks,
                         **memory_gb(torch)})
            if i == 0:
                main_launches = total
        spread = {k: [min(r[k] for r in runs), max(r[k] for r in runs)]
                  for k in ("tokens_per_s", "client_ttft_median_s",
                            "client_tpot_median_s")}
        # the same traffic through Router.submit, no HTTP
        direct = router_submit_run(torch, router, engines, measured,
                                   engine_rows, prompts, want, layers, vocab)
        # and again with one prompt of a length no engine was warmed with,
        # submitted under load: its prefill graph is captured while both
        # loops run
        rng = np.random.default_rng(7)
        first_use = router_submit_run(
            torch, router, engines, measured, engine_rows, prompts, want,
            layers, vocab, extra=rng.integers(0, vocab, (FIRST_USE_LEN,),
                                              dtype=np.int32))
        drain = router_drain_run(router, fd, engines, prompts, want)
        emit({"phase": "serve_router_7b", "card": card, "layers": layers,
              "dtype": "bfloat16", "replicas": sorted(engines),
              "requests": len(prompts), "streamed": len(prompts[::2]),
              "prompt_lens": [int(x) for x in lens], "new_tokens": 64,
              "warmup_s": warmup_s, "runs": runs,
              "spread_min_max": spread, "router_submit": direct,
              "http_vs_submit_tokens_per_s": statistics.median(
                  r["tokens_per_s"] for r in runs)
              / direct["tokens_per_s"],
              "first_use_under_load": first_use,
              "drain_run": drain,
              "stream_per_engine": all(
                  e.stream is not None
                  and e.stream != torch.cuda.default_stream()
                  for e in engines.values())})
    finally:
        router.stop(drain=True, timeout=60)
        fd.close()
        obs.disable()
    del engines, router, fd
    gc.collect()
    torch.cuda.empty_cache()
    serve_router_prefix_7b(torch, card, fa, pa, model)
    emit({"phase": "serve_router_7b_seconds",
          "seconds": time.monotonic() - t_phase})
    return main_launches


def router_submit_run(torch, router, engines, measured, engine_rows,
                      prompts, want, layers: int, vocab: int,
                      extra=None) -> dict:
    """``router_submit_traffic`` under ``measured`` with
    ``require_router_served``'s gates and first tokens equal to ``want``'s;
    with ``extra`` its engine must capture exactly that one prefill graph
    in the run. Reports the numbers, placement, engines, launches, the
    transcripts' agreement and, with ``extra``, the capture's seconds and
    each engine's longest gap between two tokens of a request."""
    what = "serve_router_7b submit" + (" first use" if extra is not None
                                       else "")
    (wall, reqs, results, stamps), stats, launches = measured(
        lambda: router_submit_traffic(router, prompts, 64, extra))
    where = placed_on(router)
    by_engine = {n: [] for n in engines}
    for r, res in zip(reqs, results):
        by_engine[where[r.request_id]].append(res.tokens)
    host = where[reqs[-1].request_id] if extra is not None else None
    require_router_served(engines, stats, by_engine, launches, layers,
                          vocab, 64, what,
                          captured={n: int(n == host) for n in engines})
    mine = results[:len(prompts)]
    require([r.tokens[0] for r in mine] == [t[0] for t in want],
            f"{what}: first tokens differ from serve_llama2_7b's")
    row = {**serving_numbers(results, wall),
           "placed": {n: len(v) for n, v in by_engine.items()},
           "engines": engine_rows(stats), "launches": launches,
           **transcript_agreement([r.tokens for r in mine], want),
           **memory_gb(torch)}
    if extra is not None:
        row["first_use"] = {
            "prompt_len": int(extra.size), "engine": host,
            "capture_s": stats[host]["prefill_capture_s"],
            "max_token_gap_s_by_engine": {
                n: max((max(b - a for a, b in zip(s, s[1:]))
                        for rid, s in stamps.items()
                        if where[rid] == n and len(s) > 1), default=None)
                for n in engines}}
    return row


def router_drain_run(router, fd, engines, prompts, want) -> dict:
    """The HTTP traffic once more, ``drain_replica("b", timeout=0)``
    issued at the first streamed token: ``b`` leaves the rotation before
    its drain begins, its admitted requests end typed (DrainTimeout, 503),
    its queued ones fail over to ``a``; every request ends 200 or with its
    mapped typed status and every stream with one terminal event. Then
    ``b`` restored and one request placed on it (``a`` latched out for
    it)."""
    import threading
    fired = threading.Event()
    done = threading.Event()
    box = {}

    def on_token(i, n):
        if not fired.is_set():
            fired.set()
            t = threading.Thread(target=drain, daemon=True)
            t.start()

    def drain():
        box["trace_at"] = len(router.trace)
        router.drain_replica("b", timeout=0.0, on_timeout="fail")
        box["rotation"] = router.in_rotation()
        done.set()

    wall, outs = http_traffic(fd, prompts, 64, on_token=on_token)
    require(done.wait(timeout=60), "serve_router_7b drain: the drain hung")
    statuses = {}
    for i, o in enumerate(outs):
        status, err, tokens = terminal_of(o)
        require(status == 200 or (status in (503, 504) and err in (
            "DrainTimeout", "EngineStopped")),
            f"serve_router_7b drain: request {i} answered {status} ({err})")
        if status == 200:
            require(len(tokens) == 64 and tokens[0] == want[i][0],
                    f"serve_router_7b drain: request {i} completed wrong")
        if o["stream"] and status == 200:
            require(o["tokens"] == tokens, "serve_router_7b drain: a "
                                           "stream's tokens differ from its "
                                           "done event's")
        key = f"{status}" + (f" {err}" if err else "")
        statuses[key] = statuses.get(key, 0) + 1
    tail = router.trace[box["trace_at"]:]
    out_at = tail.index(("out", "b"))
    failovers = [e for e in tail if e[0] == "failover"]
    require(all(tail.index(e) > out_at for e in failovers)
            and box["rotation"] == ["a"],
            f"serve_router_7b drain: b not out of the rotation before its "
            f"drain ({box['rotation']})")
    for name, eng in engines.items():
        require(eng.kv.outstanding_pages == 0,
                f"serve_router_7b drain: pages leaked on {name}")
    # b back, and a request placed on it
    router.restore_replica("b")
    router.latch_out("a")
    try:
        o = http_generate(fd, prompts[0], 64, False)
    finally:
        router.restore_replica("a")
    status, err, tokens = terminal_of(o)
    require(status == 200 and placed_on(router)[o["doc"]["request_id"]]
            == "b" and tokens[0] == want[0][0],
            f"serve_router_7b drain: the restored replica answered {status} "
            f"({err})")
    return {"wall_s": wall, "statuses": statuses,
            "failovers": len(failovers),
            "rotation_during_drain": box["rotation"],
            "restored_request_on": "b"}


def serve_router_prefix_7b(torch, card, fa, pa, model) -> None:
    """``serve_router_7b_prefix``: serve_prefix_7b's traffic (16 requests
    sharing a 1024-token prefix, tails of 16-256 tokens, 64 new) through
    ``Router.submit`` over two serve_7b engines with prefix sharing on,
    every full and tail prefill key warmed on both: the first request
    alone (its admission publishes the prefix on its replica), then the
    other 15 at once, placed by prefix-affine pick-2 (bias 0.75). Reports
    the share of the 15 placed on the replica holding the prefix, and
    prompt tokens computed / requested over both engines."""
    import numpy as np
    from paddle_tpu_torch.serving import (GenerationRequest, Router,
                                          RouterConfig)
    cfg = model.config
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (1024,), dtype=np.int32)
    tails = rng.integers(16, 257, (16,))
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, (n,), dtype=np.int32)]) for n in tails]
    t0 = time.monotonic()
    engines = router_engines(model, ("a", "b"), "on",
                             [p.size for p in prompts])
    for eng in engines.values():
        for p in prompts:
            eng.prefill_graph(1024, p.size - 1024)
    warmup_s = time.monotonic() - t0
    counters = serve_counters(fa, pa)
    router = Router(list(engines.items()), RouterConfig(seed=0))
    router.start()
    try:
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        before = {n: e.decode_stats() for n, e in engines.items()}
        t0 = time.monotonic()
        first = router.submit(GenerationRequest(prompts[0],
                                                max_new_tokens=64))
        results = [first.result(timeout=600)]
        futs = [router.submit(GenerationRequest(p, max_new_tokens=64))
                for p in prompts[1:]]
        results += [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        stats = {n: stats_delta(before[n], e.decode_stats())
                 for n, e in engines.items()}
        launches = {k: c.count for k, c in counters.items()}
        where = placed_on(router)
        holder = where[results[0].request_id]
        by_engine = {n: [r.tokens for r in results
                         if where[r.request_id] == n] for n in engines}
        require_router_served(
            engines, stats, by_engine, launches, cfg.num_hidden_layers,
            cfg.vocab_size, 64, "serve_router_7b_prefix",
            captured={n: s["prefill_graphs"] for n, s in stats.items()})
        affine = [e for e in router.trace if e[0] == "affinity"]
        requested = sum(e.prefill_token_stats()[0] for e in engines.values())
        computed = sum(e.prefill_token_stats()[1] for e in engines.values())
        require(computed < requested and affine,
                f"serve_router_7b_prefix: prefill tokens {computed} of "
                f"{requested}, {len(affine)} affine placements")
        emit({"phase": "serve_router_7b_prefix", "card": card,
              "requests": 16, "prefix_len": 1024,
              "tail_lens": [int(x) for x in tails], "new_tokens": 64,
              "warmup_s": warmup_s, **serving_numbers(results, wall),
              "prefix_holder": holder,
              "placed": {n: len(v) for n, v in by_engine.items()},
              "placed_on_holder_share": sum(
                  where[r.request_id] == holder for r in results[1:]) / 15,
              "affinity_entries": len(affine),
              "prefill_tokens_requested": requested,
              "prefill_tokens_computed": computed,
              "computed_over_requested": computed / requested,
              "prefills": {n: s["prefills"] for n, s in stats.items()},
              "captured_in_run": {n: s["prefill_graphs"]
                                  for n, s in stats.items()},
              "launches": launches, **memory_gb(torch)})
    finally:
        router.stop(drain=True, timeout=60)
    del engines, router
    gc.collect()
    torch.cuda.empty_cache()


def fleet_engine(name: str, layers: int = FLEET_LAYERS,
                 seed: int = FLEET_SEED, device=None):
    """The fleet workers' factory (``chip_smoke:fleet_engine``, the repo
    root on the spec's ``pythonpath``): Llama-2-7B's widths at ``layers``
    layers, bf16, its weights drawn from a ``torch.Generator`` seeded with
    ``seed``, behind an engine of serve_7b's settings named ``name``, not
    warmed (the worker's ``Engine.warmup`` over the spec's lengths
    captures every graph). ``device`` None needs a card, as every entry
    point of the port: a worker without one exits non-zero."""
    import torch
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, ServingConfig
    dev = resolve_device(device)
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = layers
    cfg.dtype = "bfloat16"
    model = LlamaForCausalLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    torch.cuda.synchronize(dev)
    return Engine(*model.serving_callables(2048), ServingConfig(
        num_layers=layers, num_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, max_len=2048, max_batch=16, page_size=64,
        compute_dtype="bfloat16", kv_dtype="native", policy="budget",
        prefill_token_budget=2048, prefix_sharing="off", device=dev,
        name=name))


def serve_fleet_7b_width(torch, card, served) -> None:
    """``serve_fleet_7b_width``: a ``FleetSupervisor`` over two worker
    processes (``python -m paddle_tpu_torch.serving.fleet_worker``), each
    serving ``fleet_engine`` (Llama-2-7B's widths, FLEET_LAYERS layers,
    seeded weights, warmed with serve_7b's 16 lengths), its ``Router``
    behind a ``FrontDoor``; serve_7b's traffic over HTTP against the same
    model built in this process. Then every slot of worker w0 held by a
    long stream and one more request queued behind them, w0 SIGKILLed:
    each admitted stream ends typed (RpcTransportError, 503 with
    retry_after_s), the queued one fails over and completes on w1, no
    token is delivered twice, w0 is respawned once (its split reported),
    rejoins and serves; then w1 SIGTERMed drains and exits 0."""
    import signal
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import (FleetSupervisor, FleetWorkerSpec,
                                          FrontDoor)
    t_phase = time.monotonic()
    prompts, lens = served["prompts"], served["lens"]
    root = str(Path(__file__).resolve().parent)
    # the reference: the workers' model and engine, in this process
    ref = fleet_engine("ref").warmup([int(n) for n in lens])
    _, ref_results, _ = run_traffic(torch, ref, prompts, 64)
    want = [r.tokens for r in ref_results]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    fresh_obs(obs)
    env = {"PYTHONPATH": os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])])}
    specs = [FleetWorkerSpec(name=n, factory="chip_smoke:fleet_engine",
                             config={"name": n}, pythonpath=[root], env=env,
                             warmup=[int(x) for x in lens])
             for n in ("w0", "w1")]
    t0 = time.monotonic()
    sup = FleetSupervisor(specs, poll_s=0.1, rpc_timeout_s=10.0,
                          stale_after_s=30.0, max_respawns=1,
                          spawn_timeout_s=FLEET_SPAWN_S)
    sup.start()
    boot_s = time.monotonic() - t0
    fd = FrontDoor(sup.router)
    pids = dict(sup.worker_pids())
    try:
        boots = {n: sup.worker_stats(n)["boot"] for n in ("w0", "w1")}
        wall, outs = http_traffic(fd, prompts, 64)
        got = require_http_ok(outs, "serve_fleet_7b_width")
        require([t[0] for t in got] == [t[0] for t in want],
                "serve_fleet_7b_width: first tokens differ from the "
                "in-process engine's")
        where = placed_on(sup.router)
        traffic = {**http_numbers(outs, wall),
                   "placed": {n: sum(where[request_id_of(o)] == n
                                     for o in outs) for n in ("w0", "w1")},
                   **transcript_agreement(got, want)}
        kill = fleet_kill(torch, sup, fd, prompts, want)
        # SIGTERM: w1 drains and exits 0 (no respawn left to take)
        sup.max_respawns = 0
        proc = sup._workers["w1"].proc
        proc.send_signal(signal.SIGTERM)
        t0 = time.monotonic()
        rc = proc.wait(timeout=120)
        require(rc == 0, f"serve_fleet_7b_width: w1 exited {rc} on SIGTERM")
        snap = obs.snapshot()
        emit({"phase": "serve_fleet_7b_width", "card": card,
              "layers": FLEET_LAYERS,
              "cut": "depth 32 -> 4: two worker processes and a respawn "
                     "(process start, weights, captures) must fit the run's "
                     "time limit; widths are Llama-2-7B's",
              "dtype": "bfloat16", "workers": 2, "requests": len(prompts),
              "new_tokens": 64, "supervisor_start_s": boot_s,
              "boot": boots, "traffic": traffic, "kill": kill,
              "sigterm": {"exit_code": rc,
                          "seconds": time.monotonic() - t0},
              "metrics": {k: snap.get(k) for k in (
                  "fleet.respawns_total", "fleet.worker_deaths_total",
                  "serving.router.failovers_total",
                  "serving.http.requests_total")},
              "seconds": time.monotonic() - t_phase})
    finally:
        sup.max_respawns = 0
        sup.stop(drain=False, timeout=30)
        fd.close()
        obs.disable()
        for pid in {*pids.values(), *sup.worker_pids().values()}:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)


def fleet_kill(torch, sup, fd, prompts, want) -> dict:
    """w0's 16 slots held by long streams (w1 latched out while they are
    placed), one more request queued behind them, w1 restored, w0
    SIGKILLed; the outcomes, the respawn's split and w0 serving again."""
    import signal
    import threading
    from paddle_tpu_torch.observability import trace
    router = sup.router
    router.latch_out("w1")
    hold = [p[:FLEET_HOLD_PROMPT] for p in prompts]
    first = [threading.Event() for _ in hold]
    outs = [None] * (len(hold) + 1)

    def client(i, prompt, n_new):
        outs[i] = http_generate(
            fd, prompt, n_new, True,
            None if i >= len(first) else (lambda n: first[i].set()))

    threads = [threading.Thread(target=client, args=(i, p, FLEET_HOLD_TOKENS),
                                daemon=True) for i, p in enumerate(hold)]
    for t in threads:
        t.start()
    require(all(e.wait(timeout=120) for e in first),
            "serve_fleet_7b_width kill: the holding streams never started")
    picks = sum(e[0] == "pick" and e[2] == "w0" for e in router.trace)
    queued = threading.Thread(target=client,
                              args=(len(hold), prompts[0], 64),
                              daemon=True)
    queued.start()
    # placed on w0 (the router's trace), then accepted into its queue: a
    # heartbeat asked for now shows it (the cached one may predate it)
    w0 = next(r.engine for r in router.replicas if r.name == "w0")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            sum(e[0] == "pick" and e[2] == "w0" for e in router.trace)
            == picks or w0.beat(timeout=10.0)["queue_depth"] < 1):
        time.sleep(0.01)
    require(time.monotonic() < deadline,
            "serve_fleet_7b_width kill: the queued request was not accepted")
    router.restore_replica("w1")
    free_before = torch.cuda.mem_get_info()[0]
    old_pid = sup.worker_pids()["w0"]
    t_kill = time.monotonic()
    wall_kill = time.time()
    os.kill(old_pid, signal.SIGKILL)
    for t in [*threads, queued]:
        t.join(timeout=600)
    require(all(not t.is_alive() for t in [*threads, queued]),
            "serve_fleet_7b_width kill: a client hung")
    held = [terminal_of(o) for o in outs[:-1]]
    require(all(s == 503 and e == "RpcTransportError" for s, e, _ in held),
            f"serve_fleet_7b_width kill: the admitted streams ended "
            f"{sorted({(s, e) for s, e, _ in held})}")
    require(all(o["terminals"][0][1].get("retry_after_s") for o in outs[:-1]),
            "serve_fleet_7b_width kill: a 503 without retry_after_s")
    require(all(o["indices"] == list(range(len(o["tokens"])))
                and 0 < len(o["tokens"]) < FLEET_HOLD_TOKENS
                for o in outs[:-1]),
            "serve_fleet_7b_width kill: a held stream repeated or skipped a "
            "token")
    status, err, tokens = terminal_of(outs[-1])
    rid = request_id_of(outs[-1])
    seen = {"status": status, "error": err,
            "tokens": None if tokens is None else len(tokens),
            "streamed": len(outs[-1]["tokens"]),
            "first_token_equal": bool(tokens) and tokens[0] == want[0][0],
            "trace": [e for e in router.trace if len(e) > 1 and e[1] == rid]}
    require(status == 200 and outs[-1]["tokens"] == tokens
            and len(tokens) == 64 and tokens[0] == want[0][0]
            and placed_on(router)[rid] == "w1"
            and ("failover", rid, "w0") in router.trace,
            f"serve_fleet_7b_width kill: the queued request did not fail over "
            f"to w1 and complete: {seen}")
    # the respawn: a new process, back in the rotation
    deadline = time.monotonic() + FLEET_SPAWN_S
    while time.monotonic() < deadline and not (
            sup.worker_pids()["w0"] != old_pid
            and router.in_rotation() == ["w0", "w1"]):
        time.sleep(0.05)
    rejoin_s = time.monotonic() - t_kill
    require(sup.worker_pids()["w0"] != old_pid
            and router.in_rotation() == ["w0", "w1"] and not sup.lost,
            f"serve_fleet_7b_width kill: w0 did not rejoin ({sup.lost})")
    free_after = torch.cuda.mem_get_info()[0]
    event = [e for e in trace.flight_recorder().snapshot()
             if e["name"] == "fleet_respawned"][-1]["attrs"]
    boot = sup.worker_stats("w0")["boot"]
    split = {"kill_to_spawn_s": event["spawned_at"] - wall_kill,
             "spawn_to_worker_main_s": boot["started_at"]
             - event["spawned_at"],
             "weights_s": boot["factory_s"],
             "warmup_captures_s": boot["warmup_s"],
             "worker_main_to_port_file_s": boot["port_at"]
             - boot["started_at"],
             "port_file_seen_s": event["port_at"] - boot["port_at"],
             "first_good_heartbeat_s": event["beat_at"] - event["port_at"],
             "kill_to_rejoin_s": rejoin_s}
    # the respawned worker serves (w1 latched out for the request)
    router.latch_out("w1")
    try:
        o = http_generate(fd, prompts[1], 64, False)
    finally:
        router.restore_replica("w1")
    status, err, tokens = terminal_of(o)
    require(status == 200 and placed_on(router)[o["doc"]["request_id"]]
            == "w0" and tokens[0] == want[1][0],
            f"serve_fleet_7b_width kill: the respawned w0 answered {status} "
            f"({err})")
    from paddle_tpu_torch import observability as obs
    snap = obs.snapshot()
    require(snap.get("fleet.respawns_total") == 1
            and snap.get("fleet.worker_deaths_total") == {
                "reason=signal:SIGKILL": 1.0},
            f"serve_fleet_7b_width kill: respawns "
            f"{snap.get('fleet.respawns_total')}, deaths "
            f"{snap.get('fleet.worker_deaths_total')}")
    return {"held_streams": len(held),
            "held_tokens_streamed": [len(o["tokens"]) for o in outs[:-1]],
            "held_status": "503 RpcTransportError",
            "queued_request": {"status": status, "failed_over_to": "w1"},
            "respawn_split": split,
            "free_gb_before_kill": free_before / 1e9,
            "free_gb_after_respawn": free_after / 1e9,
            "respawned_serves": True}


# ---------------------------------------------------------------------------
# training phase 1: forward with lse, flash backward against plain versions
# ---------------------------------------------------------------------------

# the 16-bit flash kernels (forward, dq, dk/dv): each must run on wgmma and
# TMA. The element type leads the template arguments (an older source's
# kernels name none: they read as bf16)
WGMMA_KERNEL = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel)"
                          r"I(13__nv_bfloat16|6__half)?((?:L[ib]\d+E)+)E")
WGMMA_TYPES = {"6__half": "fp16"}
# forward <E, D, LSE, SEGS, DROP>, dq and dk/dv <E, D, SEGS, DROP>; E bf16
# or fp16; D in 64, 128; (SEGS, DROP) in (0, 0), (1, 0), (1, 1): dropout
# always carries ids
N_WGMMA_KERNELS = 48


def sass_functions(native_build, name: str, pattern, ops) -> dict:
    """Each function of the built library of ``csrc/<name>.cu`` whose
    (mangled) name ``pattern`` finds: how many lines of its SASS
    (``cuobjdump -sass``) hold each of ``ops``, and its registers and
    spills as ptxas reported them when this run built it."""
    bindir = Path(native_build.nvcc()).parent
    sass = subprocess.run(
        [str(bindir / "cuobjdump"), "-sass",
         str(native_build.library_path(name))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    kernels, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1) if pattern.search(m.group(1)) else None
            if fn:
                kernels[fn] = dict.fromkeys(ops, 0)
        elif fn:
            for op in ops:
                kernels[fn][op] += op in ln
    fn = None
    for ln in native_build.build_logs.get(name, "").splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1) if m.group(1) in kernels else None
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                    r"spill loads", ln)):
            kernels[fn].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            kernels[fn]["registers"] = int(m[1])
    return kernels


def wgmma_key(m) -> str:
    """The key of a WGMMA_KERNEL match, e.g.
    ``flash_fwd_wgmma_kernel<fp16, 64, 1, 0, 0>``."""
    return "%s<%s, %s>" % (m[1], WGMMA_TYPES.get(m[2], "bf16"),
                           ", ".join(re.findall(r"L[ib](\d+)E", m[3])))


def wgmma_kernels(native_build) -> dict:
    """Each 16-bit flash kernel of the built library (forward, dq, dk/dv):
    the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in its
    SASS, and its registers and spills, keyed by :func:`wgmma_key`."""
    kernels = sass_functions(native_build, "flash_attention", WGMMA_KERNEL,
                             ("HGMMA", "UTMALDG"))
    return {wgmma_key(WGMMA_KERNEL.search(fn)): v for fn, v in kernels.items()}


# the paged split kernel (pool type, D, q heads per kv head bucket): each
# must copy its pages by cp.async.bulk, whose SASS is UBLKCP
PAGED_SPLIT_KERNEL = re.compile(r"paged_decode_split_kernel")
BULK_COPY_OP = "UBLKCP"
# f32, bf16, fp16, int8 pools x D 64, 128 x rep 1, 2, 4, 8
N_PAGED_SPLIT_KERNELS = 32


def paged_kernels(native_build) -> dict:
    """Each paged split kernel of the built library: its bulk copies
    (``BULK_COPY_OP``) in SASS, registers and spills, by mangled name."""
    return sass_functions(native_build, "paged_attention", PAGED_SPLIT_KERNEL,
                          (BULK_COPY_OP,))


def build_planted(native_build):
    """Start ``nvcc`` on each copy that PLANTED_FAULTS names, its source
    with its faults applied, into the git-ignored build directory (one
    process each, in parallel); return a function that waits for them and
    returns the loaded libraries by copy name."""
    out_dir = native_build.BUILD_DIR / "planted"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in dict.fromkeys(n for n, _, _ in PLANTED_FAULTS):
        src = (native_build.CSRC / f"{name.split(':')[0]}.cu").read_text()
        for _, anchor, fault in (f for f in PLANTED_FAULTS if f[0] == name):
            require(src.count(anchor) == 1, f"planted fault: anchor "
                                            f"{anchor!r} not found once")
            src = src.replace(anchor, fault + anchor)
        stem = name.replace(":", "_")
        cu, so = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [native_build.nvcc(), *native_build.NVCC_FLAGS, "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)

    def load():
        libs = {}
        for name, (proc, so) in procs.items():
            log, _ = proc.communicate()
            require(proc.returncode == 0, f"planted {name} build failed:\n{log}")
            libs[name] = ctypes.CDLL(str(so))
        return libs
    return load


def entry_tail(torch, fa, q, k, causal: bool, var):
    """The arguments of a flash entry point after its pointers: the dims,
    dtype code, causal and sm_scale; for a variant ``var = (q_segs,
    kv_segs, dropout_p, seed)`` the ``*_segdrop`` arguments too. Returns
    ``(entry suffix, arguments, tensors to keep alive)``; the stream
    follows them, the current one at each call (:func:`call_entry`)."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    tail = (b, lq, lk, h, hkv, d, fa._DTYPE_CODES[q.dtype], int(causal),
            1.0 / math.sqrt(d))
    extra, keep, suffix = (), (), ""
    if var is not None:
        extra, keep = fa._segdrop_args(*var, b, lq, lk, q.device)
        suffix = "_segdrop"
    return suffix, (*tail, *extra), keep


def call_entry(torch, fn, args) -> None:
    """A flash entry point (:func:`bind_entry`'s, which raises where the
    launch is refused) on the current stream, a graph capture's too."""
    fn(*args, torch.cuda.current_stream().cuda_stream)


def bind_entry(fa, lib, name: str):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = fa._ARGTYPES_OF[name], ctypes.c_int
    return lambda *a: fa._native.check(fn(*a), name)


def bwd_launches(torch, fa, lib, q, k, v, out, lse, do, causal: bool = True,
                 var=None):
    """The two launches of ``flash_attention_bwd`` (causal unless said,
    ``var`` a variant as for :func:`entry_tail`) from the library ``lib``,
    as closures over fresh dq, dk, dv: for timing the kernels alone and for
    running the planted libraries."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = tuple(torch.empty_like(x) for x in (q, k, v))
    suffix, tail, keep = entry_tail(torch, fa, q, k, causal, var)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    fns = []
    for name, outs in (("flash_bwd_dq", grads[:1]),
                       ("flash_bwd_dkv", grads[1:])):
        fn = bind_entry(fa, lib, name + suffix)
        args = (*ptrs, *(x.data_ptr() for x in outs), *tail)
        # the closure owns what its launch reads and writes, so a caller
        # that keeps only the closure cannot free them under it
        fns.append(lambda fn=fn, args=args,
                   keep=(keep, delta, grads, q, k, v, do, lse):
                   call_entry(torch, fn, args))
    return grads, fns[0], fns[1]


def fwd_lse_launch(torch, fa, lib, q, k, v, causal: bool = True, var=None,
                   with_lse: bool = True):
    """``flash_fwd_lse`` (``flash_fwd`` without ``with_lse``; causal unless
    said, ``var`` as for :func:`entry_tail`) of the library ``lib`` as a
    closure over fresh out and lse."""
    b, lq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device="cuda")
    suffix, tail, keep = entry_tail(torch, fa, q, k, causal, var)
    fn = bind_entry(fa, lib, ("flash_fwd_lse" if with_lse else "flash_fwd")
                    + suffix)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()) + (
        (lse.data_ptr(),) if with_lse else ())
    return out, lse, lambda keep=(keep, out, lse): call_entry(
        torch, fn, (*ptrs, *tail))


def check_planted(torch, fa, planted_lib, q, k, v, rout, rlse, do, refs):
    """Run the planted library's forward and backward at the main path's
    shape and require that REL_TOL rejects its out and each gradient."""
    out, _, run_fwd = fwd_lse_launch(torch, fa, planted_lib, q, k, v)
    (dq, dk, dv), run_dq, run_dkv = bwd_launches(torch, fa, planted_lib, q, k,
                                                 v, rout, rlse, do)
    run_fwd()
    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    row = {}
    for name, got, ref, kernel in (("out", out, rout, "flash"),
                                   *((n, g, r, "flash_bwd") for n, g, r in
                                     zip(("dq", "dk", "dv"), (dq, dk, dv),
                                         refs))):
        limit = REL_TOL[kernel, dtype_name(q.dtype)]
        rel = tile_rel_err(torch, got, ref)
        # whether the elementwise limit that held these outputs before
        # REL_TOL would also reject the fault (PERF.md compares the two)
        old_pass = bool(((got.float() - ref.float()).abs()
                         <= 5e-2 + 2e-2 * ref.float().abs()).all())
        require(rel > limit, f"planted fault in {name} passed: tile "
                             f"error {rel} <= {limit}")
        row[name] = {"tile_rel": rel, "limit": limit,
                     "old_abs_limit_passes": old_pass}
    emit({"phase": "flash_train_check", "planted_faults": {
        "shape": list(q.shape), "dtype": dtype_name(q.dtype),
        "out": "skips the K/V tile at Lk/2",
        "dq": "skips the K tile at Lk/2", "dk_dv": "skip the Q tile at Lq/2",
        **row}})


def check_flash_train(torch, fa, planted_lib):
    """B2-B4 against their plain versions in bf16, fp32 and fp16 (the
    planted copy rejected at L=4096 in bf16 and fp16), fp16's range
    (:func:`check_flash_fp16_range`), then the times at bench.py's shape
    in bf16 and fp16 (:func:`flash_train_timing`). Returns the largest
    errors and the times, bf16 (with fp32) and fp16 apart."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf, f32, h16 = torch.bfloat16, torch.float32, torch.float16
    cases = [  # name, B, H, Hkv, Lq, Lk, causal, dtype, D
        ("causal_4096_h20", 1, 20, 20, 4096, 4096, True, bf, 128),
        ("gqa_causal_1024_h32_kv8", 1, 32, 8, 1024, 1024, True, bf, 128),
        ("causal_lq256_lk1024", 1, 20, 20, 256, 1024, True, bf, 128),
        ("full_512", 1, 20, 20, 512, 512, False, bf, 128),
        # the edges of the forward's 128-row tiles (see check_flash)
        ("causal_lq1_lk1064", 1, 20, 20, 1, 1064, True, bf, 128),
        ("causal_lq256_lk128", 1, 20, 20, 256, 128, True, bf, 128),
        ("d64_causal_1024", 1, 20, 20, 1024, 1024, True, bf, 64),
        ("causal_129", 1, 20, 20, 129, 129, True, bf, 128),
        # the fp32 CUDA-core kernels at the train_vs_cpu phase's shape,
        # and ragged lengths
        ("f32_causal_256_b2", 2, 20, 20, 256, 256, True, f32, 128),
        ("f32_causal_37", 1, 20, 20, 37, 37, True, f32, 128),
        ("f32_causal_513", 1, 20, 20, 513, 513, True, f32, 128),
        # fp16: bench.py's heads at L=4096, GQA, D=64 and the tile edges
        ("fp16_causal_4096_h20", 1, 20, 20, 4096, 4096, True, h16, 128),
        ("fp16_gqa_causal_1024_h32_kv8", 1, 32, 8, 1024, 1024, True, h16,
         128),
        ("fp16_full_512", 1, 20, 20, 512, 512, False, h16, 128),
        ("fp16_causal_lq1_lk1064", 1, 20, 20, 1, 1064, True, h16, 128),
        ("fp16_causal_lq256_lk128", 1, 20, 20, 256, 128, True, h16, 128),
        ("fp16_d64_causal_1024", 1, 20, 20, 1024, 1024, True, h16, 64),
    ]
    all_errs = {dt: {"lse": 0.0, "out": 0.0, "dq": 0.0, "dkv": 0.0}
                for dt in ("16", "other")}
    for name, b, h, hkv, lq, lk, causal, dt, d in cases:
        errs = all_errs["16" if dt == h16 else "other"]
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda", dtype=dt)
        q, k, v = rnd(b, lq, h, d), rnd(b, lk, hkv, d), rnd(b, lk, hkv, d)
        do = rnd(b, lq, h, d)
        out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
        rout, rlse = fa.flash_attention_lse_reference(q, k, v, causal=causal)
        # the backward of both from the plain forward's out and lse
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, rout, rlse, do,
                                            causal=causal)
        rq, rk, rv = fa.flash_attention_bwd_reference(q, k, v, rout, rlse,
                                                      do, causal=causal)
        torch.cuda.synchronize()
        require_unseen_rows_zero(torch, fa, out, lse, lq, lk, causal, name)
        dn = dtype_name(dt)
        row = {"case": name, "dtype": dn,
               "out": check_close(torch, out, rout, "flash", f"{name} out"),
               "lse": check_close(torch, lse, rlse, "lse", f"{name} lse", dn),
               "dq": check_close(torch, dq, rq, "flash_bwd", f"{name} dq"),
               "dk": check_close(torch, dk, rk, "flash_bwd", f"{name} dk"),
               "dv": check_close(torch, dv, rv, "flash_bwd", f"{name} dv")}
        errs["out"] = max(errs["out"], row["out"]["max_abs"])
        errs["lse"] = max(errs["lse"], row["lse"]["max_abs"])
        errs["dq"] = max(errs["dq"], row["dq"]["max_abs"])
        errs["dkv"] = max(errs["dkv"], row["dk"]["max_abs"],
                          row["dv"]["max_abs"])
        emit({"phase": "flash_train_check", **row})
        if name in ("causal_4096_h20", "fp16_causal_4096_h20"):
            check_planted(torch, fa, planted_lib, q, k, v, rout, rlse, do,
                          (rq, rk, rv))
        del q, k, v, do, out, lse, rout, rlse, dq, dk, dv, rq, rk, rv
    gc.collect()
    torch.cuda.empty_cache()
    check_flash_fp16_range(torch, fa, gen)
    return (all_errs["other"], flash_train_timing(torch, fa, gen, bf),
            all_errs["16"], flash_train_timing(torch, fa, gen, h16))


def check_flash_fp16_range(torch, fa, gen) -> None:
    """fp16's range in B3/B4, where dS = P (dP - delta) is re-packed as a
    16-bit operand (the reference keeps it fp32): a dO of loss-scaled size
    (GradScaler's 2^15 times an ERNIE-sized gradient of about 2^-12), and
    inputs built so that |dS| reaches 2^17, past fp16's 65504, while the
    fp32 results fit fp16 (q near 0, so P is near uniform; keys near one
    vector, so the dS terms of dq cancel; V rows of alternate sign and a
    constant dO, so dP = +-2^24 and delta = 0). Each gradient must be
    finite and within REL_TOL of the plain version."""
    h16 = torch.float16
    rows = {}
    b, L, h, d = 2, 1024, 12, 64
    q, k, v = (torch.randn(b, L, h, d, generator=gen, device="cuda",
                           dtype=h16) for _ in range(3))
    do = (torch.randn(b, L, h, d, generator=gen, device="cuda")
          * 2.0 ** 3).to(h16)
    inputs = {"loss_scaled_do": (q, k, v, do, True)}
    b, L, h, d = 1, 128, 2, 64
    q = (torch.randn(b, L, h, d, generator=gen, device="cuda")
         * 1e-3).to(h16)
    k = (torch.randn(1, 1, 1, d, generator=gen, device="cuda") + 1e-3
         * torch.randn(b, L, h, d, generator=gen, device="cuda")).to(h16)
    sign = 1.0 - 2.0 * (torch.arange(L, device="cuda") % 2).float()
    v = (64.0 * sign.view(1, L, 1, 1).expand(b, L, h, d)).to(h16)
    do = torch.full((b, L, h, d), 4096.0, device="cuda", dtype=h16)
    inputs["ds_past_65504"] = (q, k, v, do, False)
    for name, (q, k, v, do, causal) in inputs.items():
        rout, rlse = fa.flash_attention_lse_reference(q, k, v, causal=causal)
        refs = fa.flash_attention_bwd_reference(q, k, v, rout, rlse, do,
                                                causal=causal)
        got = fa.flash_attention_bwd(q, k, v, rout, rlse, do, causal=causal)
        torch.cuda.synchronize()
        # the largest |dS| of the plain version, in fp32
        qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))
        p = torch.exp(qf @ kf.transpose(-1, -2) / math.sqrt(d)
                      - rlse[..., None])
        if causal:
            p = p.tril()
        delta = (dof * rout.float().transpose(1, 2)).sum(-1, keepdim=True)
        ds_max = float((p * (dof @ vf.transpose(-1, -2) - delta)).abs().max())
        rows[name] = {"shape": [b, L, h, d], "ds_max": ds_max,
                      "plain_finite": all(bool(torch.isfinite(x).all())
                                          for x in refs)}
        for n, g, ref in zip(("dq", "dk", "dv"), got, refs):
            rows[name][n] = check_close(torch, g, ref, "flash_bwd",
                                        f"fp16 range {name} {n}")
        del qf, kf, vf, dof, p
    require(rows["ds_past_65504"]["ds_max"] > 65504.0
            and rows["ds_past_65504"]["plain_finite"],
            f"fp16 range: the built case does not reach past 65504 with "
            f"finite plain gradients: {rows['ds_past_65504']}")
    emit({"phase": "flash_fp16_range_check", **rows})
    del inputs
    gc.collect()
    torch.cuda.empty_cache()


def flash_train_timing(torch, fa, gen, dt) -> dict:
    """B2-B4 at bench.py's B=6, H=20, L=4096, D=128, causal, in ``dt``:
    three launches of each bit for bit, then times beside the bound, the
    plain version and SDPA (forward, and its whole backward)."""
    import torch.nn.functional as TF
    b, h, L, d = 6, 20, 4096, 128
    dn = dtype_name(dt)
    q, k, v, do = (torch.randn(b, L, h, d, generator=gen, device="cuda",
                               dtype=dt) for _ in range(4))
    # the forward has no atomics: launches that differ in any bit race in
    # its pipeline
    runs = [fa.flash_attention_lse(q, k, v, causal=True) for _ in range(3)]
    same = all(torch.equal(o.view(torch.int16), runs[0][0].view(torch.int16))
               and torch.equal(l.view(torch.int32), runs[0][1].view(torch.int32))
               for o, l in runs[1:])
    require(same, f"flash_fwd_lse at B=6 H=20 L=4096 {dn}: three launches "
                  f"on the same inputs differ")
    out, lse = runs[0]
    del runs
    grads, run_dq, run_dkv = bwd_launches(
        torch, fa, fa._native.load("flash_attention"), q, k, v, out, lse, do)
    # nor have the backward kernels (each gradient is one block's sum)
    bwd_runs = []
    for _ in range(3):
        run_dq()
        run_dkv()
        bwd_runs.append([g.clone() for g in grads])
    bwd_same = {name: all(torch.equal(r[i].view(torch.int16),
                                      bwd_runs[0][i].view(torch.int16))
                          for r in bwd_runs[1:])
                for i, name in enumerate(("dq", "dk", "dv"))}
    del bwd_runs
    require(all(bwd_same.values()), f"flash backward at B=6 H=20 L=4096 "
                                    f"{dn}: three launches on the same "
                                    f"inputs differ {bwd_same}")
    emit({"phase": "flash_train_check", "determinism": {
        "shape": [b, L, h, d], "dtype": dn, "launches": 3,
        "bit_identical": same,
        "backward_bit_identical": bwd_same}})
    ms_fwd = cuda_ms(torch, lambda: fa.flash_attention_lse(q, k, v, causal=True), 5)
    ms_dq = cuda_ms(torch, run_dq, 5)
    ms_dkv = cuda_ms(torch, run_dkv, 5)
    plain_fwd = cuda_ms(torch, lambda: fa.flash_attention_lse_reference(
        q, k, v, causal=True), 1, warmup=1)
    gc.collect()
    torch.cuda.empty_cache()
    plain_bwd = cuda_ms(torch, lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True), 1, warmup=1)
    gc.collect()
    torch.cuda.empty_cache()
    # library yardsticks, never called by the port: SDPA forward, and its
    # backward (dq, dk, dv together)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    lib_fwd = cuda_ms(torch, lambda: TF.scaled_dot_product_attention(
        qh.detach(), kh.detach(), vh.detach(), is_causal=True), 5)
    lib_out = TF.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qh, kh, vh), doh, retain_graph=True), 5)
    dev = {"flash_fwd_lse": graph_pair(
               torch, lambda: fa.flash_attention_lse(q, k, v, causal=True),
               lambda: TF.scaled_dot_product_attention(
                   qh.detach(), kh.detach(), vh.detach(), is_causal=True)),
           "flash_bwd_dq": {"device_ms": device_ms(torch, run_dq)},
           "flash_bwd_dkv": {"device_ms": device_ms(torch, run_dkv)}}
    lib_bwd_dev = sdpa_backward_device_ms(torch, qh, kh, vh, doh,
                                          is_causal=True)
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        dev[kname]["library_device_ms"] = lib_bwd_dev
    timings = {}
    for kname, ms, plain, lib in (
            ("flash_fwd_lse", ms_fwd, plain_fwd, lib_fwd),
            ("flash_bwd_dq", ms_dq, plain_bwd, lib_bwd),
            ("flash_bwd_dkv", ms_dkv, plain_bwd, lib_bwd)):
        # the launch's cost function: what the cost registry files
        flops, nbytes = fa.attention_cost(kname[len("flash_"):], b, L, L, h,
                                          h, d, q.element_size(), True)
        bms, by = bound(flops, nbytes, dn)
        timings[kname] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bms, bound_by=by,
                              tflops=flops / ms / 1e9, **dev[kname])
    emit({"phase": "flash_train_timing", "shape": [b, L, h, d],
          "dtype": dn, "causal": True, **timings,
          "plain_note": "plain_ms of dq and dkv is the whole plain backward",
          "library_note": "library_ms of dq and dkv is SDPA's whole "
                          "backward"})
    del q, k, v, do, out, lse, grads, qh, kh, vh, doh, lib_out
    gc.collect()
    torch.cuda.empty_cache()
    return timings


# ---------------------------------------------------------------------------
# training phase 2: int8 AdamW kernel against its plain version
# ---------------------------------------------------------------------------

def check_q8_adam(torch, q8):
    gen = torch.Generator(device="cuda").manual_seed(4)
    hp = dict(lr=1e-4, eps=1e-8, beta1=0.9, beta2=0.999)
    t = 3  # a step past the first, so the moments carry state
    c1, c2 = (float(torch.tensor(1.0 - bt ** t, dtype=torch.float32))
              for bt in (0.9, 0.999))
    rows = []
    worst = 0.0
    timing = None
    for n in (2560, 6553600, 17694720):
        m0, ms0 = q8.q8_quantize(
            torch.randn(n, generator=gen, device="cuda") * 1e-3)
        v0, vs0 = q8.q8_quantize(
            torch.rand(n, generator=gen, device="cuda") * 1e-3)
        base32 = torch.randn(n, generator=gen, device="cuda") * 0.02
        g32 = torch.randn(n, generator=gen, device="cuda") * 1e-2
        legs = [("f32_wd", torch.float32, 1.0 - 1e-4 * 0.01, False),
                ("f32_nowd", torch.float32, None, False),
                ("bf16_sr_wd", torch.bfloat16, 1.0 - 1e-4 * 0.01, True)]
        for leg, dt, decay, sr in legs:
            st_k = [x.clone() for x in (m0, ms0, v0, vs0, base32.to(dt))]
            st_r = [x.clone() for x in st_k]
            g = g32.to(dt)
            kw = dict(eps=hp["eps"], beta1=hp["beta1"], beta2=hp["beta2"],
                      scalars=q8.scalar_block(hp["lr"], c1, c2, decay,
                                              device="cuda"),
                      has_wd=decay is not None, seed=1234, use_sr=sr)
            q8.q8_adam_update(*st_k, g, **kw)
            q8.q8_adam_update_reference(*st_r, g, **kw)
            torch.cuda.synchronize()
            code_diff = [int((a.int() - b.int()).abs().gt(0).sum())
                         for a, b in ((st_k[0], st_r[0]), (st_k[2], st_r[2]))]
            code_max = max(int((a.int() - b.int()).abs().max())
                           for a, b in ((st_k[0], st_r[0]), (st_k[2], st_r[2])))
            scale_rel = max(float(((a - b).abs() / b.abs()).max())
                            for a, b in ((st_k[1], st_r[1]), (st_k[3], st_r[3])))
            kb, rb = st_k[4], st_r[4]
            if dt == torch.float32:
                ulps = int((kb.view(torch.int32).long()
                            - rb.view(torch.int32).long()).abs().max())
                require(ulps <= 1, f"q8 n={n} {leg}: base {ulps} ulps apart")
            else:
                ulps = int((kb.view(torch.int16).long()
                            - rb.view(torch.int16).long()).abs().max())
                require(ulps == 0, f"q8 n={n} {leg}: bf16 SR base not "
                                   f"bit-equal ({ulps})")
            require(code_diff == [0, 0] and scale_rel <= 1e-6,
                    f"q8 n={n} {leg}: codes {code_diff} differ (max "
                    f"{code_max}), scales rel {scale_rel}")
            err = float((kb.float() - rb.float()).abs().max())
            worst = max(worst, err)
            row = {"n": n, "leg": leg, "codes_differing": code_diff,
                   "code_max_diff": code_max, "scale_max_rel": scale_rel,
                   "base_max_ulps": ulps, "base_max_abs": err}
            emit({"phase": "q8_adam_check", **row})
            rows.append(row)
            if n == 17694720 and sr:
                # the main path's case: bf16 base and grad, SR, wd, the
                # scalars and the seed in device memory as the optimizer
                # gives them (no host copy in the timed launches)
                nb = st_k[0].shape[0]
                kw = dict(eps=hp["eps"], beta1=hp["beta1"],
                          beta2=hp["beta2"], has_wd=True, use_sr=True,
                          scalars=q8.scalar_block(hp["lr"], c1, c2, decay,
                                                  device="cuda"),
                          seed=torch.tensor(1234, device="cuda"))
                # a gate of 0 (the NaN gate withholding the step) writes
                # nothing
                held = [x.clone() for x in st_k]
                closed = dict(kw, scalars=kw["scalars"].clone())
                closed["scalars"][4] = 0.0
                q8.q8_adam_update(*st_k, g, **closed)
                torch.cuda.synchronize()
                require(all(torch.equal(a, b) for a, b in zip(st_k, held)),
                        "q8: a closed gate wrote state")
                del held
                ms = cuda_ms(torch, lambda: q8.q8_adam_update(*st_k, g, **kw), 20)
                plain = cuda_ms(torch, lambda: q8.q8_adam_update_reference(
                    *st_r, g, **kw), 3, warmup=1)
                # the launch's cost function: codes, base, grad; scales
                flops, nbytes = q8.q8_adam_cost(st_k[4], g)
                bms, by = bound(flops, nbytes, "float32")
                timing = dict(n=n, ms=ms, plain_ms=plain, bound_ms=bms,
                              bound_by=by, library_ms=None,
                              device_ms=device_ms(
                                  torch, lambda: q8.q8_adam_update(
                                      *st_k, g, **kw)),
                              gbytes_per_s=nbytes / ms / 1e6,
                              closed_gate_writes_nothing=True)
            del st_k, st_r, g
        del m0, ms0, v0, vs0, base32, g32
    # stochastic rounding is unbiased: base 1.0 decayed to f32(0.9997) with
    # no Adam step (zero grad and moments) lies between the bf16 neighbours
    # 0.99609375 and 1.0; the mean over 16 seeds x 4M elements must be it
    n = 4 * 1024 * 1024
    nb = n // q8.Q8_BLOCK
    target = float(torch.tensor(0.9997, dtype=torch.float32))
    total = 0.0
    for seed in range(16):
        st = [torch.zeros(nb, q8.Q8_BLOCK, dtype=torch.int8, device="cuda"),
              torch.ones(nb, device="cuda"),
              torch.zeros(nb, q8.Q8_BLOCK, dtype=torch.int8, device="cuda"),
              torch.ones(nb, device="cuda"),
              torch.ones(n, dtype=torch.bfloat16, device="cuda")]
        q8.q8_adam_update(*st, torch.zeros(n, dtype=torch.bfloat16,
                                           device="cuda"),
                          scalars=q8.scalar_block(1e-3, 0.1, 0.001, 0.9997,
                                                  device="cuda"),
                          has_wd=True, eps=1e-8, beta1=0.9, beta2=0.999,
                          seed=seed, use_sr=True)
        total += float(st[4].double().mean())
    mean = total / 16
    require(abs(mean - target) < 2e-6,
            f"SR biased: mean {mean} vs {target} (round-to-nearest gives 1.0)")
    emit({"phase": "q8_adam_check", "sr_unbiased": {
        "target": target, "mean": mean, "seeds": 16, "n": n}})
    emit({"phase": "q8_adam_timing", **timing})
    gc.collect()
    torch.cuda.empty_cache()
    return worst, timing


# ---------------------------------------------------------------------------
# training phase 3: train the 1.59B Llama of bench.py
# ---------------------------------------------------------------------------

TRAIN_COUNTERS = ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv", "q8_adam")


def train_counters(fa, q8):
    return {"flash_fwd_lse": fa.launches_lse, "flash_bwd_dq": fa.launches_bwd_dq,
            "flash_bwd_dkv": fa.launches_bwd_dkv, "q8_adam": q8.launches,
            **fused_counters(),
            **{k: c for k, c in ernie_op_counters().items()
               if k == "embedding"}}


def bench_config():
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=2560,
                       intermediate_size=6912, num_hidden_layers=18,
                       num_attention_heads=20, num_key_value_heads=20,
                       max_position_embeddings=4096, recompute=True)


def train_1p6b(torch, card, fa, q8, all_counters):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bench_config()
    batch, seq, warmup, timed = 6, 4096, 2, 4
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                use_multi_tensor=False, moment_dtype="int8",
                use_master_weights=False)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                              master_weight=False)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))

    def step():
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    counters = train_counters(fa, q8)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in all_counters:
        c.reset()
    stop_sampler = sample_card()
    try:
        for i in range(warmup + timed):
            t0 = time.monotonic()
            loss = step()
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            losses.append(float(loss.detach()))
    finally:
        card_samples = stop_sampler()
    launches = {k: c.count for k, c in counters.items()}
    steps = warmup + timed
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # random init: the head's logits are Gaussian with variance
    # hidden * 0.02^2 (unit-RMS input, N(0, 0.02) weights), so the expected
    # first loss is ln(V) + hidden * 0.02^2 / 2 (10.885 here), not ln(V)
    expect = math.log(cfg.vocab_size) + cfg.hidden_size * 0.02 ** 2 / 2
    require(abs(losses[0] - expect) < 0.5,
            f"step-1 loss {losses[0]} not within 0.5 of {expect}")
    require(all(n > 0 for n in launches.values()), f"launches {launches}")
    require(fa.launches.count == 0, "the forward-only kernel ran in training")
    per_step = llama_fused_per_step(cfg.num_hidden_layers)
    require(all(launches[k] == n * steps for k, n in per_step.items()
                if k in launches),
            f"Llama fused launches {launches}, expected {per_step} a step")
    timed_s = times[warmup:]
    p50 = statistics.median(timed_s)
    tok_s = batch * seq / p50
    fpt = model.flops_per_token(seq)
    row = {"phase": "train_llama_1p6b", "card": card,
           "config": {"vocab": 32000, "hidden": 2560, "intermediate": 6912,
                      "layers": 18, "heads": 20, "kv_heads": 20,
                      "max_pos": 4096, "recompute": True},
           "params": model.num_params(), "batch": batch, "seq": seq,
           "warmup_steps": warmup, "timed_steps": timed,
           "step_s": times, "step_p50_s": p50,
           "step_spread_s": max(timed_s) - min(timed_s),
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "mfu_vs_989tflops": fpt * tok_s / 989e12,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "expected_first_loss": expect,
           "init_s": init_s, "card_during_steps": card_samples,
           "launches": launches,
           "launches_per_step": {k: n / steps for k, n in launches.items()}}
    emit(row)
    profile_train(torch, card, step, p50)
    # nothing may keep an eager step's autograd graph alive: its gradient
    # accumulators would run on the stream they were made on, which a
    # capture cannot record
    del opt, step, loss
    gc.collect()
    torch.cuda.empty_cache()
    captured = train_1p6b_captured(torch, card, fa, q8, model, cfg, batch,
                                   seq, p50)
    del model, ids
    gc.collect()
    torch.cuda.empty_cache()
    return launches, captured


LLAMA_ITERS = 4   # bench.py's scan_k: steps per captured call


def train_1p6b_captured(torch, card, fa, q8, model, cfg, batch: int,
                        seq: int, eager_p50: float) -> dict:
    """The bench.py step through ``jit.capture_step(..., iters_per_call=4)``
    (its K-stacked batches, one graph of 4 steps), on the model the eager
    phase trained, with a fresh int8 AdamW: one capturing call, then 2
    timed calls (8 steps). Losses must be finite and no call may bypass the
    graph."""
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                use_multi_tensor=False, moment_dtype="int8",
                use_master_weights=False)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                              master_weight=False)
    ids = torch.randint(0, cfg.vocab_size, (LLAMA_ITERS, batch, seq),
                        device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))

    def body(ids):
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    cap = jit.capture_step(body, iters_per_call=LLAMA_ITERS)
    counters = train_counters(fa, q8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    losses = cap(ids).tolist()
    torch.cuda.synchronize()
    first_s = time.monotonic() - t0
    for c in counters.values():
        c.reset()
    times = []
    stop_sampler = sample_card()
    try:
        for _ in range(2):
            t0 = time.monotonic()
            out = cap(ids)
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) / LLAMA_ITERS)
            losses += out.tolist()
    finally:
        card_samples = stop_sampler()
    launches = {k: c.count for k, c in counters.items()}
    graph = next(iter(cap._graphs.values()))
    per_replay = {c.name: n for c, n in graph.recorded.items()}
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(cap.stats == {"hits": 2, "retraces": 1, "bypasses": {}},
            f"Llama captured: {cap.stats}")
    require(all(n == 2 * per_replay[counters[k].name] > 0
                for k, n in launches.items()),
            f"Llama captured: launches {launches}, per replay {per_replay}")
    per_step = llama_fused_per_step(cfg.num_hidden_layers)
    require(all(per_replay[k] == n * LLAMA_ITERS for k, n in per_step.items()
                if k in per_replay),
            f"Llama captured: fused launches a replay {per_replay}, expected "
            f"{per_step} a step")
    p50 = statistics.median(times)
    tok_s = batch * seq / p50
    fpt = model.flops_per_token(seq)
    row = {"phase": "train_llama_1p6b_captured", "card": card,
           "batch": batch, "seq": seq, "iters_per_call": LLAMA_ITERS,
           "first_call_s": first_s, "timed_calls": 2,
           "step_s": times, "step_p50_s": p50, "eager_step_p50_s": eager_p50,
           "captured_over_eager": p50 / eager_p50,
           "tokens_per_s": tok_s, "mfu_vs_989tflops": fpt * tok_s / 989e12,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "launches": launches,
           "launches_per_replay": per_replay, "stats": cap.stats,
           "card_during_steps": card_samples}
    emit(row)
    del opt, cap, graph
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_family(name: str) -> str:
    low = name.lower()
    for key, fam in (("flash_fwd", "flash_fwd_lse"),
                     ("flash_bwd_dq", "flash_bwd_dq"),
                     ("flash_bwd_dkv", "flash_bwd_dkv"),
                     ("q8_adam", "q8_adam"),
                     ("multi_tensor_adam", "multi_tensor_adam")) + \
            FUSED_FAMILY:
        if key in low:
            return fam
    if any(s in low for s in ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")):
        return "matmul"
    return "other"


def profile_train(torch, card, step, unprofiled_step_s: float) -> None:
    profile_step(torch, card, step, unprofiled_step_s, "train_profile",
                 train_family)


def profile_step(torch, card, step, unprofiled_step_s: float, phase: str,
                 family, extra=None) -> None:
    """One more training step under ``torch.profiler``: device time and
    launches per kernel family (``family`` of a kernel's name), the busy
    share, the device operations (kernels, copies and fills) and the host
    calls that put work on the card (kernel and graph launches, copies,
    fills); returns the row."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    evts = prof.key_averages()
    kernels = [e for e in evts
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    host = {e.key: e.count for e in evts
            if e.device_type == torch.autograd.DeviceType.CPU
            and HOST_LAUNCH.search(e.key)}
    total_s = sum(device_us(e) for e in kernels) / 1e6
    require(total_s > 0, "profiler recorded no device time")
    fams = {}
    for e in kernels:
        f = fams.setdefault(family(e.key), {"device_ms": 0.0, "calls": 0})
        f["device_ms"] += device_us(e) / 1e3
        f["calls"] += e.count
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    row = {"phase": phase, "card": card, **(extra or {}), "wall_s": wall,
           "device_ms": total_s * 1e3, "device_busy_share": total_s / wall,
           "unprofiled_step_s": unprofiled_step_s,
           "device_busy_share_est_unprofiled": total_s / unprofiled_step_s,
           "device_ops": sum(e.count for e in kernels),
           "device_kernels": sum(e.count for e in kernels if not
                                 e.key.startswith(("Memcpy", "Memset"))),
           "host_launch_calls": sum(host.values()), "host_calls": host,
           "families": fams,
           "top": [{"kernel": e.key[:90], "device_ms": device_us(e) / 1e3,
                    "calls": e.count} for e in top]}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# training phase 4: the same steps on the card and on the CPU
# ---------------------------------------------------------------------------

def train_vs_cpu(torch, fa, q8):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bench_config()
    cfg.num_hidden_layers = 2
    batch, seq, steps, lr = 2, 256, 3, 1e-4
    ids = torch.randint(0, cfg.vocab_size, (batch, seq),
                        generator=torch.Generator().manual_seed(5))
    init = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(5)).state_dict()
    init = {k: v.cpu() for k, v in init.items()}
    counters = train_counters(fa, q8)
    for moments in ("float32", "int8"):
        runs = {}
        for dev in ("cuda", "cpu"):
            model = LlamaForCausalLM(cfg, device=dev)
            model.load_state_dict(init)
            opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                        moment_dtype=moments)
            x = ids.to(dev)
            for c in counters.values():
                c.reset()
            losses, grads = [], None
            for i in range(steps):
                loss, _ = model(x, labels=x)
                loss.backward()
                if i == 0:
                    grads = {k: p.grad.detach().float().cpu()
                             for k, p in model.named_parameters()}
                opt.step()
                opt.clear_grad()
                losses.append(float(loss.detach()))
            runs[dev] = dict(losses=losses, grads=grads, launches={
                k: c.count for k, c in counters.items()},
                params={k: v.detach().float().cpu()
                        for k, v in model.state_dict().items()})
            del model, opt
            gc.collect()
            torch.cuda.empty_cache()
        a, b = runs["cuda"], runs["cpu"]
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                            b["losses"]))
        grad_rel = max(float((a["grads"][k] - b["grads"][k]).abs().max())
                       / max(float(b["grads"][k].abs().max()), 1e-30)
                       for k in b["grads"])
        pdiff = [(a["params"][k] - b["params"][k]).abs() for k in b["params"]]
        p_max = max(float(d.max()) for d in pdiff)
        p_frac = sum(int((d > lr / 10).sum()) for d in pdiff) / sum(
            d.numel() for d in pdiff)
        # with fp32 moments an Adam step moves an element by at most about
        # lr, so two runs differ by at most 2 * lr * steps where they
        # disagree. With int8 moments a sqrt(v) code that rounds to 0 on one
        # side and 1 on the other (a block-absmax boundary) makes that
        # element's step lr * m / eps on one side only, so there only the
        # share of disagreeing elements is bounded. Both must disagree (by
        # more than lr / 10) almost nowhere.
        p_ok = moments == "int8" or p_max <= 2 * lr * steps
        require(loss_rel < 1e-4 and grad_rel < 1e-3 and p_ok
                and p_frac < 1e-3,
                f"card vs CPU ({moments} moments): loss rel {loss_rel}, "
                f"grad rel {grad_rel}, param max {p_max}, frac {p_frac}")
        kernel_launches = a["launches"]
        require(kernel_launches["flash_fwd_lse"] > 0
                and kernel_launches["flash_bwd_dq"] > 0
                and (kernel_launches["q8_adam"] > 0) == (moments == "int8")
                and sum(b["launches"].values()) == 0,
                f"launches card {kernel_launches}, cpu {b['launches']}")
        emit({"phase": "train_vs_cpu", "layers": 2, "dtype": "float32",
              "batch": batch, "seq": seq, "moments": moments,
              "losses_card": a["losses"], "losses_cpu": b["losses"],
              "loss_max_rel": loss_rel, "grad_step1_max_rel": grad_rel,
              "param_max_abs": p_max, "param_frac_over_lr_10": p_frac,
              "launches_card": kernel_launches})


# ---------------------------------------------------------------------------
# training phase 5: the segment-id and dropout variants of B1-B4 (B0)
# ---------------------------------------------------------------------------

# the TPU kernels' branches each variant ports (paddle_tpu/ops/
# flash_attention.py): segment ids, and segment ids with dropout (B0,
# _keep_tile at :47); dropout always carries ids, as _flash_core_drop
VARIANT_LINES = {
    "fwd": {"segs": ":106-109, 135",
            "segs_drop": ":47, 106-109, 135, 145-148"},
    "fwd_lse": {"segs": ":172-175, 200",
                "segs_drop": ":47, 172-175, 200, 208-211"},
    "bwd_dq": {"segs": ":239-242, 265",
               "segs_drop": ":47, 239-242, 265, 271-274"},
    "bwd_dkv": {"segs": ":300-303, 329",
                "segs_drop": ":47, 300-303, 329, 335-338"},
}
# the ids each variant is timed with at ERNIE_SHAPE, as its path gives them:
# packed sequences (flash_attn_unpadded) and none, dropout alone (ERNIE's
# attention, which the wrapper runs on zero ids)
VARIANT_IDS = {"segs": "packed", "segs_drop": "none"}
VARIANT_KERNEL = {"fwd": ("flash_prefill", 82), "fwd_lse": ("flash_fwd_lse", 163),
                  "bwd_dq": ("flash_bwd_dq", 228), "bwd_dkv": ("flash_bwd_dkv", 288)}
DROPOUT_P = 0.1


def packed_segs(torch, gen, b: int, length: int):
    """(B, L) int32 ids of a few packed sequences a row (random boundaries,
    ids rising): every row sees at least its own key."""
    cuts = torch.randint(1, length, (b, 3), generator=gen, device="cuda")
    pos = torch.arange(length, device="cuda")
    return (pos[None, :, None] >= cuts[:, None, :]).sum(-1).to(torch.int32)


def variant_var(torch, gen, variant: str, b: int, lq: int, lk: int,
                ids: str = "packed", seed: int = 1234):
    """``(q_segs, kv_segs, dropout_p, seed)`` of a variant. ``ids``:
    "packed" (with lq != lk the key ids are drawn apart and shifted by one,
    so the rows of the first query segment see no key), "zeros" (one
    segment), or "none" (dropout alone: the wrappers pass zero ids)."""
    segs = (None, None)
    if ids == "packed":
        qs = packed_segs(torch, gen, b, lq)
        segs = (qs, qs if lk == lq else packed_segs(torch, gen, b, lk) + 1)
    elif ids == "zeros":
        segs = tuple(torch.zeros(b, n, dtype=torch.int32, device="cuda")
                     for n in (lq, lk))
    return (*segs, DROPOUT_P if variant == "segs_drop" else 0.0, seed)


def check_segs_dropout_cases(torch, fa, gen):
    """Every variant of B1-B4 (forward, forward with lse, dq, dk/dv)
    against its plain version on one set of inputs per case; the two
    ERNIE cases are the attention of its two training legs as the model
    calls it (dropout, no ids)."""
    bf, f32, h16 = torch.bfloat16, torch.float32, torch.float16
    cases = [  # name, B, H, Hkv, L, causal, dtype, D, variant, ids
        ("segs_causal_512", 2, 8, 8, 512, True, bf, 128, "segs", "packed"),
        ("drop_causal_512", 2, 8, 8, 512, True, bf, 128, "segs_drop", "none"),
        ("segs_drop_causal_512", 2, 8, 8, 512, True, bf, 128, "segs_drop",
         "packed"),
        ("segs_drop_full_128", 2, 8, 8, 128, False, bf, 128, "segs_drop",
         "packed"),
        ("segs_drop_causal_1000_ragged", 2, 8, 8, 1000, True, bf, 128,
         "segs_drop", "packed"),
        ("gqa_segs_drop_causal_512_h8_kv2", 2, 8, 2, 512, True, bf, 128,
         "segs_drop", "packed"),
        ("d64_segs_drop_full_128", 4, 12, 12, 128, False, bf, 64, "segs_drop",
         "packed"),
        ("ernie_leg1_drop_full_128", 32, 12, 12, 128, False, bf, 64,
         "segs_drop", "none"),
        ("ernie_leg2_drop_full_512", 8, 12, 12, 512, False, bf, 64,
         "segs_drop", "none"),
        ("d64_zero_ids_drop_full_512", 2, 12, 12, 512, False, bf, 64,
         "segs_drop", "zeros"),
        ("d64_segs_causal_1000_ragged", 2, 12, 12, 1000, True, bf, 64, "segs",
         "packed"),
        ("f32_segs_causal_128", 2, 8, 8, 128, True, f32, 128, "segs",
         "packed"),
        ("f32_drop_full_512", 2, 8, 8, 512, False, f32, 128, "segs_drop",
         "none"),
        ("f32_gqa_segs_drop_causal_1000", 2, 8, 2, 1000, True, f32, 128,
         "segs_drop", "packed"),
        ("f32_d64_segs_drop_full_128", 2, 12, 12, 128, False, f32, 64,
         "segs_drop", "packed"),
        # Lq != Lk, the two id layouts drawn apart: some rows see no key
        # (out 0, lse 1e30, no gradient)
        ("segs_drop_causal_lq256_lk640", 2, 8, 8, (256, 640), True, bf, 128,
         "segs_drop", "packed"),
        ("f32_segs_full_lq200_lk333", 2, 8, 4, (200, 333), False, f32, 64,
         "segs", "packed"),
        # fp16: ERNIE's leg-1 attention as the fp16 leg calls it, packed ids
        # with and without dropout, GQA, and Lq != Lk
        ("fp16_ernie_leg1_drop_full_128", 32, 12, 12, 128, False, h16, 64,
         "segs_drop", "none"),
        ("fp16_segs_drop_causal_1000_ragged", 2, 8, 8, 1000, True, h16, 128,
         "segs_drop", "packed"),
        ("fp16_d64_segs_causal_1000_ragged", 2, 12, 12, 1000, True, h16, 64,
         "segs", "packed"),
        ("fp16_gqa_segs_drop_causal_512_h8_kv2", 2, 8, 2, 512, True, h16,
         128, "segs_drop", "packed"),
        ("fp16_segs_drop_causal_lq256_lk640", 2, 8, 8, (256, 640), True, h16,
         128, "segs_drop", "packed"),
    ]
    errs = {}
    for name, b, h, hkv, L, causal, dt, d, variant, ids in cases:
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda", dtype=dt)
        lq, lk = L if isinstance(L, tuple) else (L, L)
        q, k, v, do = rnd(b, lq, h, d), rnd(b, lk, hkv, d), \
            rnd(b, lk, hkv, d), rnd(b, lq, h, d)
        var = variant_var(torch, gen, variant, b, lq, lk, ids)
        row, _ = check_variant(torch, fa, name, q, k, v, do, causal, var)
        emit({"phase": "flash_segs_dropout_check", "case": name,
              "shape": [b, lq, lk, h, hkv, d], "causal": causal,
              "variant": variant, "ids": ids, **row})
        errs[name] = entry_errs(row)
        del q, k, v, do
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def check_variant(torch, fa, name: str, q, k, v, do, causal: bool, var,
                  runs: int = 1):
    """The four variant wrappers (forward, forward with lse, dq, dk/dv; the
    backward from the plain forward's out and lse) on one set of inputs,
    ``runs`` times, each output held against its plain version. Returns
    the check_close row and each run's ``(out_fwd, out, lse, dq, dk,
    dv)``."""
    rout, rlse = fa.flash_attention_lse_reference(q, k, v, causal, None, *var)
    refs = (rout, rout, rlse, *fa.flash_attention_bwd_reference(
        q, k, v, rout, rlse, do, causal, None, *var))
    got = [(fa.flash_attention_fwd(q, k, v, causal, None, *var),
            *fa.flash_attention_lse(q, k, v, causal, None, *var),
            *fa.flash_attention_bwd(q, k, v, rout, rlse, do, causal, None,
                                    *var))
           for _ in range(runs)]
    torch.cuda.synchronize()
    dn = dtype_name(q.dtype)
    row = {}
    for i, (key, kernel) in enumerate((
            ("out_fwd", "flash"), ("out", "flash"), ("lse", "lse"),
            ("dq", "flash_bwd"), ("dk", "flash_bwd"), ("dv", "flash_bwd"))):
        row[key] = max((check_close(torch, g[i], refs[i], kernel,
                                    f"{name} {key}", dn) for g in got),
                       key=lambda r: r["max_abs"])
    return row, got


# the check_close keys each entry point's error is read from
ENTRY_KEYS = {"fwd": ("out_fwd",), "fwd_lse": ("out", "lse"),
              "bwd_dq": ("dq",), "bwd_dkv": ("dk", "dv")}


def entry_errs(row) -> dict:
    """The largest error of each entry point in a row of check_close
    results keyed as ENTRY_KEYS."""
    return {e: max(row[x]["max_abs"] for x in keys)
            for e, keys in ENTRY_KEYS.items()}


def check_keep_mask_exact(torch, fa, dt, ids: str, seed: int) -> dict:
    """B0's mask as each kernel reveals it, against keep_mask_reference in
    every bit, at B=2, H=4 over 2 kv heads, Lq = Lk = D = 128 (identity
    inputs, so each output element is one kept or dropped probability):

    * B1, B2: q = 0 (P = 1/L), V = I, so out[i, j] = keep(i, j) inv / L;
    * B3: q = 0, K = I, V = 1, dO = I, out = 0, lse = log L, so dq[i, j] =
      scale keep(i, j) inv / L;
    * B4: Q = I, K = 0, V = 1, dO = 2^r I on the r-th query head of each kv
      group, out = 0, lse = log L: dv[j, d] (dk[j, d] / scale) =
      inv / L * sum_r 2^r keep_r(d, j), whose bits give each head's mask.

    ``ids``: "zeros" passes zero segment ids, "none" none (the wrappers
    pass zeros: the call ERNIE's attention makes)."""
    b, h, hkv, L = 2, 4, 2, 128
    rep = h // hkv
    dev = "cuda"
    keep_prob, inv = fa.dropout_constants(DROPOUT_P)
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    ref = fa.keep_mask_reference(seed, ar(b * h).view(b, h, 1, 1),
                                 ar(L).view(1, 1, L, 1), ar(L).view(1, 1, 1, L),
                                 keep_prob)
    zeros = torch.zeros(b, L, dtype=torch.int32, device=dev)
    var = ((zeros, zeros) if ids == "zeros" else (None, None)) + (
        DROPOUT_P, seed)
    eye = torch.eye(L, device=dev, dtype=dt)

    def heads(x, n):  # (L, D) -> (B, L, n, D)
        return x[None, :, None, :].expand(b, L, n, L).contiguous()
    zq, zk = (torch.zeros(b, L, n, L, device=dev, dtype=dt) for n in (h, hkv))
    ones_kv = torch.ones(b, L, hkv, L, device=dev, dtype=dt)
    k_rand = torch.randn(b, L, hkv, L, device=dev, dtype=dt)
    got = {}
    out = fa.flash_attention_fwd(zq, k_rand, heads(eye, hkv), False, None, *var)
    got["B1"] = out.permute(0, 2, 1, 3) != 0
    out, _ = fa.flash_attention_lse(zq, k_rand, heads(eye, hkv), False, None,
                                    *var)
    got["B2"] = out.permute(0, 2, 1, 3) != 0
    lse = torch.full((b, h, L), math.log(L), device=dev)
    zo = torch.zeros_like(zq)
    dq, _, _ = fa.flash_attention_bwd(zq, heads(eye, hkv), ones_kv, zo, lse,
                                      heads(eye, h), False, None, *var)
    got["B3"] = dq.permute(0, 2, 1, 3) != 0
    scaled = torch.stack([eye * 2 ** (i % rep) for i in range(h)], 1)[None]
    _, dk, dv = fa.flash_attention_bwd(heads(eye, h), zk, ones_kv, zo, lse,
                                       scaled.expand(b, L, h, L).contiguous(),
                                       False, None, *var)
    unit = inv / L
    for name, g, u in (("B4_dv", dv, unit), ("B4_dk", dk, unit / math.sqrt(L))):
        n = torch.round(g.float() / u).long()          # (B, L keys, Hkv, D)
        bits = torch.stack([(n >> r) & 1 for r in range(rep)], 3)
        # -> (B, H, query d, key j)
        got[name] = bits.reshape(b, L, h, L).permute(0, 2, 3, 1) == 1
    torch.cuda.synchronize()
    res = {}
    for name, m in got.items():
        wrong = int((m != ref).sum())
        require(wrong == 0, f"B0 via {name} ({dtype_name(dt)}, ids {ids}, "
                            f"seed {seed}): {wrong} of {ref.numel()} keep "
                            f"bits differ from keep_mask_reference")
        res[name] = wrong
    return {"dtype": dtype_name(dt), "ids": ids, "seed": seed,
            "kept_share": float(ref.float().mean()), "bits": ref.numel(),
            "wrong_bits": res}


def time_variants(torch, fa, b: int, h: int, L: int, d: int,
                  dt=None) -> dict:
    """Times of every variant entry point (raw launches) at one shape, in
    ``dt`` (default bf16), not causal, on the ids VARIANT_IDS names, with the bound, the plain
    version and the library yardstick: SDPA with a boolean key-padding mask
    (segs), with dropout_p=0.1 (segs_drop: no ids, as ERNIE calls it); for
    dq and dk/dv SDPA's whole backward and the whole plain backward. Each
    variant's wrappers are held against the plain version on the timed
    inputs (``max_abs_err``). The flag-free kernels ("none") are timed too,
    as the variants' baseline; they are not returned."""
    import torch.nn.functional as TF
    gen = torch.Generator(device="cuda").manual_seed(7)
    lib = fa._native.load("flash_attention")
    dt = dt or torch.bfloat16
    dn = dtype_name(dt)
    q, k, v, do = (torch.randn(b, L, h, d, generator=gen, device="cuda",
                               dtype=dt) for _ in range(4))
    rows = {}
    # the flag-free kernels at the same shape first, for the variants' cost
    for variant in ("none",) + fa.VARIANTS:
        var, errs = None, {}
        if variant != "none":
            var = variant_var(torch, gen, variant, b, L, L,
                              VARIANT_IDS[variant])
            row, _ = check_variant(torch, fa, f"timing {variant}", q, k, v,
                                   do, False, var)
            errs = entry_errs(row)
        args = var or (None, None, 0.0, 0)
        out, lse = fa.flash_attention_lse(q, k, v, False, None, *args)
        _, _, run_fwd = fwd_lse_launch(torch, fa, lib, q, k, v, False, var,
                                       with_lse=False)
        _, _, run_lse = fwd_lse_launch(torch, fa, lib, q, k, v, False, var)
        _, run_dq, run_dkv = bwd_launches(torch, fa, lib, q, k, v, out, lse,
                                          do, False, var)
        plain_fwd = cuda_ms(torch, lambda: fa.flash_attention_lse_reference(
            q, k, v, False, None, *args), 3, warmup=1)
        plain_bwd = cuda_ms(torch, lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, False, None, *args), 3, warmup=1)
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        mask = None
        if args[0] is not None:   # the key-padding form SDPA takes
            mask = (args[1][:, None, None, :] == args[1][:, None, None, :1])
        p = args[2]
        torch.manual_seed(0)
        lib_fwd = cuda_ms(torch, lambda: TF.scaled_dot_product_attention(
            qh.detach(), kh.detach(), vh.detach(), attn_mask=mask,
            dropout_p=p), 10)
        lib_out = TF.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  dropout_p=p)
        doh = do.transpose(1, 2).contiguous()
        lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qh, kh, vh), doh, retain_graph=True), 10)
        lib_dev = {"fwd": device_ms(
            torch, lambda: TF.scaled_dot_product_attention(
                qh.detach(), kh.detach(), vh.detach(), attn_mask=mask,
                dropout_p=p))}
        lib_dev["bwd"] = sdpa_backward_device_ms(torch, qh, kh, vh, doh,
                                                 attn_mask=mask, dropout_p=p)
        for entry, run, plain, libms in (
                ("fwd", run_fwd, plain_fwd, lib_fwd),
                ("fwd_lse", run_lse, plain_fwd, lib_fwd),
                ("bwd_dq", run_dq, plain_bwd, lib_bwd),
                ("bwd_dkv", run_dkv, plain_bwd, lib_bwd)):
            ms = cuda_ms(torch, run, 20)
            # the launch's cost function (ids read where the caller gave
            # them): what the cost registry files
            flops, nbytes = fa.attention_cost(
                entry, b, L, L, h, h, d, q.element_size(), False,
                args[0] is not None)
            bms, by = bound(flops, nbytes, dn)
            rows[entry, variant] = dict(ms=ms, plain_ms=plain, library_ms=libms,
                                        device_ms=device_ms(torch, run),
                                        library_device_ms=lib_dev[
                                            entry[:3]],
                                        bound_ms=bms, bound_by=by,
                                        tflops=flops / ms / 1e9,
                                        max_abs_err=errs.get(entry),
                                        ids=VARIANT_IDS.get(variant))
        del out, lse, qh, kh, vh, lib_out, doh, run_fwd, run_lse, run_dq, \
            run_dkv
    emit({"phase": "flash_segs_dropout_timing", "shape": [b, L, h, d],
          "dtype": dn, "causal": False, "dropout_p": DROPOUT_P,
          **{f"{e}[{v}]": r for (e, v), r in rows.items()},
          "plain_note": "plain_ms of dq and dkv is the whole plain backward",
          "library_note": "SDPA: a boolean key mask (segs), dropout_p=0.1 "
                          "(segs_drop), neither (none); of dq and dkv its "
                          "whole backward"})
    del q, k, v, do
    gc.collect()
    torch.cuda.empty_cache()
    return {k: r for k, r in rows.items() if k[1] != "none"}


def check_flash_segs_dropout(torch, fa, planted_b0):
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = check_segs_dropout_cases(torch, fa, gen)
    # B0 exactly, through every kernel, both dtypes, with and without ids
    masks = [check_keep_mask_exact(torch, fa, dt, ids, seed)
             for dt in (torch.bfloat16, torch.float32, torch.float16)
             for ids in ("none", "zeros")
             for seed in (2024, -7)]
    emit({"phase": "flash_segs_dropout_check", "keep_mask_exact": masks})
    for dt in (torch.bfloat16, torch.float16):
        segs_drop_repeat_and_planted(torch, fa, planted_b0, gen, dt)
    return errs, masks


def segs_drop_repeat_and_planted(torch, fa, planted_b0, gen, dt) -> None:
    """In ``dt``: three launches of each variant kernel at the second ERNIE
    leg's shape, as ERNIE calls it (dropout, no ids), each against the
    plain version and all three bit for bit; then the planted fault, B4's
    dropout keyed on the kv head, which REL_TOL must reject at GQA 8/2."""
    dn = dtype_name(dt)
    b, h, L, d = 8, 12, 512, 64
    q, k, v, do = (torch.randn(b, L, h, d, generator=gen, device="cuda",
                               dtype=dt) for _ in range(4))
    var = variant_var(torch, gen, "segs_drop", b, L, L, "none")
    det_row, runs = check_variant(torch, fa, "determinism", q, k, v, do,
                                  False, var, runs=3)

    def bits(x):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    same = {n: all(torch.equal(bits(r[i]), bits(runs[0][i])) for r in runs[1:])
            for i, n in enumerate(det_row)}
    require(all(same.values()),
            f"segs_drop at B={b} H={h} L={L} {dn}: three launches differ: "
            f"{same}")
    del runs, q, k, v, do
    b, h, hkv, L = 2, 8, 2, 512
    q, do = (torch.randn(b, L, h, 128, generator=gen, device="cuda",
                         dtype=dt) for _ in range(2))
    k, v = (torch.randn(b, L, hkv, 128, generator=gen, device="cuda",
                        dtype=dt) for _ in range(2))
    var = variant_var(torch, gen, "segs_drop", b, L, L)
    rout, rlse = fa.flash_attention_lse_reference(q, k, v, True, None, *var)
    _, rk, rv = fa.flash_attention_bwd_reference(q, k, v, rout, rlse, do, True,
                                                 None, *var)
    (_, dk, dv), _, run_dkv = bwd_launches(torch, fa, planted_b0, q, k, v,
                                           rout, rlse, do, True, var)
    run_dkv()
    torch.cuda.synchronize()
    planted = {n: tile_rel_err(torch, g, r) for n, g, r in
               (("dk", dk, rk), ("dv", dv, rv))}
    limit = REL_TOL["flash_bwd", dn]
    require(all(e > limit for e in planted.values()),
            f"the planted fault (B4 dropout keyed on the kv head, {dn}) "
            f"passed REL_TOL {limit}: {planted}")
    emit({"phase": "flash_segs_dropout_check", "dtype": dn, "determinism": {
        "shape": [8, 512, 12, 64], "variant": "segs_drop", "ids": "none",
        "launches": 3, "bit_identical": same, **det_row},
        "planted_fault": {"fault": "B4 dropout keyed on the kv head",
                          "shape": [b, L, h, hkv, 128], "tile_rel": planted,
                          "limit": limit}})
    del q, k, v, do, rout, rlse, rk, rv, dk, dv
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training phase 6: flash_attn_unpadded (packed variable-length batches)
# ---------------------------------------------------------------------------

UNPADDED_LENS = (1, 127, 128, 300, 500)


def check_unpadded(torch, fa, counters) -> dict:
    """``flash_attn_unpadded`` on packed lengths 1..500 (8 tail tokens past
    cu_seqlens[-1]), bf16, 12 heads of 64: forward under no_grad and
    forward + backward, with and without dropout, causal and not, against
    the plain version (the same seg ids through the plain functions,
    autograd for the gradients). The four configurations run first, as the
    phase's path, with the counts set to 0 just before and read just
    after; the launches are returned. The plain versions run after."""
    from paddle_tpu_torch.nn import functional as TF
    gen = torch.Generator(device="cuda").manual_seed(8)
    h, d = 12, 64
    total = sum(UNPADDED_LENS) + 8
    cu = torch.tensor([0, *itertools.accumulate(UNPADDED_LENS)],
                      dtype=torch.int32, device="cuda")
    qs = fa._unpadded_seg_ids(cu, total, fa.TAIL_Q_SEG)
    ks = fa._unpadded_seg_ids(cu, total, fa.TAIL_KV_SEG)
    seed = 99
    configs = ((False, 0.0), (True, 0.0), (True, DROPOUT_P),
               (False, DROPOUT_P))
    inputs = [tuple(torch.randn(total, h, d, generator=gen, device="cuda",
                                dtype=torch.bfloat16) for _ in range(4))
              for _ in configs]
    for c in counters.values():
        c.reset()
    results = []
    for (causal, p), (q, k, v, do) in zip(configs, inputs):
        with torch.no_grad():
            fwd_only = TF.flash_attn_unpadded(q, k, v, cu, cu, 512, 512,
                                              dropout=p, causal=causal,
                                              fixed_seed_offset=seed)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = TF.flash_attn_unpadded(qg, kg, vg, cu, cu, 512, 512, dropout=p,
                                     causal=causal, fixed_seed_offset=seed)
        results.append((fwd_only, out.detach(),
                        torch.autograd.grad(out, (qg, kg, vg), do)))
    torch.cuda.synchronize()
    launches = {f"{e}[{v}]": c.count for (e, v), c in counters.items()}
    for (causal, p), (q, k, v, do), (fwd_only, out, grads) in zip(
            configs, inputs, results):
        qr, kr, vr = (x.float()[None].requires_grad_() for x in (q, k, v))
        ref = fa.flash_attention_reference(qr, kr, vr, causal, None, qs, ks,
                                           p, seed)
        rgrads = torch.autograd.grad(ref, (qr, kr, vr), do.float()[None])
        torch.cuda.synchronize()
        name = f"{'causal' if causal else 'full'}_p{p}"
        ref_bf = ref[0].to(torch.bfloat16)
        row = {"case": name, "lens": list(UNPADDED_LENS), "tail": 8,
               "fwd_no_grad": check_close(torch, fwd_only[None], ref_bf[None],
                                          "flash", f"unpadded {name} fwd"),
               "out": check_close(torch, out[None], ref_bf[None], "flash",
                                  f"unpadded {name} out")}
        for n, g, r in zip(("dq", "dk", "dv"), grads, rgrads):
            row[n] = check_close(torch, g[None], r.to(torch.bfloat16),
                                 "flash_bwd", f"unpadded {name} {n}")
        require(not bool(out[-8:].any()), f"unpadded {name}: tail rows not 0")
        emit({"phase": "unpadded_check", **row})
        del qr, kr, vr, ref, rgrads
    del inputs, results
    require(all(n > 0 for n in launches.values()),
            f"unpadded: a variant was not launched: {launches}")
    emit({"phase": "unpadded_check", "launches": launches})
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# training phase 7: train ERNIE-3.0-base (bench_ernie.py's traffic)
# ---------------------------------------------------------------------------

ERNIE_LEGS = ((32, 128), (8, 512))   # (batch, seq): bench_ernie.py's, then long
# (B, H, L, D) of the first leg's attention: where the variants are timed
ERNIE_SHAPE = (32, 12, 128, 64)


def variant_path(entry: str, variant: str) -> str:
    """The path whose run gives a variant row its ``launches``: ERNIE's
    first leg (bench_ernie.py's traffic) for the training kernels with
    dropout, flash_attn_unpadded for the rest (segment ids alone, and the
    forward without lse, which ERNIE's training never calls)."""
    if variant == "segs_drop" and entry != "fwd":
        return "ernie_leg1"
    return "unpadded"


def train_ernie3_base(torch, card, fa, all_counters) -> dict:
    """ERNIE-3.0-base (vocab 40000, hidden 768, 12 layers, 12 heads,
    intermediate 3072) for sequence classification, random weights from
    seed 0, AMP O2 bf16 with fp32 masters, AdamW lr 5e-5 wd 0.01 with fp32
    moments (the per-tensor update; the fused multi-tensor one is not
    ported), dropout on (hidden 0.1, attention 0.1 in the kernels). Leg 1
    is bench_ernie.py's traffic (B = 32, L = 128, 2 classes, ids and labels
    from numpy seed 0, no mask), leg 2 B = 8, L = 512; each 2 warm-up and 10
    timed steps, then one profiled step. The loss on the fixed batch in
    eval mode (no dropout) must fall over each leg."""
    import numpy as np
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForSequenceClassification)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = ErnieConfig.ernie3_base()
    warmup, timed = 2, 10
    t0 = time.monotonic()
    model = ErnieForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0), seed=0)
    opt = AdamW(learning_rate=5e-5, weight_decay=0.01,
                parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    params = model.num_params()
    path = {e: fa.launches_variant[e, "segs_drop"]
            for e in ("fwd_lse", "bwd_dq", "bwd_dkv")}
    legs = []
    for batch, seq in ERNIE_LEGS:
        rng = np.random.default_rng(0)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq),
                                           dtype=np.int32), device="cuda")
        labels = torch.as_tensor(rng.integers(0, 2, (batch,)).astype(np.int64),
                                 device="cuda")

        def step():
            with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
                loss, _ = model(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        def eval_loss():
            model.eval()
            with torch.no_grad(), amp.auto_cast(enable=True, level="O2",
                                                dtype="bfloat16"):
                loss, _ = model(ids, labels=labels)
            model.train()
            return float(loss)

        before = eval_loss()
        losses, times = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in all_counters:
            c.reset()
        stop_sampler = sample_card()
        try:
            for _ in range(warmup + timed):
                t1 = time.monotonic()
                loss = step()
                torch.cuda.synchronize()
                times.append(time.monotonic() - t1)
                losses.append(float(loss.detach()))
        finally:
            card_samples = stop_sampler()
        steps = warmup + timed
        launches = {f"{e}[segs_drop]": c.count for e, c in path.items()}
        fused_step = ernie_fused_per_step(cfg.num_hidden_layers)
        fused = {k: c.count for k, c in step_counters().items()
                 if k in fused_step}
        others = {c.name: c.count for c in all_counters
                  if c not in path.values() and c.name not in fused_step
                  and c.count}
        after = eval_loss()
        require(all(math.isfinite(x) for x in losses), f"losses {losses}")
        require(all(n == cfg.num_hidden_layers * steps
                    for n in launches.values()) and not others
                and all(fused[k] == fused_step[k] * steps for k in fused),
                f"ERNIE B={batch} L={seq}: launches {launches} (want "
                f"{cfg.num_hidden_layers} a step), fused {fused} (want "
                f"{fused_step} a step), others {others}")
        require(after < before, f"ERNIE B={batch} L={seq}: eval loss on the "
                                f"fixed batch {before} -> {after}, not falling")
        timed_s = times[warmup:]
        p50 = statistics.median(timed_s)
        tok_s = batch * seq / p50
        fpt = model.flops_per_token(seq)
        row = {"phase": "train_ernie3_base", "card": card,
               "config": {"vocab": cfg.vocab_size, "hidden": cfg.hidden_size,
                          "layers": cfg.num_hidden_layers,
                          "heads": cfg.num_attention_heads,
                          "intermediate": cfg.intermediate_size,
                          "hidden_dropout": cfg.hidden_dropout_prob,
                          "attention_dropout":
                              cfg.attention_probs_dropout_prob},
               "params": params, "batch": batch, "seq": seq,
               "warmup_steps": warmup, "timed_steps": timed,
               "step_s": times, "step_p50_s": p50,
               "step_spread_s": max(timed_s) - min(timed_s),
               "tokens_per_s": tok_s, "examples_per_s": batch / p50,
               "flops_per_token": fpt, "mfu_vs_989tflops": fpt * tok_s / 989e12,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "losses": losses, "eval_loss_before": before,
               "eval_loss_after": after, "init_s": init_s,
               "card_during_steps": card_samples, "launches": launches,
               "launches_per_step": {k: n / steps for k, n in launches.items()},
               "launches_fused": fused,
               "launches_fused_per_step": {k: n / steps
                                           for k, n in fused.items()}}
        emit(row)
        profile_step(torch, card, step, p50, "train_ernie_profile",
                     train_family, {"batch": batch, "seq": seq})
        legs.append(row)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    # each leg's launches, counted from 0 over its own steps
    return {f"ernie_leg{i}": {**r["launches"], **r["launches_fused"]}
            for i, r in enumerate(legs, 1)}


def ernie_vs_cpu(torch, fa) -> None:
    """Two full-width ERNIE-3.0-base layers in fp32, training mode, on the
    card (the fp32 kernels' SEGS+DROP variants) and on the CPU (their plain
    versions), from one state dict, dropout on (hidden and attention 0.1):
    each model's DropoutRNG (seed 5) derives the same seeds on both, so B0
    and the hidden dropout kernel (K7) draw the same masks as the CPU's
    plain versions. Logits, loss and every gradient must agree, and the
    card launches K5-K7 as an ERNIE step does."""
    import numpy as np
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForSequenceClassification)
    cfg = ErnieConfig.ernie3_base()
    cfg.num_hidden_layers = 2
    batch, seq = 4, 128
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)))
    labels = torch.as_tensor(rng.integers(0, 2, (batch,)))
    init = None
    runs = {}
    counters = {e: fa.launches_variant[e, "segs_drop"]
                for e in ("fwd_lse", "bwd_dq", "bwd_dkv")}
    counters.update(ernie_op_counters())
    for dev in ("cuda", "cpu"):
        model = ErnieForSequenceClassification(cfg, device=dev, seed=5)
        if init is None:
            init = {k: v.cpu() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        for c in counters.values():
            c.reset()
        loss, logits = model(ids.to(dev), labels=labels.to(dev))
        loss.backward()
        runs[dev] = dict(loss=float(loss), logits=logits.detach().cpu(),
                         grads={k: p.grad.detach().cpu()
                                for k, p in model.named_parameters()},
                         launches={e: c.count for e, c in counters.items()})
        del model, loss, logits
    a, b = runs["cuda"], runs["cpu"]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    logit_err = float((a["logits"] - b["logits"]).abs().max())
    # each gradient's max-abs difference over its own largest element,
    # floored at 1e-3 of the largest gradient element of the model: the k
    # biases' exact gradient is 0 (softmax ignores a shift common to every
    # key), so both sides hold rounding noise there
    floor = 1e-3 * max(float(g.abs().max()) for g in b["grads"].values())
    grad_rel = max(float((a["grads"][k] - b["grads"][k]).abs().max())
                   / max(float(b["grads"][k].abs().max()), floor)
                   for k in b["grads"])
    # fp32 on both; the sums run in another order (1e-4 relative seen for
    # the Llama layers of train_vs_cpu)
    require(loss_rel < 1e-4 and logit_err < 1e-4 and grad_rel < 1e-3,
            f"ERNIE card vs CPU: loss rel {loss_rel}, logits {logit_err}, "
            f"grad rel {grad_rel}")
    per_step = ernie_fused_per_step(cfg.num_hidden_layers)
    require(all(n == cfg.num_hidden_layers for e, n in a["launches"].items()
                if e in ("fwd_lse", "bwd_dq", "bwd_dkv"))
            and all(a["launches"][k] == per_step.get(k, 0)
                    for k in ernie_op_counters())
            and not any(b["launches"].values()),
            f"ERNIE card vs CPU launches: card {a['launches']}, cpu "
            f"{b['launches']}")
    emit({"phase": "ernie_vs_cpu", "layers": 2, "dtype": "float32",
          "batch": batch, "seq": seq, "attention_dropout":
              cfg.attention_probs_dropout_prob,
          "hidden_dropout": cfg.hidden_dropout_prob,
          "loss_card": a["loss"], "loss_cpu": b["loss"], "loss_rel": loss_rel,
          "logits_max_abs": logit_err, "grad_max_rel": grad_rel,
          "tolerance": {"loss_rel": 1e-4, "logits_abs": 1e-4,
                        "grad_rel": 1e-3},
          "launches_card": a["launches"]})
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the train step as one CUDA graph: the multi-tensor AdamW kernel, the
# capture contract, ERNIE-3.0-base and the Llama step captured
# ---------------------------------------------------------------------------

ERNIE3_BASE_PARAMS = 117946370   # ErnieConfig.ernie3_base() with 2 classes
ADAM_HP = dict(eps=1e-8, beta1=0.9, beta2=0.999)


def ulps32(torch, a, b) -> int:
    """Largest distance in fp32 units in the last place between a and b."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def check_multi_tensor_adam(torch, q8, mta, dt=None) -> dict:
    """The multi-tensor AdamW kernel against its plain version at
    ERNIE-3.0-base's 117,946,370 parameters (parameters and gradients in
    ``dt``, bf16 by default or fp16, fp32 master and moments, the
    global-norm scale and weight decay on): master, m and v within one fp32
    ulp (max-abs reported), the 16-bit parameters equal; a planted closed
    gate writes nothing; its time against its byte bound, the plain version
    and ``torch._fused_adamw_`` (a yardstick, never the path: bf16 on the
    fp32 masters, fp16 on fp16 parameters, gradients and moments)."""
    dt = dt or torch.bfloat16
    n = ERNIE3_BASE_PARAMS
    gen = torch.Generator(device="cuda").manual_seed(11)
    master = torch.randn(n, generator=gen, device="cuda") * 0.02
    m = torch.randn(n, generator=gen, device="cuda") * 1e-3
    v = torch.rand(n, generator=gen, device="cuda") * 1e-4
    grad = (torch.randn(n, generator=gen, device="cuda") * 1e-2).to(dt)
    param = master.to(dt)
    t = 3
    c1, c2 = (float(torch.tensor(1.0 - b ** t, dtype=torch.float32))
              for b in (0.9, 0.999))
    lr, wd = 5e-5, 0.01
    sc = q8.scalar_block(lr, c1, c2, 1.0 - lr * wd, grad_scale=0.8,
                         device="cuda")
    kw = dict(ADAM_HP, scalars=sc, has_wd=True, grad_scale=True)
    st_k = [x.clone() for x in (master, m, v, param)]
    st_r = [x.clone() for x in (master, m, v, param)]
    launches0 = mta.launches.count
    mta.multi_tensor_adam_update(*st_k, grad, **kw)
    mta.multi_tensor_adam_update_reference(*st_r, grad, **kw)
    torch.cuda.synchronize()
    require(mta.launches.count == launches0 + 1,
            "multi_tensor_adam: not one launch")
    errs = {name: float((a - b).abs().max())
            for name, a, b in zip(("master", "m", "v"), st_k, st_r)}
    ulps = {name: ulps32(torch, a, b)
            for name, a, b in zip(("master", "m", "v"), st_k, st_r)}
    param_diff = int((st_k[3] != st_r[3]).sum())
    moved = int((st_k[0] != master).sum())      # the update reached them
    require(max(ulps.values()) <= 1 and param_diff == 0 and moved > n // 2,
            f"multi_tensor_adam kernel vs plain ({dtype_name(dt)}): max-abs "
            f"{errs}, ulps {ulps}, parameters differing {param_diff}, "
            f"masters moved {moved}")
    closed = sc.clone()
    closed[4] = 0.0
    st_g = [x.clone() for x in (master, m, v, param)]
    mta.multi_tensor_adam_update(*st_g, grad, **dict(kw, scalars=closed))
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in
                zip(st_g, (master, m, v, param))),
            "multi_tensor_adam: a closed gate wrote state")
    del st_g
    ms = cuda_ms(torch, lambda: mta.multi_tensor_adam_update(
        *st_k, grad, **kw), 20)
    dev = device_time(torch, lambda: mta.multi_tensor_adam_update(
        *st_k, grad, **kw), 20, ms)
    plain = cuda_ms(torch, lambda: mta.multi_tensor_adam_update_reference(
        *st_r, grad, **kw), 3, warmup=1)
    del st_r
    gc.collect()
    torch.cuda.empty_cache()
    # the library yardstick: one fused PyTorch AdamW over the fp32 masters
    # (its gradient fp32 too: it takes the parameters' dtype); for fp16
    # over fp16 parameters, as torch.optim.AdamW(fused=True) keeps them
    lib_dt = torch.float16 if dt == torch.float16 else torch.float32
    p32, g32 = master.to(lib_dt), grad.to(lib_dt)
    m32, v32 = m.to(lib_dt), v.to(lib_dt)
    step_t = torch.tensor(float(t), device="cuda")
    library = cuda_ms(torch, lambda: torch._fused_adamw_(
        [p32], [g32], [m32], [v32], [], [step_t], lr=lr, beta1=0.9,
        beta2=0.999, weight_decay=wd, eps=1e-8, amsgrad=False,
        maximize=False), 20)
    library_dev = device_ms(torch, lambda: torch._fused_adamw_(
        [p32], [g32], [m32], [v32], [], [step_t], lr=lr, beta1=0.9,
        beta2=0.999, weight_decay=wd, eps=1e-8, amsgrad=False,
        maximize=False), 20)
    # the launch's cost function (ops.multi_tensor_adam): what the cost
    # registry files
    mt_flops, mt_bytes = mta.multi_tensor_adam_cost(*st_k, grad)
    bms, by = bound(mt_flops, mt_bytes, "float32")
    row = {"phase": "multi_tensor_adam_check", "n": n,
           "param_dtype": dtype_name(dt), "grad_dtype": dtype_name(dt),
           "max_abs_err": errs, "max_ulps": ulps,
           "params_differing": param_diff,
           "closed_gate_writes_nothing": True, "ms": ms, "plain_ms": plain,
           "device_ms": dev["device_ms"], "device_source": dev["source"],
           "library_device_ms": library_dev,
           "bound_ms": bms, "bound_by": by, "library_ms": library,
           "library": "torch._fused_adamw_ on fp32 masters and fp32 grads"
                      if lib_dt == torch.float32 else
                      "torch._fused_adamw_ on fp16 params, grads and moments",
           "gbytes_per_s": mt_bytes / ms / 1e6}
    emit(row)
    del master, m, v, grad, param, st_k, p32, g32, m32, v32
    gc.collect()
    torch.cuda.empty_cache()
    return row


CAPTURE_STEPS = 6
CAPTURE_RTOL, CAPTURE_ATOL = 1e-5, 1e-6   # tests/test_step_capture.py:212-221


def ernie_recipe(torch, model, decay_steps: int, warmup_steps: int,
                 peak: float = 5e-5):
    """The fine-tune recipe: AdamW(use_multi_tensor, wd 0.01),
    LinearWarmup over PolynomialDecay(power 1, to 0), global-norm clip 1."""
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as lr_mod
    sched = lr_mod.LinearWarmup(
        lr_mod.PolynomialDecay(peak, decay_steps, end_lr=0.0, power=1.0),
        warmup_steps, 0.0, peak)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                weight_decay=0.01, use_multi_tensor=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    return sched, opt


def carried_state(model, opt) -> list:
    """Clones of every state tensor a step writes: the parameters, the flat
    master, m and v, the step count and the dropout seed counter."""
    fs = opt._flat
    return ([p.detach().clone() for p in model.parameters()]
            + [fs.master.clone(), fs.m.clone(), fs.v.clone(),
               opt._step_t.clone(), model.ernie.rng.counter.clone()])


def within(torch, a, b) -> bool:
    return bool(torch.allclose(a.float(), b.float(), rtol=CAPTURE_RTOL,
                               atol=CAPTURE_ATOL))


def captured_step(jit, step, mode: str, **kw):
    """``jit.CapturedStep(step, **kw)`` built under
    ``PADDLE_TPU_STEP_CAPTURE=mode`` (``off``: the eager tier), as a user
    selects the tier."""
    prev = os.environ.get("PADDLE_TPU_STEP_CAPTURE")
    os.environ["PADDLE_TPU_STEP_CAPTURE"] = mode
    try:
        return jit.CapturedStep(step, **kw)
    finally:
        if prev is None:
            del os.environ["PADDLE_TPU_STEP_CAPTURE"]
        else:
            os.environ["PADDLE_TPU_STEP_CAPTURE"] = prev


def capture_check(torch, fa, mta) -> dict:
    """The capture contract on two full-width ERNIE-3.0-base layers in
    fp32, dropout on (hidden and attention 0.1), the fine-tune recipe and
    the NaN gate: an eager run (``PADDLE_TPU_STEP_CAPTURE=off`` tier) and a
    captured one go 6 steps from the same state and must agree (step 1's
    loss bit-equal, every loss and parameter within rtol 1e-5, atol 1e-6);
    a captured run whose dropout seeds (attention and hidden) are frozen
    into the graph as constants must not; the dropout counter advances
    (layers attention + 2 layers + 2 hidden draws) x steps; the LR
    follows the scheduler with one capture and 5 replays; a NaN batch
    leaves every state tensor bitwise unchanged; ``scheduler.step()`` in
    the update raises ``HostStateWriteError``; a new shape captures a
    second graph; a replay launches the flash kernels layers x 3 times, the
    multi-tensor kernel once and K1, K4-K7 as an eager step does
    (``ernie_fused_per_step``); a step with a host read runs eagerly
    (bypass ``untraceable``)."""
    import warnings
    import numpy as np
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForSequenceClassification)
    from paddle_tpu_torch.nn import common as nn_common
    from paddle_tpu_torch.ops._u32 import M32
    cfg = ErnieConfig.ernie3_base()
    cfg.num_hidden_layers = 2
    layers = cfg.num_hidden_layers
    draws = 3 * layers + 2   # seeds a step: attention, hidden dropouts
    batch, seq = 8, 128
    rng = np.random.default_rng(3)
    data = [(torch.as_tensor(rng.integers(1, cfg.vocab_size, (batch, seq)),
                             device="cuda"),
             torch.as_tensor(rng.integers(0, 2, (batch,)), device="cuda"))
            for _ in range(CAPTURE_STEPS)]
    one = torch.ones((), device="cuda")
    init = {}
    counters = {e: fa.launches_variant[e, "segs_drop"]
                for e in ("fwd_lse", "bwd_dq", "bwd_dkv")}

    def build(mode):
        model = ErnieForSequenceClassification(cfg, device="cuda", seed=5)
        if not init:
            init.update({k: v.clone() for k, v in model.state_dict().items()})
        model.load_state_dict(init)
        sched, opt = ernie_recipe(torch, model, decay_steps=8,
                                  warmup_steps=2)

        def step(ids, labels, scale):
            loss, _ = model(ids, labels=labels)
            loss = loss * scale
            loss.backward()
            return loss

        def update():
            opt.step()
            opt.clear_grad()
        cap = captured_step(jit, step, mode, update_fn=update,
                            clear_fn=opt.clear_grad, nan_gate=True)
        return model, sched, opt, cap

    def run(mode):
        model, sched, opt, cap = build(mode)
        losses = []
        for ids, labels in data:
            losses.append(cap(ids, labels, one))
            sched.step()
            require(float(opt._lr_t) == float(np.float32(sched())),
                    f"capture ({mode}): _lr_t {float(opt._lr_t)} is not the "
                    f"scheduler's {sched()}")
        torch.cuda.synchronize()
        return model, sched, opt, cap, torch.stack(losses)

    def agree(a, b) -> dict:
        (ma, _, oa, _, la), (mb, _, ob, _, lb) = a, b
        params = [within(torch, x, y) for x, y in
                  zip(carried_state(ma, oa)[:-2], carried_state(mb, ob)[:-2])]
        la, lb = la.detach(), lb.detach()
        return {"step1_loss_bit_equal": bool(torch.equal(la[0], lb[0])),
                "losses_within": within(torch, la, lb),
                "state_tensors_within": sum(params),
                "state_tensors": len(params),
                "loss_max_rel": float(((la - lb).abs() / lb.abs()).max())}

    eager = run("off")
    captured = run("auto")
    verdict = agree(eager, captured)
    require(verdict["step1_loss_bit_equal"] and verdict["losses_within"]
            and verdict["state_tensors_within"] == verdict["state_tensors"],
            f"capture: eager and captured trajectories differ: {verdict}")
    model, sched, opt, cap, _ = captured
    require(cap.stats == {"hits": CAPTURE_STEPS - 1, "retraces": 1,
                          "bypasses": {}},
            f"capture: stats {cap.stats}")
    for name, (m_, *_rest) in (("eager", eager), ("captured", captured)):
        require(int(m_.ernie.rng.counter) == draws * CAPTURE_STEPS,
                f"capture ({name}): dropout counter "
                f"{int(m_.ernie.rng.counter)}, want {draws * CAPTURE_STEPS}")
    graph = next(iter(cap._graphs.values()))
    per_replay = {c.name: n for c, n in graph.recorded.items()}
    flash = sum(graph.recorded.get(c, 0) for c in counters.values())
    per_step = ernie_fused_per_step(layers)
    require(flash == layers * 3 and graph.recorded.get(mta.launches) == 1
            and all(graph.recorded.get(ctr, 0) == per_step[k]
                    for k, ctr in step_counters().items() if k in per_step),
            f"capture: launches per replay {per_replay}, want K1-K7 "
            f"{per_step}")
    # the counters follow the replays
    for c in (*counters.values(), mta.launches):
        c.reset()
    cap(*data[0], one)
    torch.cuda.synchronize()
    counted = {c.name: c.count for c in (*counters.values(), mta.launches)}
    require(counted == {c.name: graph.recorded[c]
                        for c in (*counters.values(), mta.launches)},
            f"capture: a replay counted {counted}, recorded {per_replay}")
    # a NaN batch: the gate withholds the update on the device
    before = carried_state(model, opt)
    nan_loss = cap(*data[1], torch.full((), float("nan"), device="cuda"))
    torch.cuda.synchronize()
    changed = sum(not torch.equal(a, b)
                  for a, b in zip(carried_state(model, opt), before))
    require(not math.isfinite(float(nan_loss)) and changed == 0,
            f"capture: a NaN batch changed {changed} state tensors")
    # a new shape: a second graph
    cap(data[0][0][:4], data[0][1][:4], one)
    require(cap.stats["retraces"] == 2 and cap.num_graphs == 2,
            f"capture: a new shape gave {cap.stats}")
    # scheduler.step() inside the captured update
    trap = captured_step(
        jit, lambda ids, labels: model(ids, labels=labels)[0].backward(),
        "auto",
        update_fn=lambda: (opt.step(), opt.clear_grad(), sched.step()))
    try:
        trap(*data[2])
        raised = False
    except jit.HostStateWriteError:
        raised = True
    require(raised, "capture: scheduler.step() inside the captured update "
                    "did not raise HostStateWriteError")
    opt.clear_grad()
    # a graph holds and writes only the RNGs its step draws from: an
    # unrelated model and a CPU DropoutRNG alive at capture, the model
    # freed (its memory handed to new tensors) before the replays
    other = ErnieForSequenceClassification(cfg, device="cuda", seed=9)
    cpu_rng = nn_common.DropoutRNG("cpu", seed=9)
    iso_model, _, _, iso = build("auto")
    iso_losses = [iso(*data[0], one)]
    iso_graph = next(iter(iso._graphs.values()))
    iso_rngs = iso_graph.rngs
    del other
    gc.collect()
    torch.cuda.empty_cache()
    junk = [torch.full((1,), -1, dtype=torch.int64, device="cuda")
            for _ in range(8192)]
    iso_losses += [iso(ids, labels, one) for ids, labels in data[1:4]]
    torch.cuda.synchronize()
    junk_intact = bool(torch.cat(junk).eq(-1).all())
    isolation = {"rngs_kept": len(iso_rngs),
                 "kept_is_the_model_rng": iso_rngs == (iso_model.ernie.rng,),
                 "stats": iso.stats, "junk_intact": junk_intact,
                 "cpu_rng_counter": int(cpu_rng.counter),
                 "counter": int(iso_model.ernie.rng.counter),
                 "losses_finite": all(math.isfinite(float(x))
                                      for x in iso_losses)}
    require(isolation["kept_is_the_model_rng"] and junk_intact
            and isolation["cpu_rng_counter"] == 0
            and isolation["counter"] == draws * 4
            and isolation["losses_finite"]
            and iso.stats == {"hits": 3, "retraces": 1, "bypasses": {}},
            f"capture: a graph touched RNGs its step does not draw from: "
            f"{isolation}")
    del iso_model, iso, iso_graph, iso_rngs, junk, cpu_rng
    # the planted fault: dropout seeds (attention and hidden) frozen into
    # the graph as by-value constants (what passing the seed by value did);
    # eager runs draw them as the real scheme does, so only the replays go
    # wrong
    real = nn_common.DropoutRNG.next_seed
    host_count = {}

    def frozen(self):
        k = host_count.setdefault(id(self), 0)
        host_count[id(self)] = k + 1
        self.counter.add_(1)
        return torch.full((), (5 + k * 0x9E3779B1) & M32,
                          dtype=torch.int64, device=self.seed_t.device)
    nn_common.DropoutRNG.next_seed = frozen
    try:
        planted = run("auto")
    finally:
        nn_common.DropoutRNG.next_seed = real
    planted_verdict = agree(eager, planted)
    require(not (planted_verdict["losses_within"]
                 and planted_verdict["state_tensors_within"]
                 == planted_verdict["state_tensors"]),
            f"capture: the frozen-seed graph passed the comparison: "
            f"{planted_verdict}")
    # a step that reads the host cannot be captured: eager, counted
    lin = torch.nn.Linear(64, 64, device="cuda")
    x = torch.randn(16, 64, device="cuda")

    def host_read(x):
        loss = lin(x).square().mean()
        loss.backward()
        return torch.tensor(float(loss), device="cuda")
    reader = captured_step(jit, host_read, "auto")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs = [float(reader(x)) for _ in range(2)]
    require(reader.stats["bypasses"] == {"untraceable": 2}
            and all(math.isfinite(o) for o in outs) and len(caught) == 1,
            f"capture: host-read step gave {reader.stats}, {outs}, "
            f"{[str(w.message)[:80] for w in caught]}")
    torch.cuda.synchronize()
    row = {"phase": "capture_check", "layers": layers, "dtype": "float32",
           "batch": batch, "seq": seq, "steps": CAPTURE_STEPS,
           "hidden_dropout": cfg.hidden_dropout_prob,
           "attention_dropout": cfg.attention_probs_dropout_prob,
           "eager_vs_captured": verdict,
           "losses_eager": eager[4].tolist(),
           "losses_captured": captured[4].tolist(),
           "tolerance": {"rtol": CAPTURE_RTOL, "atol": CAPTURE_ATOL},
           "planted_frozen_seed": planted_verdict,
           "losses_planted": planted[4].tolist(),
           "dropout_counter": int(model.ernie.rng.counter),
           "stats": cap.stats, "launches_per_replay": per_replay,
           "nan_batch_state_changed": changed,
           "scheduler_step_in_update_raises": raised,
           "rng_isolation": isolation,
           "host_read_step": reader.stats}
    emit(row)
    del eager, captured, planted, model, opt, cap, trap, graph
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_ernie3_base_captured(torch, card, fa, mta) -> dict:
    """The main path: ERNIE-3.0-base fine-tuning (full width and depth,
    random weights from seed 0) with the recipe (AMP O2 bf16 with fp32
    masters, dropout 0.1, multi-tensor AdamW, LinearWarmup over
    PolynomialDecay, global-norm clip 1.0) through
    ``jit.capture_step(..., nan_gate=True)``, ``scheduler.step()``
    between calls; bench_ernie.py's traffic (B=32, L=128), then B=8,
    L=512, each 2 warm-up (the first captures) and 10 timed calls, then one
    profiled call. Leg 1 also runs the same recipe on the eager tier
    (``PADDLE_TPU_STEP_CAPTURE=off``), timed and profiled, for the side-by-side. The eval
    loss on the fixed batch must fall over each leg, and no call may
    bypass the graph."""
    import numpy as np
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForSequenceClassification)
    cfg = ErnieConfig.ernie3_base()
    warmup, timed, eager_timed = 2, 10, 5
    model = ErnieForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0), seed=0)
    params = model.num_params()
    require(params == ERNIE3_BASE_PARAMS, f"ERNIE-3.0-base has {params} "
                                          f"parameters")
    total = 2 * (warmup + timed + 1) + warmup + eager_timed + 1
    sched, opt = ernie_recipe(torch, model, decay_steps=total,
                              warmup_steps=max(1, total // 10))
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    path = {e: fa.launches_variant[e, "segs_drop"]
            for e in ("fwd_lse", "bwd_dq", "bwd_dkv")}
    path["multi_tensor_adam"] = mta.launches
    fused_step = ernie_fused_per_step(cfg.num_hidden_layers)
    path.update({k: ctr for k, ctr in step_counters().items()
                 if k in fused_step})

    def step(ids, labels):
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            loss, _ = model(ids, labels=labels)
        loss.backward()
        return loss

    def update():
        opt.step()
        opt.clear_grad()
    cap = jit.capture_step(step, update_fn=update, clear_fn=opt.clear_grad,
                           nan_gate=True)
    legs = []
    for leg, (batch, seq) in enumerate(ERNIE_LEGS, 1):
        rng = np.random.default_rng(0)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq),
                                           dtype=np.int32), device="cuda")
        labels = torch.as_tensor(rng.integers(0, 2, (batch,)).astype(np.int64),
                                 device="cuda")

        def eval_loss():
            model.eval()
            with torch.no_grad(), amp.auto_cast(enable=True, level="O2",
                                                dtype="bfloat16"):
                loss, _ = model(ids, labels=labels)
            model.train()
            return float(loss)

        def timed_calls(fn, n):
            losses, times = [], []
            for _ in range(n):
                t1 = time.monotonic()
                loss = fn(ids, labels)
                torch.cuda.synchronize()
                times.append(time.monotonic() - t1)
                losses.append(float(loss))
                sched.step()
            return losses, times

        before = eval_loss()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in path.values():
            c.reset()
        stats0 = dict(cap.stats, bypasses=dict(cap.stats["bypasses"]))
        stop_sampler = sample_card()
        try:
            losses, times = timed_calls(cap, warmup + timed)
        finally:
            card_samples = stop_sampler()
        launches = {k: c.count for k, c in path.items()}
        after = eval_loss()
        graph = cap._graphs[next(reversed(cap._graphs))]
        per_replay = {c.name: n for c, n in graph.recorded.items()}
        require(all(math.isfinite(x) for x in losses), f"losses {losses}")
        require(not cap.stats["bypasses"], f"ERNIE captured: bypasses "
                                           f"{cap.stats}")
        require(cap.stats["retraces"] == stats0["retraces"] + 1
                and cap.stats["hits"] == stats0["hits"] + warmup + timed - 1,
                f"ERNIE captured B={batch} L={seq}: {cap.stats} after "
                f"{stats0}")
        require(after < before, f"ERNIE captured B={batch} L={seq}: eval "
                                f"loss {before} -> {after}, not falling")
        require(all(launches[f"{e}"] == cfg.num_hidden_layers * (warmup + timed)
                    for e in ("fwd_lse", "bwd_dq", "bwd_dkv"))
                and launches["multi_tensor_adam"] == warmup + timed
                and all(launches[k] == n * (warmup + timed)
                        for k, n in fused_step.items() if k in launches),
                f"ERNIE captured B={batch} L={seq}: launches {launches}")
        timed_s = times[warmup:]
        p50 = statistics.median(timed_s)
        tok_s = batch * seq / p50
        fpt = model.flops_per_token(seq)
        row = {"phase": "train_ernie3_base_captured", "card": card,
               "leg": leg, "params": params, "batch": batch, "seq": seq,
               "recipe": {"amp": "O2 bf16, fp32 masters",
                          "optimizer": "AdamW(use_multi_tensor=True, wd 0.01)",
                          "lr": "LinearWarmup(PolynomialDecay(5e-5, %d, 0.0,"
                                " 1.0), %d, 0.0, 5e-5)" % (
                                    total, max(1, total // 10)),
                          "grad_clip": "ClipGradByGlobalNorm(1.0)",
                          "dropout": [cfg.hidden_dropout_prob,
                                      cfg.attention_probs_dropout_prob],
                          "nan_gate": True},
               "warmup_calls": warmup, "timed_calls": timed,
               "step_s": times, "step_p50_s": p50,
               "step_spread_s": max(timed_s) - min(timed_s),
               "tokens_per_s": tok_s, "examples_per_s": batch / p50,
               "flops_per_token": fpt,
               "mfu_vs_989tflops": fpt * tok_s / 989e12,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "losses": losses, "eval_loss_before": before,
               "eval_loss_after": after, "card_during_steps": card_samples,
               "launches": launches, "launches_per_replay": per_replay,
               "stats": cap.stats, "lr_end": sched()}
        emit(row)
        prof = profile_step(torch, card, lambda: cap(ids, labels), p50,
                            "train_ernie_captured_profile", train_family,
                            {"batch": batch, "seq": seq, "tier": "captured"})
        sched.step()
        if leg == 1:
            # the same recipe on the eager tier, for the side-by-side
            eager_cap = captured_step(jit, step, "off", update_fn=update,
                                      clear_fn=opt.clear_grad, nan_gate=True)
            e_losses, e_times = timed_calls(eager_cap, warmup + eager_timed)
            e_p50 = statistics.median(e_times[warmup:])
            e_prof = profile_step(torch, card, lambda: eager_cap(ids, labels),
                                  e_p50, "train_ernie_captured_profile",
                                  train_family, {"batch": batch, "seq": seq,
                                                 "tier": "eager (off)"})
            sched.step()
            pair = {"captured": prof, "eager": e_prof}
            emit({"phase": "train_ernie3_base_captured_vs_eager",
                  "card": card, "batch": batch, "seq": seq,
                  "step_p50_s": {"captured": p50, "eager": e_p50},
                  "speedup": e_p50 / p50,
                  **{k: {t: r[k] for t, r in pair.items()} for k in (
                      "host_launch_calls", "device_kernels",
                      "device_busy_share_est_unprofiled")},
                  "eager_step_s": e_times, "eager_losses": e_losses})
        legs.append(row)
    del model, opt, cap
    gc.collect()
    torch.cuda.empty_cache()
    return {f"ernie_captured_leg{r['leg']}": {
        f"{e}[segs_drop]": r["launches"][e]
        for e in ("fwd_lse", "bwd_dq", "bwd_dkv")} | {
        k: n for k, n in r["launches"].items()
        if k == "multi_tensor_adam" or k in fused_step}
        for r in legs}


def train_ernie3_base_fp16(torch, card, fa, mta) -> dict:
    """``train_ernie3_base_fp16``: ERNIE-3.0-base (full width and depth,
    random weights from seed 0) fine-tuned under AMP O2 fp16 with fp32
    masters and ``amp.GradScaler(init_loss_scaling=2**15)`` (its default
    schedule), dropout 0.1, ``ernie_recipe``'s multi-tensor AdamW and
    schedule, at bench_ernie.py's B=32, L=128 (PaddleNLP's ``--fp16
    --fp16_opt_level O2`` fine-tune). The same 12 steps on the eager tier,
    then from the same state (put back from a host copy) through
    ``jit.capture_step``: every loss finite, the loss-scale histories and
    the steps applied equal, and the captured run's losses and final state
    (parameters, master, m, v, step, dropout counter, scaler) bit-equal to
    the eager run's; B2-B4 SEGS+DROP launched 12 times and multi-tensor
    AdamW once a step. Returns each tier's launches."""
    import numpy as np
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForSequenceClassification)
    t0 = time.monotonic()
    cfg = ErnieConfig.ernie3_base()
    batch, seq = ERNIE_LEGS[0]
    warmup, timed = 2, 10
    steps = warmup + timed
    model = ErnieForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0), seed=0)
    sched, opt = ernie_recipe(torch, model, decay_steps=2 * steps,
                              warmup_steps=max(1, steps // 5))
    decay0 = sched.lr_sched.state_dict()    # the warm-up's inner schedule
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    require(all(p.dtype == torch.float16 for p in model.parameters()),
            "train_ernie3_base_fp16: parameters not fp16 after decorate")
    path = {e: fa.launches_variant[e, "segs_drop"]
            for e in ("fwd_lse", "bwd_dq", "bwd_dkv")}
    path["multi_tensor_adam"] = mta.launches
    fused_step = ernie_fused_per_step(cfg.num_hidden_layers)
    path.update({k: ctr for k, ctr in step_counters().items()
                 if k in fused_step})
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq),
                                       dtype=np.int32), device="cuda")
    labels = torch.as_tensor(rng.integers(0, 2, (batch,)).astype(np.int64),
                             device="cuda")

    def step(ids, labels):
        with amp.auto_cast(enable=True, level="O2", dtype="float16"):
            loss, _ = model(ids, labels=labels)
        scaler.scale(loss).backward()
        return loss

    def update():
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
    scaler._state(torch.device("cuda"))    # its state tensors, for the copy
    fs = opt._flat
    state = (list(model.parameters())
             + [fs.master, fs.m, fs.v, opt._step_t, model.ernie.rng.counter,
                scaler._scale, scaler._good, scaler._bad])
    saved = [x.detach().cpu() for x in state]
    epoch0 = sched.last_epoch
    runs = {}
    for tier in ("eager", "captured"):
        with torch.no_grad():
            for x, c in zip(state, saved):
                x.copy_(c)
        sched.lr_sched.set_state_dict(decay0)
        sched.step(epoch0)
        call = (captured_step(jit, step, "off", update_fn=update,
                              clear_fn=opt.clear_grad, nan_gate=True)
                if tier == "eager" else
                jit.capture_step(step, update_fn=update,
                                 clear_fn=opt.clear_grad, nan_gate=True))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in path.values():
            c.reset()
        t_applied = int(opt._step_t)
        losses, times, scales = [], [], []
        for _ in range(steps):
            t1 = time.monotonic()
            loss = call(ids, labels)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t1)
            losses.append(float(loss))
            scales.append(scaler.get_loss_scaling())
            sched.step()
        launches = {k: c.count for k, c in path.items()}
        applied = int(opt._step_t) - t_applied
        timed_s = times[warmup:]
        p50 = statistics.median(timed_s)
        tok_s = batch * seq / p50
        fpt = model.flops_per_token(seq)
        runs[tier] = {"losses": losses, "scales": scales, "step_s": times,
                      "step_p50_s": p50,
                      "step_spread_s": max(timed_s) - min(timed_s),
                      "tokens_per_s": tok_s,
                      "mfu_vs_989tflops": fpt * tok_s / 989e12,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "steps_applied": applied,
                      "steps_skipped": steps - applied,
                      "launches": launches,
                      "digests": [digest(torch, x) for x in state],
                      "stats": dict(call.stats)}
        # one more step under the profiler, after the digests: where the
        # device time goes, by family
        runs[tier]["profile"] = {k: v for k, v in profile_step(
            torch, card, lambda: call(ids, labels), p50,
            "train_ernie_fp16_profile", train_family,
            {"batch": batch, "seq": seq, "tier": tier}).items()
            if k in ("device_ms", "device_busy_share_est_unprofiled",
                     "device_kernels", "host_launch_calls")}
        require(all(math.isfinite(x) for x in losses),
                f"train_ernie3_base_fp16 {tier}: losses {losses}")
        require(all(launches[e] == cfg.num_hidden_layers * steps
                    for e in ("fwd_lse", "bwd_dq", "bwd_dkv"))
                and launches["multi_tensor_adam"] == steps
                and all(launches[k] == n * steps
                        for k, n in fused_step.items() if k in launches),
                f"train_ernie3_base_fp16 {tier}: launches {launches}")
        del call
    e, c = runs["eager"], runs["captured"]
    require(not c["stats"]["bypasses"] and c["stats"]["hits"] == steps - 1,
            f"train_ernie3_base_fp16 captured: {c['stats']}")
    require(e["scales"] == c["scales"]
            and e["steps_applied"] == c["steps_applied"] > 0,
            f"train_ernie3_base_fp16: scale histories {e['scales']} "
            f"{c['scales']}, steps applied {e['steps_applied']} "
            f"{c['steps_applied']}")
    require(e["losses"] == c["losses"] and e["digests"] == c["digests"],
            f"train_ernie3_base_fp16: the captured run is not bit-equal to "
            f"the eager run (losses {e['losses']} {c['losses']})")
    emit({"phase": "train_ernie3_base_fp16", "card": card,
          "params": model.num_params(), "batch": batch, "seq": seq,
          "recipe": {"amp": "O2 fp16, fp32 masters",
                     "grad_scaler": "GradScaler(init_loss_scaling=2**15), "
                                    "incr_every_n_steps 2000, ratio 2, 0.5",
                     "optimizer": "AdamW(use_multi_tensor=True, wd 0.01)",
                     "grad_clip": "ClipGradByGlobalNorm(1.0)",
                     "dropout": [cfg.hidden_dropout_prob,
                                 cfg.attention_probs_dropout_prob],
                     "nan_gate": True},
          "warmup_calls": warmup, "timed_calls": timed,
          **{t: {k: v for k, v in r.items() if k != "digests"}
             for t, r in runs.items()},
          "replay_bit_equal_to_eager": True,
          "speedup": e["step_p50_s"] / c["step_p50_s"],
          "seconds": time.monotonic() - t0})
    del model, opt, scaler, state, saved
    gc.collect()
    torch.cuda.empty_cache()
    return {f"ernie_fp16_{t}": r["launches"] for t, r in runs.items()}


# ---------------------------------------------------------------------------
# the fused small-op kernels: K1 norm, K2 RoPE, K3 SwiGLU, K4 cross-entropy
# ---------------------------------------------------------------------------

# kernel vs plain version, elementwise |out - ref| <= rtol |ref| + arel
# rms(ref), keyed by (what, output dtype). The kernels do their plain
# versions' operations in the same order, so a bf16 (fp16) output is at most
# one rounding off where a row sum differs in its last fp32 bit: an ulp is at
# most 2^-7 of |ref|. fp32 outputs differ by the order of the row sums
# (statistics, log-sum-exp) and, for dx, of the row means that cancel (the
# RMS term). "out2": two roundings after the sums (the plain-order norm
# rounds n, then n * w), so two ulps. A value rounded, then added to
# another and rounded again (the norm's dx plus the residual's gradient) is
# held against the size of the value before the add as well: |ref| there
# is |ref| + |ref - addend|. "sum": the weight and bias gradients, each a
# sum over up to 24,576 rows taken in another order.
FUSED_TOL = {("out", "bfloat16"): (2.0 ** -7, 1e-6),
             ("out", "float16"): (2.0 ** -10, 1e-6),
             ("out", "float32"): (1e-5, 1e-5),
             ("out2", "bfloat16"): (2.0 ** -6, 1e-6),
             ("out2", "float16"): (2.0 ** -9, 1e-6),
             ("out2", "float32"): (1e-5, 1e-5),
             ("sum", "bfloat16"): (2.0 ** -7, 1e-4),
             ("sum", "float16"): (2.0 ** -10, 1e-4),
             ("sum", "float32"): (1e-4, 1e-4)}
FUSED_KERNELS = ("fused_norm", "rope", "swiglu", "softmax_cross_entropy")
# the JAX function each replaces: XLA-fused jnp, no pallas_call
FUSED_REPLACES = {"fused_norm": "paddle_tpu/ops/nn_ops.py:192",
                  "rope": "paddle_tpu/models/llama.py:78",
                  "swiglu": "paddle_tpu/models/llama.py:142",
                  "softmax_cross_entropy": "paddle_tpu/ops/loss_ops.py:25"}
FUSED_SOURCES = {k: f"paddle_tpu_torch/csrc/{k}.cu" for k in FUSED_KERNELS}
FUSED_ITERS = 20


def fused_counters() -> dict:
    """The launch counters of K1-K4 by kernel name."""
    from paddle_tpu_torch.ops import fused_norm, rope, softmax_cross_entropy
    from paddle_tpu_torch.ops import swiglu
    return {"fused_norm": fused_norm.launches, "rope": rope.launches,
            "swiglu": swiglu.launches,
            "softmax_cross_entropy": softmax_cross_entropy.launches}


def llama_fused_per_step(layers: int) -> dict:
    """K1-K5 launches of one Llama training step with recompute: the norms
    (two a layer, the second with the residual add, and the final one)
    forward, again in the recomputation and backward; RoPE of q and k and
    SwiGLU once a layer in each of the three; the loss forward and
    backward; the embedding forward and backward."""
    return {"fused_norm": 3 * (2 * layers + 1) - 1, "rope": 3 * layers,
            "swiglu": 3 * layers, "softmax_cross_entropy": 2, "embedding": 2}


def ernie_fused_per_step(layers: int) -> dict:
    """K1, K4, K5, K6 and K7 launches of one ERNIE training step, each
    forward and backward: the embeddings' norm and two a layer; the loss;
    the four embedding tables; linear1's bias and GELU once a layer; the
    hidden dropouts, the embeddings', two a layer (act_dropout is 0) and
    the classifier's."""
    return {"fused_norm": 2 * (2 * layers + 1), "softmax_cross_entropy": 2,
            "embedding": 2 * 4, "bias_act": 2 * layers,
            "dropout": 2 * (2 * layers + 2)}


def fused_close(torch, out, ref, kind: str, mag=None):
    """``(ok, max-abs)`` of out against ref under FUSED_TOL (``mag``: the
    size the relative part scales, default |ref|)."""
    if out.shape != ref.shape:
        return False, float("inf")
    o, r = out.float(), ref.float()
    if o.numel() == 0:
        return True, 0.0
    d = (o - r).abs()
    rtol, arel = FUSED_TOL[kind, dtype_name(out.dtype)]
    lim = rtol * (r.abs() if mag is None else mag) \
        + arel * float(r.square().mean().sqrt())
    # below the normal range a result rounds on a fixed grid (fp16: 2^-24),
    # so no limit is finer than one step of it
    fi = torch.finfo(out.dtype)
    lim = lim.clamp_min(fi.smallest_normal * fi.eps)
    ok = bool(torch.isfinite(o).all()) and bool((d <= lim).all())
    return ok, float(d.max())


def fused_compare(torch, pairs: dict):
    """``(all ok, max-abs, {name: [ok, max-abs]})`` over named
    ``(out, ref, kind[, mag])`` tuples (None outputs skipped)."""
    res = {n: fused_close(torch, *p) for n, p in pairs.items()
           if p[0] is not None}
    return (all(ok for ok, _ in res.values()),
            max((e for _, e in res.values()), default=0.0),
            {n: list(v) for n, v in res.items()})


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kernel_name(key: str) -> str:
    """A profiler kernel name cut to its function and template arguments:
    ``void (anonymous namespace)::norm_fwd_kernel<8>((anonymous
    namespace)::FwdArgs)`` -> ``norm_fwd_kernel<8>``."""
    name = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0][:90]


# a timing graph holds calls for about GRAPH_MS of the card's time (3 to
# GRAPH_CALLS_MAX), replayed GRAPH_REPS times behind a spin of GRAPH_SPIN
# cycles (about a millisecond: every replay is queued before the first
# starts)
GRAPH_MS = 1.0
GRAPH_CALLS_MAX = 64
GRAPH_REPS = 5
GRAPH_SPIN = 2_000_000


def graph_calls(est_ms: float) -> int:
    """Calls a timing graph holds for a call of about ``est_ms``."""
    return max(3, min(GRAPH_CALLS_MAX, math.ceil(GRAPH_MS / max(est_ms,
                                                                1e-3))))


def graph_ms(torch, fn, n: int = 3, reps: int = GRAPH_REPS) -> float:
    """The card's ms a call of ``fn``: ``n`` calls captured into one CUDA
    graph (the launch counters put back), replayed ``reps`` times between
    two CUDA events, all queued behind a spin of the card
    (``torch.cuda._sleep``) so that no host time falls between them; the
    gaps between the graph's kernels count. ``fn`` has run before (no
    warm-up on a side stream: its cached blocks would stay reserved).
    Raises where ``fn`` cannot be captured (a host sync)."""
    from paddle_tpu_torch._native import recorded_launches
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with recorded_launches(), torch.cuda.graph(g):
            for _ in range(n):
                fn()
        g.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(GRAPH_SPIN)
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * n)
    finally:
        del g
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()


def profile_kernels(torch, fn, iters: int):
    """``{kernel: {"ms", "calls"}}`` a call of ``fn``, summed by
    ``torch.profiler`` over ``iters`` calls, or None where a kernel's
    records are not a whole number a call (the profiler dropped some)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and device_us(e) > 0:
            k = by.setdefault(kernel_name(e.key), [0.0, 0])
            k[0] += device_us(e) / 1e3 / iters
            k[1] += e.count
    if not by or any(c % iters for _, c in by.values()):
        return None
    return {n: {"ms": v[0], "calls": v[1] // iters}
            for n, v in sorted(by.items())}


def device_time(torch, fn, iters: int = FUSED_ITERS, est_ms=None,
                split: bool = False) -> dict:
    """The card's own ms a call of ``fn`` (``device_ms``): :func:`graph_ms`
    over :func:`graph_calls` calls (``est_ms``: a time a call to size the
    graph by, else measured), ``source`` "graph"; where ``fn`` cannot be
    captured, None and "none" (``graph_error`` says why). ``split``: also
    ``kernels``, :func:`profile_kernels`'s split by kernel (None where the
    profiler dropped records)."""
    if est_ms is None:
        est_ms = cuda_ms(torch, fn, 3)
    out = {"device_ms": None, "source": "none", "kernels": None}
    try:
        out.update(device_ms=graph_ms(torch, fn, graph_calls(est_ms)),
                   source="graph")
    except RuntimeError as e:   # a call that cannot be captured
        out["graph_error"] = str(e)[:200]
    if split:
        out["kernels"] = profile_kernels(torch, fn, iters)
    return out


def device_ms(torch, fn, iters: int = FUSED_ITERS):
    return device_time(torch, fn, iters)["device_ms"]


def graph_pair(torch, kernel, library) -> dict:
    """``device_ms`` and ``library_device_ms``: :func:`device_ms` of a
    kernel's call and of its library yardstick's."""
    return {"device_ms": device_ms(torch, kernel),
            "library_device_ms": device_ms(torch, library)}


def library_backward_device_ms(torch, fn, inputs, dy):
    """The card's ms of the backward of a library call ``fn(*inputs)`` by
    autograd (the gradients of every input): the forward and backward
    captured together, less the forward alone (autograd runs a backward on
    its forward's stream, so the backward is captured with its forward);
    None where either cannot be captured."""
    plain = [x.detach() for x in inputs]
    # fresh leaves: the callers' own carry autograd nodes from earlier
    # calls on another stream
    leaves = [x.detach().requires_grad_() for x in inputs]

    def fwd_bwd():
        return torch.autograd.grad(fn(*leaves), leaves, dy)
    f, fb = device_ms(torch, lambda: fn(*plain)), device_ms(torch, fwd_bwd)
    return None if f is None or fb is None else fb - f


def sdpa_backward_device_ms(torch, qh, kh, vh, doh, **kw):
    """The card's ms of SDPA's backward (dq, dk and dv together):
    :func:`library_backward_device_ms`."""
    import torch.nn.functional as TF
    return library_backward_device_ms(
        torch, lambda q, k, v: TF.scaled_dot_product_attention(q, k, v, **kw),
        (qh, kh, vh), doh)


def event_and_host(torch, fn, iters: int, warmup: int = 2):
    """``(ms, host_us)``: CUDA-event ms a call over ``iters`` back-to-back
    calls (the wrapper's host time shows in it where that exceeds the
    kernel's), and the host's time a call to enqueue them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host / iters * 1e6


def fused_timing(torch, kernel, plain, library=None, iters=FUSED_ITERS,
                 split=False):
    """A kernel's wrapper beside its plain version and a library call:
    ``ms``, ``plain_ms`` and ``library_ms`` are CUDA-event times of
    back-to-back calls of each; ``device_ms`` and ``library_device_ms``
    the card's own time a call (:func:`device_time`; ``split``: with
    ``device_kernels`` by kernel); ``host_us`` the wrapper's host time a
    call."""
    ms, host = event_and_host(torch, kernel, iters)
    dev = device_time(torch, kernel, iters, ms, split)
    lib_ms = None if library is None else cuda_ms(torch, library, iters)
    return {"ms": ms, "host_us": host, "device_ms": dev["device_ms"],
            "device_source": dev["source"], "device_kernels": dev["kernels"],
            "plain_ms": cuda_ms(torch, plain, max(2, iters // 4)),
            "library_ms": lib_ms,
            "library_device_ms": None if library is None else device_time(
                torch, library, iters, lib_ms)["device_ms"]}


def norm_timed_cases(torch, fn) -> tuple:
    """K1's timed cases, at the shapes its paths give it: (name, rows,
    cols, x, residual, weight, bias dtypes, spec, backward timed). The
    Llama training step's RMSNorm with the residual add (O2), ERNIE's
    post-LN add (O2, fp32 residual), the FMT stack's LayerNorm (bf16,
    ``layer_norm``'s casts) in a 512-token prefill and a 16-row decode
    step, and a Llama-2-7B decode step's 16 rows."""
    f32, bf = torch.float32, torch.bfloat16
    S = fn.NormSpec
    return (
        ("llama_o2_residual", 24576, 2560, bf, bf, bf, None,
         S("rms", 1e-5, f32, f32, bf, f32), True),
        ("ernie_o2_residual", 4096, 768, bf, f32, bf, bf,
         S("ln", 1e-12, f32, f32, bf, f32, f32), True),
        ("fmt_prefill_ln", 512, 2560, bf, None, bf, bf,
         S("ln", 1e-5, bf, bf, None, bf, bf), False),
        ("fmt_decode_ln", 16, 2560, bf, None, bf, bf,
         S("ln", 1e-5, bf, bf, None, bf, bf), False),
        ("serve_decode_bf16_residual", 16, 4096, bf, bf, bf, None,
         S("rms", 1e-5, bf, bf, bf, bf), False))


def fused_norm_timing(torch, fn, gen) -> dict:
    """K1's forward and backward (with its fold) at each of
    :func:`norm_timed_cases`: the card's time, by kernel too, CUDA-event
    and host times of the wrapper, the plain version's and the library
    call's (``F.rms_norm`` / ``F.layer_norm`` of the add's result; its
    autograd backward: the forward and backward in one call, less the
    forward, since a capture holds only the backward of a forward it
    recorded), and the byte bounds. Needs only ``_launch_fwd`` /
    ``_launch_bwd``, so it times any tree's K1."""
    TF = torch.nn.functional

    def rn(shape, dt, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dt)
    out = {}
    for name, rows, cols, xd, rd, wd, bd, spec, bwd in norm_timed_cases(
            torch, fn):
        x, res = rn((rows, cols), xd), None if rd is None else \
            rn((rows, cols), rd)
        w = rn((cols,), wd, 0.1, 1.0)
        b = None if bd is None else rn((cols,), bd, 0.1)
        got = fn._launch_fwd(x, w, b, res, None, spec)
        h = x if got[1] is None else got[1]
        lib_x = h.detach().to(spec.norm if spec.add is None else spec.add)

        def library(lx=lib_x, w=w, b=b, spec=spec):
            if spec.kind == "rms":
                return TF.rms_norm(lx, (lx.shape[-1],), w.to(lx.dtype),
                                   spec.eps)
            return TF.layer_norm(lx, (lx.shape[-1],), w.to(lx.dtype),
                                 None if b is None else b.to(lx.dtype),
                                 spec.eps)
        row = {"rows": rows, "cols": cols, "kind": spec.kind,
               "dtypes": [dtype_name(d) for d in (xd, rd, spec.out)],
               "fwd": fused_timing(
                   torch, lambda: fn._launch_fwd(x, w, b, res, None, spec),
                   lambda: fn.fused_norm_reference(x, w, b, res, spec=spec),
                   library, split=True),
               "fwd_bound_ms": bound(0, nbytes(x, res, w, b, *got),
                                     "float32")[0]}
        if bwd:
            dy = rn((rows, cols), spec.out)
            dres = None if spec.add is None else rn((rows, cols), spec.add)
            dx_dtype = xd if spec.add is None else spec.add

            def run_b(dy=dy, dres=dres, h=h, got=got, w=w, spec=spec,
                      dx_dtype=dx_dtype, bd=bd):
                return fn._launch_bwd(dy, dres, h, got[2], got[3], w, spec,
                                      dx_dtype=dx_dtype, want_w=True,
                                      bias_dtype=bd, pre_bias_dtype=None)
            g = run_b()
            lx = lib_x.clone().requires_grad_()
            lw = w.to(lx.dtype).requires_grad_()
            lb = None if b is None else b.to(lx.dtype).requires_grad_()
            ldy = dy.to(lx.dtype)

            def library_fb(lx=lx, lw=lw, lb=lb, ldy=ldy, spec=spec):
                lo = TF.rms_norm(lx, (lx.shape[-1],), lw, spec.eps) \
                    if spec.kind == "rms" else \
                    TF.layer_norm(lx, (lx.shape[-1],), lw, lb, spec.eps)
                return torch.autograd.grad(
                    lo, [t for t in (lx, lw, lb) if t is not None], ldy)
            row["bwd"] = fused_timing(
                torch, run_b,
                lambda: fn.fused_norm_bwd_reference(
                    dy, dres, h, w, spec=spec, dx_dtype=dx_dtype,
                    bias_dtype=bd),
                library_fb, split=True)
            for k in ("library_ms", "library_device_ms"):
                fb, f = row["bwd"][k], row["fwd"][k]
                row["bwd"][k] = None if fb is None or f is None else fb - f
            row["bwd_bound_ms"] = bound(0, nbytes(dy, dres, h, w, got[2],
                                                  got[3], *g), "float32")[0]
        out[name] = row
    return out


# graph device ms readings a timed case of K2 and K3 takes (their mean is
# its device_ms; the A/B tool compares the readings' spread)
TIMED_READINGS = 3


def graph_readings(torch, fn, reads: int = TIMED_READINGS) -> dict:
    """``device_ms`` (the mean) and ``readings``: :func:`graph_ms` of
    ``fn`` read ``reads`` times over :func:`graph_calls` calls."""
    fn()
    n = graph_calls(cuda_ms(torch, fn, 3))
    rs = [graph_ms(torch, fn, n) for _ in range(reads)]
    return {"device_ms": sum(rs) / len(rs), "readings": rs}


def rope_timed_cases(torch) -> tuple:
    """K2's timed cases at the shapes its paths give it: (name, q/k shapes,
    offset, positions dtype, dtype, table dtype, backward timed). The
    Llama training step's q and k under AMP O2 (fp32 tables cast to bf16),
    forward and backward; a Llama-2-7B decode step (positions on the
    device) and tail prefill (offset 24), bf16 with fp32 tables uncast."""
    bf = torch.bfloat16
    return (("llama_o2", [(6, 4096, 20, 128)] * 2, 0, None, bf, bf, True),
            ("serve_decode", [(16, 1, 32, 128)] * 2, 0, torch.int32, None,
             None, False),
            ("serve_prefill_tail", [(1, 1000, 32, 128)] * 2, 24, None, None,
             None, False))


def rope_timing(torch, rp, gen) -> dict:
    """K2's forward (and backward) at each of :func:`rope_timed_cases`:
    graph device ms (:func:`graph_readings`) beside the byte bound (each
    element read and written once, the table rows the positions use
    read once)."""
    bf = torch.bfloat16
    out = {}
    for name, shapes, off, pdt, dt, tdt, bwd in rope_timed_cases(torch):
        ang = torch.rand((4096, 64), generator=gen, device="cuda") * 6.3
        cos, sin = ang.cos(), ang.sin()
        xs = [torch.randn(sh, generator=gen, device="cuda").to(bf)
              for sh in shapes]
        b, n = shapes[0][:2]
        pos = None if pdt is None else torch.randint(
            0, 4096, (b, n), generator=gen, device="cuda", dtype=pdt)
        kw = dict(offset=off, positions=pos, neox=True, dtype=dt,
                  table_dtype=tdt)
        out_dt = dt or bf
        used = n if pos is None else int(torch.unique(pos).numel())
        tbytes = 2 * used * cos.shape[1] * cos.element_size()
        row = {"shapes": shapes,
               "fwd": graph_readings(torch, lambda: rp._launch(
                   xs, cos, sin, backward=False,
                   out_dtypes=[out_dt] * len(xs), **kw)),
               "bound_ms": bound(0, 2 * nbytes(*xs) + tbytes,
                                 "float32")[0]}
        if bwd:
            gs = [torch.randn(sh, generator=gen, device="cuda").to(out_dt)
                  for sh in shapes]
            row["bwd"] = graph_readings(torch, lambda: rp._launch(
                gs, cos, sin, backward=True, out_dtypes=[bf] * len(gs),
                **dict(kw, dtype=out_dt)))
        out[name] = row
        del xs, cos, sin
    return out


def swiglu_timing(torch, sw, gen) -> dict:
    """K3's forward (and backward) at the shapes its paths give it, bf16:
    the Llama training step's g and u (24576, 6912), forward and backward,
    and a Llama-2-7B decode step's (16, 11008): graph device ms
    (:func:`graph_readings`) beside the byte bound."""
    bf = torch.bfloat16
    out = {}
    for name, rows, d, bwd in (("llama", 24576, 6912, True),
                               ("serve", 16, 11008, False)):
        g, u, dy = (torch.randn((rows, d), generator=gen, device="cuda")
                    .to(bf) for _ in range(3))
        row = {"rows": rows, "d": d,
               "fwd": graph_readings(torch, lambda: sw._launch_fwd(
                   g, u, False)),
               "bound_ms": bound(0, 3 * nbytes(g), "float32")[0]}
        if bwd:
            row["bwd"] = graph_readings(torch, lambda: sw._launch_bwd(
                g, u, dy, False))
            row["bwd_bound_ms"] = bound(0, 5 * nbytes(g), "float32")[0]
        out[name] = row
        del g, u, dy
    return out


def softmax_mask_timing(torch, sm, gen) -> dict:
    """K8's forward and backward at the shapes its paths give it, bf16:
    ERNIE's attention scores (32, 12, 128, 128) with a (32, 1, 128, 128)
    mask (``softmax_mask_fuse``) and the upper triangle at (8, 12, 128,
    128): graph device ms (:func:`graph_readings`) beside the byte bound
    and the library's (``torch.softmax`` of the masked scores; its
    backward by autograd, :func:`library_backward_device_ms`)."""
    bf = torch.bfloat16
    out = {}
    for name, shape, mshape in (("ernie", (32, 12, 128, 128),
                                 (32, 1, 128, 128)),
                                ("upper_triangle", (8, 12, 128, 128), None)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(bf)
        dy = torch.randn(shape, generator=gen, device="cuda").to(bf)
        causal = mshape is None
        if causal:
            q, k = shape[-2:]
            keep = torch.ones(q, k, dtype=torch.bool,
                              device="cuda").tril(k - q)
            lib_mask = torch.zeros((q, k), device="cuda").masked_fill(
                ~keep, -1e30).to(bf)
            mask = None
        else:
            mask = torch.randn(mshape, generator=gen, device="cuda").to(bf)
            lib_mask = mask
        y = sm._launch_fwd(x, mask, causal)

        def library(x, m=lib_mask):
            return torch.softmax(x + m, -1)
        out[name] = {
            "shape": list(shape),
            "fwd": graph_readings(torch, lambda: sm._launch_fwd(x, mask,
                                                                causal)),
            "bwd": graph_readings(torch, lambda: sm._launch_bwd(y, dy)),
            "bound_ms": bound(0, nbytes(x, mask, y), "float32")[0],
            "bwd_bound_ms": bound(0, 3 * nbytes(y), "float32")[0],
            "library_device_ms": device_ms(torch, lambda: library(x)),
            "bwd_library_device_ms": library_backward_device_ms(
                torch, library, (x,), dy)}
        del x, dy, y
    return out


def bias_act_timed_cases(torch) -> tuple:
    """K6's timed cases at the shapes its paths give it: (name, rows, n,
    y dtype, bias rows (None: no bias), period, act, backward timed).
    ERNIE's linear1 epilogue under O2 and in fp32, FMT serving's prefill
    and decode-step epilogues (GELU tanh) and the expert-choice MoE's
    per-expert bias."""
    bf, f32 = torch.bfloat16, torch.float32
    return (("ernie_o2", 4096, 3072, bf, 1, None, "gelu", True),
            ("ernie_fp32", 4096, 3072, f32, 1, None, "gelu", True),
            ("fmt_prefill", 512, 6912, bf, 1, None, "gelu_tanh", False),
            ("fmt_decode", 16, 6912, bf, 1, None, "gelu_tanh", False),
            ("moe_period", 8192, 14336, bf, 16, 512, "gelu_tanh", True))


def bias_act_timing(torch, ba, gen) -> dict:
    """K6's forward (and backward with its fold) at each of
    :func:`bias_act_timed_cases`: graph device ms (:func:`graph_readings`)
    beside the byte bound and the library's (``F.gelu(y + b)``; its
    backward by autograd, :func:`library_backward_device_ms`)."""
    TF = torch.nn.functional
    out = {}
    for name, rows, n, dt, brows, period, act, bwd in bias_act_timed_cases(
            torch):
        y = torch.randn((rows, n), generator=gen, device="cuda").to(dt)
        b = (torch.randn((brows, 1, n) if period else (n,), generator=gen,
                         device="cuda") * 0.5).to(dt)
        spec = ba.ActSpec(act, dt, dt)
        o = ba._launch_fwd(y, b, spec, period)
        approx = "tanh" if act == "gelu_tanh" else "none"

        def library(y, b, period=period, rows=rows, n=n, approx=approx):
            yy = y.view(-1, period, n) if period else y
            return TF.gelu(yy + b, approximate=approx)
        row = {"rows": rows, "n": n, "dtype": dtype_name(dt), "act": act,
               "period": period,
               "fwd": graph_readings(torch, lambda: ba._launch_fwd(
                   y, b, spec, period)),
               "bound_ms": bound(0, nbytes(y, b, o), "float32")[0],
               "library_device_ms": device_ms(torch, lambda: library(y, b))}
        if bwd:
            dy = torch.randn((rows, n), generator=gen, device="cuda").to(dt)
            g = ba._launch_bwd(y, b, dy, spec, period)
            row["bwd"] = graph_readings(torch, lambda: ba._launch_bwd(
                y, b, dy, spec, period))
            row["bwd_bound_ms"] = bound(0, nbytes(y, b, dy, *g),
                                        "float32")[0]
            row["bwd_library_device_ms"] = library_backward_device_ms(
                torch, library, (y, b), dy.view(o.shape if not period else
                                                (-1, period, n)))
            del dy, g
        out[name] = row
        del y, b, o
    return out


def fused_planted_rejected(torch, run, refs: dict, what: str) -> dict:
    """Run ``run`` (a planted copy's launch, returning outputs by name) and
    require that FUSED_TOL rejects it against ``refs``."""
    outs = run()
    ok, err, errs = fused_compare(torch, {n: (outs[n], *refs[n])
                                          for n in refs})
    require(not ok, f"{what}: the planted fault passed the check {errs}")
    return {"max_abs_err": err}


def fused_repeat_equal(torch, run, what: str) -> None:
    """Three launches on the same inputs give the same bits."""
    first = run()
    for _ in range(2):
        again = run()
        require(all(torch.equal(first[k], again[k]) for k in first
                    if first[k] is not None),
                f"{what}: three launches on the same inputs differ")


def check_fused_norm(torch, fn, planted_lib, gen) -> dict:
    f32, bf, h16 = torch.float32, torch.bfloat16, torch.float16
    S = fn.NormSpec

    def rn(shape, dt, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dt)
    fmt_ln = S("ln", 1e-5, bf, bf, None, bf, bf)
    # (name, rows, cols, x, residual, pre-bias, weight, bias dtypes, spec)
    cases = [
        ("llama_o2_residual", 24576, 2560, bf, bf, None, bf, None,
         S("rms", 1e-5, f32, f32, bf, f32)),
        ("llama_o2", 24576, 2560, bf, None, None, bf, None,
         S("rms", 1e-5, f32, f32, None, f32)),
        ("ernie_o2_residual", 4096, 768, bf, f32, None, bf, bf,
         S("ln", 1e-12, f32, f32, bf, f32, f32)),
        ("serve_decode_bf16_residual", 16, 4096, bf, bf, None, bf, None,
         S("rms", 1e-5, bf, bf, bf, bf)),
        ("serve_prefill_bf16", 1000, 4096, bf, None, None, bf, None,
         S("rms", 1e-5, bf, bf, None, bf)),
        ("llama_fp32_residual", 24576, 2560, f32, f32, None, f32, None,
         S("rms", 1e-5, f32, f32, f32, f32)),
        ("ernie_fp32_residual", 4096, 768, f32, f32, None, f32, f32,
         S("ln", 1e-12, f32, f32, f32, f32, f32)),
        ("incubate_fused_bf16", 4096, 4096, bf, bf, bf, bf, bf,
         S("rms", 1e-6, bf, bf, bf, bf, bf, True)),
        ("incubate_fused_ln_fp32", 1000, 768, f32, None, None, None, f32,
         S("ln", 1e-5, f32, f32, None, None, f32, True)),
        # row groups of one warp (512 columns) and of four (2048)
        ("narrow_o2_residual", 16384, 512, bf, bf, None, bf, None,
         S("rms", 1e-5, f32, f32, bf, f32)),
        ("wide_ln_bf16_residual", 2048, 2048, bf, bf, None, bf, bf,
         S("ln", 1e-5, bf, bf, bf, bf, bf)),
        # the FMT stack's LayerNorm: a 512-token prefill, a decode step
        ("fmt_prefill_ln", 512, 2560, bf, None, None, bf, bf, fmt_ln),
        ("fmt_decode_ln", 16, 2560, bf, None, None, bf, bf, fmt_ln),
        # rows of 770: no 8-element vectors, the block-per-row kernels
        ("vec1_ln_prebias", 1000, 770, bf, bf, bf, bf, bf,
         S("ln", 1e-5, f32, f32, bf, f32, f32)),
        # MAX_COLS in fp32: too wide for the ring, the block-per-row kernels
        ("max_cols_fp32", 512, fn.MAX_COLS, f32, f32, None, f32, f32,
         S("ln", 1e-5, f32, f32, f32, f32, f32)),
        # fp16: ERNIE's O2 LayerNorm with the residual add as its fp16 leg
        # calls it, a Llama-2-7B fp16 decode step and prefill
        ("ernie_fp16_o2_residual", 4096, 768, h16, h16, None, h16, h16,
         S("ln", 1e-12, f32, f32, h16, f32, f32)),
        ("serve_decode_fp16_residual", 16, 4096, h16, h16, None, h16, None,
         S("rms", 1e-5, h16, h16, h16, h16)),
        ("serve_prefill_fp16", 1000, 4096, h16, None, None, h16, None,
         S("rms", 1e-5, h16, h16, None, h16)),
    ]
    results, err, timing = [], 0.0, {}
    for name, rows, cols, xd, rd, pbd, wd, bd, spec in cases:
        x = rn((rows, cols), xd)
        res = None if rd is None else rn((rows, cols), rd)
        pb = None if pbd is None else rn((cols,), pbd, 0.1)
        w = None if wd is None else rn((cols,), wd, 0.1, 1.0)
        b = None if bd is None else rn((cols,), bd, 0.1)
        dy = rn((rows, cols), spec.out)
        dres = None if spec.add is None else rn((rows, cols), spec.add)
        dx_dtype = xd if spec.add is None else spec.add

        def fwd(fns=None):
            out, h, mean, rstd = fn._launch_fwd(x, w, b, res, pb, spec,
                                                fns=fns)
            return {"out": out, "h": h, "mean": mean, "rstd": rstd}

        def bwd(fns=None, h=None, stats=None):
            dx, dw, db, dpb = fn._launch_bwd(
                dy, dres, h, *stats, w, spec, dx_dtype=dx_dtype,
                want_w=w is not None, bias_dtype=bd, pre_bias_dtype=pbd,
                fns=fns)
            return {"dx": dx, "dw": dw, "db": db, "dpb": dpb}

        ref_out, ref_h = fn.fused_norm_reference(x, w, b, res, pb, spec=spec)
        got = fwd()
        h = x if got["h"] is None else got["h"]
        stats = (got["mean"], got["rstd"])
        two = not spec.fused and w is not None and spec.out != f32
        refs_f = {"out": (ref_out, "out2" if two else "out")}
        if ref_h is not None:
            refs_f["h"] = (ref_h, "out")
        ok_f, err_f, errs_f = fused_compare(
            torch, {n: (got[n], *refs_f[n]) for n in refs_f})
        g = bwd(h=h, stats=stats)
        r_dx, r_dw, r_db, r_dpb = fn.fused_norm_bwd_reference(
            dy, dres, h, w, spec=spec, dx_dtype=dx_dtype, bias_dtype=bd,
            pre_bias_dtype=pbd)
        mag = None if dres is None else \
            r_dx.float().abs() + (r_dx.float() - dres.float()).abs()
        refs_b = {"dx": (r_dx, "out", mag), "dw": (r_dw, "sum"),
                  "db": (r_db, "sum"), "dpb": (r_dpb, "sum")}
        ok_b, err_b, errs_b = fused_compare(
            torch, {n: (g[n], *refs_b[n]) for n in refs_b
                    if refs_b[n][0] is not None})
        require(ok_f and ok_b, f"fused_norm {name}: beyond FUSED_TOL: "
                               f"{errs_f} {errs_b}")
        err = max(err, err_f, err_b)
        results.append({"case": name, "rows": rows, "cols": cols,
                        "fwd": errs_f, "bwd": errs_b})
        if name in ("llama_o2_residual", "ernie_o2_residual",
                    "fmt_prefill_ln", "narrow_o2_residual"):
            # the first 16 rows alone (the block-per-row kernels) and the
            # first 200 (the row groups): each row's bits as in the full call
            for n in (16, 200):
                def cut(t, n=n):
                    return None if t is None else t[:n]
                sf = fn._launch_fwd(x[:n], w, b, cut(res), pb, spec)
                sb = fn._launch_bwd(
                    dy[:n], cut(dres), h[:n], cut(got["mean"]),
                    got["rstd"][:n], w, spec, dx_dtype=dx_dtype,
                    want_w=False, bias_dtype=None, pre_bias_dtype=None)
                full = (got["out"], got["h"], got["mean"], got["rstd"],
                        g["dx"])
                require(all(a is None or torch.equal(a, cut(f)) for a, f in
                            zip((*sf, sb[0]), full)),
                        f"fused_norm {name}: the first {n} rows alone differ "
                        f"from the full call's")
        if name not in ("llama_o2_residual", "serve_prefill_fp16"):
            continue
        # forward and backward, fold included, three times: equal bits
        fused_repeat_equal(torch, lambda: {**fwd(), **bwd(h=h, stats=stats)},
                           f"fused_norm {name}")
        planted = fused_planted_rejected(
            torch, lambda: fwd(fn.bind(planted_lib)), refs_f,
            f"fused_norm {name}")
        # the planted fold drops the second CTA's partial: dw must fail
        planted_fold = fused_planted_rejected(
            torch, lambda: bwd(fn.bind(planted_lib), h=h, stats=stats),
            {"dw": refs_b["dw"]}, f"fused_norm {name} fold")
        pre = "fp16_" if xd == h16 else ""
        timing[pre + "planted_max_abs_err"] = planted["max_abs_err"]
        timing[pre + "planted_fold_max_abs_err"] = planted_fold["max_abs_err"]
    timed = fused_norm_timing(torch, fn, gen)
    llama = timed["llama_o2_residual"]
    timing.update(llama["fwd"])
    timing.update({"bwd_" + k: v for k, v in llama["bwd"].items()})
    timing["bound_ms"], timing["bound_by"] = llama["fwd_bound_ms"], "bytes"
    timing["bwd_bound_ms"] = llama["bwd_bound_ms"]
    timing["case"] = ("N=24576 C=2560 RMS, bf16 x and residual, fp32 out "
                      "(O2); library: rms_norm of the bf16 sum")
    return {"cases": results, "max_abs_err": err, "timed_cases": timed,
            **timing}


def check_rope(torch, rp, planted_lib, gen) -> dict:
    f32, bf, h16 = torch.float32, torch.bfloat16, torch.float16

    def table(n, width, dt=f32):
        ang = torch.rand((n, width), generator=gen, device="cuda") * 6.3
        return ang.cos().to(dt), ang.sin().to(dt)
    cs_llama = table(4096, 64)
    cs_7b = table(4096, 64)
    # (name, shapes, dtype, tables, offset, positions dtype, neox, dtype,
    #  table_dtype)
    cases = [
        ("llama_o2", [(6, 4096, 20, 128)] * 2, bf, cs_llama, 0, None, True,
         bf, bf),
        ("serve_decode", [(16, 1, 32, 128)] * 2, bf, cs_7b, 0, torch.int32,
         True, None, None),
        ("serve_prefill_tail", [(1, 1000, 32, 128)] * 2, bf, cs_7b, 24,
         None, True, None, None),
        ("fp32_gqa", [(2, 512, 8, 128), (2, 512, 2, 128)], f32, cs_llama, 3,
         None, True, None, None),
        ("incubate_interleaved_qkv", [(2, 256, 4, 64)] * 3, bf,
         table(256, 64), 0, torch.int64, False, bf, bf),
        ("incubate_neox_full_table_fp32", [(2, 256, 4, 64)] * 2, f32,
         table(256, 64), 0, None, True, None, None),
        # fp16: the Llama-2-7B fp16 leg's decode step and prefill as its
        # engine calls them
        ("serve_decode_fp16", [(16, 1, 32, 128)] * 2, h16, cs_7b, 0,
         torch.int32, True, None, None),
        ("serve_prefill_fp16", [(1, 1000, 32, 128)] * 2, h16, cs_7b, 0, None,
         True, h16, f32),
    ]
    results, err, timing = [], 0.0, None
    for name, shapes, xd, (cos, sin), off, pdt, neox, dt, tdt in cases:
        xs = [torch.randn(s, generator=gen, device="cuda").to(xd)
              for s in shapes]
        b, n = shapes[0][:2]
        pos = None if pdt is None else torch.randint(
            0, cos.shape[0], (b, n), generator=gen, device="cuda", dtype=pdt)
        kw = dict(offset=off, positions=pos, neox=neox, dtype=dt,
                  table_dtype=tdt)
        out_dt = dt or xd
        gs = [torch.randn(s, generator=gen, device="cuda").to(out_dt)
              for s in shapes]

        def run(fns=None, back=False, xs=xs, gs=gs, kw=kw, out_dt=out_dt):
            src = gs if back else xs
            outs = rp._launch(src, cos, sin, backward=back,
                              out_dtypes=[xd if back else out_dt] * len(src),
                              fns=fns, **dict(kw, dtype=out_dt if back
                                              else kw["dtype"]))
            return {f"{'d' if back else ''}x{i}": o
                    for i, o in enumerate(outs)}
        ref = rp.rope_reference(xs, cos, sin, **kw)
        ref_b = rp.rope_reference(gs, cos, sin, backward=True,
                                  **dict(kw, dtype=out_dt))
        got, got_b = run(), run(back=True)
        refs = {f"x{i}": (r, "out") for i, r in enumerate(ref)}
        refs_b = {f"dx{i}": (r.to(xd), "out") for i, r in enumerate(ref_b)}
        ok_f, err_f, errs_f = fused_compare(
            torch, {k: (got[k], *refs[k]) for k in refs})
        ok_b, err_b, errs_b = fused_compare(
            torch, {k: (got_b[k], *refs_b[k]) for k in refs_b})
        bits = {k: int((got[k] != refs[k][0]).sum()) for k in refs}
        require(ok_f and ok_b, f"rope {name}: beyond FUSED_TOL: {errs_f} "
                               f"{errs_b}")
        err = max(err, err_f, err_b)
        results.append({"case": name, "shapes": shapes, "fwd": errs_f,
                        "bwd": errs_b, "elements_not_bit_equal": bits})
        if name == "serve_prefill_fp16":
            fused_repeat_equal(torch, lambda: {**run(), **run(back=True)},
                               f"rope {name}")
            results[-1]["planted_max_abs_err"] = fused_planted_rejected(
                torch, lambda: run(rp.bind(planted_lib)), refs,
                f"rope {name}")["max_abs_err"]
        if name != "llama_o2":
            continue
        fused_repeat_equal(torch, lambda: {**run(), **run(back=True)},
                           f"rope {name}")
        planted = fused_planted_rejected(
            torch, lambda: run(rp.bind(planted_lib)), refs, f"rope {name}")
        timing = fused_timing(torch, run,
                              lambda: rp.rope_reference(xs, cos, sin, **kw))
        bwd_t = fused_timing(
            torch, lambda: run(back=True),
            lambda: rp.rope_reference(gs, cos, sin, backward=True,
                                      **dict(kw, dtype=out_dt)))
        timing.update({"bwd_" + k: v for k, v in bwd_t.items()
                       if k != "library_ms"})
        fb = nbytes(*xs, cos, sin) + nbytes(*got.values())
        timing["bound_ms"], timing["bound_by"] = bound(0, fb, "float32")
        timing["bwd_bound_ms"] = timing["bound_ms"]
        timing["planted_max_abs_err"] = planted["max_abs_err"]
        timing["case"] = ("q and k (6, 4096, 20, 128) bf16, fp32 tables "
                          "cast to bf16 (O2), one launch")
    timing["timed_cases"] = rope_timing(torch, rp, gen)
    return {"cases": results, "max_abs_err": err, **timing}


def check_swiglu(torch, sw, planted_lib, gen) -> dict:
    f32, bf, h16 = torch.float32, torch.bfloat16, torch.float16
    cases = [("llama", (24576, 6912), bf, False), ("serve", (16, 11008), bf,
                                                     False),
             ("fp32", (4096, 1024), f32, False),
             ("packed_bf16", (4096, 1024), bf, True),
             # fp16: the Llama-2-7B fp16 leg's decode step and prefill
             ("serve_fp16", (16, 11008), h16, False),
             ("serve_prefill_fp16", (1000, 11008), h16, False)]
    results, err, timing = [], 0.0, None
    for name, (rows, d), dt, packed in cases:
        if packed:
            x = (torch.randn((rows, 2 * d), generator=gen, device="cuda")
                 * 2).to(dt)
            g, u = x, None
        else:
            g, u = ((torch.randn((rows, d), generator=gen, device="cuda")
                     * 2).to(dt) for _ in range(2))
        dy = torch.randn((rows, d), generator=gen, device="cuda").to(dt)

        def run(fns=None, g=g, u=u, packed=packed):
            return {"y": sw._launch_fwd(g, u, packed, fns=fns)}

        def run_b(g=g, u=u, dy=dy, packed=packed):
            outs = sw._launch_bwd(g, u, dy, packed)
            return dict(zip(("dx",) if packed else ("dg", "du"), outs))

        def plain_b(g=g, u=u, dy=dy, packed=packed):
            leaves = [t.detach().requires_grad_() for t in
                      ((g,) if packed else (g, u))]
            y = sw.swiglu_reference(*leaves) if not packed else \
                sw.swiglu_reference(leaves[0])
            return dict(zip(("dx",) if packed else ("dg", "du"),
                            torch.autograd.grad(y, leaves, dy)))
        ref = {"y": (sw.swiglu_reference(g, u), "out")}
        got = run()
        ok_f, err_f, errs_f = fused_compare(
            torch, {k: (got[k], *ref[k]) for k in ref})
        gb, rb = run_b(), plain_b()
        ok_b, err_b, errs_b = fused_compare(
            torch, {k: (gb[k], rb[k], "out") for k in gb})
        bits = {"y": int((got["y"] != ref["y"][0]).sum()),
                **{k: int((gb[k] != rb[k]).sum()) for k in gb}}
        require(ok_f and ok_b, f"swiglu {name}: beyond FUSED_TOL: {errs_f} "
                               f"{errs_b}")
        err = max(err, err_f, err_b)
        results.append({"case": name, "rows": rows, "d": d, "fwd": errs_f,
                        "bwd": errs_b, "elements_not_bit_equal": bits})
        if name == "serve_prefill_fp16":
            fused_repeat_equal(torch, lambda: {**run(), **run_b()},
                               f"swiglu {name}")
            results[-1]["planted_max_abs_err"] = fused_planted_rejected(
                torch, lambda: run(sw.bind(planted_lib)), ref,
                f"swiglu {name}")["max_abs_err"]
        if name != "llama":
            continue
        fused_repeat_equal(torch, lambda: {**run(), **run_b()},
                           f"swiglu {name}")
        planted = fused_planted_rejected(
            torch, lambda: run(sw.bind(planted_lib)), ref, f"swiglu {name}")
        timing = fused_timing(torch, run, lambda: sw.swiglu_reference(g, u))
        both = cuda_ms(torch, plain_b, max(2, FUSED_ITERS // 4))
        timing.update({"bwd_ms": cuda_ms(torch, run_b, FUSED_ITERS),
                       "bwd_device_ms": device_ms(torch, run_b),
                       "bwd_plain_ms": both - timing["plain_ms"]})
        fb = nbytes(g, u, got["y"])
        timing["bound_ms"], timing["bound_by"] = bound(0, fb, "float32")
        timing["bwd_bound_ms"], _ = bound(0, nbytes(g, u, dy, *gb.values()),
                                          "float32")
        timing["planted_max_abs_err"] = planted["max_abs_err"]
        timing["case"] = "g, u (24576, 6912) bf16"
    timing["timed_cases"] = swiglu_timing(torch, sw, gen)
    return {"cases": results, "max_abs_err": err, **timing}


def check_cross_entropy(torch, ce, planted_lib, gen) -> dict:
    f32, bf, h16 = torch.float32, torch.bfloat16, torch.float16
    i64, i32 = torch.int64, torch.int32
    # (name, logits shape, dtype, labels dtype, ignore_index, shift,
    #  labels: "random", "some_ignored", "all_ignored", "n1"; view)
    cases = [("llama_shift", (6, 4096, 32000), bf, i64, -100, True,
              "random", None),
             ("ernie", (32, 2), bf, i64, -100, False, "random", None),
             ("ignore_n1_fp32", (512, 1000), f32, i32, 0, False, "n1", None),
             ("all_ignored", (64, 128), bf, i64, 5, False, "all_ignored",
              None),
             ("strided_view_fp32", (4, 64, 1024), f32, i64, 3, False,
              "some_ignored", "every_other_row"),
             # fp16: ERNIE's classifier logits as its fp16 leg gives them,
             # and a vocabulary wide enough for the planted fault
             ("ernie_fp16", (32, 2), h16, i64, -100, False, "random", None),
             ("vocab_fp16_shift", (2, 1024, 32000), h16, i64, -100, True,
              "random", None)]
    results, err, timing = [], 0.0, None
    for name, shape, dt, ldt, ign, shift, lab_kind, view in cases:
        base = (torch.randn(shape, generator=gen, device="cuda") * 2).to(dt)
        logits = base[:, 1::2, :] if view == "every_other_row" else base
        v = shape[-1]
        lab_shape = logits.shape[:-1]
        labels = torch.randint(0, v, lab_shape, generator=gen,
                               device="cuda").to(ldt)
        if lab_kind == "all_ignored":
            labels.fill_(ign)
        elif lab_kind in ("some_ignored", "n1"):
            labels[..., ::4] = ign
        if lab_kind == "n1":
            labels = labels[..., None]
        xc = f32
        g = torch.tensor(0.75, device="cuda")
        if shift:
            x3 = logits
            lab2 = labels[:, 1:]
            lu = x3.shape[1] - 1
        else:
            x3 = ce._as_3d(logits)
            lab2 = ce._labels_2d(ce._flat_labels(labels, logits.dim()),
                                 x3.shape[:2])
            lu = x3.shape[1]

        def run(fns=None, x3=x3, lab2=lab2, lu=lu, ign=ign):
            out, m, logs, valid = ce._launch_fwd(x3, lab2, lu, ign, xc,
                                                 fns=fns)
            return {"loss": out[0], "count": out[1], "m": m, "logs": logs,
                    "state": (m, logs, valid, out)}

        def run_b(state, x3=x3, lab2=lab2, lu=lu, ign=ign):
            return {"dx": ce._launch_bwd(x3, lab2, lu, ign, xc, *state, g)}

        def plain(logits=logits, labels=labels, ign=ign, shift=shift):
            return ce.softmax_cross_entropy_reference(
                logits, labels, ign, dtype=xc, shift=shift)

        def plain_b(logits=logits, labels=labels, ign=ign, shift=shift):
            leaf = logits.detach().requires_grad_()
            loss = ce.softmax_cross_entropy_reference(leaf, labels, ign,
                                                      dtype=xc, shift=shift)
            return torch.autograd.grad(loss, leaf, g)[0]
        got = run()
        gb = run_b(got["state"])
        ref_loss, ref_dx = plain(), plain_b()
        ok_f, err_f, errs_f = fused_compare(
            torch, {"loss": (got["loss"], ref_loss, "out")})
        ok_b, err_b, errs_b = fused_compare(
            torch, {"dx": (gb["dx"].view(logits.shape), ref_dx, "out")})
        require(ok_f and ok_b, f"softmax_cross_entropy {name}: beyond "
                               f"FUSED_TOL: {errs_f} {errs_b}")
        err = max(err, err_f, err_b)
        results.append({"case": name, "shape": list(shape), "fwd": errs_f,
                        "bwd": errs_b, "loss": float(got["loss"]),
                        "count": float(got["count"])})
        if name == "vocab_fp16_shift":
            fused_repeat_equal(torch, lambda: (lambda f: {
                "loss": f["loss"], "m": f["m"], "logs": f["logs"],
                **run_b(f["state"])})(run()), f"softmax_cross_entropy {name}")
            results[-1]["planted_max_abs_err"] = fused_planted_rejected(
                torch, lambda: run(ce.bind(planted_lib)),
                {"loss": (ref_loss, "out")},
                f"softmax_cross_entropy {name}")["max_abs_err"]
        if name != "llama_shift":
            continue
        fused_repeat_equal(torch, lambda: (lambda f: {
            "loss": f["loss"], "m": f["m"], "logs": f["logs"],
            **run_b(f["state"])})(run()), f"softmax_cross_entropy {name}")
        planted = fused_planted_rejected(
            torch, lambda: run(ce.bind(planted_lib)),
            {"loss": (ref_loss, "out")}, f"softmax_cross_entropy {name}")
        state = got["state"]
        flat = logits[:, :-1, :].reshape(-1, v)
        flat_lab = labels[:, 1:].reshape(-1)
        timing = fused_timing(
            torch, run, plain,
            lambda: torch.nn.functional.cross_entropy(flat, flat_lab))
        both = cuda_ms(torch, plain_b, max(2, FUSED_ITERS // 4))
        leaf = flat.detach().requires_grad_()

        def library_fb():
            leaf.grad = None
            torch.nn.functional.cross_entropy(leaf, flat_lab).backward()
        lib_both = cuda_ms(torch, library_fb, FUSED_ITERS)
        timing.update({"bwd_ms": cuda_ms(torch, lambda: run_b(state),
                                         FUSED_ITERS),
                       "bwd_device_ms": device_ms(torch,
                                                  lambda: run_b(state)),
                       "bwd_plain_ms": both - timing["plain_ms"],
                       "bwd_library_ms": lib_both - timing["library_ms"],
                       "bwd_library_device_ms": library_backward_device_ms(
                           torch, lambda x: torch.nn.functional.cross_entropy(
                               x, flat_lab), (flat,), None)})
        # the launch's cost function: the rows it scores and their labels
        fb = ce.cross_entropy_cost(x3, lab2, lu)[1]
        timing["bound_ms"], timing["bound_by"] = bound(0, fb, "float32")
        timing["bwd_bound_ms"], _ = bound(
            0, fb + nbytes(gb["dx"]), "float32")
        timing["planted_max_abs_err"] = planted["max_abs_err"]
        timing["case"] = ("logits (6, 4096, 32000) bf16, rows l < 4095 read "
                          "in place; library: F.cross_entropy on the sliced "
                          "bf16 logits (copied)")
    return {"cases": results, "max_abs_err": err, **timing}


def fused_ops_check(torch, planted) -> dict:
    """K1-K4 against their plain versions, forward and backward, at the
    Llama, ERNIE and serving shapes, fp32 and bf16; three launches of each
    on the same inputs bit-equal; a planted copy of each rejected; times
    beside the bound, the plain version and the library call. Returns the
    kernels-line numbers by kernel."""
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import rope as rp
    from paddle_tpu_torch.ops import softmax_cross_entropy as ce
    from paddle_tpu_torch.ops import swiglu as sw
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = {"fused_norm": check_fused_norm(torch, fn, planted["fused_norm"],
                                           gen),
            "rope": check_rope(torch, rp, planted["rope"], gen),
            "swiglu": check_swiglu(torch, sw, planted["swiglu"], gen),
            "softmax_cross_entropy": check_cross_entropy(
                torch, ce, planted["softmax_cross_entropy"], gen)}
    emit({"phase": "fused_ops_check", "seconds": time.monotonic() - t0,
          **rows})
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# ERNIE's remaining small ops: K5 embedding, K6 bias_act, K7 dropout,
# K8 softmax_mask
# ---------------------------------------------------------------------------

ERNIE_OP_KERNELS = ("embedding", "bias_act", "dropout", "softmax_mask")
# the JAX function each replaces: XLA-fused jnp, no pallas_call
ERNIE_OP_REPLACES = {
    "embedding": "paddle_tpu/ops/nn_ops.py:37",
    "bias_act": "paddle_tpu/incubate/nn_functional.py:212",
    "dropout": "paddle_tpu/ops/nn_ops.py:102",
    "softmax_mask": "paddle_tpu/incubate/nn_functional.py:283"}
ERNIE_OP_SOURCES = {k: f"paddle_tpu_torch/csrc/{k}.cu"
                    for k in ERNIE_OP_KERNELS}
DROPOUT_SEED = 123456789


def ernie_op_counters() -> dict:
    """The launch counters of K5-K8 by kernel name."""
    from paddle_tpu_torch.ops import bias_act, dropout, embedding
    from paddle_tpu_torch.ops import softmax_mask
    return {"embedding": embedding.launches, "bias_act": bias_act.launches,
            "dropout": dropout.launches, "softmax_mask": softmax_mask.launches}


def step_counters() -> dict:
    """K1-K8's counters by kernel name."""
    return {**fused_counters(), **ernie_op_counters()}


def exact_compare(torch, got: dict, refs: dict, what: str) -> dict:
    """Require every output equal to its reference bit for bit; return the
    elements that differ (0) by name."""
    bits = {}
    for k, ref in refs.items():
        out = got[k]
        same = out.shape == ref.shape and out.dtype == ref.dtype \
            and bool(torch.equal(out, ref))
        bits[k] = 0 if same else int((out != ref).sum()) \
            if out.shape == ref.shape else -1
        require(same, f"{what}: {k} is not bit-equal to the plain version "
                      f"({bits[k]} elements differ)")
    return bits


def planted_differs(torch, out: dict, refs: dict, what: str) -> dict:
    """A planted copy's outputs must differ from the plain version's."""
    differs = {k: not bool(torch.equal(out[k], refs[k])) for k in refs}
    require(any(differs.values()), f"{what}: the planted fault passed the "
                                   f"bit-for-bit check")
    err = max(float((out[k].float() - refs[k].float()).abs().max())
              for k in refs)
    return {"max_abs_err": err}


def embedding_cases(torch, gen) -> list:
    """K5's cases at the shapes its paths give it: (name, ids, rows, width,
    dtype, padding_idx). ERNIE's four tables (tokens (32, 128): word ids
    with padding 0, position ids each hit 32 times, all-zero type and task
    ids, one id for all 4096 rows) in bf16 (O2) and fp32, Llama's 6 x 4096
    ids into 32000 x 2560 bf16, odd widths, and in fp16 ERNIE's word and
    type tables and a Llama-2-7B fp16 prompt of 1000 ids into 32000 x
    4096."""
    bf, f32, h16 = torch.bfloat16, torch.float32, torch.float16
    b, n = 32, 128
    word = torch.randint(1, 40000, (b, n), generator=gen, device="cuda")
    word[:, -8:] = 0
    pos = torch.arange(n, device="cuda").expand(b, n).contiguous()
    zero = torch.zeros(b, n, dtype=torch.int64, device="cuda")
    llama = torch.randint(0, 32000, (6, 4096), generator=gen, device="cuda")
    prompt = torch.randint(0, 32000, (1, 1000), generator=gen, device="cuda")
    return [("ernie_word_bf16", word, 40000, 768, bf, 0),
            ("ernie_position_bf16", pos, 2048, 768, bf, None),
            ("ernie_type_bf16_skew", zero, 4, 768, bf, None),
            ("ernie_task_bf16_skew", zero, 3, 768, bf, None),
            ("ernie_word_fp32", word, 40000, 768, f32, 0),
            ("ernie_type_fp32_skew", zero, 4, 768, f32, None),
            ("llama_bf16", llama, 32000, 2560, bf, None),
            ("int32_ids_width_90_fp32", (word % 500).to(torch.int32), 500,
             90, f32, 3),
            ("width_99_bf16", word % 700, 700, 99, bf, None),
            ("ernie_word_fp16", word, 40000, 768, h16, 0),
            ("ernie_type_fp16_skew", zero, 4, 768, h16, None),
            ("serve_7b_prompt_fp16", prompt, 32000, 4096, h16, None)]


# K5's timed cases: ERNIE's four tables (bf16) and its word table in fp32,
# and Llama's table
EMBEDDING_TIMED = ("ernie_word_bf16", "ernie_word_fp32",
                   "ernie_position_bf16", "ernie_type_bf16_skew",
                   "ernie_task_bf16_skew", "llama_bf16")


def embedding_timing(torch, em, gen) -> dict:
    """K5's backward (and forward) at each of :data:`EMBEDDING_TIMED`:
    graph device ms (:func:`graph_readings`), the backward's split by
    kernel (:func:`profile_kernels`: the index preparation, the kernels and
    whatever else the wrapper launches), the byte bounds (forward: ids, the
    rows read and the output; backward: ids and dy read once, the whole
    gradient table written once) and ``aten.embedding_dense_backward``'s
    device ms. Needs only ``_launch_fwd`` / ``_launch_bwd``, so it times
    any tree's K5."""
    out = {}
    for name, ids, rows, d, dt, pad in embedding_cases(torch, gen):
        if name not in EMBEDDING_TIMED:
            continue
        w = (torch.randn((rows, d), generator=gen, device="cuda")
             * 0.02).to(dt)
        dy = torch.randn((*ids.shape, d), generator=gen, device="cuda").to(dt)

        def bwd(ids=ids, dy=dy, rows=rows, pad=pad, dt=dt):
            return em._launch_bwd(ids, dy, rows, pad, dt)
        hit = int(torch.unique(ids).numel())
        out[name] = {
            "ids": list(ids.shape), "rows": rows, "width": d,
            "dtype": dtype_name(dt),
            "fwd": graph_readings(torch, lambda: em._launch_fwd(ids, w, pad)),
            "bwd": graph_readings(torch, bwd),
            "bwd_kernels": profile_kernels(torch, bwd, FUSED_ITERS),
            "bound_ms": bound(0, nbytes(ids, dy) + hit * d * w.element_size(),
                              "float32")[0],
            "bwd_bound_ms": bound(0, nbytes(ids, dy) + nbytes(w),
                                  "float32")[0],
            "bwd_library_device_ms": device_ms(
                torch, lambda: torch.ops.aten.embedding_dense_backward(
                    dy, ids, rows, -1 if pad is None else pad, False))}
        del w, dy
    return out


def check_embedding(torch, em, planted_lib, gen) -> dict:
    """K5 at :func:`embedding_cases`: forward and backward bit-equal to the
    plain version."""
    bf = torch.bfloat16
    cases = embedding_cases(torch, gen)
    results, timing, tables = [], {}, {}
    for name, ids, rows, d, dt, pad in cases:
        w = (torch.randn((rows, d), generator=gen, device="cuda")
             * 0.02).to(dt)
        dy = torch.randn((*ids.shape, d), generator=gen, device="cuda").to(dt)

        def fwd(fns=None, ids=ids, w=w, pad=pad):
            return {"out": em._launch_fwd(ids, w, pad, fns=fns)}

        def bwd(fns=None, ids=ids, dy=dy, rows=rows, pad=pad, dt=dt):
            return {"dw": em._launch_bwd(ids, dy, rows, pad, dt, fns=fns)}
        refs = {"out": em.embedding_reference(ids, w, pad),
                "dw": em.embedding_bwd_reference(ids, dy, rows, pad, dt)}
        got = fwd()
        # the gradient's block comes from the allocator's cache: fill it
        # with NaN first, so that a row the kernels leave unwritten shows
        poison = torch.full((rows, d), float("nan"), dtype=dt, device="cuda")
        del poison
        bits = exact_compare(torch, {**got, **bwd()}, refs,
                             f"embedding {name}")
        results.append({"case": name, "ids": list(ids.shape), "rows": rows,
                        "width": d, "dtype": dtype_name(dt),
                        "elements_not_bit_equal": bits})
        if name.startswith("ernie_") and dt == bf:
            tables[name] = {"ms": cuda_ms(torch, fwd, FUSED_ITERS),
                            "bwd_ms": cuda_ms(torch, bwd, FUSED_ITERS),
                            "bwd_library_ms": cuda_ms(
                                torch, lambda: torch.ops.aten.
                                embedding_dense_backward(
                                    dy, ids, rows, -1 if pad is None else pad,
                                    False), FUSED_ITERS)}
        if name in ("ernie_type_bf16_skew", "ernie_type_fp16_skew"):
            fused_repeat_equal(torch, lambda: {**fwd(), **bwd()},
                               f"embedding {name}")
            timing["planted" if dt == bf else "planted_fp16"] = \
                planted_differs(torch, bwd(em.bind(planted_lib)),
                                {"dw": refs["dw"]}, f"embedding {name}")
        if name in ("ernie_word_bf16", "llama_bf16"):
            lib_pad = -1 if pad is None else pad
            t = fused_timing(
                torch, fwd, lambda: em.embedding_reference(ids, w, pad),
                lambda: torch.nn.functional.embedding(ids, w,
                                                      padding_idx=pad))
            t.update({"bwd_" + k: v for k, v in fused_timing(
                torch, bwd, lambda: em.embedding_bwd_reference(
                    ids, dy, rows, pad, dt),
                lambda: torch.ops.aten.embedding_dense_backward(
                    dy, ids, rows, lib_pad, False)).items()})
            hit = int(torch.unique(ids).numel())
            fb = nbytes(ids) + hit * d * w.element_size() + nbytes(dy)
            bb = nbytes(ids, dy) + rows * d * w.element_size()
            t["bound_ms"], t["bound_by"] = bound(0, fb, "float32")
            t["bwd_bound_ms"], _ = bound(0, bb, "float32")
            timing[name] = t
    row = dict(timing["ernie_word_bf16"])
    row.update({"cases": results, "max_abs_err": 0.0,
                "planted_max_abs_err": timing["planted"]["max_abs_err"],
                "fp16_planted_max_abs_err":
                    timing["planted_fp16"]["max_abs_err"],
                "llama": timing["llama_bf16"], "ernie_tables": tables,
                "ernie_tables_bwd_ms": sum(t["bwd_ms"]
                                           for t in tables.values()),
                "ernie_tables_bwd_library_ms": sum(
                    t["bwd_library_ms"] for t in tables.values()),
                "case": "ERNIE word ids (32, 128) into 40000 x 768 bf16, "
                        "padding_idx 0; backward: its sort, index and "
                        "table kernels, no zero fill; library: "
                        "F.embedding and "
                        "aten.embedding_dense_backward",
                "timed_cases": embedding_timing(torch, em, torch.Generator(
                    device="cuda").manual_seed(19))})
    return row


def check_bias_act_tables(torch, ba) -> dict:
    """K6's activation tables against torch's own GELU on every entry: the
    forward table (bf16 bits) against ``F.gelu`` of the bf16 value, the
    backward table (fp32) against ``aten.gelu_backward`` of 1 at its fp32
    value, erf and tanh forms, bit for bit; returns the entries that
    differ (0) by form."""
    TF = torch.nn.functional
    out = {}
    for act, approx in (("gelu", "none"), ("gelu_tanh", "tanh")):
        fwd, bwd = ba._tables(torch.cuda.current_device(), act)
        half = fwd.numel() // 2
        lo = 111 << 7   # csrc/bias_act.cu TAB_LO: 2^-16
        mags = torch.arange(lo, lo + half, dtype=torch.int32, device="cuda")
        bits = torch.cat([mags, mags + 0x8000]).to(torch.int16)
        x = bits.view(torch.bfloat16)
        want_f = TF.gelu(x, approximate=approx).view(torch.int16)
        want_b = torch.ops.aten.gelu_backward(
            torch.ones(x.shape, device="cuda"), x.float(), approximate=approx)
        out[act] = {"fwd": int((fwd != want_f).sum()),
                    "bwd": int((bwd.view(torch.int32)
                                != want_b.view(torch.int32)).sum()),
                    "entries": int(fwd.numel())}
        require(out[act]["fwd"] == 0 and out[act]["bwd"] == 0,
                f"bias_act {act} tables differ from torch's GELU: "
                f"{out[act]}")
    return out


def check_bias_act_fp16_gelu(torch, ba) -> dict:
    """K6's fp16 GELU, which computes the activation (the lookup tables
    are bf16 only): every finite fp16 value through the kernel's forward,
    against ``F.gelu`` of the fp16 value bit for bit, and its backward at
    dy = 1 against ``aten.gelu_backward`` in fp16, erf and tanh forms;
    returns the values that differ by form (the forward must give none)."""
    TF = torch.nn.functional
    h16 = torch.float16
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device="cuda")
    x = bits.to(torch.int16).view(h16)
    x = x[torch.isfinite(x)].reshape(-1, 8)     # 8-element vectors
    one = torch.ones_like(x)
    out = {}
    for act, approx in (("gelu", "none"), ("gelu_tanh", "tanh")):
        spec = ba.ActSpec(act, h16, h16)
        fwd = ba._launch_fwd(x, None, spec)
        dx, _ = ba._launch_bwd(x, None, one, spec)
        want_f = TF.gelu(x, approximate=approx)
        want_b = torch.ops.aten.gelu_backward(one, x, approximate=approx)
        out[act] = {"fwd": int((fwd.view(torch.int16)
                                != want_f.view(torch.int16)).sum()),
                    "bwd": int((dx.view(torch.int16)
                                != want_b.view(torch.int16)).sum()),
                    "bwd_max_abs": float((dx.float() - want_b.float()).abs()
                                         .max()),
                    "values": int(x.numel())}
        require(out[act]["fwd"] == 0,
                f"bias_act fp16 {act} differs from torch's GELU: {out[act]}")
    return out


def check_bias_act(torch, ba, planted_lib, gen) -> dict:
    """K6 at ERNIE's linear1 output (4096 x 3072, bias, GELU erf) in bf16
    (O2) and fp32, the tanh form, ReLU, no bias and an odd width: forward
    within FUSED_TOL ``out``, the input gradient ``out``, the bias gradient
    ``sum``; its activation tables bit-equal to torch's GELU on every
    entry (:func:`check_bias_act_tables`)."""
    bf, f32, h16 = torch.bfloat16, torch.float32, torch.float16
    S = ba.ActSpec
    tables = check_bias_act_tables(torch, ba)
    fp16_gelu = check_bias_act_fp16_gelu(torch, ba)
    # (name, rows, n, y dtype, bias dtype, act)
    cases = [("ernie_o2_gelu", 4096, 3072, bf, bf, "gelu"),
             ("ernie_fp32_gelu", 4096, 3072, f32, f32, "gelu"),
             ("gelu_tanh_bf16", 1024, 3072, bf, bf, "gelu_tanh"),
             ("relu_fp32_width_1001", 1000, 1001, f32, f32, "relu"),
             ("gelu_no_bias_bf16", 4096, 768, bf, None, "gelu"),
             ("identity_bf16_y_fp32_bias", 512, 3072, bf, f32, "none"),
             # fp16: ERNIE's linear1 epilogue as its fp16 leg calls it
             ("ernie_fp16_gelu", 4096, 3072, h16, h16, "gelu")]
    results, err, timing = [], 0.0, None
    for name, rows, n, yd, bd, act in cases:
        y = (torch.randn((rows, n), generator=gen, device="cuda") * 2).to(yd)
        bias = None if bd is None else \
            (torch.randn((n,), generator=gen, device="cuda") * 0.5).to(bd)
        h = yd if bd is None else torch.promote_types(yd, bd)
        spec = S(act, h, h)
        dy = torch.randn((rows, n), generator=gen, device="cuda").to(h)

        def fwd(fns=None, y=y, bias=bias, spec=spec):
            return {"out": ba._launch_fwd(y, bias, spec, fns=fns)}

        def bwd(y=y, bias=bias, dy=dy, spec=spec):
            return dict(zip(("dy_y", "db"), ba._launch_bwd(y, bias, dy,
                                                           spec)))
        ref = {"out": (ba.bias_act_reference(y, bias, spec), "out")}
        r_dyy, r_db = ba.bias_act_bwd_reference(y, bias, dy, spec)
        got, gb = fwd(), bwd()
        ok_f, err_f, errs_f = fused_compare(
            torch, {k: (got[k], *ref[k]) for k in ref})
        ok_b, err_b, errs_b = fused_compare(
            torch, {"dy_y": (gb["dy_y"], r_dyy, "out"),
                    "db": (gb["db"], r_db, "sum")})
        bits = {"out": int((got["out"] != ref["out"][0]).sum()),
                "dy_y": int((gb["dy_y"] != r_dyy).sum())}
        require(ok_f and ok_b, f"bias_act {name}: beyond FUSED_TOL: "
                               f"{errs_f} {errs_b}")
        err = max(err, err_f, err_b)
        results.append({"case": name, "rows": rows, "n": n, "act": act,
                        "fwd": errs_f, "bwd": errs_b,
                        "elements_not_bit_equal": bits})
        if name == "ernie_fp16_gelu":
            fused_repeat_equal(torch, lambda: {**fwd(), **bwd()},
                               f"bias_act {name}")
            results[-1]["planted_max_abs_err"] = fused_planted_rejected(
                torch, lambda: fwd(ba.bind(planted_lib)), ref,
                f"bias_act {name}")["max_abs_err"]
        if name != "ernie_o2_gelu":
            continue
        fused_repeat_equal(torch, lambda: {**fwd(), **bwd()},
                           f"bias_act {name}")
        planted = fused_planted_rejected(
            torch, lambda: fwd(ba.bind(planted_lib)), ref, f"bias_act {name}")
        timing = fused_timing(
            torch, fwd, lambda: ba.bias_act_reference(y, bias, spec),
            lambda: torch.nn.functional.gelu(y + bias))
        leaves = [t.detach().requires_grad_() for t in (y, bias)]

        def plain_fb():
            out = ba.bias_act_reference(*leaves, spec)
            torch.autograd.grad(out, leaves, dy)

        def library_fb():
            out = torch.nn.functional.gelu(leaves[0] + leaves[1])
            torch.autograd.grad(out, leaves, dy)
        timing.update({
            "bwd_ms": cuda_ms(torch, bwd, FUSED_ITERS),
            "bwd_device_ms": device_ms(torch, bwd),
            "bwd_plain_ms": cuda_ms(torch, plain_fb, FUSED_ITERS)
            - timing["plain_ms"],
            "bwd_library_ms": cuda_ms(torch, library_fb, FUSED_ITERS)
            - timing["library_ms"],
            "bwd_library_device_ms": library_backward_device_ms(
                torch, lambda y, b: torch.nn.functional.gelu(y + b),
                (y, bias), dy)})
        timing["bound_ms"], timing["bound_by"] = bound(
            0, nbytes(y, bias, got["out"]), "float32")
        timing["bwd_bound_ms"], _ = bound(
            0, nbytes(y, bias, dy, gb["dy_y"], gb["db"]), "float32")
        timing["planted_max_abs_err"] = planted["max_abs_err"]
        timing["case"] = ("y (4096, 3072) bf16 + bias, GELU erf (O2); "
                          "library: F.gelu(y + b), its backward by autograd")
    # a generator of its own: the later checks draw the inputs they drew
    timing["timed_cases"] = bias_act_timing(
        torch, ba, torch.Generator(device="cuda").manual_seed(17))
    return {"cases": results, "tables_not_bit_equal": tables,
            "fp16_gelu_not_bit_equal": fp16_gelu, "max_abs_err": err,
            **timing}


def check_dropout(torch, dr, planted_lib, gen) -> dict:
    """K7 at ERNIE's hidden dropout (4096 x 768, p = 0.1) in bf16 (O2) and
    fp32, with a residual of another dtype, downscale_in_infer on an odd
    size and the classifier's (32, 768): forward and backward bit-equal to
    the plain version, which hashes the same seed; the kept share near
    1 - p; another seed another mask. The same in fp16 at the hidden and
    classifier shapes."""
    bf, f32, h16 = torch.bfloat16, torch.float32, torch.float16
    seed = torch.tensor(DROPOUT_SEED, dtype=torch.int64, device="cuda")
    # (name, shape, x dtype, residual dtype, upscale)
    cases = [("ernie_hidden_bf16", (4096, 768), bf, None, True),
             ("ernie_hidden_fp32", (4096, 768), f32, None, True),
             ("residual_bf16_x_fp32_res", (4096, 768), bf, f32, True),
             ("downscale_fp32_odd", (1000, 33), f32, None, False),
             ("classifier_bf16", (32, 768), bf, None, True),
             # fp16: ERNIE's hidden and classifier dropouts as its fp16 leg
             # calls them
             ("ernie_hidden_fp16", (4096, 768), h16, None, True),
             ("classifier_fp16", (32, 768), h16, None, True)]
    p = 0.1
    results, timing = [], None
    for name, shape, xd, rd, up in cases:
        x = torch.randn(shape, generator=gen, device="cuda").to(xd)
        res = None if rd is None else \
            torch.randn(shape, generator=gen, device="cuda").to(rd)
        out_dt = xd if rd is None else torch.promote_types(xd, rd)
        dy = torch.randn(shape, generator=gen, device="cuda").to(out_dt)

        def fwd(fns=None, x=x, res=res, up=up, s=seed):
            return {"out": dr._launch_fwd(x, res, s, p, up, fns=fns)}

        def bwd(dy=dy, up=up, xd=xd):
            return {"dx": dr._launch_bwd(dy, seed, p, up, xd)}

        def plain_b(x=x, res=res, dy=dy, up=up):
            leaf = x.detach().requires_grad_()
            out = dr.dropout_reference(leaf, seed, p, residual=res,
                                       upscale=up)
            return {"dx": torch.autograd.grad(out, leaf, dy)[0]}
        refs = {"out": dr.dropout_reference(x, seed, p, residual=res,
                                            upscale=up)}
        bits = exact_compare(torch, {**fwd(), **bwd()},
                             {**refs, **plain_b()}, f"dropout {name}")
        keep = dr.keep_mask(seed, shape, p, "cuda")
        kept = float(keep.float().mean())
        other = fwd(s=torch.tensor(DROPOUT_SEED + 1, dtype=torch.int64,
                                   device="cuda"))["out"]
        require(abs(kept - (1 - p)) < 0.01 + 3 / math.sqrt(keep.numel())
                and not torch.equal(other, refs["out"]),
                f"dropout {name}: kept share {kept}, or a new seed gave the "
                f"same mask")
        results.append({"case": name, "shape": list(shape),
                        "dtype": dtype_name(xd), "upscale": up,
                        "kept_share": kept,
                        "elements_not_bit_equal": bits})
        if name == "ernie_hidden_fp16":
            fused_repeat_equal(torch, lambda: {**fwd(), **bwd()},
                               f"dropout {name}")
            results[-1]["planted_max_abs_err"] = planted_differs(
                torch, fwd(dr.bind(planted_lib)), refs,
                f"dropout {name}")["max_abs_err"]
        if name != "ernie_hidden_bf16":
            continue
        fused_repeat_equal(torch, lambda: {**fwd(), **bwd()},
                           f"dropout {name}")
        planted = planted_differs(torch, fwd(dr.bind(planted_lib)), refs,
                                  f"dropout {name}")
        timing = fused_timing(
            torch, fwd, lambda: dr.dropout_reference(x, seed, p),
            lambda: torch.nn.functional.dropout(x, p))
        _, mask = torch.ops.aten.native_dropout(x, p, True)
        scale = 1.0 / (1.0 - p)
        timing.update({
            "bwd_ms": cuda_ms(torch, bwd, FUSED_ITERS),
            "bwd_device_ms": device_ms(torch, bwd),
            "bwd_plain_ms": cuda_ms(torch, plain_b, max(2, FUSED_ITERS // 4)),
            "bwd_library_ms": cuda_ms(
                torch, lambda: torch.ops.aten.native_dropout_backward(
                    dy, mask, scale), FUSED_ITERS),
            "bwd_library_device_ms": library_backward_device_ms(
                torch, lambda x: torch.nn.functional.dropout(x, p), (x,),
                dy)})
        timing["bound_ms"], timing["bound_by"] = bound(
            0, nbytes(x, refs["out"]), "float32")
        timing["bwd_bound_ms"], _ = bound(0, 2 * nbytes(dy), "float32")
        timing["planted_max_abs_err"] = planted["max_abs_err"]
        timing["case"] = ("x (4096, 768) bf16, p = 0.1 (one hidden site); "
                          "library: F.dropout (Philox, its mask stored), "
                          "aten.native_dropout_backward")
    return {"cases": results, "max_abs_err": 0.0, **timing}


def check_softmax_mask(torch, sm, planted_lib, gen) -> dict:
    """K8 at ERNIE's attention scores (32, 12, 128, 128) with an additive
    (32, 1, 128, 128) mask (-1e4 on padded keys) in bf16 and fp32, the
    upper triangle (Lq = Lk and Lq < Lk) and a 3-D odd width: forward
    within FUSED_TOL ``out``, backward ``out`` against its size |y| (|dy|
    + |sum dy y|)."""
    bf, f32 = torch.bfloat16, torch.float32
    # (name, x shape, mask shape or None (upper triangle), dtype)
    cases = [("ernie_bf16", (32, 12, 128, 128), (32, 1, 128, 128), bf),
             ("ernie_fp32", (32, 12, 128, 128), (32, 1, 128, 128), f32),
             ("upper_triangle_bf16", (8, 12, 128, 128), None, bf),
             ("upper_triangle_lq_lt_lk_fp32", (2, 4, 64, 200), None, f32),
             ("mask_3d_width_77_fp32", (3, 50, 77), (3, 50, 77), f32),
             # fp16: ERNIE's scores and mask in fp16
             ("ernie_fp16", (32, 12, 128, 128), (32, 1, 128, 128),
              torch.float16)]
    results, err, timing = [], 0.0, None
    for name, shape, mshape, dt in cases:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dt)
        mask = None
        if mshape is not None:
            mask = torch.randn(mshape, generator=gen, device="cuda")
            mask[..., -16:] = -1e4 * (torch.rand(
                mshape[:-1] + (1,), generator=gen, device="cuda") < 0.5)
            mask = mask.to(dt)
        causal = mask is None
        dy = torch.randn(shape, generator=gen, device="cuda").to(dt)

        def fwd(fns=None, x=x, mask=mask, causal=causal):
            return {"y": sm._launch_fwd(x, mask, causal, fns=fns)}
        got = fwd()

        def bwd(y=got["y"], dy=dy):
            return {"dx": sm._launch_bwd(y, dy)}
        ref = {"y": (sm.softmax_mask_reference(x, mask, causal), "out")}
        gb = bwd()
        yf, gf = got["y"].float(), dy.float()
        mag = yf.abs() * (gf.abs() + (gf * yf).sum(-1, keepdim=True).abs())
        r_dx = sm.softmax_mask_bwd_reference(got["y"], dy)
        ok_f, err_f, errs_f = fused_compare(
            torch, {k: (got[k], *ref[k]) for k in ref})
        ok_b, err_b, errs_b = fused_compare(
            torch, {"dx": (gb["dx"], r_dx, "out", mag)})
        require(ok_f and ok_b, f"softmax_mask {name}: beyond FUSED_TOL: "
                               f"{errs_f} {errs_b}")
        err = max(err, err_f, err_b)
        results.append({"case": name, "shape": list(shape),
                        "dtype": dtype_name(dt), "fwd": errs_f,
                        "bwd": errs_b,
                        "elements_not_bit_equal": {
                            "y": int((got["y"] != ref["y"][0]).sum()),
                            "dx": int((gb["dx"] != r_dx).sum())}})
        if name == "ernie_fp16":
            fused_repeat_equal(torch, lambda: {**fwd(), **bwd()},
                               f"softmax_mask {name}")
            results[-1]["planted_max_abs_err"] = fused_planted_rejected(
                torch, lambda: fwd(sm.bind(planted_lib)), ref,
                f"softmax_mask {name}")["max_abs_err"]
        if name != "ernie_bf16":
            continue
        fused_repeat_equal(torch, lambda: {**fwd(), **bwd()},
                           f"softmax_mask {name}")
        planted = fused_planted_rejected(
            torch, lambda: fwd(sm.bind(planted_lib)), ref,
            f"softmax_mask {name}")
        timing = fused_timing(
            torch, fwd, lambda: sm.softmax_mask_reference(x, mask),
            lambda: torch.softmax(x + mask, -1))
        y = got["y"]
        timing.update({
            "bwd_ms": cuda_ms(torch, bwd, FUSED_ITERS),
            "bwd_device_ms": device_ms(torch, bwd),
            "bwd_plain_ms": cuda_ms(
                torch, lambda: sm.softmax_mask_bwd_reference(y, dy),
                max(2, FUSED_ITERS // 4)),
            "bwd_library_ms": cuda_ms(
                torch, lambda: torch.ops.aten._softmax_backward_data(
                    dy, y, -1, dt), FUSED_ITERS),
            "bwd_library_device_ms": library_backward_device_ms(
                torch, lambda x: torch.softmax(x + mask, -1), (x,), dy)})
        timing["bound_ms"], timing["bound_by"] = bound(
            0, nbytes(x, mask, y), "float32")
        timing["bwd_bound_ms"], _ = bound(0, nbytes(y, dy, gb["dx"]),
                                          "float32")
        timing["planted_max_abs_err"] = planted["max_abs_err"]
        timing["case"] = ("scores (32, 12, 128, 128) bf16 + mask (32, 1, "
                          "128, 128); library: torch.softmax(x + mask), "
                          "aten._softmax_backward_data")
    timing["timed_cases"] = softmax_mask_timing(
        torch, sm, torch.Generator(device="cuda").manual_seed(18))
    return {"cases": results, "max_abs_err": err, **timing}


def ernie_ops_check(torch, planted) -> dict:
    """K5-K8 against their plain versions at ERNIE's (and Llama's
    embedding) shapes, forward and backward: K5 and K7 bit for bit, K6 and
    K8 within FUSED_TOL; three launches of each on the same inputs
    bit-equal; a planted copy of each rejected; times beside the bound, the
    plain version and the library call. Returns the kernels-line numbers
    by kernel."""
    from paddle_tpu_torch.ops import bias_act as ba
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import embedding as em
    from paddle_tpu_torch.ops import softmax_mask as sm
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = {"embedding": check_embedding(torch, em, planted["embedding"],
                                         gen),
            "bias_act": check_bias_act(torch, ba, planted["bias_act"], gen),
            "dropout": check_dropout(torch, dr, planted["dropout"], gen),
            "softmax_mask": check_softmax_mask(torch, sm,
                                               planted["softmax_mask"], gen)}
    emit({"phase": "ernie_ops_check", "seconds": time.monotonic() - t0,
          **rows})
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def incubate_check(torch) -> dict:
    """The incubate surface on the card at ERNIE-3.0-base's width (hidden
    768, 12 heads, intermediate 3072): ``FusedMultiHeadAttention``,
    ``FusedFeedForward`` and ``FusedTransformerEncoderLayer`` in fp32, eval
    mode, on the card and on the CPU with the same weights (B = 2, L =
    128), ``variable_length_memory_efficient_attention`` and
    ``fused_linear_activation`` likewise; then the layers in training with
    dropout 0.1 under AMP O2 at B = 32, L = 128 and ``softmax_mask_fuse`` /
    ``softmax_mask_fuse_upper_triangle`` with their gradients at ERNIE's
    attention shape, counting K6-K8 launches from 0: the path whose run
    gives K8 its launches."""
    import numpy as np
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate import nn as inn
    from paddle_tpu_torch.nn import DropoutRNG
    t0 = time.monotonic()
    h, heads, inter = 768, 12, 3072

    def build(device, dropout):
        return (inn.FusedMultiHeadAttention(h, heads, dropout, dropout,
                                            device=device),
                inn.FusedFeedForward(h, inter, dropout, activation="gelu",
                                     device=device),
                inn.FusedTransformerEncoderLayer(h, heads, inter, dropout,
                                                 activation="gelu",
                                                 device=device))
    gen = torch.Generator().manual_seed(12)
    card, cpu = build("cuda", 0.1), build("cpu", 0.1)
    for lc, lp in zip(card, cpu):
        for (k, pc), (_, pp) in zip(lc.named_parameters(),
                                    lp.named_parameters()):
            with torch.no_grad():
                pp.copy_(torch.randn(pp.shape, generator=gen) * 0.05
                         + (1.0 if "ln" in k and "weight" in k else 0.0))
                pc.copy_(pp)
        lc.eval()
        lp.eval()
    x = torch.randn((2, 128, h), generator=gen)
    agree = {}
    for name, lc, lp in zip(("mha", "ffn", "encoder"), card, cpu):
        with torch.no_grad():
            out_c, out_p = lc(x.cuda()).cpu(), lp(x)
        agree[name] = float((out_c - out_p).abs().max()
                            / out_p.abs().max())
    f = inn.functional
    q, k, v = (torch.randn((2, heads, 128, 64), generator=gen)
               for _ in range(3))
    sl, kvl = torch.tensor([128, 77]), torch.tensor([128, 100])
    var_c = f.variable_length_memory_efficient_attention(
        q.cuda(), k.cuda(), v.cuda(), sl.cuda(), kvl.cuda(), causal=True)
    var_p = f.variable_length_memory_efficient_attention(q, k, v, sl, kvl,
                                                         causal=True)
    agree["varlen_mea"] = float((var_c.cpu() - var_p).abs().max()
                                / var_p.abs().max())
    w1 = torch.randn((h, inter), generator=gen) * 0.05
    b1 = torch.randn((inter,), generator=gen) * 0.05
    fla_c = f.fused_linear_activation(x.cuda(), w1.cuda(), b1.cuda())
    fla_p = f.fused_linear_activation(x, w1, b1)
    agree["fused_linear_activation"] = float(
        (fla_c.cpu() - fla_p).abs().max() / fla_p.abs().max())
    require(all(e <= 1e-4 for e in agree.values()),
            f"incubate: card and CPU disagree (max |diff| / max |ref|) "
            f"{agree}")
    # training under O2 at B = 32, L = 128: launches from 0
    counters = ernie_op_counters()
    for c in counters.values():
        c.reset()
    rng = DropoutRNG("cuda", seed=3)
    mha, ffn, enc = build("cuda", 0.1)
    for m in (mha, ffn, enc):
        m.rng = rng
        for mod in m.modules():
            if hasattr(mod, "rng"):
                mod.rng = rng
    amp.decorate([mha, ffn, enc], level="O2", dtype="bfloat16")
    xb = torch.randn((32, 128, h), device="cuda").requires_grad_()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        out = enc(ffn(mha(xb)))
    out.float().square().mean().backward()
    s = torch.randn((32, 12, 128, 128), device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    mask = torch.zeros((32, 1, 128, 128), device="cuda", dtype=torch.bfloat16)
    mask[..., 120:] = -1e4
    probs = f.softmax_mask_fuse(s, mask)
    probs_causal = f.softmax_mask_fuse_upper_triangle(s)
    (probs.float().square().sum() + probs_causal.float().square().sum()
     ).backward()
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    # forward and backward: MHA's output dropout; FFN's two dropouts and
    # two epilogues (linear1's activation, fused_linear's bias); the
    # encoder's three dropouts (act_dropout defaults to the rate) and its
    # epilogue; two masked softmaxes
    want = {"embedding": 0, "bias_act": 2 * (2 + 1),
            "dropout": 2 * (1 + 2 + 3), "softmax_mask": 4}
    finite = bool(torch.isfinite(out.float()).all()) and bool(
        torch.isfinite(xb.grad).all()) and bool(torch.isfinite(s.grad).all())
    require(launches == want and finite,
            f"incubate: launches {launches} (want {want}), finite {finite}")
    row = {"phase": "incubate_check", "seconds": time.monotonic() - t0,
           "card_vs_cpu_rel": agree, "launches": launches,
           "dropout_counter": int(rng.counter)}
    emit(row)
    del mha, ffn, enc, card, xb, s, out
    gc.collect()
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the fused inference stack: FusedMultiTransformer served through the engine
# ---------------------------------------------------------------------------

# benchmarks/bench_generation.py's defaults: --hidden 2560 --heads 20
# --inter 6912 --layers 22 --vocab 32000 --prompt 512 --tokens 64
# --max-len 1024 --page-size 64, buckets (1, 4, 16), 16 requests from
# default_rng(0), bf16 weights without AMP
FMT = dict(vocab=32000, hidden=2560, heads=20, inter=6912)
FMT_LAYERS, FMT_PROMPT, FMT_NEW, FMT_MAX_LEN, FMT_PS = 22, 512, 64, 1024, 64
FMT_BUCKETS, FMT_REQUESTS = (1, 4, 16), 16
# the bench's parity oracle (bench_generation.py:483-541) is the bs=1
# per-token dense reference run for each request alone, and its gate is a
# match on >= 0.75 of the request's tokens, since "a 1-ulp bf16 logit tie
# may flip an argmax". Run free, the reference leaves the engine's
# transcript at its first flip and follows another continuation, so the
# match of the rest says nothing of the engine. serve_fmt reports that
# free-running match and holds the engine to the same bs=1 reference fed
# the engine's own transcript (teacher forcing): at every position of
# every request the engine's logits, kept as it picked each token, against
# the reference's at the same context. Each request's picks equal the
# reference's on >= FMT_MATCH of its positions, and every pick that
# differs is a tie: the two sides' margins for their own picks sum to at
# most FMT_TIE_ULPS bf16 ulps of the row's largest logit. Each side rounds
# its two logits to bf16, half an ulp each, so two rows that agree before
# that rounding can prefer opposite tokens by 2 ulps in sum after it.
FMT_MATCH = 0.75
FMT_TIE_ULPS = 2
# The two logit rows of one context differ by rounding only: bf16 products
# in other orders (cuBLAS picks kernels by the batch, B6 against the dense
# branch), compounded through the residual stream, one bf16 rounding a
# layer as serve_prefix_7b's K/V check allows, and two more for the final
# LayerNorm and the head. A wrong page, position or weight is off by order
# 1. Held as ||engine - reference|| / ||reference|| at every position, at
# most (layers + 2) * KV_ROUNDING_PER_LAYER (fmt_parity).
# fmt_check holds a 2-layer fp32 prefill's outputs and caches on the card
# against the same weights on the CPU (plain versions), and the tail of a
# seq_offset prefill against the full causal prefill, each as
# ||a - b|| / ||b||: the card's and the CPU's fp32 sums differ by order
FMT_FP32_REL = 1e-5


def fmt_counters(fa, pa) -> dict:
    """The counters of the kernels on the FMT path, by kernel name."""
    c = step_counters()
    return {"flash_prefill": fa.launches, "paged_decode": pa.launches,
            **{k: c[k] for k in ("fused_norm", "bias_act", "embedding")}}


def fmt_per_call(layers: int) -> dict:
    """K1, K6 and K5 launches of one FMT prefill or decode step: two
    LayerNorms a layer and the final one; once a layer each the out
    projection's bias, linear1's bias with GELU and linear2's bias; the
    embedding."""
    return {"fused_norm": 2 * layers + 1, "bias_act": 3 * layers,
            "embedding": 1}


def require_fmt_launches(launches: dict, prefills: int, steps: int,
                         layers: int, what: str) -> None:
    want = {"flash_prefill": prefills * layers, "paged_decode": steps * layers,
            **{k: n * (prefills + steps)
               for k, n in fmt_per_call(layers).items()}}
    require(launches == want, f"{what}: launches {launches}, want {want} "
                              f"({prefills} prefills, {steps} steps)")


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@contextlib.contextmanager
def shadow_kernels(torch, record: dict):
    """Hold every eager launch of B1, B6, K1 and K6 against its plain
    version on the same inputs as it happens (``check_close`` or
    ``fused_close``, raising past the limit); ``record`` gathers each
    kernel's calls and largest error. A graph replay runs no Python, so
    only eager calls are held."""
    from paddle_tpu_torch.incubate import nn_functional as IF
    from paddle_tpu_torch.ops import bias_act as ba
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops import paged_attention as pa
    saved = (fa.flash_attention_fwd, pa.paged_attention, nn_ops.fused_norm,
             IF.bias_act)

    def note(name, err, shape):
        r = record.setdefault(name, {"calls": 0, "max_abs_err": 0.0,
                                     "shapes": []})
        r["calls"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if list(shape) not in r["shapes"]:
            r["shapes"].append(list(shape))

    def flash(*a, **k):
        out = saved[0](*a, **k)
        ref = fa.flash_attention_reference(*a, **k)
        what = f"fmt flash {tuple(a[0].shape)} over {a[1].shape[1]}"
        note("flash_prefill", check_close(torch, out, ref, "flash",
                                          what)["max_abs"],
             (*a[0].shape, a[1].shape[1]))
        return out

    def paged(*a, page_size):
        out = saved[1](*a, page_size=page_size)
        ref = pa.paged_attention_dense(*a, page_size)
        what = f"fmt paged {tuple(a[0].shape)} pool {a[3].dtype}"
        note("paged_decode", check_close(torch, out, ref, "paged",
                                         what)["max_abs"],
             (*a[0].shape, str(a[3].dtype)))
        return out

    def norm(x, weight=None, bias=None, residual=None, pre_bias=None, *,
             spec):
        out, h = saved[2](x, weight, bias, residual, pre_bias, spec=spec)
        ref, _ = fn.fused_norm_reference(x, weight, bias, residual, pre_bias,
                                         spec=spec)
        ok, err = fused_close(torch, out, ref, "out")
        require(ok, f"fmt layer norm {tuple(x.shape)}: {err} beyond "
                    f"FUSED_TOL")
        note("fused_norm", err, x.shape)
        return out, h

    def epilogue(y, b, spec):
        out = saved[3](y, b, spec)
        ok, err = fused_close(torch, out, ba.bias_act_reference(y, b, spec),
                              "out")
        require(ok, f"fmt bias_act {spec.act} {tuple(y.shape)}: {err} "
                    f"beyond FUSED_TOL")
        note(f"bias_act[{spec.act}]", err, y.shape)
        return out

    fa.flash_attention_fwd, pa.paged_attention = flash, paged
    nn_ops.fused_norm, IF.bias_act = norm, epilogue
    try:
        yield record
    finally:
        (fa.flash_attention_fwd, pa.paged_attention, nn_ops.fused_norm,
         IF.bias_act) = saved


def fmt_stack(torch, layers: int, dtype, seed: int):
    from paddle_tpu_torch.tools.fmt_stack import FMTStack
    return FMTStack(FMT["vocab"], FMT["hidden"], FMT["heads"], FMT["inter"],
                    layers, dtype=dtype, device="cuda", seed=seed)


def fmt_engine(stack, max_len: int, max_batch: int, buckets, kv_dtype: str,
               compute_dtype: str, causal: bool = False,
               prefix_sharing: str = "auto", callables=None,
               paged_attention: str = "auto"):
    from paddle_tpu_torch.serving import Engine, ServingConfig
    L, _, H, D = stack.cache_shape
    callables = callables or stack.serving_callables(causal=causal)
    return Engine(*callables, ServingConfig(
        num_layers=L, num_heads=H, head_dim=D, max_len=max_len,
        max_batch=max_batch, buckets=buckets, page_size=FMT_PS,
        kv_dtype=kv_dtype, compute_dtype=compute_dtype,
        prefix_sharing=prefix_sharing, device="cuda",
        paged_attention=paged_attention))


def fmt_check(torch, fa, pa, kvc) -> dict:
    """Two layers of the FMT stack at full width in fp32 on the card: the
    bidirectional prefill with every B1, K1 and K6 launch held against its
    plain version, its output and stacked cache against the CPU's;
    a causal prefill resumed at ``seq_offset`` 448 (B1 at Lq 64 over Lk
    512) against the full causal prefill; eight eager paged decode steps
    over bf16 and int8 pools with every B6 launch held against
    ``paged_attention_dense``; engine transcripts (decode graphs) against
    the per-token dense reference loop for 4 prompts; and each bucket's
    decode graph against an eager step (equal tokens, bit-equal pools),
    with B6, K1, K5 and K6 launches per replay."""
    import numpy as np
    from paddle_tpu_torch.ops.paged_attention import PagedDecodeCache
    from paddle_tpu_torch.tools.fmt_stack import FMTStack
    t0 = time.monotonic()
    L = 2
    stack = fmt_stack(torch, L, torch.float32, seed=1)
    _, _, H, D = stack.cache_shape
    rng = np.random.default_rng(4)
    n = FMT_PROMPT
    ids = torch.as_tensor(rng.integers(0, FMT["vocab"], (1, n)),
                          device="cuda")
    shape = (L, 2, 1, H, n, D)
    record = {}
    row = {"phase": "fmt_check", "layers": L, "dtype": "float32"}
    with torch.no_grad(), shadow_kernels(torch, record):
        # the bidirectional prefill (the engine's 2-argument prefill_fn)
        cache = torch.zeros(shape, device="cuda")
        out, _ = stack.fmt(stack.embed(ids), caches=cache)
        # the causal prefill, whole and resumed at a page-aligned offset
        full = torch.zeros(shape, device="cuda")
        out_full, _ = stack.fmt(stack.embed(ids), caches=full, seq_offset=0)
        off = n - FMT_PS
        tail = torch.zeros(shape, device="cuda")
        stack.fmt(stack.embed(ids[:, :off]), caches=tail, seq_offset=0)
        out_tail, _ = stack.fmt(stack.embed(ids[:, off:]), caches=tail,
                                seq_offset=off)
    torch.cuda.synchronize()
    cpu = FMTStack(FMT["vocab"], FMT["hidden"], FMT["heads"], FMT["inter"],
                   L, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in stack.state_dict().items()})
    with torch.no_grad():
        cache_cpu = torch.zeros(shape)
        out_cpu, _ = cpu.fmt(cpu.embed(ids.cpu()), caches=cache_cpu)
    del cpu
    agree = {"prefill_out": rel_err(out.cpu(), out_cpu),
             "prefill_cache": rel_err(cache.cpu(), cache_cpu),
             "tail_out": rel_err(out_tail, out_full[:, off:]),
             **{f"tail_kv_layer{i}": rel_err(tail[i, :, :, :, off:],
                                             full[i, :, :, :, off:])
                for i in range(L)}}
    require(all(e <= FMT_FP32_REL for e in agree.values()),
            f"fmt_check: prefill against the CPU or the tail against the full "
            f"causal prefill beyond {FMT_FP32_REL}: {agree}")
    held = {k: record.get(k, {}).get("calls") for k in (
        "flash_prefill", "fused_norm", "bias_act[none]",
        "bias_act[gelu_tanh]")}
    # four prefills: B1 and the GELU epilogue once a layer, the two
    # LayerNorms and the out projection's and linear2's biases twice
    require(held == {"flash_prefill": 4 * L, "fused_norm": 4 * 2 * L,
                     "bias_act[none]": 4 * 2 * L,
                     "bias_act[gelu_tanh]": 4 * L},
            f"fmt_check: prefill launches held {held}")
    row["prefill"] = {"rel_err": agree, "held": dict(record)}
    del cache, full, tail, cache_cpu, out_cpu
    # eight eager decode steps over bf16 and int8 pools, B6 held each time
    step_fn = stack.serving_callables()[1]
    lens = (100, 300, 512, 700)
    for leg in ("bf16", "int8"):
        record.clear()
        eng = fmt_engine(stack, FMT_MAX_LEN, 4, (4,), leg, "float32")
        rows, toks = [], []
        for ln in lens:
            pages = eng.kv.alloc(eng.kv.pages_for(ln + 8))
            rows.append(eng.kv.table_row(pages))
            toks.append(eng._prefill(rng.integers(0, FMT["vocab"], (ln,)),
                                     rows[-1]))
        tok = torch.tensor(toks, device="cuda")[:, None]
        tables = torch.as_tensor(np.stack(rows), device="cuda")
        t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        with torch.no_grad(), shadow_kernels(torch, record):
            for _ in range(8):
                view = PagedDecodeCache(eng.kv.pool, tables, t, FMT_PS,
                                        eng.kv.scales)
                tok, _ = step_fn(tok, view, t)
                t = t + 1
        torch.cuda.synchronize()
        held = {k: r["calls"] for k, r in record.items()}
        # eight steps: the final LayerNorm too, once a step
        require(held == {"paged_decode": 8 * L, "fused_norm": 8 * (2 * L + 1),
                         "bias_act[none]": 8 * 2 * L,
                         "bias_act[gelu_tanh]": 8 * L},
                f"fmt_check {leg}: decode launches held {held}")
        row[f"decode_{leg}"] = dict(record)
        del eng
    # the engine (decode and prefill graphs) against the per-token dense
    # reference
    prompts = [rng.integers(0, FMT["vocab"], (ln,), dtype=np.int32)
               for ln in (64, 200, 512, 333)]
    eng = fmt_engine(stack, FMT_MAX_LEN, 4, (1, 4), "native",
                     "float32").warmup([p.size for p in prompts])
    counters = fmt_counters(fa, pa)
    for c in counters.values():
        c.reset()
    _, results, stats = run_traffic(torch, eng, prompts, 16)
    launches = {k: c.count for k, c in counters.items()}
    refs = [stack.reference(p, 16, FMT_MAX_LEN) for p in prompts]
    same = [r.tokens == ref for r, ref in zip(results, refs)]
    require(all(same), f"fmt_check: engine tokens differ from the dense "
                       f"reference loop: {same}")
    require_fmt_launches(launches, 4, sum(stats["steps"].values()), L,
                         "fmt_check engine")
    require(sorted(stats["prefill_replays"].values()) == [1] * 4,
            f"fmt_check engine: prefill replays "
            f"{keyed(stats['prefill_replays'])}")
    require_prefill_replays(stats, 4, 0, "fmt_check engine")
    row["engine_vs_reference"] = {"prompt_lens": [len(p) for p in prompts],
                                  "new_tokens": 16, "equal": same,
                                  "decode_steps": stats["steps"],
                                  "prefill_replays":
                                      keyed(stats["prefill_replays"]),
                                  "launches": launches}
    del eng
    # each bucket's decode graph against an eager step, native and int8
    grng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda").manual_seed(5)
    graphs = []
    for leg in ("native", "int8"):
        eng = fmt_engine(stack, FMT_MAX_LEN, 16, FMT_BUCKETS, leg,
                         "float32").warmup()
        kv = eng.kv
        with torch.no_grad():
            x = torch.randn(kv.pool.shape, generator=gen, device="cuda")
            if leg == "int8":
                q8, sc = kvc.quantize_pages(x)
                kv.pool.copy_(q8)
                kv.scales.copy_(sc)
            else:
                kv.pool.copy_(x)
            del x
        s = kv.config.pages_per_slot
        for b in FMT_BUCKETS:
            tok, tables, t = decode_case(grng, b, s, FMT_PS,
                                         kv.config.num_pages, FMT["vocab"])
            res = graph_vs_eager(torch, pa, eng, step_fn, tok, tables, t)
            per_replay = {c.name: k for c, k in
                          eng.decode_graph(b).launches.items()}
            want = {"paged_decode_attention": L,
                    **fmt_per_call(L)}
            require(res["tokens_equal"] and res["pools_equal"]
                    and res["launches"] == L and per_replay == want,
                    f"fmt decode graph {leg} bucket {b}: {res}, launches "
                    f"per replay {per_replay} (want {want})")
            graphs.append({"pool": leg, "bucket": b, **res,
                           "launches_per_replay": per_replay})
        del eng, kv
        gc.collect()
        torch.cuda.empty_cache()
    row["graph_vs_eager"] = graphs
    row["seconds"] = time.monotonic() - t0
    emit(row)
    del stack
    gc.collect()
    torch.cuda.empty_cache()
    return row


def fmt_decode_bound(stack, rows: int, t: int):
    """Least time of one decode step of ``rows`` rows at context ``t``:
    every weight but the embedding's read once, and each row's live K/V
    of every layer, over the card's memory rate (ms)."""
    L, two, H, D = stack.cache_shape
    weights = sum(p.numel() * p.element_size()
                  for n, p in stack.named_parameters()
                  if not n.startswith("embed."))
    kv = rows * (t + 1) * L * two * H * D * stack.embed.weight.element_size()
    return (weights + kv) / HBM_BYTES_PER_S * 1e3, weights, kv


def serve_fmt(torch, card, fa, pa) -> dict:
    """``bench_generation.py --serving`` at its defaults on the port: the
    22-layer bf16 FMT stack (random weights from seed 0) through the
    engine, 16 requests of 512 prompt tokens and 64 new ones, buckets (1,
    4, 16), page 64, max_len 1024. A warm pass, then three timed runs
    (tok/s, TTFT, TPOT, peak memory, launches counted from 0 in each);
    a bucket-16 replay timed at 16 live rows of 560 positions beside its
    byte bound, with its device time by kernel family; the traffic once
    more under ``torch.profiler`` (``serve_fmt_profile``); the first
    run's transcripts against the bs=1 per-token dense reference
    (:func:`fmt_parity`); then the bench's prefix leg at 90% overlap (8
    requests of 512 tokens sharing 448, 8 new tokens), sharing on and
    off: prompt tokens computed against requested, and equal
    transcripts."""
    import numpy as np
    t0 = time.monotonic()
    stack = fmt_stack(torch, FMT_LAYERS, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in stack.parameters())
    t0 = time.monotonic()
    eng = fmt_engine(stack, FMT_MAX_LEN, FMT_REQUESTS, FMT_BUCKETS,
                     "native", "bfloat16").warmup([FMT_PROMPT])
    warmup_s = time.monotonic() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, FMT["vocab"], (FMT_PROMPT,), dtype=np.int32)
               for _ in range(FMT_REQUESTS)]
    counters = fmt_counters(fa, pa)
    run_traffic(torch, eng, prompts, FMT_NEW)             # the warm pass
    runs = []
    for i in range(SERVE_RUNS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        wall, results, stats = run_traffic(torch, eng, prompts, FMT_NEW)
        launches = {k: c.count for k, c in counters.items()}
        steps = sum(stats["steps"].values())
        for r in results:
            require(len(r.tokens) == FMT_NEW and all(
                0 <= x < FMT["vocab"] for x in r.tokens),
                f"serve_fmt run {i + 1}: request {r.request_id}: "
                f"{r.tokens}")
        require(sum(stats["replays"].values()) == steps > 0,
                f"serve_fmt run {i + 1}: {steps} steps, replays "
                f"{stats['replays']}")
        require_prefill_replays(stats, FMT_REQUESTS, 0,
                                f"serve_fmt run {i + 1}",
                                keys=[(0, FMT_PROMPT)])
        require_fmt_launches(launches, FMT_REQUESTS, steps, FMT_LAYERS,
                             f"serve_fmt run {i + 1}")
        require(eng.kv.outstanding_pages == 0,
                f"serve_fmt run {i + 1}: pages leaked")
        runs.append({**serving_numbers(results, wall), "decode_steps": steps,
                     "batch_sizes": stats["steps"],
                     "graph_replays": stats["replays"],
                     "prefill_replays": keyed(stats["prefill_replays"]),
                     "launches": launches, **memory_gb(torch)})
        if i == 0:
            main_launches, main_results = launches, results
    spread = {k: [min(r[k] for r in runs), max(r[k] for r in runs)]
              for k in ("tokens_per_s", "ttft_median_s", "tpot_median_s")}
    # one bucket-16 replay at 16 live rows of 560 positions
    g = eng.decode_graph(16)
    per_slot = -(-(560 + 1) // FMT_PS)
    tables = np.zeros((16, eng.kv.config.pages_per_slot), np.int32)
    tables[:, :per_slot] = 1 + np.arange(16 * per_slot).reshape(16, per_slot)
    g.load(np.asarray(prompts)[:, :1].astype(np.int64), tables,
           np.full((16,), 560, np.int32))
    replay_ms = cuda_ms(torch, g.replay, 20)
    bound_ms, wbytes, kvbytes = fmt_decode_bound(stack, 16, 560)
    # where a replay's device time goes (replayed kernels keep their names)
    n = 5
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            g.replay()
        torch.cuda.synchronize()
    replay_fams = families([e for e in prof.key_averages()
                            if e.device_type == torch.autograd.DeviceType.CUDA
                            and device_us(e) > 0], per=n)
    emit({"phase": "serve_fmt", "card": card, "layers": FMT_LAYERS,
          "params": n_params, "dtype": "bfloat16", **FMT,
          "requests": FMT_REQUESTS, "prompt_len": FMT_PROMPT,
          "new_tokens": FMT_NEW, "max_len": FMT_MAX_LEN,
          "page_size": FMT_PS, "buckets": list(FMT_BUCKETS),
          "decode": "cuda_graph_per_bucket", "prefill": PREFILL,
          "warmup_s": warmup_s, **prefill_graph_counts(eng.decode_stats()),
          "runs": runs,
          "spread_min_max": spread,
          "peak_mem_gb": max(r["peak_mem_gb"] for r in runs),
          "peak_reserved_gb": max(r["peak_reserved_gb"] for r in runs),
          "replay_b16_t560": {"ms": replay_ms, "bound_ms": bound_ms,
                              "weight_bytes": wbytes, "kv_bytes": kvbytes,
                              "families_per_replay": replay_fams,
                              "launches_per_replay": {
                                  c.name: k for c, k in g.launches.items()}},
          "weights_init_s": init_s})
    profile_serving(torch, card, eng, prompts, runs[0]["wall_s"],
                    new_tokens=FMT_NEW, layers=FMT_LAYERS,
                    phase="serve_fmt_profile")
    del eng, g
    gc.collect()
    torch.cuda.empty_cache()
    serve_fmt_first_use(torch, card, fa, pa, stack, prompts)
    fmt_parity(torch, card, stack, prompts,
               [r.tokens for r in main_results])
    prefix = serve_fmt_prefix(torch, card, fa, pa, stack)
    fmt_prefill_graph_check(torch, card, stack)
    del stack
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve_run1": main_launches, **prefix}


def serve_fmt_first_use(torch, card, fa, pa, stack, prompts) -> None:
    """serve_fmt's traffic once on a fresh engine whose ``warmup()`` was
    given no prompt length: the first admission captures the pool's primer
    and the 512-token key, with the requests behind it waiting."""
    from paddle_tpu_torch.serving.engine import _WARM_STEPS
    t0 = time.monotonic()
    eng = fmt_engine(stack, FMT_MAX_LEN, FMT_REQUESTS, FMT_BUCKETS,
                     "native", "bfloat16").warmup()
    warmup_s = time.monotonic() - t0
    counters = fmt_counters(fa, pa)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    wall, results, stats = run_traffic(torch, eng, prompts, FMT_NEW)
    launches = {k: c.count for k, c in counters.items()}
    steps = sum(stats["steps"].values())
    require(all(len(r.tokens) == FMT_NEW for r in results)
            and sum(stats["replays"].values()) == steps > 0,
            f"serve_fmt_first_use: {steps} steps, replays {stats['replays']}")
    require_prefill_replays(stats, FMT_REQUESTS, 2, "serve_fmt_first_use",
                            keys=[(0, FMT_PROMPT)])
    # the warm-up calls before the capture launch as prefills do
    require_fmt_launches(
        launches, FMT_REQUESTS + _WARM_STEPS * stats["prefill_graphs"],
        steps, FMT_LAYERS, "serve_fmt_first_use")
    emit({"phase": "serve_fmt_first_use", "card": card,
          "warmed_prompt_lens": [], "prefill": PREFILL,
          **serving_numbers(results, wall), "decode_steps": steps,
          "prefill_replays": keyed(stats["prefill_replays"]),
          "captured_in_run": prefill_graph_counts(stats),
          "warmup_s": warmup_s, "launches": launches, **memory_gb(torch)})
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``x`` (8 significant bits)."""
    return 2.0 ** (math.frexp(abs(x))[1] - 8) if x else 2.0 ** -133


def fmt_kept_logits(torch, stack, prompts, n_new: int,
                    paged_attention: str = "auto"):
    """The traffic once more, through an engine whose callables keep the
    logits each token is picked from (the graphs capture the keeping: a
    bucket's or a prompt length's kept logits are its graph's output).
    After each prefill and replay the rows are copied out to their
    requests, a replay's rows matched to the live slots by page table.
    Returns per prompt the transcript and its logits ``(n_new, V)``
    fp32."""
    import numpy as np
    kept = {}

    def prefill_fn(ids, cache):
        key = ("prefill", ids.shape[1])
        kept[key], cache = stack.prefill_logits(ids, cache)
        return stack.greedy(kept[key]), cache

    def step_fn(tok, cache, t):
        kept[tok.shape[0]], cache = stack.step_logits(tok, cache, t)
        return stack.greedy(kept[tok.shape[0]]), cache

    eng = fmt_engine(stack, FMT_MAX_LEN, FMT_REQUESTS, FMT_BUCKETS,
                     "native", "bfloat16", callables=(prefill_fn, step_fn),
                     paged_attention=paged_attention)
    eng.warmup([FMT_PROMPT])
    index = {np.asarray(p, np.int64).tobytes(): i
             for i, p in enumerate(prompts)}
    rows = [[] for _ in prompts]
    prefill, decode = eng._prefill, eng._decode

    def keep_prefill(prompt, row, start=0):
        tok = prefill(prompt, row, start)
        rows[index[np.asarray(prompt, np.int64).tobytes()]].append(
            kept["prefill", prompt.size].reshape(-1).float())
        return tok

    def keep_decode(tok, tables, t):
        nxt = decode(tok, tables, t)
        out = kept[tok.shape[0]]
        for slot in list(eng._slots):
            hit = np.flatnonzero((tables == slot.table_row).all(axis=1))
            if hit.size:
                key = np.asarray(slot.request.prompt, np.int64).tobytes()
                rows[index[key]].append(out[hit[0]].reshape(-1).float())
        return nxt

    eng._prefill, eng._decode = keep_prefill, keep_decode
    _, results, _ = run_traffic(torch, eng, prompts, n_new)
    del eng
    return ([r.tokens for r in results],
            [torch.stack(r) for r in rows])


def fmt_parity(torch, card, stack, prompts, served, layers: int = FMT_LAYERS,
               phase: str = "serve_fmt_parity",
               paged_attention: str = "auto") -> dict:
    """``served`` (the first timed run's transcripts) against the bs=1
    per-token dense reference: run free, as the bench compares
    (match and first difference a request), and fed the engine's own
    transcript, each position's logits against the engine's kept ones
    (``FMT_MATCH``, ``FMT_TIE_ULPS`` and the relative logits limit of
    ``layers`` layers). Every pick that differs is listed with both
    sides' margins, the largest difference of the two rows, and the bf16
    ulp at the reference row's largest logit. ``paged_attention``: the
    decode tier of the engine that keeps its logits."""
    t0 = time.monotonic()
    logits_rel = (layers + 2) * KV_ROUNDING_PER_LAYER
    free = [stack.reference(p, FMT_NEW, FMT_MAX_LEN) for p in prompts]
    tokens, engine = fmt_kept_logits(torch, stack, prompts, FMT_NEW,
                                     paged_attention)
    require(tokens == served, f"{phase}: the engine that keeps its "
                              f"logits gave other transcripts than run 1")
    per_request, flips = [], []
    for i, (p, toks, e_lg) in enumerate(zip(prompts, tokens, engine)):
        r_lg = stack.reference_logits(p, toks, FMT_MAX_LEN)
        require(e_lg.shape == r_lg.shape == (FMT_NEW, FMT["vocab"]),
                f"{phase}: request {i}: logits {e_lg.shape}")
        e = torch.tensor(toks, device=e_lg.device)
        require(torch.equal(e_lg.argmax(dim=1), e),
                f"{phase}: request {i}: the kept logits do not "
                f"give the engine's tokens")
        a = r_lg.argmax(dim=1)
        diff = e_lg - r_lg
        rel = (diff.norm(dim=1) / r_lg.norm(dim=1)).tolist()
        spread = diff.abs().amax(dim=1).tolist()
        first_free = next((j for j, (x, y) in enumerate(zip(toks, free[i]))
                           if x != y), None)
        for j in (a != e).nonzero().reshape(-1).tolist():
            ai, ei = int(a[j]), int(e[j])
            top = float(r_lg[j].max())
            flips.append({
                "request": i, "position": j, "engine_token": ei,
                "reference_token": ai,
                "reference_margin": float(r_lg[j, ai] - r_lg[j, ei]),
                "engine_margin": float(e_lg[j, ei] - e_lg[j, ai]),
                "largest_difference": spread[j],
                "reference_max_logit": top, "bf16_ulp": bf16_ulp(top)})
        mine = [f["position"] for f in flips if f["request"] == i]
        per_request.append({
            "free_match": sum(x == y for x, y in zip(toks, free[i]))
            / FMT_NEW,
            "free_first_difference": first_free,
            "forced_match": 1 - len(mine) / FMT_NEW,
            "forced_first_difference": mine[0] if mine else None,
            "logits_rel_err_max": max(rel),
            "logits_largest_difference_max": max(spread)})
    for f in flips:
        f["tie"] = f["reference_margin"] + f["engine_margin"] \
            <= FMT_TIE_ULPS * f["bf16_ulp"]
    row = {"phase": phase, "card": card,
           "layers": layers, "dtype": "bfloat16",
           "decode_tier": paged_attention,
           "match_limit": FMT_MATCH, "logits_rel_limit": logits_rel,
           "tie_limit_ulps": FMT_TIE_ULPS,
           "requests": per_request, "flips": flips,
           "seconds": time.monotonic() - t0}
    emit(row)
    for i, r in enumerate(per_request):
        require(r["free_first_difference"] == r["forced_first_difference"],
                f"{phase}: request {i}: the fed reference departs "
                f"from the free one before the engine does: {r}")
        require(r["forced_match"] >= FMT_MATCH
                and r["logits_rel_err_max"] <= logits_rel,
                f"{phase}: request {i} against the bs=1 "
                f"reference at the engine's context: {r}")
    require(all(f["tie"] for f in flips),
            f"{phase}: picks that differ by more than a tie: "
            f"{[f for f in flips if not f['tie']]}")
    return row


def serve_fmt_prefix(torch, card, fa, pa, stack) -> dict:
    """The bench's prefix-sharing leg at 90% overlap
    (``bench_generation.py:970-1010``): 8 requests of 512 tokens, a common
    448-token prefix and fresh tails, 8 new tokens, max_batch 4, through
    the causal prefill; a warm drain (its own tails) seeds the index, the
    measured drain shares the base chain. Sharing on, then off."""
    import numpy as np
    n_req, n_new = 8, 8
    max_len = -(-(FMT_PROMPT + n_new + 2) // FMT_PS) * FMT_PS
    rng = np.random.default_rng(3)
    shared = int(0.9 * FMT_PROMPT) // FMT_PS * FMT_PS
    base = rng.integers(0, FMT["vocab"], (shared,), dtype=np.int32)

    def make_prompts():
        return [np.concatenate([base, rng.integers(
            0, FMT["vocab"], (FMT_PROMPT - shared,), dtype=np.int32)])
            for _ in range(n_req)]
    warm, measured = make_prompts(), make_prompts()
    counters = fmt_counters(fa, pa)
    legs, transcripts, launches_by = {}, {}, {}
    for mode in ("on", "off"):
        eng = fmt_engine(stack, max_len, 4, (1, 4), "native", "bfloat16",
                         causal=True, prefix_sharing=mode).warmup(
                             [FMT_PROMPT])
        run_traffic(torch, eng, warm, n_new)
        req0, comp0 = eng.prefill_token_stats()
        for c in counters.values():
            c.reset()
        wall, results, stats = run_traffic(torch, eng, measured, n_new)
        req1, comp1 = eng.prefill_token_stats()
        launches = {k: c.count for k, c in counters.items()}
        require_fmt_launches(launches, n_req, sum(stats["steps"].values()),
                             FMT_LAYERS, f"serve_fmt prefix {mode}")
        require_prefill_replays(stats, n_req, 0, f"serve_fmt prefix {mode}")
        transcripts[mode] = [r.tokens for r in results]
        launches_by[f"prefix_{mode}"] = launches
        legs[mode] = {**serving_numbers(results, wall),
                      "prompt_tokens_requested": req1 - req0,
                      "prompt_tokens_computed": comp1 - comp0,
                      "prefills": stats["prefills"],
                      "prefill_replays": keyed(stats["prefill_replays"]),
                      "launches": launches}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    equal = transcripts["on"] == transcripts["off"]
    emit({"phase": "serve_fmt_prefix", "card": card, "overlap": 0.9,
          "shared_tokens": shared, "requests": n_req, "new_tokens": n_new,
          "max_len": max_len, "legs": legs, "transcripts_equal": equal,
          "first_difference": [next((i for i, (a, b) in enumerate(zip(
              x, y)) if a != b), None) for x, y in zip(
              transcripts["on"], transcripts["off"])]})
    require(legs["on"]["prefills"] == {"tail": n_req},
            f"serve_fmt prefix: sharing on prefilled {legs['on']['prefills']}")
    require(equal, "serve_fmt prefix: transcripts differ between prefix "
                   "sharing on and off")
    return launches_by


def fmt_kernel_times(torch, fa, pa, kvc) -> dict:
    """The path's kernels at the FMT serving shapes, each held against its
    plain version and timed beside its bound, plain version and library
    call: B1 over the 512-token bidirectional prefill (1, 512, 20, 128)
    and the prefix leg's tail (Lq 64 over Lk 512, causal), B6 at bucket 16
    with 20 heads (rep 1) at t = 560 on bf16 and int8 pools, K1's
    LayerNorm over the prefill's (512, 2560) and K6's bias + GELU (tanh)
    over its (512, 6912), all bf16."""
    import numpy as np
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops import bias_act as ba
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import nn_ops
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16
    H, D, E, F = FMT["heads"], 128, FMT["hidden"], FMT["inter"]
    rows = {}
    for name, lq, lk, causal in (("flash_prefill", 512, 512, False),
                                 ("flash_prefill_tail", 64, 512, True)):
        q = torch.randn(1, lq, H, D, generator=gen, device="cuda", dtype=bf)
        k, v = (torch.randn(1, lk, H, D, generator=gen, device="cuda",
                            dtype=bf) for _ in range(2))
        out = fa.flash_attention_fwd(q, k, v, causal=causal)
        ref = fa.flash_attention_reference(q, k, v, causal=causal)
        err = check_close(torch, out, ref, "flash", f"fmt {name}")
        mask = torch.ones(lq, lk, dtype=torch.bool, device="cuda").tril(
            lk - lq) if causal else None
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        bms, by = bound(*fa.attention_cost("fwd", 1, lq, lk, H, H, D, 2,
                                           causal), "bfloat16")
        rows[name] = {
            "case": f"(1, {lq}, {H}, {D}) over {lk} bf16"
                    f"{' causal' if causal else ''}",
            "max_abs_err": err["max_abs"], "tile_rel_err": err["tile_rel"],
            "ms": cuda_ms(torch, lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal), 20),
            "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_reference(
                q, k, v, causal=causal), 3, warmup=1),
            "library_ms": cuda_ms(
                torch, lambda: TF.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask), 20),
            **graph_pair(torch, lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal),
                lambda: TF.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask)),
            "bound_ms": bms, "bound_by": by}
    rng = np.random.default_rng(6)
    for leg in ("bf16", "int8"):
        case = paged_case(torch, kvc, gen, rng, (560,) * 16, H, H, leg, bf,
                          s=FMT_MAX_LEN // FMT_PS)
        args = case["args"]
        out = pa.paged_attention(*args, page_size=FMT_PS)
        ref = pa.paged_attention_dense(*args, page_size=FMT_PS)
        err = check_close(torch, out, ref, "paged", f"fmt paged {leg}")
        lib = paged_sdpa(torch, case)
        bms, by = bound(case["flops"], case["nbytes"], "bfloat16")
        rows[f"paged_decode_{leg}"] = {
            "case": f"bucket 16, {H} heads (rep 1), D {D}, t 560, page "
                    f"{FMT_PS}, {leg} pool, bf16 q",
            "max_abs_err": err["max_abs"],
            "ms": cuda_ms(torch, lambda: pa.paged_attention(
                *args, page_size=FMT_PS), 20),
            "plain_ms": cuda_ms(torch, lambda: pa.paged_attention_dense(
                *args, page_size=FMT_PS), 3, warmup=1),
            "library_ms": cuda_ms(torch, lib, 20),
            **graph_pair(torch, lambda: pa.paged_attention(
                *args, page_size=FMT_PS), lib),
            "bound_ms": bms, "bound_by": by}
        del case, args, lib
    x = torch.randn(512, E, generator=gen, device="cuda").to(bf)
    w, b = (torch.randn(E, generator=gen, device="cuda").to(bf)
            for _ in range(2))
    spec = nn_ops._norm_spec("layer_norm", "ln", x, w, b, None, 1e-5, 1)
    out = nn_ops.layer_norm(x, E, w, b)
    ok, err = fused_close(torch, out, fn.fused_norm_reference(
        x, w, b, spec=spec)[0], "out")
    require(ok, f"fmt layer norm (512, {E}) bf16: {err}")
    bms, by = bound(0, nbytes(x, w, b, out), "bfloat16")
    rows["fused_norm"] = {
        "case": f"LayerNorm (512, {E}) bf16, weight and bias",
        "max_abs_err": err, **fused_timing(
            torch, lambda: nn_ops.layer_norm(x, E, w, b),
            lambda: fn.fused_norm_reference(x, w, b, spec=spec),
            lambda: TF.layer_norm(x, (E,), w, b)),
        "bound_ms": bms, "bound_by": by}
    for n_rows in (512, 16):
        y = torch.randn(n_rows, F, generator=gen, device="cuda").to(bf)
        bias = torch.randn(F, generator=gen, device="cuda").to(bf)
        aspec = ba.ActSpec("gelu_tanh", bf, bf)
        out = ba.bias_act(y, bias, aspec)
        ok, err = fused_close(torch, out, ba.bias_act_reference(
            y, bias, aspec), "out")
        require(ok, f"fmt bias_act ({n_rows}, {F}): {err}")
        bms, by = bound(0, nbytes(y, bias, out), "bfloat16")
        rows[f"bias_act_{n_rows}"] = {
            "case": f"y ({n_rows}, {F}) bf16 + bias, GELU tanh",
            "max_abs_err": err, **fused_timing(
                torch, lambda: ba.bias_act(y, bias, aspec),
                lambda: ba.bias_act_reference(y, bias, aspec),
                lambda: TF.gelu(y + bias, approximate="tanh")),
            "bound_ms": bms, "bound_by": by}
    emit({"phase": "fmt_kernel_times", **rows})
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Mixture-of-Experts: K9 (moe_route), K6's bias period, at AI21-Jamba2-Mini's
# expert widths
# ---------------------------------------------------------------------------

# https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/config.json:
# hidden 4096, intermediate_size 14336, 16 experts, 2 per token (its experts
# are SiLU-gated; the JAX package's are Linear -> act -> Linear, so only the
# widths, the expert count and top-2 are taken)
JAMBA2 = dict(hidden=4096, inter=14336, experts=16, top_k=2)
MOE_BATCH, MOE_SEQ = 4, 2048          # 8192 tokens: capacity 1536 (cf 1.5)
MOE_WARM, MOE_TIMED = 2, 4
MOE_ITERS = 10
# K9 against its plain version: every output bit for bit (the same fp32
# operations in the same order, the same roundings) except the gate
# gradient, an fp32 dot over the row summed in another order: held within
# MOE_DGATE_RTOL of the largest |dgate|.
MOE_DGATE_RTOL = 1e-5
# moe_vs_cpu: fp32 card against CPU; cuBLAS and MKL sum the products in
# other orders: outputs and gradients within 1e-4 of each tensor's largest
# element.
MOE_CPU_RTOL = 1e-4
MOE_REPLACES = {"moe_dispatch": "paddle_tpu/incubate/moe.py:153",
                "moe_combine": "paddle_tpu/incubate/moe.py:169"}


def moe_counters() -> dict:
    from paddle_tpu_torch.ops import moe
    return {"moe_dispatch": moe.launches_dispatch,
            "moe_combine": moe.launches_combine}


def moe_path_counters() -> dict:
    """K1, K6, K9 and the multi-tensor AdamW: the MoE phases' kernels."""
    from paddle_tpu_torch.ops import multi_tensor_adam
    return {**moe_counters(), **step_counters(),
            "multi_tensor_adam": multi_tensor_adam.launches}


def counts_of(counters: dict) -> dict:
    return {k: c.count for k, c in counters.items() if c.count}


def reset_counts(counters: dict) -> None:
    for c in counters.values():
        c.reset()


def moe_token_choice(torch, K9, gen, tokens: int, cap: int):
    """A GShard top-2 routing of ``tokens`` over JAMBA2's experts at
    capacity ``cap``, expert 0 favoured so that its queue overflows (some
    routes dropped)."""
    from paddle_tpu_torch.incubate.moe import top_k
    e, k = JAMBA2["experts"], JAMBA2["top_k"]
    logits = torch.randn(tokens, e, device="cuda", generator=gen)
    logits[:, 0] += 1.5
    probs = torch.softmax(logits, -1)
    topv, topi = top_k(probs, k)
    oh = torch.nn.functional.one_hot(topi.t().reshape(-1), e)
    pos = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1).reshape(k, tokens).t()
    keep = pos < cap
    gates = topv * keep
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return K9.token_choice_routes(topi, pos, keep, e, cap), gates.reshape(-1)


def moe_expert_choice(torch, K9, gen, tokens: int, dt):
    from paddle_tpu_torch.incubate.moe import top_k
    e = JAMBA2["experts"]
    probs = torch.softmax(torch.randn(tokens, e, device="cuda",
                                      generator=gen), -1).to(dt)
    w, sel = top_k(probs.t(), max(tokens // e, 1))
    routes, perm = K9.expert_choice_routes(sel, tokens)
    return routes, w.reshape(-1)[perm].float()


def moe_case(torch, K9, gen, kind: str, dt):
    """The routing, inputs and roundings of one K9 case at the MoE phases'
    shapes: ``token_choice`` (MoELayer: fp32 sums, output in ``dt`` as O2
    casts it or fp32) or ``expert_choice`` (FusedEcMoe: bias, every add
    rounded to ``dt``)."""
    h = JAMBA2["hidden"]
    t = MOE_BATCH * MOE_SEQ
    if kind == "token_choice":
        routes, gate = moe_token_choice(torch, K9, gen, t, 1536)
        gate = gate.to(dt).float()
        bias, acc = None, torch.float32
        spec = K9.CombineSpec(None, torch.float32, torch.float32, dt)
    else:
        routes, gate = moe_expert_choice(torch, K9, gen, t, dt)
        bias = torch.randn(routes.experts, h, device="cuda",
                           generator=gen).to(dt)
        acc = dt
        spec = K9.CombineSpec(dt, dt, dt, dt)
    x = torch.randn(t, h, device="cuda", generator=gen).to(dt)
    y = torch.randn(routes.slots, h, device="cuda", generator=gen).to(dt)
    dout = torch.randn(t, h, device="cuda", generator=gen).to(spec.out)
    dy = torch.randn(routes.slots, h, device="cuda", generator=gen).to(dt)
    return dict(routes=routes, gate=gate, bias=bias, acc=acc, spec=spec,
                x=x, y=y, dout=dout, dy=dy, dt=dt)


def moe_dispatch_spec(K9, c):
    """The dispatch backward's sum: fp32 or every add rounded (``acc``),
    written in the tokens' dtype."""
    return K9.CombineSpec(None, c["acc"], c["acc"], c["dt"])


def moe_kernel_fns(K9, c, fns=None):
    """The four K9 calls of a case, each returning its outputs by name."""
    r, s = c["routes"], c["spec"]
    return {
        "dispatch_fwd": lambda: {"rows": K9._launch_rows(
            c["x"], r, None, None, None, c["dt"], None, fns)[0]},
        "dispatch_bwd": lambda: {"dx": K9._launch_gather(
            c["dy"], r, None, None, moe_dispatch_spec(K9, c), fns)},
        "combine_fwd": lambda: {"out": K9._launch_gather(
            c["y"], r, c["gate"], c["bias"], s, fns)},
        "combine_bwd": lambda: dict(zip(("dy", "dgate"), K9._launch_rows(
            c["dout"], r, c["gate"], c["y"], c["bias"], c["dt"], s.h,
            fns)))}


def moe_plain_fns(K9, c):
    r, s = c["routes"], c["spec"]
    return {
        "dispatch_fwd": lambda: {"rows": K9.slot_rows_reference(
            c["x"], r, None, None, None, c["dt"])[0]},
        "dispatch_bwd": lambda: {"dx": K9.gather_sum_reference(
            c["dy"], r, None, None, moe_dispatch_spec(K9, c))},
        "combine_fwd": lambda: {"out": K9.gather_sum_reference(
            c["y"], r, c["gate"], c["bias"], s)},
        "combine_bwd": lambda: dict(zip(("dy", "dgate"),
                                        K9.slot_rows_reference(
            c["dout"], r, c["gate"], c["y"], c["bias"], c["dt"], s.h)))}


def moe_library_fns(torch, c):
    """One PyTorch call beside each K9 call, a yardstick only (the port
    never calls them): index_select of the routed rows, index_add_ of the
    weighted rows (weighted beforehand, outside the timing), index_add_ of
    the slots' rows, index_select of the output gradient's rows."""
    r = c["routes"]
    live = r.slot_route >= 0
    slot_tok = torch.where(live, r.route_token.long()[
        r.slot_route.long().clamp(min=0)], 0)
    yw = c["y"].float() * torch.where(live, c["gate"][
        r.slot_route.long().clamp(min=0)], 0.0)[:, None]
    h = c["x"].shape[1]
    out = torch.zeros(r.tokens, h, device="cuda")
    dx = torch.zeros(r.tokens, h, device="cuda", dtype=c["dy"].dtype)
    return {"dispatch_fwd": lambda: c["x"].index_select(0, slot_tok),
            "dispatch_bwd": lambda: dx.index_add_(0, slot_tok, c["dy"]),
            "combine_fwd": lambda: out.index_add_(0, slot_tok, yw),
            "combine_bwd": lambda: c["dout"].index_select(0, slot_tok)}


def moe_bytes(torch, c) -> dict:
    """Bytes each K9 call must move for this routing: the token rows it
    reads (tokens with a live route) or writes (all tokens), the live slot
    rows it reads, the slot rows it writes, the routing table and gates."""
    r = c["routes"]
    h = c["x"].shape[1]
    n_live = int((r.slot >= 0).sum())
    toks = int((torch.bincount(r.route_token.long()[r.slot >= 0],
                               minlength=r.tokens) > 0).sum())
    it, ot = c["x"].element_size(), c["y"].element_size()
    idx = 4 * (r.ptr.numel() + r.slot.numel() + r.slot_route.numel()
               + r.route_token.numel())
    g = 4 * r.slot.numel()
    b = 0 if c["bias"] is None else nbytes(c["bias"])
    so = c["spec"].out.itemsize
    return {"dispatch_fwd": toks * h * it + r.slots * h * ot + idx,
            "dispatch_bwd": n_live * h * ot + r.tokens * h * it + idx,
            "combine_fwd": n_live * h * ot + b + g + r.tokens * h * so + idx,
            "combine_bwd": toks * h * so + 2 * n_live * h * ot + b + 2 * g
            + (r.slots - n_live) * h * ot + idx}


def moe_compare(torch, got: dict, ref: dict, what: str) -> dict:
    """Bit for bit, but dgate within MOE_DGATE_RTOL; returns the errors."""
    errs = {}
    for k, r in ref.items():
        o = got[k]
        require(o.shape == r.shape and o.dtype == r.dtype,
                f"{what}: {k} is {o.dtype} {tuple(o.shape)}, want {r.dtype} "
                f"{tuple(r.shape)}")
        d = float((o.float() - r.float()).abs().max()) if o.numel() else 0.0
        errs[k] = d
        if k == "dgate":
            lim = MOE_DGATE_RTOL * float(r.abs().max())
            require(d <= lim and bool(torch.isfinite(o).all()),
                    f"{what}: dgate off by {d} > {lim}")
        else:
            require(bool(torch.equal(o, r)), f"{what}: {k} is not bit-equal "
                                             f"to the plain version ({d})")
    return errs


def check_moe_route(torch, K9, planted_lib, gen) -> dict:
    """K9's four calls at the MoE phases' shapes, token choice (O2 bf16
    and fp32) and expert choice (bf16 and fp32)."""
    bf, f32 = torch.bfloat16, torch.float32
    cases, err, timing = [], 0.0, {}
    for kind in ("token_choice", "expert_choice"):
        for dt in (bf, f32):
            c = moe_case(torch, K9, gen, kind, dt)
            kfns, pfns = moe_kernel_fns(K9, c), moe_plain_fns(K9, c)
            errs = {}
            for name in kfns:
                errs.update({f"{name}.{k}": v for k, v in moe_compare(
                    torch, kfns[name](), pfns[name](),
                    f"moe_route {kind} {dtype_name(dt)} {name}").items()})
            err = max(err, *errs.values())
            dropped = float((c["routes"].slot < 0).float().mean())
            cases.append({"case": f"{kind}_{dtype_name(dt)}",
                          "dropped_route_share": dropped, "errs": errs})
            if dt != bf:
                continue
            for name, fn in kfns.items():
                fused_repeat_equal(torch, fn, f"moe_route {kind} {name}")
            libs = moe_library_fns(torch, c)
            nb_ = moe_bytes(torch, c)
            tm = {}
            for name in kfns:
                tm[name] = fused_timing(torch, kfns[name], pfns[name],
                                        libs[name], MOE_ITERS)
                tm[name]["bound_ms"], tm[name]["bound_by"] = bound(
                    0, nb_[name], "bfloat16")
            if kind == "token_choice":
                # the planted copy skips each token's second route
                ref = pfns["combine_fwd"]()
                planted = planted_differs(torch, moe_kernel_fns(
                    K9, c, K9.bind(planted_lib))["combine_fwd"](), ref,
                    "moe_route planted combine")
                tm["planted_max_abs_err"] = planted["max_abs_err"]
            timing[kind] = tm
    return {"cases": cases, "max_abs_err": err, "timing": timing}


def check_bias_period(torch, ba, gen) -> dict:
    """K6 with a bias period at FusedEcMoe's first product: y (E C, I) =
    (8192, 14336) bf16, b (16, 1, 14336), GELU tanh, period C = 512:
    forward and input gradient within FUSED_TOL ``out``, bias gradient
    ``sum``; three launches bit-equal; times."""
    e, i = JAMBA2["experts"], JAMBA2["inter"]
    cap = MOE_BATCH * MOE_SEQ // e
    y = (torch.randn(e * cap, i, device="cuda", generator=gen)).bfloat16()
    b = (torch.randn(e, 1, i, device="cuda", generator=gen) * 0.5).bfloat16()
    dy = torch.randn(e * cap, i, device="cuda", generator=gen).bfloat16()
    spec = ba.ActSpec("gelu_tanh", torch.bfloat16, torch.bfloat16)

    def fwd():
        return {"out": ba._launch_fwd(y, b, spec, cap)}

    def bwd():
        return dict(zip(("dy_y", "db"), ba._launch_bwd(y, b, dy, spec, cap)))
    got, gb = fwd(), bwd()
    r_dyy, r_db = ba.bias_act_bwd_reference(y, b, dy, spec, cap)
    ok, err, errs = fused_compare(torch, {
        "out": (got["out"], ba.bias_act_reference(y, b, spec, cap), "out"),
        "dy_y": (gb["dy_y"], r_dyy, "out"),
        "db": (gb["db"], r_db.view(gb["db"].shape), "sum")})
    require(ok, f"bias_act period: beyond FUSED_TOL: {errs}")
    fused_repeat_equal(torch, lambda: {**fwd(), **bwd()}, "bias_act period")
    y3 = y.view(e, cap, i)
    t = fused_timing(
        torch, fwd, lambda: ba.bias_act_reference(y, b, spec, cap),
        lambda: torch.nn.functional.gelu(y3 + b, approximate="tanh"),
        MOE_ITERS)
    t["bwd_ms"] = cuda_ms(torch, bwd, MOE_ITERS)
    t["bwd_device_ms"] = device_ms(torch, bwd, MOE_ITERS)
    t["bwd_plain_ms"] = cuda_ms(
        torch, lambda: ba.bias_act_bwd_reference(y, b, dy, spec, cap),
        max(2, MOE_ITERS // 4))
    dy3 = dy.view(e, cap, i)

    def library_bwd():
        dyy = torch.ops.aten.gelu_backward(dy3, y3 + b, approximate="tanh")
        return dyy, dyy.sum(dim=1, keepdim=True)
    t["bwd_library_ms"] = cuda_ms(torch, library_bwd, MOE_ITERS)
    t["bwd_library_device_ms"] = library_backward_device_ms(
        torch, lambda y3, b: torch.nn.functional.gelu(y3 + b,
                                                      approximate="tanh"),
        (y3, b), dy3)
    t["bound_ms"], t["bound_by"] = bound(0, nbytes(y, b, got["out"]),
                                         "float32")
    t["bwd_bound_ms"], _ = bound(0, nbytes(y, b, dy, gb["dy_y"], gb["db"]),
                                 "float32")
    return {"max_abs_err": err, "errs": errs,
            "case": "y (8192, 14336) bf16 + b (16, 1, 14336), period 512, "
                    "GELU tanh; library: F.gelu(y + b, tanh) on (E, C, I); "
                    "backward library: aten.gelu_backward on (E, C, I) and "
                    "its sum over C",
            **t}


def moe_check(torch, planted) -> dict:
    """K9 and K6's bias period against their plain versions (see
    check_moe_route, check_bias_period); a planted combine that skips each
    token's second route must fail."""
    from paddle_tpu_torch.ops import bias_act as ba
    from paddle_tpu_torch.ops import moe as K9
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {"moe_route": check_moe_route(torch, K9, planted["moe"], gen),
            "bias_act_period": check_bias_period(torch, ba, gen)}
    emit({"phase": "moe_check", "seconds": time.monotonic() - t0, **rows})
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def moe_expert(torch, h: int, i: int, device, dtype=None):
    """The JAX package's expert shape: Linear(h, i) -> GELU -> Linear(i, h),
    the bias and GELU in K6."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.ops import nn_ops

    class Expert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = Linear(h, i, device=device, dtype=dtype)
            self.fc2 = Linear(i, h, device=device, dtype=dtype)

        def forward(self, x):
            return self.fc2(nn_ops.linear(x, self.fc1.weight, self.fc1.bias,
                                          activation="gelu"))
    return Expert()


def moe_block(torch, h: int, i: int, e: int, device, seed: int,
              dtype=None):
    """The pre-LN MoE block: LayerNorm -> MoELayer(GShardGate, top-2, e
    experts) -> residual; weights normal(0, 0.02) and the gate
    Xavier-uniform from ``seed``, biases 0."""
    from paddle_tpu_torch.incubate.moe import MoELayer
    from paddle_tpu_torch.nn import LayerNorm
    g = torch.Generator(device=device).manual_seed(seed)

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = LayerNorm(h, device=device, dtype=dtype)
            experts = [moe_expert(torch, h, i, device, dtype)
                       for _ in range(e)]
            for ex in experts:
                for lin in (ex.fc1, ex.fc2):
                    lin.reset_parameters(g)
            self.moe = MoELayer(h, experts, gate={"type": "gshard",
                                                  "top_k": 2},
                                device=device, dtype=dtype, generator=g)

        def forward(self, x):
            return x + self.moe(self.norm(x))
    return Block()


def moe_optimizer(block, gate_lr: float = 0.5):
    """AdamW on the multi-tensor path, two parameter groups (the gate and
    norm at ``gate_lr`` of the LR, the experts), no decay on biases and
    norms."""
    from paddle_tpu_torch.optimizer import AdamW, set_parameter_names
    set_parameter_names(block)
    groups = [{"params": list(block.norm.parameters())
               + list(block.moe.gate.parameters()),
               "learning_rate": gate_lr},
              {"params": list(block.moe.experts.parameters())}]
    return AdamW(learning_rate=1e-4, parameters=groups, weight_decay=0.01,
                 use_multi_tensor=True,
                 apply_decay_param_fun=lambda n: not (
                     n.endswith("bias") or n.startswith("norm.")))


def digest(torch, t) -> int:
    """A position-weighted integer sum of ``t``'s bits (chunked): equal
    tensors give equal digests."""
    v = t.detach().reshape(-1)
    v = v.view(torch.int16 if v.element_size() == 2 else torch.int32)
    total = 0
    for off in range(0, v.numel(), 1 << 26):
        c = v[off:off + (1 << 26)].long()
        w = torch.arange(off, off + c.numel(), device=c.device) % 65521 + 1
        total += int((c * w).sum())
    return total


def drop_aux_graph(moe):
    """Keep ``l_aux`` detached once the step's backward has run: the live
    tensor holds the step's autograd graph, whose gradient accumulators a
    later capture cannot record (``jit.capture_step``'s docstring)."""
    moe.l_aux = moe.gate.l_aux = moe.l_aux.detach()
    return moe.l_aux


def moe_state(block, opt) -> list:
    fs = opt._flat
    return [fs.master, fs.m, fs.v, fs.param, opt._step_t]


def train_moe_jamba2(torch, card) -> dict:
    """``train_moe_jamba2``: the pre-LN MoE block at Jamba2-Mini's expert
    widths (about 1.88 B parameters), AMP O2 bf16, multi-tensor AdamW in
    two groups, 4 x 2048 tokens; eager steps, then the same step captured
    (``jit.capture_step``): the replay must be bit-equal to the eager step
    on the same inputs (state put back from a host copy between them)."""
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.ops import multi_tensor_adam as mta
    h, i, e, k = (JAMBA2[n] for n in ("hidden", "inter", "experts", "top_k"))
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    torch.cuda.reset_peak_memory_stats()
    block = moe_block(torch, h, i, e, "cuda", seed=21)
    n_params = sum(p.numel() for p in block.parameters())
    opt = moe_optimizer(block)
    block, opt = amp.decorate(block, opt, level="O2", dtype="bfloat16")
    init_s = time.monotonic() - t0
    gen = torch.Generator(device="cuda").manual_seed(22)
    tokens = MOE_BATCH * MOE_SEQ
    xs = [torch.randn(MOE_BATCH, MOE_SEQ, h, device="cuda", generator=gen
                      ).bfloat16() for _ in range(MOE_WARM + MOE_TIMED)]
    target = torch.randn(MOE_BATCH, MOE_SEQ, h, device="cuda",
                         generator=gen) * 0.5

    def fwd_bwd(x):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            out = block(x)
        aux = block.moe.l_aux
        loss = (out.float() - target).square().mean() + 0.01 * aux
        loss.backward()
        return loss.detach(), drop_aux_graph(block.moe)

    def update():
        opt.step()
        opt.clear_grad()
    counters = moe_path_counters()
    reset_counts(counters)
    stop = sample_card()
    times, losses = [], []
    for j, x in enumerate(xs):
        torch.cuda.synchronize()
        ts = time.monotonic()
        loss, aux = fwd_bwd(x)
        update()
        torch.cuda.synchronize()
        if j >= MOE_WARM:
            times.append(time.monotonic() - ts)
        losses.append(float(loss))
    clocks = stop()
    eager_launches = counts_of(counters)
    steps = len(xs)
    want = {"moe_dispatch": 2 * steps, "moe_combine": 2 * steps,
            "bias_act": 2 * e * steps, "fused_norm": 2 * steps,
            "multi_tensor_adam": steps}
    require(all(eager_launches.get(n, 0) == c for n, c in want.items()),
            f"train_moe_jamba2: launches {eager_launches}, want {want}")
    require(all(math.isfinite(v) for v in losses), f"losses {losses}")
    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        routes, _, _ = block.moe.gate.route(block.norm(xs[-1]).reshape(-1, h))
        dropped = float((routes.slot < 0).float().mean())
    mem = memory_gb(torch)
    p50 = statistics.median(times)
    routed_flops = 12 * h * i * k * tokens    # k T rows, both products, f+b
    eager_calls = profile_call(torch, lambda: (fwd_bwd(xs[0]), update()))

    # the captured step against the eager step on the same inputs
    x = xs[0]
    state = moe_state(block, opt)
    saved = [s.detach().cpu() for s in state]

    def restore():
        with torch.no_grad():
            for s, c in zip(state, saved):
                s.copy_(c, non_blocking=False)
        torch.cuda.synchronize()

    def digests(loss):
        return [digest(torch, loss.float())] + [digest(torch, s)
                                                 for s in state]
    loss_e, _ = fwd_bwd(x)
    update()
    d_eager = digests(loss_e)
    restore()
    step = captured_step(jit, fwd_bwd, "auto", update_fn=update,
                         clear_fn=opt.clear_grad)
    loss_w, _ = step(x)                     # warm-up: the real step, eager
    d_warm = digests(loss_w)
    restore()
    reset_counts(counters)
    loss_r, _ = step(x)                     # the replay
    torch.cuda.synchronize()
    d_replay = digests(loss_r)
    replay_launches = counts_of(counters)
    require(step.stats["hits"] == 1 and step.stats["retraces"] == 1,
            f"train_moe_jamba2 captured: {step.stats}")
    require(d_replay == d_eager and d_warm == d_eager,
            f"train_moe_jamba2: replay not bit-equal to the eager step "
            f"(loss, master, m, v, param, step: {d_eager} {d_warm} "
            f"{d_replay})")
    require(replay_launches == {n: c // steps for n, c in want.items()},
            f"train_moe_jamba2 replay launches {replay_launches}")
    rtimes = []
    for xr in xs[1:]:
        torch.cuda.synchronize()
        ts = time.monotonic()
        step(xr)
        torch.cuda.synchronize()
        rtimes.append(time.monotonic() - ts)
    replay_calls = profile_call(torch, lambda: step(xs[1]))
    mem_c = memory_gb(torch)
    r50 = statistics.median(rtimes)
    row = {"phase": "train_moe_jamba2", "card": card,
           "config": {**JAMBA2, "batch": MOE_BATCH, "seq": MOE_SEQ,
                      "capacity": block.moe.gate.capacity(tokens),
                      "source": "ai21labs/AI21-Jamba2-Mini config.json "
                                "(widths, experts, top-2)"},
           "params": n_params, "init_s": init_s,
           "free_gb_at_start": free_gb,
           "eager": {"step_s_p50": p50, "step_s": times,
                     "tokens_per_s": tokens / p50,
                     "mfu_routed": routed_flops / p50 / PEAK_OPS_PER_S[
                         "bfloat16"],
                     "host_launch_calls": eager_calls["host_launch_calls"],
                     "device_kernels": eager_calls["device_kernels"],
                     "launches": eager_launches},
           "captured": {"step_s_p50": r50, "step_s": rtimes,
                        "tokens_per_s": tokens / r50,
                        "mfu_routed": routed_flops / r50 / PEAK_OPS_PER_S[
                            "bfloat16"],
                        "host_launch_calls": replay_calls[
                            "host_launch_calls"],
                        "device_kernels": replay_calls["device_kernels"],
                        "launches_per_replay": replay_launches,
                        "replay_bit_equal_to_eager": True},
           "mfu_note": "MFU over routed tokens: k T = 16384 rows through "
                       "both expert products, forward and backward; the "
                       "capacity padding (24576 slots) is not counted",
           "losses": losses, "aux_loss": float(aux),
           "dropped_route_share": dropped, **mem,
           "captured_peak_mem_gb": mem_c["peak_mem_gb"],
           "captured_peak_reserved_gb": mem_c["peak_reserved_gb"],
           "card_during_steps": clocks,
           "seconds": time.monotonic() - t0}
    emit(row)
    del step, block, opt, saved, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": eager_launches, "replay": replay_launches}


def ec_moe_jamba2(torch, card) -> dict:
    """``FusedEcMoe`` at H 4096, I 14336, 16 experts, 8192 tokens (C =
    512), GELU tanh, bf16: one forward and backward counted (K9, K6), then
    timed beside the bound of its two grouped products."""
    from paddle_tpu_torch.incubate import nn as inn
    h, i, e = (JAMBA2[n] for n in ("hidden", "inter", "experts"))
    t0 = time.monotonic()
    tokens = MOE_BATCH * MOE_SEQ
    g = torch.Generator(device="cuda").manual_seed(31)
    layer = inn.FusedEcMoe(h, i, e, "gelu", device="cuda",
                           dtype=torch.bfloat16, generator=g)
    x = torch.randn(MOE_BATCH, MOE_SEQ, h, device="cuda",
                    generator=g).bfloat16().requires_grad_()
    gate = torch.randn(MOE_BATCH, MOE_SEQ, e, device="cuda",
                       generator=g).bfloat16().requires_grad_()
    dout = torch.randn(MOE_BATCH, MOE_SEQ, h, device="cuda",
                       generator=g).bfloat16()
    counters = moe_path_counters()
    reset_counts(counters)
    out = layer(x, gate)
    out.backward(dout)
    torch.cuda.synchronize()
    launches = counts_of(counters)
    require(launches == {"moe_dispatch": 2, "moe_combine": 2, "bias_act": 2},
            f"ec_moe_jamba2 launches {launches}")
    require(bool(torch.isfinite(out).all()) and all(
        bool(torch.isfinite(p.grad).all()) for p in layer.parameters()),
        "ec_moe_jamba2: a non-finite output or gradient")

    def fwd():
        with torch.no_grad():
            layer(x, gate)

    def fwd_bwd():
        layer(x, gate).backward(dout)
    fwd_ms = cuda_ms(torch, fwd, MOE_ITERS)
    fb_ms = cuda_ms(torch, fwd_bwd, MOE_ITERS)
    flops = 4 * tokens * h * i
    row = {"phase": "ec_moe_jamba2", "card": card,
           "config": {"hidden": h, "inter": i, "experts": e,
                      "tokens": tokens, "capacity": tokens // e,
                      "act": "gelu (tanh)", "dtype": "bfloat16"},
           "launches": launches, "fwd_ms": fwd_ms,
           "fwd_bound_ms": flops / PEAK_OPS_PER_S["bfloat16"] * 1e3,
           "fwd_bound_by": "operations (4 T H I, the two grouped products)",
           "fwd_bwd_ms": fb_ms,
           "fwd_bwd_bound_ms": 3 * flops / PEAK_OPS_PER_S["bfloat16"] * 1e3,
           **memory_gb(torch), "seconds": time.monotonic() - t0}
    emit(row)
    del layer, x, gate, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


def grads_of(module) -> dict:
    return {n: p.grad for n, p in module.named_parameters()
            if p.grad is not None}


def moe_vs_cpu(torch) -> None:
    """A narrow MoE block (H 256, I 512, 8 experts, 2 x 64 tokens) and an
    EC-MoE from one seed, fp32, on the card (kernels) and on the CPU (plain
    versions): outputs, aux loss and gradients within MOE_CPU_RTOL of each
    tensor's largest element. The block again on the card with its gate
    behind a dense-only object: K9 launched, output equal to the routed
    gate's."""
    from paddle_tpu_torch.incubate import nn as inn
    t0 = time.monotonic()
    h, i, e = 256, 512, 8
    errs = {}

    def close(name, a, b):
        a, b = a.detach().float().cpu(), b.detach().float()
        err = float((a - b).abs().max())
        errs[name] = err
        require(err <= MOE_CPU_RTOL * max(float(b.abs().max()), 1e-12),
                f"moe_vs_cpu: {name} off by {err}")
    x = torch.randn(2, 64, h, generator=torch.Generator().manual_seed(40))
    w = torch.randn(2, 64, h, generator=torch.Generator().manual_seed(41))
    outs = {}
    for dev in ("cuda", "cpu"):
        blk = moe_block(torch, h, i, e, "cpu", seed=42).to(dev)
        xd = x.to(dev, copy=True).requires_grad_()
        out = blk(xd)
        ((out * w.to(dev)).sum() + blk.moe.l_aux).backward()
        outs[dev] = (out, blk.moe.l_aux, xd.grad, grads_of(blk))
    (oc, ac, xc, gc_), (op, ap, xp, gp) = outs["cuda"], outs["cpu"]
    close("moe_out", oc, op)
    close("moe_aux", ac, ap)
    close("moe_dx", xc, xp)
    for n in gp:
        close(f"moe_grad.{n}", gc_[n], gp[n])
    # a gate object with only the dense contract (no ``route``): its
    # tensors become K9's table on the card and take the same kernels
    from paddle_tpu_torch.ops import moe as k9

    class DenseOnly(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, t):
            return self.inner(t)
    blk = moe_block(torch, h, i, e, "cpu", seed=42).to("cuda")
    blk.moe.gate = DenseOnly(blk.moe.gate)
    before = (k9.launches_dispatch.count, k9.launches_combine.count)
    xd = x.to("cuda", copy=True).requires_grad_()
    out = blk(xd)
    ((out * w.cuda()).sum() + blk.moe.l_aux).backward()
    got = (k9.launches_dispatch.count - before[0],
           k9.launches_combine.count - before[1])
    require(got == (2, 2), f"moe_vs_cpu: a dense gate launched K9 {got}")
    require(torch.equal(out, oc), "moe_vs_cpu: the dense gate's output "
            "differs from the routed gate's on the card")
    close("dense_gate_out", out, op)
    close("dense_gate_dx", xd.grad, xp)
    for n, t in grads_of(blk).items():
        n = n.replace("gate.inner.", "gate.")
        close(f"dense_gate_grad.{n}", t, gp[n])
    g = torch.randn(2, 64, e, generator=torch.Generator().manual_seed(43))
    for dev in ("cuda", "cpu"):
        layer = inn.FusedEcMoe(h, i, e, device="cpu",
                               generator=torch.Generator().manual_seed(44))
        layer = layer.to(dev)
        xd = x.to(dev, copy=True).requires_grad_()
        gd = g.to(dev, copy=True).requires_grad_()
        out = layer(xd, gd)
        (out * w.to(dev)).sum().backward()
        outs[dev] = (out, xd.grad, gd.grad, grads_of(layer))
    (oc, xc, gc2, pc), (op, xp, gp2, pp) = outs["cuda"], outs["cpu"]
    close("ec_out", oc, op)
    close("ec_dx", xc, xp)
    close("ec_dgate", gc2, gp2)
    for n in pp:
        close(f"ec_grad.{n}", pc[n], pp[n])
    emit({"phase": "moe_vs_cpu", "rtol_of_max": MOE_CPU_RTOL,
          "max_abs_err": errs, "seconds": time.monotonic() - t0})


def grad_scaler_check(torch) -> dict:
    """``amp.GradScaler`` in an fp16 O1 step of the narrow MoE block, eager
    and captured, over three batches, the second with an ``inf``: that step
    is skipped and the scale halved on both paths, and the two end with
    the same parameters."""
    from paddle_tpu_torch import amp, jit
    t0 = time.monotonic()
    h, i, e = 256, 512, 8
    xs = [torch.randn(2, 64, h, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(50 + j)) for j in range(3)]
    xs[1][0, 0, 0] = float("inf")
    runs = {}
    for path in ("eager", "captured"):
        blk = moe_block(torch, h, i, e, "cuda", seed=51)
        opt = moe_optimizer(blk)
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 12)

        def fwd_bwd(x, blk=blk, scaler=scaler):
            with amp.auto_cast(level="O1", dtype="float16"):
                loss = blk(x).float().square().mean() + 0.01 * blk.moe.l_aux
            scaler.scale(loss).backward()
            drop_aux_graph(blk.moe)
            return loss.detach()

        def update(opt=opt, scaler=scaler):
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
        step = captured_step(jit, fwd_bwd, "auto" if path == "captured"
                             else "off", update_fn=update,
                             clear_fn=opt.clear_grad)
        scales = []
        for x in xs:
            step(x)
            scales.append(scaler.get_loss_scaling())
        runs[path] = dict(blk=blk, opt=opt, scales=scales, stats=step.stats,
                          t=opt.t)
    a, b = runs["eager"], runs["captured"]
    require(a["t"] == b["t"] == 2, f"grad_scaler: steps {a['t']} {b['t']}")
    require(a["scales"] == b["scales"] == [4096.0, 2048.0, 2048.0],
            f"grad_scaler: scales {a['scales']} {b['scales']}")
    require(b["stats"]["hits"] == 2, f"grad_scaler: {b['stats']}")
    same = all(torch.equal(p, q) for p, q in zip(a["blk"].parameters(),
                                                  b["blk"].parameters()))
    require(same, "grad_scaler: the eager and captured runs differ")
    row = {"phase": "grad_scaler_check", "scales": a["scales"],
           "steps_applied": a["t"], "captured_stats": b["stats"],
           "eager_equals_captured": same,
           "seconds": time.monotonic() - t0}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the rest of the optimizer: the multi-tensor AdamW kernel's new forms, the
# bf16-state Llama step of bench_llama.py, and the optimizers beyond AdamW
# ---------------------------------------------------------------------------

# bench_config()'s parameters: embeddings and head 2 x 32000 x 2560, 18
# layers of 4 x 2560^2 + 3 x 2560 x 6912 + 2 x 2560, the final norm
LLAMA_1P6B_PARAMS = 1591308800
# the new forms of the multi-tensor AdamW kernel: (storage, moments,
# parameter buffer, rounding); the grad is bf16 throughout
MT_FORMS = {
    # an fp32 master with bf16 moments and bf16 parameters
    "bf16_moments": ("float32", "bfloat16", "bfloat16", False),
    # bench_llama's --state bf16: the bf16 parameters are the storage,
    # rounded stochastically
    "master_free_sr": ("bfloat16", "bfloat16", None, True),
    "master_free_rn": ("bfloat16", "bfloat16", None, False),
}
MT_FORM_LR = 1e-3
MT_FORM_SPLIT = 795654400   # a 16-byte aligned cut near half of n


def mt_form_state(torch, n: int, form: str, seed: int = 11) -> list:
    """``[w, m, v, param]`` of ``form`` for ``n`` elements, made on the card
    from ``seed`` (the same each call): weights 0.02-sized, m 1e-3, v up to
    1e-4."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    w_dt, m_dt, p_dt, _ = MT_FORMS[form]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n, generator=gen, device="cuda") * 0.02
    m = (torch.randn(n, generator=gen, device="cuda") * 1e-3).to(dt[m_dt])
    v = (torch.rand(n, generator=gen, device="cuda") * 1e-4).to(dt[m_dt])
    param = None if p_dt is None else w.to(dt[p_dt])
    return [w.to(dt[w_dt]), m, v, param]


def check_multi_tensor_adam_forms(torch, q8, mta) -> dict:
    """The multi-tensor AdamW kernel's forms of this slice against its
    plain version, bit for bit, at the 1.59B Llama's 1,591,308,800
    parameters (bf16 gradients, the global-norm scale and weight decay on):
    an fp32 master with bf16 moments; the master-free bf16 storage with
    stochastic rounding and to nearest. The rounding form updated in two
    launches at their flat offsets draws the bits of one launch; a closed
    gate writes nothing. Each timed beside its byte bound, the plain
    version and ``torch._fused_adamw_`` on bf16 parameters, gradients and
    moments (a yardstick that rounds to nearest, never the path)."""
    from paddle_tpu_torch.ops._u32 import derive_seed
    n = LLAMA_1P6B_PARAMS
    t = 3
    c1, c2 = (float(torch.tensor(1.0 - b ** t, dtype=torch.float32))
              for b in (0.9, 0.999))
    lr, wd = MT_FORM_LR, 0.01
    sc = q8.scalar_block(lr, c1, c2, 1.0 - lr * wd, grad_scale=0.8,
                         device="cuda")
    seed = derive_seed(torch.tensor(1234, device="cuda"),
                       torch.tensor(t, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(12)
    grad = (torch.randn(n, generator=gen, device="cuda") * 1e-2).to(
        torch.bfloat16)
    rows = {}
    for form, (_, _, _, sr) in MT_FORMS.items():
        kw = dict(ADAM_HP, scalars=sc, has_wd=True, grad_scale=True,
                  seed=seed, stochastic_rounding=sr)
        before = [None if x is None else digest(torch, x)
                  for x in mt_form_state(torch, n, form)]
        st_k = mt_form_state(torch, n, form)
        launches0 = mta.launches.count
        mta.multi_tensor_adam_update(*st_k, grad, **kw)
        torch.cuda.synchronize()
        require(mta.launches.count == launches0 + 1,
                f"multi_tensor_adam[{form}]: not one launch")
        st_r = mt_form_state(torch, n, form)
        mta.multi_tensor_adam_update_reference(*st_r, grad, **kw)
        names = ("w", "m", "v", "param")
        differ = {nm: int((a != b).sum()) for nm, a, b in
                  zip(names, st_k, st_r) if a is not None}
        errs = {nm: float((a.float() - b.float()).abs().max()) for nm, a, b
                in zip(names, st_k, st_r) if a is not None}
        after = [None if x is None else digest(torch, x) for x in st_k]
        moved = {nm: b != a for nm, a, b in zip(names, before, after)
                 if a is not None}
        require(all(v == 0 for v in differ.values()) and moved["m"]
                and moved["v"] and (moved["w"] or form == "master_free_rn"),
                f"multi_tensor_adam[{form}] kernel vs plain: elements "
                f"differing {differ}, max-abs {errs}, moved {moved}")
        del st_r
        row = {"phase": "multi_tensor_adam_check", "form": form, "n": n,
               "storage": MT_FORMS[form][0], "moments": MT_FORMS[form][1],
               "param": MT_FORMS[form][2], "grad": "bfloat16",
               "stochastic_rounding": sr, "elements_differing": differ,
               "max_abs_err": errs, "state_moved": moved}
        if sr:
            # two launches at their flat offsets draw one launch's bits
            st_s = mt_form_state(torch, n, form)
            cut = MT_FORM_SPLIT
            for a, b in ((0, cut), (cut, n)):
                mta.multi_tensor_adam_update(
                    *(None if x is None else x[a:b] for x in st_s),
                    grad[a:b], **dict(kw, base=a))
            require(all(torch.equal(a, b) for a, b in zip(st_s[:3],
                                                          st_k[:3])),
                    f"multi_tensor_adam[{form}]: two runs drew other bits "
                    f"than one")
            row["two_runs_bit_equal"] = True
            # rounding moved the storage where rounding to nearest did not
            row["storage_elements_moved"] = int(
                (st_s[0] != mt_form_state(torch, n, form)[0]).sum())
            del st_s
        closed = sc.clone()
        closed[4] = 0.0
        st_g = mt_form_state(torch, n, form)
        mta.multi_tensor_adam_update(*st_g, grad, **dict(kw, scalars=closed))
        require([None if x is None else digest(torch, x) for x in st_g]
                == before, f"multi_tensor_adam[{form}]: a closed gate "
                f"wrote state")
        row["closed_gate_writes_nothing"] = True
        del st_g
        gc.collect()
        torch.cuda.empty_cache()

        def kernel():
            mta.multi_tensor_adam_update(*st_k, grad, **kw)
        ms, host = event_and_host(torch, kernel, 20)
        dev = device_time(torch, kernel, 20, ms)
        row.update(ms=ms, host_us=host, device_ms=dev["device_ms"],
                   device_source=dev["source"])
        w16 = st_k[0] if st_k[3] is None else st_k[3]
        # the plain version and the library on other buffers of the form
        st_r = mt_form_state(torch, n, form)
        row["plain_ms"] = cuda_ms(
            torch, lambda: mta.multi_tensor_adam_update_reference(
                *st_r, grad, **kw), 2, warmup=1)
        del st_r
        gc.collect()
        torch.cuda.empty_cache()
        p16, m16, v16 = w16.clone(), st_k[1].clone(), st_k[2].clone()
        step_t = torch.tensor(float(t), device="cuda")

        def library():
            torch._fused_adamw_([p16], [grad], [m16], [v16], [], [step_t],
                                lr=lr, beta1=0.9, beta2=0.999,
                                weight_decay=wd, eps=1e-8, amsgrad=False,
                                maximize=False)
        row["library_ms"] = cuda_ms(torch, library, 20)
        row["library_device_ms"] = device_ms(torch, library, 20)
        row["library"] = ("torch._fused_adamw_ on bf16 parameters, "
                          "gradients and moments (rounds to nearest)")
        # the launch's cost function: what the cost registry files
        mt_flops, mt_bytes = mta.multi_tensor_adam_cost(*st_k, grad)
        bms, by = bound(mt_flops, mt_bytes, "float32")
        row.update(bound_ms=bms, bound_by=by, bytes_per_element=mt_bytes / n,
                   gbytes_per_s=mt_bytes / ms / 1e6)
        emit(row)
        rows[form] = row
        del st_k, p16, m16, v16, w16
        gc.collect()
        torch.cuda.empty_cache()
    del grad
    gc.collect()
    torch.cuda.empty_cache()
    return rows


BF16_STATE_CALLS = 5   # one capturing call and 4 replays; 5 eager steps


def train_llama_1p6b_bf16_state(torch, card, fa, q8, mta) -> dict:
    """``train_llama_1p6b_bf16_state``: the 1.59B Llama of ``bench.py``
    (``bench_config()``: full width and depth, batch 6, seq 4096,
    recompute, O2 bf16) on ``benchmarks/bench_llama.py --state bf16``'s
    optimizer, ``AdamW(learning_rate=1e-4, use_multi_tensor=True,
    moment_dtype="bfloat16", use_master_weights=False)`` built on the fp32
    parameters, then ``amp.decorate(level="O2", dtype="bfloat16",
    master_weight=False)``: 2 warm-up and 4 timed eager steps, one more
    profiled. Gates: the first loss within 0.5 of ``ln V + hidden * 0.02^2
    / 2``, every loss finite, the optimizer state 6 bytes a parameter
    (bf16 storage, m and v; the flat buffers' alignment pad reported) and
    no fp32 buffer held, one multi-tensor AdamW launch a step and no B5,
    B2-B4 once a layer a step and K1-K5 their per-step counts. Then the
    same step from one saved state on the eager tier and through
    ``jit.capture_step`` (one capturing call, 4 replays): losses and the
    digests of the parameters, m, v and ``_step_t`` bit-equal, which holds
    only if the rounding seed is drawn on the card each step. Returns the
    eager run's launches."""
    import numpy as np
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bench_config()
    batch, seq, warmup, timed = 6, 4096, 2, 4
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                use_multi_tensor=True, moment_dtype="bfloat16",
                use_master_weights=False)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                              master_weight=False)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    fs = opt._flat
    n_params = model.num_params()
    require(n_params == LLAMA_1P6B_PARAMS,
            f"bench_config() has {n_params} parameters")
    require(fs.master.dtype == fs.m.dtype == fs.v.dtype == torch.bfloat16
            and not fs.lows and all(
                p.dtype == torch.bfloat16 for p in model.parameters()),
            "train_llama_1p6b_bf16_state: the state is not the bf16 "
            "master-free layout")
    state_bytes = fs.state_bytes()
    require(state_bytes == 6 * fs.total,
            f"optimizer state {state_bytes} bytes for {fs.total} flat "
            f"elements")
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))

    def fwd_bwd(ids):
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            loss, _ = model(ids, labels=ids)
        loss.backward()
        return loss

    def update():
        opt.step()
        opt.clear_grad()

    def step():
        loss = fwd_bwd(ids)
        update()
        return loss

    counters = {k: c for k, c in train_counters(fa, q8).items()
                if k != "q8_adam"}
    counters["multi_tensor_adam"] = mta.launches
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (*counters.values(), q8.launches, fa.launches):
        c.reset()
    stop_sampler = sample_card()
    try:
        for _ in range(warmup + timed):
            t1 = time.monotonic()
            loss = step()
            torch.cuda.synchronize()
            times.append(time.monotonic() - t1)
            losses.append(float(loss.detach()))
    finally:
        card_samples = stop_sampler()
    launches = {k: c.count for k, c in counters.items()}
    steps = warmup + timed
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    expect = math.log(cfg.vocab_size) + cfg.hidden_size * 0.02 ** 2 / 2
    require(abs(losses[0] - expect) < 0.5,
            f"step-1 loss {losses[0]} not within 0.5 of {expect}")
    # B2 twice a layer: the forward and its recomputation in the backward
    per_step = dict(llama_fused_per_step(cfg.num_hidden_layers),
                    flash_fwd_lse=2 * cfg.num_hidden_layers,
                    flash_bwd_dq=cfg.num_hidden_layers,
                    flash_bwd_dkv=cfg.num_hidden_layers,
                    multi_tensor_adam=len(fs.runs(
                        (True,) * len(fs.params))))
    require(q8.launches.count == 0 and fa.launches.count == 0
            and all(launches[k] == n * steps for k, n in per_step.items()),
            f"train_llama_1p6b_bf16_state: launches {launches} (B5 "
            f"{q8.launches.count}), expected {per_step} a step")
    timed_s = times[warmup:]
    p50 = statistics.median(timed_s)
    tok_s = batch * seq / p50
    fpt = model.flops_per_token(seq)
    row = {"phase": "train_llama_1p6b_bf16_state", "card": card,
           "optimizer": "AdamW(learning_rate=1e-4, use_multi_tensor=True, "
                        "moment_dtype='bfloat16', use_master_weights=False)"
                        ", amp.decorate(O2, bf16, master_weight=False)",
           "params": n_params, "flat_elements": fs.total,
           "alignment_pad_elements": fs.total - n_params,
           "optimizer_state_bytes": state_bytes,
           "optimizer_state_bytes_per_param": state_bytes / n_params,
           "batch": batch, "seq": seq, "warmup_steps": warmup,
           "timed_steps": timed, "step_s": times, "step_p50_s": p50,
           "step_spread_s": max(timed_s) - min(timed_s),
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "mfu_vs_989tflops": fpt * tok_s / 989e12,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "max_memory_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "losses": losses, "expected_first_loss": expect,
           "init_s": init_s, "card_during_steps": card_samples,
           "launches": launches,
           "launches_per_step": {k: n / steps for k, n in launches.items()}}
    # one more step under the profiler: the update's device time
    prof = profile_step(torch, card, step, p50,
                        "train_llama_bf16_state_profile", train_family)
    row["update_device_ms"] = prof["families"].get(
        "multi_tensor_adam", {}).get("device_ms")
    emit(row)
    require(row["update_device_ms"], "the profiled step shows no "
            "multi_tensor_adam device time")
    del loss
    gc.collect()
    # eager tier and captured, from one saved state (the host's copy)
    state = [fs.master, fs.m, fs.v, opt._step_t]
    saved = [x.detach().cpu() for x in state]
    gen_ids = torch.Generator(device="cuda").manual_seed(1)
    call_ids = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda",
                             generator=gen_ids)
    runs = {}
    for tier in ("eager", "captured"):
        with torch.no_grad():
            for x, c in zip(state, saved):
                x.copy_(c)
        call = (captured_step(jit, fwd_bwd, "off", update_fn=update,
                              clear_fn=opt.clear_grad, nan_gate=True)
                if tier == "eager" else
                jit.capture_step(fwd_bwd, update_fn=update,
                                 clear_fn=opt.clear_grad, nan_gate=True))
        for c in counters.values():
            c.reset()
        tl, tt = [], []
        for _ in range(BF16_STATE_CALLS):
            t1 = time.monotonic()
            loss = call(call_ids)
            torch.cuda.synchronize()
            tt.append(time.monotonic() - t1)
            tl.append(float(loss))
        runs[tier] = {"losses": tl, "call_s": tt,
                      "launches": {k: c.count for k, c in counters.items()},
                      "digests": [digest(torch, x) for x in state],
                      "stats": dict(call.stats)}
        require(all(math.isfinite(x) for x in tl),
                f"train_llama_1p6b_bf16_state {tier}: losses {tl}")
        require(runs[tier]["launches"]["multi_tensor_adam"]
                == BF16_STATE_CALLS,
                f"train_llama_1p6b_bf16_state {tier}: launches "
                f"{runs[tier]['launches']}")
        del call, loss
        gc.collect()
    e, c = runs["eager"], runs["captured"]
    require(not c["stats"]["bypasses"]
            and c["stats"]["hits"] == BF16_STATE_CALLS - 1,
            f"train_llama_1p6b_bf16_state captured: {c['stats']}")
    require(e["losses"] == c["losses"] and e["digests"] == c["digests"],
            f"train_llama_1p6b_bf16_state: the captured run is not "
            f"bit-equal to the eager run (losses {e['losses']} "
            f"{c['losses']})")
    emit({"phase": "train_llama_1p6b_bf16_state_captured", "card": card,
          "calls": BF16_STATE_CALLS, "replays": c["stats"]["hits"],
          **{t: {k: v for k, v in r.items() if k != "digests"}
             for t, r in runs.items()},
          "state": ["storage (bf16 parameters)", "m", "v", "_step_t"],
          "replay_bit_equal_to_eager": True,
          "captured_call_p50_s": statistics.median(c["call_s"][1:]),
          "eager_call_p50_s": statistics.median(e["call_s"][1:])})
    del model, opt, fs, state, saved, ids, call_ids
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# optimizer_zoo_check: name -> (class, constructor arguments, LR, O2
# master_weight or "fp32": no decorate); fp32 rtol, bf16 one ulp as the
# CPU tests (tests/test_torch_optimizer_zoo.py, test_torch_bf16_state.py)
ZOO = {
    "SGD": ("SGD", {}, 1e-2, "fp32"),
    "SGD_o2_masters": ("SGD", {}, 1e-2, None),
    "SGD_o2_master_free": ("SGD", {}, 1e-2, False),
    "Momentum": ("Momentum", dict(momentum=0.9), 1e-2, "fp32"),
    "Momentum_o2_masters": ("Momentum", dict(momentum=0.9,
                                             use_nesterov=True), 1e-2, None),
    "Momentum_o2_master_free": ("Momentum", dict(momentum=0.9), 1e-2, False),
    "Adamax": ("Adamax", {}, 1e-3, "fp32"),
    "Adagrad": ("Adagrad", dict(initial_accumulator_value=0.1), 1e-3,
                "fp32"),
    "Adadelta": ("Adadelta", dict(rho=0.9), 1.0, "fp32"),
    "RMSProp": ("RMSProp", dict(centered=True, momentum=0.5), 1e-4, "fp32"),
    "Lamb": ("Lamb", {}, 1e-3, "fp32"),
    "LBFGS": ("LBFGS", {}, 1e-3, "fp32"),
    "Rprop": ("Rprop", dict(learning_rate_range=(1e-5, 1e-2)), 1e-3, "fp32"),
    "ASGD": ("ASGD", dict(batch_num=3), 1e-3, "fp32"),
    "NAdam": ("NAdam", {}, 1e-3, "fp32"),
    "RAdam": ("RAdam", dict(beta2=0.9), 1e-3, "fp32"),
    # the multi-tensor kernel's other new forms on a path: bf16 moments
    # beside fp32 masters, and the master-free storage rounded to nearest
    "AdamW_mt_bf16_moments": ("AdamW", dict(use_multi_tensor=True,
                                            moment_dtype="bfloat16"), 1e-3,
                              None),
    "AdamW_mt_master_free_rn": ("AdamW", dict(
        use_multi_tensor=True, moment_dtype="bfloat16",
        stochastic_rounding=False), 1e-3, False),
}
ZOO_STEPS = 5
ZOO_RTOL, ZOO_ATOL, ZOO_ULP = 1e-6, 1e-8, 2.0 ** -7


def zoo_state(opt) -> list:
    """Every tensor an optimizer's step writes: accumulators, masters, the
    flat buffers and the step count."""
    out = [t for store in opt._accumulators.values() for t in store.values()]
    out += list(opt._master_weights.values())
    fs = getattr(opt, "_flat", None)
    if fs is not None:
        out += [fs.master, fs.m, fs.v, *fs.lows.values()]
    return out + [opt._step_t]


def optimizer_zoo_check(torch, mta) -> dict:
    """``optimizer_zoo_check``: each optimizer the port added in this slice
    (and AdamW's other new multi-tensor forms) takes 5 steps on the card
    on one full-width ERNIE-3.0-base layer (its embeddings, one encoder
    layer and the classifier, random weights from seed 0, B=32, L=128,
    dropout 0.1): ``SGD`` and ``Momentum`` also under O2 with fp32
    masters and master-free (stochastic rounding). The card's gradients of
    each step are handed to a CPU copy of the parameters and its optimizer
    (the plain path), which must agree within the CPU tests' tolerances
    (fp32 rtol 1e-6, atol 1e-8; bf16 one ulp). Every optimizer except
    ``LBFGS`` (eager only) then takes the same 5 calls from the same state
    through ``jit.capture_step`` (one capturing call, 4 replays): losses
    and the digests of every state tensor bit-equal to the eager steps.
    Returns the multi-tensor AdamW launches by case."""
    import numpy as np
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForSequenceClassification)
    t0 = time.monotonic()
    cfg = ErnieConfig.ernie3_base()
    cfg.num_hidden_layers = 1
    batch, seq = ERNIE_LEGS[0]
    rng = np.random.default_rng(3)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq),
                                       dtype=np.int32), device="cuda")
    labels = torch.as_tensor(rng.integers(0, 2, (batch,)).astype(np.int64),
                             device="cuda")
    rows, mt_launches = {}, {}
    for case, (cls, kw, lr, o2) in ZOO.items():
        model = ErnieForSequenceClassification(
            cfg, num_classes=2, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0), seed=0)
        opt = getattr(topt, cls)(learning_rate=lr,
                                 parameters=model.parameters(), **kw)
        cpu_params = [torch.nn.Parameter(p.detach().cpu())
                      for p in model.parameters()]
        cpu_opt = getattr(topt, cls)(learning_rate=lr,
                                     parameters=cpu_params, **kw)
        amp_kw = None if o2 == "fp32" else dict(
            level="O2", dtype="bfloat16", master_weight=o2)
        if amp_kw is not None:
            model, opt = amp.decorate(model, opt, **amp_kw)
            with torch.no_grad():
                for p in cpu_params:
                    p.data = p.data.to(torch.bfloat16)
            if o2 is False:
                cpu_opt._use_master_weights = False
            cpu_opt._on_params_cast()
        params = list(model.parameters())
        on_cpu = {"step": True}

        def fwd_bwd(ids, labels):
            with amp.auto_cast(enable=amp_kw is not None, level="O2",
                               dtype="bfloat16"):
                loss, _ = model(ids, labels=labels)
            loss.backward()
            return loss

        def update():
            if on_cpu["step"]:   # the same gradients to the plain path
                for pc, p in zip(cpu_params, params):
                    pc.grad = p.grad.detach().cpu()
                cpu_opt.step()
                cpu_opt.clear_grad()
            opt.step()
            opt.clear_grad()
        tensors = params + zoo_state(opt) + [model.ernie.rng.counter]
        saved = [x.detach().cpu() for x in tensors]
        tiers = ("eager",) if cls == "LBFGS" else ("eager", "captured")
        runs = {}
        for tier in tiers:
            with torch.no_grad():
                for x, c in zip(tensors, saved):
                    x.copy_(c)
            on_cpu["step"] = tier == "eager"
            call = (captured_step(jit, fwd_bwd, "off", update_fn=update,
                                  clear_fn=opt.clear_grad)
                    if tier == "eager" else
                    jit.capture_step(fwd_bwd, update_fn=update,
                                     clear_fn=opt.clear_grad))
            mta.launches.reset()
            losses = [float(call(ids, labels)) for _ in range(ZOO_STEPS)]
            torch.cuda.synchronize()
            runs[tier] = {"losses": losses, "stats": dict(call.stats),
                          "digests": [digest(torch, x) for x in tensors],
                          "multi_tensor_adam": mta.launches.count}
            require(all(math.isfinite(x) for x in losses),
                    f"optimizer_zoo_check {case} {tier}: losses {losses}")
            if tier == "eager":
                errs = zoo_compare(torch, case, params, cpu_params, opt,
                                   cpu_opt)
            del call
        if "captured" in runs:
            e, c = runs["eager"], runs["captured"]
            require(not c["stats"]["bypasses"]
                    and c["stats"]["hits"] == ZOO_STEPS - 1
                    and e["losses"] == c["losses"]
                    and e["digests"] == c["digests"],
                    f"optimizer_zoo_check {case}: the captured run is not "
                    f"bit-equal to the eager run ({c['stats']}, losses "
                    f"{e['losses']} {c['losses']})")
        mt_launches[case] = runs["eager"]["multi_tensor_adam"]
        rows[case] = {"optimizer": cls, "kwargs": {k: str(v) for k, v in
                                                   kw.items()},
                      "lr": lr, "amp": "fp32" if o2 == "fp32" else
                      ("O2 bf16, fp32 masters" if o2 is None else
                       "O2 bf16, master-free"),
                      "losses": runs["eager"]["losses"],
                      "card_vs_cpu": errs,
                      "captured_bit_equal": "captured" in runs,
                      "multi_tensor_adam_launches": mt_launches[case]}
        del model, opt, cpu_opt, cpu_params, params, tensors, saved
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "optimizer_zoo_check", "model": "ERNIE-3.0-base, one "
          "encoder layer", "batch": batch, "seq": seq, "steps": ZOO_STEPS,
          "cases": rows, "seconds": time.monotonic() - t0})
    return mt_launches


def zoo_compare(torch, case, params, cpu_params, opt, cpu_opt) -> dict:
    """The card's parameters and state against the CPU's after the eager
    steps: fp32 within rtol 1e-6 (atol 1e-8), 16-bit tensors within one
    bf16 ulp; returns the largest relative error of each kind."""
    out = {"params": 0.0, "state": 0.0}
    pairs = [("params", a, b) for a, b in zip(params, cpu_params)]
    pairs += [("state", a, b) for a, b in zip(zoo_state(opt)[:-1],
                                              zoo_state(cpu_opt)[:-1])]
    for j, (kind, a, b) in enumerate(pairs):
        rtol, atol = (ZOO_ULP, 0.0) if a.element_size() == 2 else \
            (ZOO_RTOL, ZOO_ATOL)
        a, b = a.detach().float().cpu(), b.detach().float()
        diff = (a - b).abs()
        rel = float((diff / b.abs().clamp(min=1e-30)).max()) \
            if diff.numel() else 0.0
        out[kind] = max(out[kind], rel)
        over = diff - (atol + rtol * b.abs())
        if diff.numel() and bool((over > 0).any()):
            i = int(over.reshape(-1).argmax())
            require(False, f"optimizer_zoo_check {case}: card vs CPU {kind} "
                    f"#{j} {tuple(a.shape)}: {int((over > 0).sum())} "
                    f"elements past the tolerance, the worst at {i}: card "
                    f"{float(a.reshape(-1)[i])!r} CPU "
                    f"{float(b.reshape(-1)[i])!r}")
    require(int(opt._step_t) == int(cpu_opt._step_t),
            f"optimizer_zoo_check {case}: step counts differ")
    return out


# the phases ``--only`` can name, in the order they run (a name covers the
# phases that share its model or inputs)
# ---------------------------------------------------------------------------
# sampling in generate and the program cost registry, on serve_7b's 7B
# ---------------------------------------------------------------------------

SAMPLE = dict(temperature=0.7, top_k=50, top_p=0.9)
SAMPLE_PROMPTS, SAMPLE_LEN, SAMPLE_NEW, SAMPLE_SEED = 4, 128, 64, 2024
# the cut tolerance: generate's logits (one token at a time over a concat
# cache) and the teacher-forced forward's (the transcript at once) differ
# by bf16 roundings, so a sampled token outside the kept set of the latter
# passes when its logit is within this many bf16 ulps of the set's smallest
# (the cut); such tokens are counted apart
CUT_TOL_ULPS = 4


def bf16_ulps_of(torch, x):
    """One bf16 ulp at each element's magnitude."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def teacher_forced(torch, model, ids, prompt_len: int):
    """fp32 logits of every generated position of ``ids`` (B, prompt +
    new), by one forward over the transcript: (B * new, V)."""
    with torch.no_grad():
        logits = model(ids)[:, prompt_len - 1:-1].float()
    return logits.reshape(-1, logits.shape[-1])


def outside_kept(torch, gm, model, ids, prompt_len: int) -> dict:
    """The sampled tokens of ``ids`` against the plain filter's kept set of
    the teacher-forced logits of their positions: inside, near the cut
    (CUT_TOL_ULPS), outside."""
    flat = teacher_forced(torch, model, ids, prompt_len)
    kept = torch.isfinite(gm.filter_logits(flat, **SAMPLE))
    tok = ids[:, prompt_len:].reshape(-1)
    rows = torch.arange(flat.shape[0], device=flat.device)
    inside = kept[rows, tok]
    cut = torch.where(kept, flat, torch.inf).min(-1).values
    near = flat[rows, tok] >= cut - CUT_TOL_ULPS * bf16_ulps_of(torch, cut)
    return {"tokens": int(tok.numel()), "inside": int(inside.sum()),
            "near_cut": int((~inside & near).sum()),
            "outside": int((~inside & ~near).sum()),
            "kept_set_sizes": [int(kept.sum(-1).min()),
                               int(kept.sum(-1).max())]}


def generate_sample_7b(torch, card, model) -> None:
    """``generate_sample_7b``: Llama-2-7B at full width, bf16, 4 prompts of
    128 tokens, 64 new tokens, sampled at temperature 0.7, top-k 50, top-p
    0.9 on a seeded card generator. Gates: one seed gives one transcript;
    top-k 1 gives greedy's tokens up to a position whose top logits tie
    within the cut tolerance; every sampled token in the plain filter's
    kept set of the teacher-forced logits (within the cut tolerance); a
    planted draw outside the kept set is caught. Prints tok/s sampled and
    greedy and the sampler's ms a call."""
    import numpy as np
    from paddle_tpu_torch.models import generation as gm
    cfg = model.config
    rng = np.random.default_rng(21)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (SAMPLE_PROMPTS, SAMPLE_LEN)),
                          device="cuda")

    def seeded():
        return torch.Generator(device="cuda").manual_seed(SAMPLE_SEED)

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = model.generate(ids, max_new_tokens=SAMPLE_NEW, **kw)
        torch.cuda.synchronize()
        return out, time.monotonic() - t0
    # first-call costs untimed (the sampler's kernels load lazily)
    model.generate(ids, max_new_tokens=2)
    model.generate(ids, max_new_tokens=2, do_sample=True,
                   generator=seeded(), **SAMPLE)
    greedy, greedy_s = timed()
    s1, s1_s = timed(do_sample=True, generator=seeded(), **SAMPLE)
    s2, s2_s = timed(do_sample=True, generator=seeded(), **SAMPLE)
    _, greedy2_s = timed()
    want_shape = (SAMPLE_PROMPTS, SAMPLE_LEN + SAMPLE_NEW)
    require(tuple(s1.shape) == want_shape and torch.equal(
        s1[:, :SAMPLE_LEN], ids), f"generate_sample_7b: shape "
        f"{tuple(s1.shape)} or prompt changed")
    require(torch.equal(s1, s2), "generate_sample_7b: one seed gave two "
                                 "transcripts")
    require(not torch.equal(s1, greedy), "generate_sample_7b: the sampled "
                                         "transcript is greedy's")
    # top-k 1 keeps the largest logit and its ties: greedy's tokens, but
    # where the top logits tie the draw may take another of them
    k1, _ = timed(do_sample=True, temperature=0.7, top_k=1,
                  generator=seeded())
    flat = teacher_forced(torch, model, greedy, SAMPLE_LEN).view(
        SAMPLE_PROMPTS, SAMPLE_NEW, -1)
    k1_rows = []
    for r in range(SAMPLE_PROMPTS):
        diff = (k1[r, SAMPLE_LEN:] != greedy[r, SAMPLE_LEN:]).nonzero()
        if not len(diff):
            k1_rows.append(None)
            continue
        i = int(diff[0])
        lg = flat[r, i]
        gap = float(lg[greedy[r, SAMPLE_LEN + i]]
                    - lg[k1[r, SAMPLE_LEN + i]])
        tol = CUT_TOL_ULPS * float(bf16_ulps_of(torch, lg.max()))
        require(abs(gap) <= tol, f"generate_sample_7b: top_k=1 row {r} "
                f"left greedy at new token {i} with a logit gap {gap} "
                f"(tolerance {tol})")
        k1_rows.append({"first_diff": i, "logit_gap": gap, "tol": tol})
    kept = outside_kept(torch, gm, model, s1, SAMPLE_LEN)
    require(kept["outside"] == 0, f"generate_sample_7b: sampled tokens "
                                  f"outside the kept set: {kept}")
    # a planted draw: the first new token of row 0 replaced by its
    # position's smallest logit
    planted = s1.clone()
    first = teacher_forced(torch, model, s1[:1, :SAMPLE_LEN + 1],
                           SAMPLE_LEN)[0]
    planted[0, SAMPLE_LEN] = int(first.argmin())
    caught = outside_kept(torch, gm, model, planted, SAMPLE_LEN)
    require(caught["outside"] >= 1, f"generate_sample_7b: a planted draw "
                                    f"outside the kept set passed: {caught}")
    logits = torch.randn(SAMPLE_PROMPTS, cfg.vocab_size, device="cuda",
                         generator=seeded())
    g = seeded()
    sampler_ms, sampler_host_us = event_and_host(torch, lambda: gm.sample_token(
        logits, True, SAMPLE["temperature"], SAMPLE["top_k"],
        SAMPLE["top_p"], g), 20)
    argmax_ms, argmax_host_us = event_and_host(
        torch, lambda: logits.argmax(-1), 20)
    new = SAMPLE_PROMPTS * SAMPLE_NEW
    emit({"phase": "generate_sample_7b", "card": card, "layers": 32,
          "dtype": "bfloat16", "prompts": SAMPLE_PROMPTS,
          "prompt_len": SAMPLE_LEN, "new_tokens": SAMPLE_NEW, **SAMPLE,
          "seed": SAMPLE_SEED, "sampled_s": [s1_s, s2_s],
          "greedy_s": [greedy_s, greedy2_s],
          "sampled_tok_s": new / min(s1_s, s2_s),
          "greedy_tok_s": new / min(greedy_s, greedy2_s),
          "two_runs_equal": True, "top_k1_rows": k1_rows,
          "kept_check": kept, "planted": caught,
          "cut_tol_bf16_ulps": CUT_TOL_ULPS,
          "sampler_ms_a_call": sampler_ms, "argmax_ms_a_call": argmax_ms,
          "sampler_host_us_a_call": sampler_host_us,
          "argmax_host_us_a_call": argmax_host_us,
          "sampler_note": "CUDA events around 20 back-to-back calls on "
                          "(4, 32000) fp32 logits: device time and launch "
                          "gaps"})


COST_FLOPS_RTOL = 1e-6      # a decode record against its closed form
COST_STEP_RTOL = 1e-3       # the train.step record against its closed form
COST_PROMPT_LENS = (128, 512, 1000)


def matmul_params(cfg) -> int:
    """Weights of the products one token goes through, the head's too."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    return cfg.num_hidden_layers * (2 * h * h + 2 * h * kv + 3 * h * i) \
        + h * v


def cost_kernel_cases(torch, gen):
    """One launch of each hand-written kernel at a case of its check, and
    the (flops, bytes) that check feeds ``bound()``: the cost function
    itself where the check reads it (B1-B6, multi-tensor AdamW), the
    check's ``nbytes`` of the same tensors where it counts them (K1-K8) and
    ``moe_bytes`` (K9). Yields (case, counter name, launch, expected)."""
    import numpy as np
    from paddle_tpu_torch.ops import bias_act as ba
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import embedding as em
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import moe as K9
    from paddle_tpu_torch.ops import multi_tensor_adam as mta
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import q8_adam as q8
    from paddle_tpu_torch.ops import rope as rp
    from paddle_tpu_torch.ops import softmax_cross_entropy as ce
    from paddle_tpu_torch.ops import softmax_mask as sm
    from paddle_tpu_torch.ops import swiglu as sw
    from paddle_tpu_torch.serving import kv_cache as kvc
    bf, f32 = torch.bfloat16, torch.float32

    def rn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)
    # B1, B1 tail, B2-B4 and the SEGS variant
    for name, (b, h, hkv, lq, lk, causal) in {
            "flash_fwd causal_1000_ragged": (1, 32, 32, 1000, 1000, True),
            "flash_fwd causal_lq200_lk1224": (1, 32, 32, 200, 1224, True),
            "flash_fwd_lse gqa": (2, 16, 4, 512, 512, True)}.items():
        q, k, v = rn((b, lq, h, 128), bf), rn((b, lk, hkv, 128), bf), \
            rn((b, lk, hkv, 128), bf)
        entry = name.split()[0][len("flash_"):]
        if entry == "fwd":
            yield name, "flash_attention_fwd", (
                lambda q=q, k=k, v=v, c=causal: fa.flash_attention_fwd(
                    q, k, v, causal=c)), fa.attention_cost(
                "fwd", b, lq, lk, h, hkv, 128, 2, causal)
        else:
            yield name, "flash_attention_fwd_lse", (
                lambda q=q, k=k, v=v: fa.flash_attention_lse(
                    q, k, v, causal=True)), fa.attention_cost(
                "fwd_lse", b, lq, lk, h, hkv, 128, 2, True)
            out, lse = fa.flash_attention_lse(q, k, v, causal=True)
            do = rn(out.shape, bf)
            for e in ("bwd_dq", "bwd_dkv"):
                yield f"flash_{e} gqa", f"flash_attention_{e}", (
                    lambda q=q, k=k, v=v, out=out, lse=lse, do=do:
                    fa.flash_attention_bwd(q, k, v, out, lse, do,
                                           causal=True)), \
                    fa.attention_cost(e, b, lq, lk, h, hkv, 128, 2, True)
    b, h, L, d = ERNIE_SHAPE
    q, k, v = (rn((b, L, h, d), bf) for _ in range(3))
    ids = torch.zeros(b, L, dtype=torch.int32, device="cuda")
    yield "flash_fwd_lse[segs] ernie", "flash_attention_fwd_lse[segs]", (
        lambda: fa.flash_attention_lse(q, k, v, False, None, ids, ids, 0.0,
                                       0)), fa.attention_cost(
        "fwd_lse", b, L, L, h, h, d, 2, False, True)
    # B6 on a bf16 and an int8 pool (paged_case's counts are the check's)
    rng = np.random.default_rng(3)
    for leg in ("bf16", "int8"):
        case = paged_case(torch, kvc, gen, rng, rng.integers(0, 2048, 16),
                          32, 32, leg, bf)
        yield f"paged_decode {leg}_h32", "paged_decode_attention", (
            lambda case=case: pa.paged_attention(
                *case["args"][:7], case["args"][7], page_size=case["ps"])), \
            (case["flops"], case["nbytes"])
    # B5, the main path's form
    n = 2048 * 512
    nb = n // q8.Q8_BLOCK
    st = [torch.zeros(nb, q8.Q8_BLOCK, dtype=torch.int8, device="cuda"),
          torch.ones(nb, device="cuda"),
          torch.zeros(nb, q8.Q8_BLOCK, dtype=torch.int8, device="cuda"),
          torch.ones(nb, device="cuda"), rn((n,), bf, 0.02)]
    g8 = rn((n,), bf, 1e-2)
    kw8 = dict(eps=1e-8, beta1=0.9, beta2=0.999, has_wd=True, use_sr=True,
               scalars=q8.scalar_block(1e-4, 0.1, 0.001, 1.0, device="cuda"),
               seed=torch.tensor(1234, device="cuda"))
    yield "q8_adam bf16 SR", "q8_adam", (
        lambda: q8.q8_adam_update(*st, g8, **kw8)), q8.q8_adam_cost(st[4],
                                                                    g8)
    # multi-tensor AdamW: an fp32 master beside bf16 parameters, and the
    # master-free bf16 form with rounding
    sc = q8.scalar_block(1e-4, 0.1, 0.001, 1.0, grad_scale=0.8,
                         device="cuda")
    gm_ = rn((n,), bf, 1e-2)
    forms = {"fp32_master": ([rn((n,), f32, 0.02), rn((n,), f32, 1e-3),
                              rn((n,), f32, 1e-4).abs(), rn((n,), bf)],
                             {}),
             "master_free_sr": ([rn((n,), bf, 0.02), rn((n,), bf, 1e-3),
                                 rn((n,), bf, 1e-4).abs(), None],
                                dict(seed=torch.tensor(7, device="cuda"),
                                     stochastic_rounding=True))}
    for form, (stm, extra) in forms.items():
        kwm = dict(ADAM_HP, scalars=sc, has_wd=True, grad_scale=True,
                   **extra)
        yield f"multi_tensor_adam {form}", "multi_tensor_adam", (
            lambda stm=stm, kwm=kwm: mta.multi_tensor_adam_update(
                *stm, gm_, **kwm)), mta.multi_tensor_adam_cost(*stm, gm_)
    # K1 forward and backward (fused_norm_timing's tensors)
    spec = fn.NormSpec("ln", 1e-12, f32, f32, bf, f32, f32)
    x, res = rn((4096, 768), bf), rn((4096, 768), f32)
    w, bb = rn((768,), bf, 0.1), rn((768,), bf, 0.1)
    got = fn._launch_fwd(x, w, bb, res, None, spec)
    yield "fused_norm fwd ernie_o2_residual", "fused_norm", (
        lambda: fn._launch_fwd(x, w, bb, res, None, spec)), \
        (0.0, float(nbytes(x, res, w, bb, *got)))
    dy, dres = rn((4096, 768), spec.out), rn((4096, 768), spec.add)
    hh = x if got[1] is None else got[1]

    def k1_bwd():
        return fn._launch_bwd(dy, dres, hh, got[2], got[3], w, spec,
                              dx_dtype=spec.add, want_w=True, bias_dtype=bf,
                              pre_bias_dtype=None)
    yield "fused_norm bwd ernie_o2_residual", "fused_norm", k1_bwd, \
        (0.0, float(nbytes(dy, dres, hh, w, got[2], got[3], *k1_bwd())))
    # K2 (check_rope's fb), K3 forward and backward
    xs = [rn((6, 512, 20, 128), bf) for _ in range(2)]
    ang = torch.rand((4096, 64), generator=gen, device="cuda") * 6.3
    cos, sin = ang.cos(), ang.sin()

    def k2():
        return rp._launch(xs, cos, sin, offset=0, positions=None, neox=True,
                          dtype=bf, table_dtype=bf, backward=False,
                          out_dtypes=[bf] * 2)
    yield "rope llama_o2", "rope", k2, \
        (0.0, float(nbytes(*xs, cos, sin) + nbytes(*k2())))
    gg, uu, dyy = (rn((4096, 6912), bf) for _ in range(3))
    yield "swiglu fwd", "swiglu", (lambda: sw._launch_fwd(gg, uu, False)), \
        (0.0, float(nbytes(gg, uu, sw._launch_fwd(gg, uu, False))))
    yield "swiglu bwd", "swiglu", (
        lambda: sw._launch_bwd(gg, uu, dyy, False)), \
        (0.0, float(nbytes(gg, uu, dyy, *sw._launch_bwd(gg, uu, dyy,
                                                          False))))
    # K4 as the Llama loss reads it: rows l < L - 1 in place
    logits = rn((2, 1024, 32000), bf, 2.0)
    labels = torch.randint(0, 32000, (2, 1024), generator=gen,
                           device="cuda")
    lab2, lu = labels[:, 1:], 1023
    state = ce._launch_fwd(logits, lab2, lu, -100, f32)
    fb = ce.cross_entropy_cost(logits, lab2, lu)[1]
    yield "softmax_cross_entropy fwd", "softmax_cross_entropy", (
        lambda: ce._launch_fwd(logits, lab2, lu, -100, f32)), (0.0, float(fb))
    g1 = torch.tensor(0.75, device="cuda")
    dx = ce._launch_bwd(logits, lab2, lu, -100, f32, *state[1:], state[0],
                        g1)
    yield "softmax_cross_entropy bwd", "softmax_cross_entropy", (
        lambda: ce._launch_bwd(logits, lab2, lu, -100, f32, *state[1:],
                               state[0], g1)), (0.0, float(fb + nbytes(dx)))
    # K5 (check_embedding's fb and bb)
    eids = torch.randint(0, 40000, (32, 128), generator=gen, device="cuda")
    ew = rn((40000, 768), bf, 0.02)
    edy = rn((32, 128, 768), bf)
    hit = int(torch.unique(eids).numel())
    yield "embedding fwd ernie_word", "embedding", (
        lambda: em._launch_fwd(eids, ew, 0)), \
        (0.0, float(nbytes(eids) + hit * 768 * ew.element_size()
                    + nbytes(edy)))
    yield "embedding bwd ernie_word", "embedding", (
        lambda: em._launch_bwd(eids, edy, 40000, 0, bf)), \
        (0.0, float(nbytes(eids, edy) + 40000 * 768 * ew.element_size()))
    # K6, K7, K8 forward and backward
    y, yb, ydy = rn((4096, 3072), bf), rn((3072,), bf, 0.5), \
        rn((4096, 3072), bf)
    aspec = ba.ActSpec("gelu", bf, bf)
    yo = ba._launch_fwd(y, yb, aspec, None)
    yield "bias_act fwd ernie_o2", "bias_act", (
        lambda: ba._launch_fwd(y, yb, aspec, None)), \
        (0.0, float(nbytes(y, yb, yo)))
    yield "bias_act bwd ernie_o2", "bias_act", (
        lambda: ba._launch_bwd(y, yb, ydy, aspec, None)), \
        (0.0, float(nbytes(y, yb, ydy, *ba._launch_bwd(y, yb, ydy, aspec,
                                                         None))))
    seed = torch.tensor(DROPOUT_SEED, dtype=torch.int64, device="cuda")
    dx_ = rn((4096, 768), bf)
    yield "dropout fwd ernie_hidden_bf16", "dropout", (
        lambda: dr._launch_fwd(dx_, None, seed, 0.1, True)), \
        (0.0, float(nbytes(dx_, dr._launch_fwd(dx_, None, seed, 0.1,
                                                True))))
    yield "dropout bwd ernie_hidden_bf16", "dropout", (
        lambda: dr._launch_bwd(dx_, seed, 0.1, True, bf)), \
        (0.0, float(2 * nbytes(dx_)))
    sx, smask = rn((32, 12, 128, 128), bf), rn((32, 1, 128, 128), bf)
    sy = sm._launch_fwd(sx, smask, False)
    sdy = rn(sy.shape, bf)
    yield "softmax_mask fwd ernie", "softmax_mask", (
        lambda: sm._launch_fwd(sx, smask, False)), \
        (0.0, float(nbytes(sx, smask, sy)))
    yield "softmax_mask bwd ernie", "softmax_mask", (
        lambda: sm._launch_bwd(sy, sdy)), \
        (0.0, float(nbytes(sy, sdy, sm._launch_bwd(sy, sdy))))
    # K9's four calls through the wrappers that count them (moe_bytes)
    c = moe_case(torch, K9, gen, "token_choice", bf)
    want = moe_bytes(torch, c)
    r, s_ = c["routes"], c["spec"]
    dsp, cmb = K9.launches_dispatch, K9.launches_combine
    calls = {
        "dispatch_fwd": (dsp, lambda: K9._rows(
            c["x"], r, None, None, None, c["dt"], None, False, dsp)),
        "dispatch_bwd": (dsp, lambda: K9._gather(
            c["dy"], r, None, None, moe_dispatch_spec(K9, c), False, dsp)),
        "combine_fwd": (cmb, lambda: K9._gather(
            c["y"], r, c["gate"], c["bias"], s_, False, cmb)),
        "combine_bwd": (cmb, lambda: K9._rows(
            c["dout"], r, c["gate"], c["y"], c["bias"], c["dt"], s_.h,
            False, cmb))}
    for name, (ctr, call) in calls.items():
        yield f"{name} token_choice", ctr.name, call, (0.0, float(want[name]))


def check_cost_functions(torch, cost) -> list:
    """Each kernel case launched once under the registry's count: it files
    one launch of its own counter (the backward cases launch dq and dk/dv,
    each its own), with the flops and bytes its check feeds ``bound()``."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    rows = []
    for case, counter, launch, (flops, nbytes_) in cost_kernel_cases(torch,
                                                                      gen):
        with cost.counted() as tally:
            launch()
        torch.cuda.synchronize()
        got = tally.kernels.get(counter)
        ok = got == [1, float(flops), float(nbytes_)]
        rows.append({"case": case, "counter": counter, "filed": got,
                     "bound_inputs": [float(flops), float(nbytes_)],
                     "equal": ok})
        require(ok, f"cost_check: {case} filed {tally.kernels}, its check "
                    f"feeds bound() flops {flops} bytes {nbytes_}")
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def http_json(url: str):
    """GET ``url``: (status, JSON body), a 503's too."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def cost_step_closed_form(cfg, batch: int, seq: int, n_params: int) -> dict:
    """What the registry counts for bench.py's Llama step (recompute on,
    int8 AdamW), per token: each layer's products forward, twice in the
    backward and again in the recompute but for ``down_proj`` (PyTorch's
    non-reentrant checkpoint stops once the tensors the backward saved are
    rebuilt, and the layer's last product saves none), the head's forward
    and backward; flash attention's causal pairs forward (B2), again in the
    recompute, dq (B3) and dk/dv (B4); B5's 25 operations an element."""
    from paddle_tpu_torch.ops.flash_attention import attention_pairs
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    layer = cfg.num_hidden_layers * (2 * h * h + 2 * h * kv + 3 * h * i)
    tokens = batch * seq
    down = cfg.num_hidden_layers * h * i
    matmul = 8.0 * layer - 2.0 * down + 6.0 * h * v
    attn = cfg.num_hidden_layers * (4 + 4 + 6 + 8) * cfg.num_attention_heads \
        * cfg.head_dim * attention_pairs(seq, seq, True) / seq
    adam = 25.0 * n_params / tokens
    return {"matmul": matmul, "attention": attn, "adam": adam,
            "total": matmul + attn + adam}


def cost_train_step(torch, card, tobs, cost) -> dict:
    """bench.py's Llama step at 4 layers (batch 6, seq 4096, O2, int8
    AdamW, recompute), captured, 4 calls timed under train.step_seconds:
    its train.step record against the closed form and beside
    ``flops_per_token``; the utilization join's MFU."""
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bench_config()
    cfg.num_hidden_layers = 4
    batch, seq = 6, 4096
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                use_multi_tensor=False, moment_dtype="int8",
                use_master_weights=False)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                              master_weight=False)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))

    def llama_step(ids):
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    cap = jit.capture_step(llama_step)
    t0 = time.monotonic()
    cap(ids)
    torch.cuda.synchronize()
    capture_s = time.monotonic() - t0
    times = []
    for _ in range(4):
        t0 = time.monotonic()
        loss = cap(ids)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        tobs.observe("train.step_seconds", times[-1])
    require(cap.stats["retraces"] == 1 and cap.stats["hits"] == 4
            and math.isfinite(float(loss)), f"cost_check: the captured "
            f"step {cap.stats}, loss {float(loss)}")
    (rec,) = cost.records(site="train.step")
    tokens = batch * seq
    counted = rec["flops"] / tokens
    closed = cost_step_closed_form(cfg, batch, seq, model.num_params())
    require(abs(counted - closed["total"]) <= COST_STEP_RTOL
            * closed["total"], f"cost_check: train.step counts {counted} "
            f"flops a token, the closed form {closed}")
    util = [r for r in cost.utilization() if r["site"] == "train.step"]
    require(len(util) == 1 and util[0]["mfu"] > 0,
            f"cost_check: no train.step utilization row {util}")
    fpt = model.flops_per_token(seq)
    p50 = statistics.median(times)
    row = {"layers": 4, "batch": batch, "seq": seq, "capture_s": capture_s,
           "step_s": times, "step_p50_s": p50, "record": rec,
           "flops_per_token_counted": counted,
           "flops_per_token_closed_form": closed,
           "flops_per_token_formula": fpt,
           "counted_over_formula": counted / fpt,
           "mfu_join": util[0]["mfu"],
           "mfu_formula_p50": fpt * tokens / p50 / 989e12,
           "bandwidth_util_join": util[0]["bandwidth_util"],
           "gap_note": "flops_per_token = 6 N + 12 L H s: N counts the "
                       "embedding table (a lookup, no product), no "
                       "recompute forward, and the whole L x L attention "
                       "square; the registry counts the products run: the "
                       "recompute's second forward of each layer, the "
                       "causal pairs only, B5's update"}
    del cap, opt, model, ids, loss
    gc.collect()
    torch.cuda.empty_cache()
    return row


def cost_check(torch, card, model) -> None:
    """``cost_check``: the program cost registry on the card, observability
    and the registry on. The 7B engine's warm-up files one serving.decode
    record per bucket and one serving.prefill record per key, each with
    flops, bytes and temp_bytes; bucket 16's flops equal the closed form;
    after serving traffic the utilization join gives each bucket's
    bandwidth share; the HBM ledger's pool and parameter bytes equal the
    engine's and the model's; /debug/cost and /healthz carry the records and
    the hbm component; a decode graph captured with the registry off
    records and replays the same launches; bench.py's Llama step at 4 layers
    captured (train.step); each kernel's filed flops and bytes are those
    its check feeds bound()."""
    import numpy as np
    from paddle_tpu_torch import observability as tobs
    from paddle_tpu_torch.observability import cost
    from paddle_tpu_torch.observability.http import start_http_server
    require(cost.mode() == "on", "cost_check: PADDLE_TPU_COST is off")
    t_phase = time.monotonic()
    fresh_obs(tobs)
    cost.clear()
    require(cost.installed(), "cost_check: enable() did not install the "
                              "registry")
    cfg = model.config
    prefill_fn, _ = model.serving_callables(2048)
    t0 = time.monotonic()
    eng = engine_7b(model, prefill_fn, "off", COST_PROMPT_LENS)
    warmup_s = time.monotonic() - t0
    dec = cost.decode_bucket_records()
    pre = cost.records(site="serving.prefill")
    recs = list(dec.values()) + pre
    require(set(dec) == set(eng.config.buckets)
            and sorted(r["program"] for r in pre)
            == sorted(f"prefill[len={n}]" for n in COST_PROMPT_LENS)
            and all(r["model_source"] == "analytic" and r["flops"]
                    and r["bytes_accessed"] and r["temp_bytes"] is not None
                    for r in recs),
            f"cost_check: records after warmup {recs}")
    closed = 2.0 * 16 * matmul_params(cfg) + cfg.num_hidden_layers * 4 * \
        cfg.num_attention_heads * cfg.head_dim * 16
    rel = abs(dec[16]["flops"] - closed) / closed
    require(rel <= COST_FLOPS_RTOL, f"cost_check: decode bucket 16 flops "
            f"{dec[16]['flops']} against the closed form {closed}")
    # serving traffic, then the utilization join
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (COST_PROMPT_LENS[i % 3],),
                            dtype=np.int32) for i in range(16)]
    wall, results, stats = run_traffic(torch, eng, prompts, 64)
    util = {r["bucket"]: r for r in cost.utilization()
            if r["site"] == "serving.decode"}
    require(set(util) == set(eng.config.buckets) and all(
        0 < r["bandwidth_util"] for r in util.values()),
        f"cost_check: utilization rows {util}")
    led = cost.hbm_ledger()
    pool = eng.kv.pool.nbytes + (0 if eng.kv.scales is None
                                 else eng.kv.scales.nbytes)
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    require(led["kv_pool_bytes"] == pool and led["param_bytes"] == params,
            f"cost_check: ledger {led}, pool {pool}, params {params}")
    srv = start_http_server(0)
    try:
        code, doc = http_json(srv.url + "/debug/cost")
        hcode, health = http_json(srv.url + "/healthz")
    finally:
        srv.close()
    require(code == 200 and len(doc["records"]) == len(cost.records())
            and doc["hbm"]["kv_pool_bytes"] == pool,
            f"cost_check: /debug/cost {code} {doc.get('hbm')}")
    hbm = health["components"].get("hbm")
    require(hbm is not None and hbm["ok"] is True,
            f"cost_check: /healthz {hcode} without its hbm component")
    # the registry off: bucket 16 captured again records the same launches
    # (counting is in the warm-up call, never in a graph), and a replay of
    # each adds them
    g_on = eng.decode_graph(16)
    cost.uninstall()
    with eng._graph_lock:
        del eng._graphs[16]
    g_off = eng.decode_graph(16)
    cost.install()
    rec_on = {c.name: n for c, n in g_on.launches.items()}
    rec_off = {c.name: n for c, n in g_off.launches.items()}
    replay = {}
    for name, g in (("on", g_on), ("off", g_off)):
        before = {c.name: c.count for c in g.launches}
        with eng._launch_lock:
            g.replay()
        torch.cuda.synchronize()
        replay[name] = {c.name: c.count - before[c.name] for c in g.launches}
    require(g_off.tally is None and rec_on == rec_off
            and replay["on"] == replay["off"] == rec_on,
            f"cost_check: decode launches with the registry on {rec_on}, "
            f"off {rec_off}, replays {replay}")
    max_reserved = torch.cuda.max_memory_reserved()
    del eng, g_on, g_off
    gc.collect()
    torch.cuda.empty_cache()
    step = cost_train_step(torch, card, tobs, cost)
    kernels = check_cost_functions(torch, cost)
    tpot = cost._hist_mean("serving.tpot_seconds")
    emit({"phase": "cost_check", "card": card, "warmup_s": warmup_s,
          "records": {r["program"]: {k: r[k] for k in (
              "flops", "bytes_accessed", "temp_bytes", "analysis_seconds")}
              for r in recs},
          "decode_b16_flops": dec[16]["flops"],
          "decode_b16_closed_form": closed, "decode_b16_rel_err": rel,
          "traffic": {**serving_numbers(results, wall),
                      "tpot_mean_s": tpot,
                      "decode_steps": sum(stats["steps"].values())},
          "bandwidth_util": {b: r["bandwidth_util"]
                             for b, r in sorted(util.items())},
          "mfu": {b: r["mfu"] for b, r in sorted(util.items())},
          "hbm_ledger": led, "max_memory_reserved": max_reserved,
          "healthz_status": hcode, "healthz_hbm": hbm,
          "decode_b16_launches": rec_on, "decode_b16_replay": replay,
          "train_step": step, "kernel_cases": kernels,
          "seconds": time.monotonic() - t_phase})
    tobs.disable()
    tobs.reset()


# ---------------------------------------------------------------------------
# the dense decode tier (serve_7b_dense, serve_fmt_dense), the loss ops
# (loss_ops_check) and Transformer-base (train_transformer_base)
# ---------------------------------------------------------------------------

DENSE_MAX_LEN, DENSE_PROMPT, DENSE_NEW, DENSE_REQUESTS = 1024, 512, 64, 16
DENSE_BUCKETS = (1, 4, 16)
# one bucket-16 step of the dense and the paged tier from one pool state
# picks the same token in every row but where the paged tier's own logits
# put the dense tier's pick within this many bf16 ulps of its top one: a
# tie either way. Over the later teacher-forced steps the two tiers' logits
# (fp32 attention over the stacked cache against B6's split sums, each
# layer's output rounded to bf16) drift apart by rounding: held as
# ||dense - paged|| / ||paged|| a row within DENSE_LOGITS_REL, one bf16
# rounding a layer plus two (serve_fmt_parity's limit at 32 layers)
DENSE_TIE_ULPS = 2
DENSE_LOGITS_REL = (32 + 2) * KV_ROUNDING_PER_LAYER
# the gates' prompts (cut from the traffic's) and teacher-forced steps: t
# runs 508-515 across the page boundary at 512
DENSE_GATE_PROMPT, DENSE_GATE_STEPS = 508, 8
# a bf16 page the JAX package's tiling rule refuses (its sublane is 16),
# which its engine demotes to the dense tier on a TPU
DEMOTED_PAGE_SIZE = 8
# a bf16 page that rule takes and the paged kernel cannot stage
# (ops.paged_attention._MAX_PAGE 256): refused at construction
REFUSED_PAGE_SIZE = 512


def engine_7b_tier(model, tier: str, page_size: int = 64,
                   max_batch: int = DENSE_REQUESTS, buckets=DENSE_BUCKETS):
    """The 7B engine of serve_7b_dense on decode tier ``tier`` (the
    ``ServingConfig.paged_attention`` value)."""
    from paddle_tpu_torch.serving import Engine, ServingConfig
    cfg = model.config
    return Engine(*model.serving_callables(DENSE_MAX_LEN), ServingConfig(
        num_layers=cfg.num_hidden_layers, num_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, max_len=DENSE_MAX_LEN, max_batch=max_batch,
        buckets=buckets, page_size=page_size, compute_dtype="bfloat16",
        kv_dtype="native", prefix_sharing="off", paged_attention=tier,
        device="cuda"))


def kept_logits(model, kept: dict, tag: str):
    """``model._logits`` that also keeps each call's logits in ``kept``
    under ``(tag, rows)``: set on the instance while an engine captures its
    graphs, it makes each graph keep its step's logits (a bucket's kept
    tensor is rewritten by every replay of its graph)."""
    logits = type(model)._logits.__get__(model)

    def keep(h):
        out = logits(h)
        kept[tag, h.shape[0]] = out
        return out
    return keep


def tier_gates(torch, de, pe, prompts, kept: dict) -> dict:
    """Gates 1 and 2 of serve_7b_dense. The prompts cut to
    ``DENSE_GATE_PROMPT`` tokens are prefilled into the dense engine's pool
    (slot i on pages 1 + 16 i ...) and the pool copied into the paged
    engine's; then ``DENSE_GATE_STEPS`` bucket-16 decode replays on each
    tier, both fed the paged tier's tokens (teacher forcing), crossing a
    page at t = 512. Gate 1: the first step's next tokens equal but where
    the paged tier's own logits (``kept`` by its graph) put the dense pick
    within DENSE_TIE_ULPS bf16 ulps of its top one; at every step the two
    tiers' logits within DENSE_LOGITS_REL (the later steps' differing picks
    are listed with both tiers' margins). Gate 2, after the first replay: the pools bit-equal at every position but each row's t (page 0,
    the warm-ups' scratch, aside); at t layer 0's K/V are bit-equal too
    (later layers read attention outputs that the two tiers round
    apart)."""
    import numpy as np
    s = de.kv.config.pages_per_slot
    ps = de.kv.config.page_size
    n = len(prompts)
    tables = (1 + np.arange(n * s, dtype=np.int32)).reshape(n, s)
    tok = np.array([[de._prefill(p[:DENSE_GATE_PROMPT], tables[i])]
                    for i, p in enumerate(prompts)], np.int64)
    pe.kv.pool.copy_(de.kv.pool)
    tok0 = tok.copy()
    flips, equal_rows, rel, pool_gate = [], [], [], None
    for k in range(DENSE_GATE_STEPS):
        t = np.full((n,), DENSE_GATE_PROMPT + k, np.int32)
        dense_next = de._decode(tok, tables, t)
        paged_next = pe._decode(tok, tables, t)
        equal_rows.append(int((dense_next == paged_next).sum()))
        lg = {tier: kept[tier, n].reshape(n, -1).float()
              for tier in ("dense", "paged")}
        rel.append(float(((lg["dense"] - lg["paged"]).norm(dim=1)
                          / lg["paged"].norm(dim=1)).max()))
        for i in np.flatnonzero(dense_next != paged_next).tolist():
            d, p = int(dense_next[i]), int(paged_next[i])
            top = float(lg["paged"][i, p])
            margin = top - float(lg["paged"][i, d])
            flips.append({"step": k, "row": i, "dense": d, "paged": p,
                          "paged_margin": margin,
                          "dense_margin": float(lg["dense"][i, d]
                                                - lg["dense"][i, p]),
                          "bf16_ulp": bf16_ulp(top),
                          "tie": margin <= DENSE_TIE_ULPS * bf16_ulp(top)})
        if k == 0:
            pool_gate = pools_equal_but_t(torch, de.kv.pool, pe.kv.pool,
                                          tables, t, ps)
        tok = paged_next.astype(np.int64).reshape(n, 1)
    require(all(f["tie"] for f in flips if f["step"] == 0)
            and max(rel) <= DENSE_LOGITS_REL,
            f"serve_7b_dense gate 1: the tiers pick other tokens outside a "
            f"tie at the first step, or their logits drift beyond "
            f"{DENSE_LOGITS_REL}: {rel} {flips}")
    require(pool_gate["pools_equal_but_t"]
            and pool_gate["kv_at_t_layer0_equal"],
            f"serve_7b_dense gate 2: the pools differ after one replay of "
            f"each tier: {pool_gate}")
    return {"rows": n, "t": [DENSE_GATE_PROMPT,
                             DENSE_GATE_PROMPT + DENSE_GATE_STEPS - 1],
            "steps": DENSE_GATE_STEPS, "tokens_equal_rows": equal_rows,
            "logits_rel_err_max": rel, "logits_rel_limit": DENSE_LOGITS_REL,
            "flips": flips, "tie_limit_ulps": DENSE_TIE_ULPS, **pool_gate,
            "tables": tables, "tok": tok0}


def pools_equal_but_t(torch, a, b, tables, t, ps: int) -> dict:
    """Whether pools ``a`` and ``b`` are bit-equal on every page but 0 away
    from each row's position ``t``, and how they compare at ``t``."""
    n = len(t)
    rows = torch.arange(n, device="cuda")
    pages = torch.as_tensor(tables, device="cuda").long()[
        rows, torch.as_tensor(t // ps, device="cuda").long()]
    offs = torch.as_tensor(t % ps, device="cuda").long()
    at_a, at_b = a[pages, :, :, :, offs], b[pages, :, :, :, offs]
    out = {"kv_at_t_equal": torch.equal(at_a, at_b),
           "kv_at_t_layer0_equal": torch.equal(at_a[:, 0], at_b[:, 0]),
           "kv_at_t_max_abs": float((at_a.float() - at_b.float()).abs()
                                    .max())}
    a[pages, :, :, :, offs] = at_b
    out["pools_equal_but_t"] = all(torch.equal(a[i:i + 16], b[i:i + 16])
                                   for i in range(1, a.shape[0], 16))
    a[pages, :, :, :, offs] = at_a
    return out


def dense_step_cost(torch, kvc, de, pe, gates) -> dict:
    """One bucket-16 replay of each tier at 16 live rows of t = 508 (the
    gates' pool), and the dense tier's gather alone into its buffer, beside
    the gather's bytes bound (the stacked cache read from the pool and
    written once)."""
    import numpy as np
    t = np.full((DENSE_REQUESTS,), DENSE_GATE_PROMPT, np.int32)
    out = {}
    for name, eng in (("dense", de), ("paged", pe)):
        g = eng.decode_graph(DENSE_REQUESTS)
        g.load(gates["tok"], gates["tables"], t)
        out[f"{name}_replay_ms"] = cuda_ms(torch, g.replay, 10)
    g = de.decode_graph(DENSE_REQUESTS)
    tables_d = torch.as_tensor(gates["tables"], device="cuda")
    out["gather_ms"] = cuda_ms(torch, lambda: kvc.gather_pages(
        de.kv.pool, None, tables_d, torch.bfloat16, out=g.dense), 10)
    out["dense_buffer_gb"] = nbytes(g.dense) / 1e9
    out["gather_bound_ms"], _ = bound(0, 2 * nbytes(g.dense), "bfloat16")
    out["gather_share_of_dense_replay"] = out["gather_ms"] / out[
        "dense_replay_ms"]
    return out


def demoted_engine_serves(torch, model, prompt) -> dict:
    """Gate 3: a kernel-tier 7B engine at a page size the JAX package's
    tiling rule refuses is built on the dense tier with the warning and
    serves one request; one at a page size that rule takes and the paged
    kernel cannot stage raises ``NotImplementedError`` at construction."""
    import logging
    try:
        engine_7b_tier(model, "on", page_size=REFUSED_PAGE_SIZE,
                       max_batch=1, buckets=(1,))
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    require(refused is not None,
            f"serve_7b_dense gate 3: page_size {REFUSED_PAGE_SIZE} on the "
            f"kernel tier was built, not refused")
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    log = logging.getLogger("paddle_tpu_torch.serving.engine")
    handler = Keep(logging.WARNING)
    log.addHandler(handler)
    try:
        eng = engine_7b_tier(model, "on", page_size=DEMOTED_PAGE_SIZE,
                             max_batch=1, buckets=(1,))
    finally:
        log.removeHandler(handler)
    require(eng.decode_path == "dense"
            and any("dense decode tier" in r for r in records),
            f"serve_7b_dense gate 3: page_size {DEMOTED_PAGE_SIZE} on the "
            f"kernel tier: decode_path {eng.decode_path}, log {records}")
    eng.warmup([DENSE_PROMPT])
    wall, results, stats = run_traffic(torch, eng, [prompt], 8)
    require(len(results[0].tokens) == 8 and eng.kv.outstanding_pages == 0
            and sum(stats["replays"].values()) == 7,
            f"serve_7b_dense gate 3: the demoted engine served "
            f"{results[0].tokens}, replays {stats['replays']}")
    out = {"page_size": DEMOTED_PAGE_SIZE, "decode_path": eng.decode_path,
           "warning": records[-1], "tokens": results[0].tokens,
           "wall_s": wall, "refused_page_size": REFUSED_PAGE_SIZE,
           "refused": refused}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_7b_dense(torch, card, fa, pa, kvc, model) -> dict:
    """Llama-2-7B at full width on the dense decode tier
    (``paged_attention="off"``, max_len 1024, buckets 1, 4, 16): the
    three gates (:func:`tier_gates`, :func:`demoted_engine_serves`), then
    16 x 512-token prompts with 64 new tokens each on the dense and on the
    paged tier, one run each (tok/s, TTFT, TPOT, peak memory, launches, the
    ``serving.paged_attention_steps_total`` path), and one bucket-16 step
    of each timed (:func:`dense_step_cost`)."""
    import numpy as np
    from paddle_tpu_torch import observability as obs
    t_phase = time.monotonic()
    cfg = model.config
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size, (DENSE_PROMPT,),
                            dtype=np.int32) for _ in range(DENSE_REQUESTS)]
    engines, kept = {}, {}
    for tier, tag in (("off", "dense"), ("on", "paged")):
        t0 = time.monotonic()
        model._logits = kept_logits(model, kept, tag)
        try:
            engines[tier] = engine_7b_tier(model, tier).warmup(
                [DENSE_PROMPT, DENSE_GATE_PROMPT])
        finally:
            del model._logits
        engines[tier].warmup_s = time.monotonic() - t0
    de, pe = engines["off"], engines["on"]
    require(de.decode_path == "dense" and pe.decode_path == "kernel",
            f"serve_7b_dense: tiers {de.decode_path}, {pe.decode_path}")
    gates = tier_gates(torch, de, pe, prompts, kept)
    cost = dense_step_cost(torch, kvc, de, pe, gates)
    counters = {"flash_prefill": fa.launches, "paged_decode": pa.launches,
                **{k: c for k, c in step_counters().items()
                   if k in SERVE_FUSED}}
    runs = {}
    for tier, eng in (("dense", de), ("paged", pe)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fresh_obs(obs)
        obs.enable()
        for c in counters.values():
            c.reset()
        try:
            wall, results, stats = run_traffic(torch, eng, prompts, DENSE_NEW)
        finally:
            obs.disable()
        launches = {k: c.count for k, c in counters.items()}
        steps = sum(stats["steps"].values())
        paths = obs.snapshot().get("serving.paged_attention_steps_total", {})
        want_path = "path=dense" if tier == "dense" else "path=kernel"
        require(paths == {want_path: steps},
                f"serve_7b_dense {tier}: path counter {paths}, {steps} steps")
        if tier == "paged":
            require_served(eng, results, stats, launches, cfg.vocab_size,
                           cfg.num_hidden_layers, DENSE_NEW, DENSE_REQUESTS,
                           "serve_7b_dense paged")
        else:
            layers = cfg.num_hidden_layers
            per = {"fused_norm": 2 * layers + 1, "rope": layers,
                   "swiglu": layers, "embedding": 1}
            calls = DENSE_REQUESTS + steps
            require(all(len(r.tokens) == DENSE_NEW for r in results)
                    and sum(stats["replays"].values()) == steps > 0
                    and launches["paged_decode"] == 0
                    and launches["flash_prefill"] == DENSE_REQUESTS * layers
                    and all(launches[k] == n * calls
                            for k, n in per.items())
                    and eng.kv.outstanding_pages == 0,
                    f"serve_7b_dense dense: launches {launches}, {steps} "
                    f"steps, replays {stats['replays']}")
        runs[tier] = {**serving_numbers(results, wall),
                      "decode_steps": steps, "graph_replays": stats["replays"],
                      "launches": launches, "path_counter": paths,
                      "warmup_s": eng.warmup_s, **memory_gb(torch)}
        runs[tier]["transcripts"] = [r.tokens for r in results]
    del eng
    obs.reset()
    pairs = list(zip(runs["dense"].pop("transcripts"),
                     runs["paged"].pop("transcripts")))
    same = {"equal": sum(a == b for a, b in pairs),
            "first_difference": [next((j for j, (x, y) in enumerate(
                zip(a, b)) if x != y), None) for a, b in pairs]}
    kept.clear()
    del de, pe, engines
    gc.collect()
    torch.cuda.empty_cache()
    demoted = demoted_engine_serves(torch, model, prompts[0])
    gates = {k: v for k, v in gates.items() if k not in ("tables", "tok")}
    emit({"phase": "serve_7b_dense", "card": card, "layers":
          cfg.num_hidden_layers, "dtype": "bfloat16", "max_len":
          DENSE_MAX_LEN, "buckets": list(DENSE_BUCKETS), "requests":
          DENSE_REQUESTS, "prompt_len": DENSE_PROMPT, "new_tokens":
          DENSE_NEW, "runs": runs, "transcripts_equal_across_tiers": same,
          "gates": gates, "step_cost": cost, "demoted": demoted,
          "seconds": time.monotonic() - t_phase})
    return runs["dense"]["launches"]


def serve_fmt_dense(torch, card, fa, pa) -> dict:
    """The FMT stack's 2-layer bf16 engine at full width on the dense tier
    (serve_fmt's traffic: 16 x 512 tokens, 64 new, buckets 1, 4, 16): no
    paged launch, B1, K1, K6 and K5 as on the paged tier, and the
    transcripts against the bs=1 dense reference under serve_fmt_parity's
    gate (:func:`fmt_parity` at 2 layers, the logits kept by a dense-tier
    engine)."""
    import numpy as np
    layers = 2
    stack = fmt_stack(torch, layers, torch.bfloat16, seed=0)
    t0 = time.monotonic()
    eng = fmt_engine(stack, FMT_MAX_LEN, FMT_REQUESTS, FMT_BUCKETS, "native",
                     "bfloat16", paged_attention="off").warmup([FMT_PROMPT])
    warmup_s = time.monotonic() - t0
    require(eng.decode_path == "dense", f"serve_fmt_dense: {eng.decode_path}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, FMT["vocab"], (FMT_PROMPT,), dtype=np.int32)
               for _ in range(FMT_REQUESTS)]
    counters = fmt_counters(fa, pa)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    wall, results, stats = run_traffic(torch, eng, prompts, FMT_NEW)
    launches = {k: c.count for k, c in counters.items()}
    steps = sum(stats["steps"].values())
    want = {"flash_prefill": FMT_REQUESTS * layers, "paged_decode": 0,
            **{k: n * (FMT_REQUESTS + steps)
               for k, n in fmt_per_call(layers).items()}}
    require(launches == want and sum(stats["replays"].values()) == steps > 0
            and eng.kv.outstanding_pages == 0,
            f"serve_fmt_dense: launches {launches}, want {want}; replays "
            f"{stats['replays']}")
    emit({"phase": "serve_fmt_dense", "card": card, "layers": layers,
          "dtype": "bfloat16", **FMT, "requests": FMT_REQUESTS,
          "prompt_len": FMT_PROMPT, "new_tokens": FMT_NEW,
          "max_len": FMT_MAX_LEN, "decode_tier": eng.decode_path,
          **serving_numbers(results, wall), "decode_steps": steps,
          "launches": launches, "warmup_s": warmup_s, **memory_gb(torch)})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    fmt_parity(torch, card, stack, prompts, [r.tokens for r in results],
               layers=layers, phase="serve_fmt_dense_parity",
               paged_attention="off")
    del stack
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# K4's forms of this slice at Transformer-base's vocabulary, 16384 rows:
# (name, label smoothing, class weights, reduction, ignore_index, labels)
LOSS_ROWS, LOSS_VOCAB = 16384, 37000
LOSS_FORMS = (
    ("smooth", 0.1, False, "mean", -100, "random"),
    ("weighted", 0.0, True, "mean", -100, "random"),
    ("smooth_weighted_none", 0.1, True, "none", -100, "random"),
    ("smooth_sum_ignore0", 0.1, False, "sum", 0, "random"),
    ("oov_ignore_n100", 0.1, False, "mean", -100, "oov"),
    ("oov_ignore_0", 0.0, False, "mean", 0, "oov"),
    ("weighted_wrap", 0.1, True, "mean", 0, "wrap"),
)


def loss_labels(torch, gen, kind: str, v: int):
    """Labels of one form: random classes (1 in 8 set to 0), with every
    seventh row cycling through -100, -1, V and V + 7 ("oov") or set to -1
    ("wrap": a class weight read from the end of the table, as jnp.take
    reads it)."""
    lab = torch.randint(0, v, (LOSS_ROWS,), generator=gen, device="cuda")
    lab[::8] = 0
    if kind == "oov":
        bad = torch.tensor([-100, -1, v, v + 7], device="cuda")
        lab[3::7] = bad.repeat(LOSS_ROWS // 28 + 1)[:lab[3::7].numel()]
    elif kind == "wrap":
        lab[3::7] = -1
    return lab


def loss_ops_check(torch, gen) -> dict:
    """K4's forms of this slice on the card against their plain version on
    the same inputs: logits (16384, 37000) bf16 read as fp32 (O2's cast),
    label smoothing 0.1, class weights, each reduction, labels outside the
    vocabulary at ignore_index -100 and 0. Loss (fp32, FUSED_TOL "out":
    rtol 1e-5, atol 1e-5 rms) and gradient (bf16, rtol 2^-7, atol 1e-6
    rms) of each; three bit-equal launches of the smoothed form; each
    form's forward timed beside its bound (``cross_entropy_cost``), its
    plain version and ``F.cross_entropy`` with the same smoothing, weight
    and reduction (none where a label lies outside the vocabulary, which
    it refuses); the smoothed form's backward too."""
    from paddle_tpu_torch.ops import softmax_cross_entropy as ce
    t0 = time.monotonic()
    v = LOSS_VOCAB
    x = (torch.randn(LOSS_ROWS, v, generator=gen, device="cuda")
         * 2).bfloat16()
    w = torch.rand(v, generator=gen, device="cuda") * 1.5 + 0.5
    f32 = torch.float32
    rows = {}
    for name, eps, weighted, red, ign, kind in LOSS_FORMS:
        lab = loss_labels(torch, gen, kind, v)
        wt = w if weighted else None
        kw = dict(dtype=f32, weight=wt, label_smoothing=eps, reduction=red)
        cot = (torch.randn(LOSS_ROWS, generator=gen, device="cuda")
               if red == "none" else torch.tensor(0.75, device="cuda"))

        def fwd_bwd(fn, lab=lab, ign=ign, kw=kw, cot=cot):
            leaf = x.detach().requires_grad_()
            loss = fn(leaf, lab, ign, **kw)
            (dx,) = torch.autograd.grad(loss, leaf, cot)
            return {"loss": loss.detach(), "dx": dx}
        got = fwd_bwd(ce.softmax_cross_entropy)
        ref = fwd_bwd(ce.softmax_cross_entropy_reference)
        ok, err, errs = fused_compare(torch, {
            "loss": (got["loss"], ref["loss"], "out"),
            "dx": (got["dx"], ref["dx"], "out")})
        require(ok, f"loss_ops_check {name}: beyond FUSED_TOL: {errs}")
        x3 = x.unsqueeze(0)
        lab2 = lab.view(1, -1)
        fb = ce.cross_entropy_cost(x3, lab2, LOSS_ROWS, None, wt,
                                   red == "none")[1]
        library = None
        if kind == "random":
            def library(lab=lab, ign=ign, wt=wt, eps=eps, red=red):
                return torch.nn.functional.cross_entropy(
                    x, lab, weight=None if wt is None else wt.to(x.dtype),
                    ignore_index=ign, label_smoothing=eps, reduction=red)
        with torch.no_grad():
            timing = fused_timing(
                torch, lambda lab=lab, ign=ign, kw=kw:
                ce.softmax_cross_entropy(x, lab, ign, **kw),
                lambda lab=lab, ign=ign, kw=kw:
                ce.softmax_cross_entropy_reference(x, lab, ign, **kw),
                library)
        timing["bound_ms"], timing["bound_by"] = bound(0, fb, "float32")
        row = {"case": f"logits ({LOSS_ROWS}, {v}) bf16 read as fp32, "
                       f"label_smoothing {eps}, weights "
                       f"{'yes' if weighted else 'no'}, reduction {red}, "
                       f"ignore_index {ign}, labels {kind}",
               "max_abs_err": err, "errs": errs,
               "loss": float(got["loss"].float().sum()), **timing}
        if name == "smooth":
            fused_repeat_equal(torch, lambda: fwd_bwd(
                ce.softmax_cross_entropy), f"loss_ops_check {name}")
            out, m, logs, valid = ce._launch_fwd(x3, lab2, LOSS_ROWS, ign,
                                                 f32, eps=eps)
            g = torch.tensor(0.75, device="cuda")
            row["bwd_device_ms"] = device_ms(torch, lambda: ce._launch_bwd(
                x3, lab2, LOSS_ROWS, ign, f32, m, logs, valid, out, g,
                eps=eps))
            row["bwd_bound_ms"], _ = bound(0, fb + nbytes(x), "float32")
            leaf = x.detach().requires_grad_()

            def library_fb():
                leaf.grad = None
                torch.nn.functional.cross_entropy(
                    leaf, lab, label_smoothing=eps).backward()
            row["bwd_library_ms"] = cuda_ms(torch, library_fb, 5) \
                - timing["library_ms"]
        rows[name] = row
        del got, ref
    emit({"phase": "loss_ops_check", "seconds": time.monotonic() - t0,
          "tolerance": {"loss": FUSED_TOL["out", "float32"],
                        "dx": FUSED_TOL["out", "bfloat16"]},
          "forms": rows})
    del x
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# Transformer-base ("Attention Is All You Need", Table 3 "base"): the
# defaults of paddle.nn.Transformer; WMT14 en-de's shared BPE vocabulary
TB_VOCAB, TB_BATCH, TB_LEN, TB_MIN_LEN = 37000, 96, 256, 128
TB_SEED, TB_WARM, TB_TIMED = 0, 2, 10
TB_EPS = 0.1
TB_CPU_LAYERS, TB_CPU_BATCH, TB_CPU_LEN = 2, 4, 64


def seq2seq(torch, d_model: int, layers: int, device, seed: int):
    """paddle.nn.Transformer at its defaults (``layers`` a stack) under one
    shared Embedding(TB_VOCAB, d_model) scaled by sqrt(d_model) plus fixed
    sinusoidal positions, dropout 0.1 on the sums, and an untied bias-free
    head; weights N(0, 0.02) from ``seed``, every dropout seeded by the
    Transformer's DropoutRNG."""
    from torch import nn as tnn

    from paddle_tpu_torch import nn

    class Seq2Seq(tnn.Module):
        def __init__(self):
            super().__init__()
            self.transformer = nn.Transformer(
                d_model, num_encoder_layers=layers,
                num_decoder_layers=layers, device=device)
            self.embed = nn.Embedding(TB_VOCAB, d_model, padding_idx=0,
                                      device=device)
            self.head = nn.Linear(d_model, TB_VOCAB, bias_attr=False,
                                  device=device)
            self.drop = nn.Dropout(0.1, rng=self.transformer.rng)
            pos = torch.arange(TB_LEN, dtype=torch.float64)[:, None]
            i = torch.arange(0, d_model, 2, dtype=torch.float64)
            ang = pos / 10000.0 ** (i / d_model)
            pe = torch.zeros(TB_LEN, d_model, dtype=torch.float64)
            pe[:, 0::2], pe[:, 1::2] = torch.sin(ang), torch.cos(ang)
            self.register_buffer("pos", pe.float().to(device))
            gen = torch.Generator(device=device).manual_seed(seed)
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.reset_parameters(gen)

        def inputs(self, ids):
            x = self.embed(ids) * math.sqrt(d_model)
            return self.drop(x + self.pos[:ids.shape[1]].to(x.dtype))

        def forward(self, src, tgt_in, src_keep, tgt_mask):
            out = self.transformer(self.inputs(src), self.inputs(tgt_in),
                                   src_keep, tgt_mask, src_keep)
            return self.head(out)
    return Seq2Seq()


def seq2seq_batch(torch, batch: int, length: int, min_len: int, seed: int,
                  device):
    """Source ids, shifted target ids (BOS 1), labels (0 = padding) and the
    key-padding mask ``(B, 1, 1, length)`` of the source: every length
    drawn from ``seed`` in ``[min_len, length]``, tokens in [2, V)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    src = np.zeros((batch, length), np.int64)
    tgt_in = np.zeros((batch, length), np.int64)
    labels = np.zeros((batch, length), np.int64)
    ls = rng.integers(min_len, length + 1, batch)
    lt = rng.integers(min_len, length + 1, batch)
    for i in range(batch):
        src[i, :ls[i]] = rng.integers(2, TB_VOCAB, ls[i])
        y = rng.integers(2, TB_VOCAB, lt[i])
        labels[i, :lt[i]] = y
        tgt_in[i, 0] = 1
        tgt_in[i, 1:lt[i]] = y[:-1]
    keep = np.arange(length)[None, :] < ls[:, None]
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (as_t(src), as_t(tgt_in), as_t(labels),
            as_t(keep[:, None, None, :]), int(ls.sum()), int(lt.sum()))


def transformer_base_vs_cpu(torch, fa) -> dict:
    """A 2 + 2-layer Transformer at base width in fp32, training mode with
    every dropout on, one forward and backward on the card and on the CPU
    (the kernels' plain versions) from one state dict: the DropoutRNGs
    derive the same seeds, so the card's masks are the CPU's. Loss rel
    1e-4, logits 1e-4, each gradient 1e-3 of its largest element (floored
    at 1e-3 of the model's largest), as ernie_vs_cpu."""
    from paddle_tpu_torch.ops.loss_ops import cross_entropy
    runs, init = {}, None
    counters = {e: fa.launches_variant[e, "segs_drop"]
                for e in ("fwd_lse", "bwd_dq", "bwd_dkv")}
    for dev in ("cuda", "cpu"):
        model = seq2seq(torch, 512, TB_CPU_LAYERS, dev, TB_SEED)
        if init is None:
            init = {k: v.cpu() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        src, tgt_in, labels, keep, _, _ = seq2seq_batch(
            torch, TB_CPU_BATCH, TB_CPU_LEN, TB_CPU_LEN // 2, 5, dev)
        mask = model.transformer.generate_square_subsequent_mask(TB_CPU_LEN)
        for c in counters.values():
            c.reset()
        logits = model(src, tgt_in, keep, mask)
        loss = cross_entropy(logits, labels, ignore_index=0,
                             label_smoothing=TB_EPS)
        loss.backward()
        runs[dev] = dict(loss=float(loss), logits=logits.detach().cpu(),
                         grads={k: p.grad.detach().cpu()
                                for k, p in model.named_parameters()},
                         launches={e: c.count for e, c in counters.items()})
        del model, loss, logits
    a, b = runs["cuda"], runs["cpu"]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    logit_err = float((a["logits"] - b["logits"]).abs().max())
    floor = 1e-3 * max(float(g.abs().max()) for g in b["grads"].values())
    grad_rel = max(float((a["grads"][k] - b["grads"][k]).abs().max())
                   / max(float(b["grads"][k].abs().max()), floor)
                   for k in b["grads"])
    require(loss_rel < 1e-4 and logit_err < 1e-4 and grad_rel < 1e-3
            and all(n == 2 * TB_CPU_LAYERS for n in a["launches"].values())
            and not any(b["launches"].values()),
            f"Transformer card vs CPU: loss rel {loss_rel}, logits "
            f"{logit_err}, grad rel {grad_rel}, launches {a['launches']} / "
            f"{b['launches']}")
    out = {"layers": f"{TB_CPU_LAYERS} + {TB_CPU_LAYERS}", "dtype": "float32",
           "batch": TB_CPU_BATCH, "len": TB_CPU_LEN, "dropout": 0.1,
           "loss_card": a["loss"], "loss_cpu": b["loss"],
           "loss_rel": loss_rel, "logits_max_abs": logit_err,
           "grad_max_rel": grad_rel,
           "tolerance": {"loss_rel": 1e-4, "logits_abs": 1e-4,
                         "grad_rel": 1e-3},
           "launches_card": a["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def transformer_counters(fa, mta) -> dict:
    c = step_counters()
    return {**{f"{e}[segs_drop]": fa.launches_variant[e, "segs_drop"]
               for e in ("fwd_lse", "bwd_dq", "bwd_dkv")},
            "multi_tensor_adam": mta.launches,
            **{k: c[k] for k in ("softmax_cross_entropy", "fused_norm",
                                 "bias_act", "dropout", "embedding")}}


def train_transformer_base(torch, card, fa, mta) -> dict:
    """Transformer-base at full width (``paddle_tpu_torch.nn.Transformer()``
    at its defaults, 6 + 6 layers; :func:`seq2seq`) trained under AMP O2
    bf16 with fp32 masters, multi-tensor AdamW (beta2 0.98, eps 1e-9, no
    weight decay) and ``NoamDecay(512, 4000)``, on one batch of 96 pairs
    padded to 256 (lengths from ``TB_SEED`` in 128-256; key-padding source
    and memory masks, the square subsequent target mask), loss
    ``cross_entropy(label_smoothing=0.1, ignore_index=0)``. The eager tier
    runs 2 warm-up and 10 timed steps, then the captured tier
    (``jit.capture_step``) the same 12 from the same state (host copy):
    losses and the digests of parameters, master, m, v, step count and
    dropout counter bit-equal. Launches a step: B2-B4 SEGS+DROP 12 each
    (encoder self and decoder cross attention), K4 2, multi-tensor AdamW
    1. MFU from ``paddle_tpu_torch.flops``: 6 x its multiply-adds of the
    Transformer at the padded shape plus the head's, over 989 TFLOP/s. The
    eval loss must fall; then :func:`transformer_base_vs_cpu`."""
    from paddle_tpu_torch import amp, flops, jit
    from paddle_tpu_torch.ops.loss_ops import cross_entropy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_mod
    t_phase = time.monotonic()
    model = seq2seq(torch, 512, 6, "cuda", TB_SEED)
    n_params = sum(p.numel() for p in model.parameters())
    sched = lr_mod.NoamDecay(512, 4000)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                beta2=0.98, epsilon=1e-9, weight_decay=0.0,
                use_multi_tensor=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    src, tgt_in, labels, keep, src_tokens, tgt_tokens = seq2seq_batch(
        torch, TB_BATCH, TB_LEN, TB_MIN_LEN, TB_SEED, "cuda")
    mask = model.transformer.generate_square_subsequent_mask(TB_LEN)

    def step(src, tgt_in, labels):
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            logits = model(src, tgt_in, keep, mask)
            loss = cross_entropy(logits, labels, ignore_index=0,
                                 label_smoothing=TB_EPS)
        loss.backward()
        return loss

    def update():
        opt.step()
        opt.clear_grad()

    def eval_loss():
        model.eval()
        with torch.no_grad(), amp.auto_cast(enable=True, level="O2",
                                            dtype="bfloat16"):
            logits = model(src, tgt_in, keep, mask)
            loss = cross_entropy(logits, labels, ignore_index=0,
                                 label_smoothing=TB_EPS)
        model.train()
        return float(loss)

    fs = opt._flat
    state = (list(model.parameters())
             + [fs.master, fs.m, fs.v, opt._step_t,
                model.transformer.rng.counter])
    saved = [x.detach().cpu().clone() for x in state]
    epoch0 = sched.last_epoch
    path = transformer_counters(fa, mta)
    steps = TB_WARM + TB_TIMED
    before = eval_loss()
    runs = {}
    for tier in ("eager", "captured"):
        with torch.no_grad():
            for x, c in zip(state, saved):
                x.copy_(c)
        sched.step(epoch0)
        call = (captured_step(jit, step, "off", update_fn=update,
                              clear_fn=opt.clear_grad, nan_gate=True)
                if tier == "eager" else
                jit.capture_step(step, update_fn=update,
                                 clear_fn=opt.clear_grad, nan_gate=True))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in path.values():
            c.reset()
        stop = sample_card()
        losses, times = [], []
        try:
            for _ in range(steps):
                t1 = time.monotonic()
                loss = call(src, tgt_in, labels)
                torch.cuda.synchronize()
                times.append(time.monotonic() - t1)
                losses.append(float(loss))
                sched.step()
        finally:
            clocks = stop()
        launches = {k: c.count for k, c in path.items()}
        timed = times[TB_WARM:]
        runs[tier] = {"losses": losses, "step_s": times,
                      "step_p50_s": statistics.median(timed),
                      "step_spread_s": max(timed) - min(timed),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": launches, "card_during_steps": clocks,
                      "digests": [digest(torch, x) for x in state],
                      "stats": dict(call.stats)}
        del call, loss
    after = eval_loss()
    e, c = runs["eager"], runs["captured"]
    require(all(math.isfinite(x) for x in e["losses"]),
            f"train_transformer_base: losses {e['losses']}")
    require(e["losses"] == c["losses"] and e["digests"] == c["digests"],
            f"train_transformer_base: the captured steps are not bit-equal "
            f"to the eager ones: losses {e['losses']} / {c['losses']}")
    require(c["stats"]["hits"] == steps - 1 and not c["stats"]["bypasses"],
            f"train_transformer_base captured: {c['stats']}")
    per_step = {"fwd_lse[segs_drop]": 12, "bwd_dq[segs_drop]": 12,
                "bwd_dkv[segs_drop]": 12, "softmax_cross_entropy": 2,
                "multi_tensor_adam": 1}
    for tier, r in runs.items():
        require(all(r["launches"][k] == n * steps
                    for k, n in per_step.items())
                and all(r["launches"][k] > 0 for k in r["launches"]),
                f"train_transformer_base {tier}: launches {r['launches']}")
    require(after < before, f"train_transformer_base: eval loss {before} -> "
                            f"{after}, not falling")
    with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
        macs = flops(model.transformer, [TB_BATCH, TB_LEN, 512]) \
            + TB_BATCH * TB_LEN * 512 * TB_VOCAB
    train_flops = 6 * macs
    for r in runs.values():
        p50 = r["step_p50_s"]
        r.update({"target_tokens_per_s": tgt_tokens / p50,
                  "tokens_per_s_src_and_tgt": (src_tokens + tgt_tokens) / p50,
                  "mfu_vs_989tflops": train_flops / p50 / 989e12})
    vs_cpu = transformer_base_vs_cpu(torch, fa)
    emit({"phase": "train_transformer_base", "card": card,
          "params": n_params, "config": {
              "d_model": 512, "nhead": 8, "layers": "6 + 6",
              "dim_feedforward": 2048, "dropout": 0.1, "vocab": TB_VOCAB,
              "source": "Vaswani et al. 2017, Table 3 'base'; WMT14 en-de "
                        "shared BPE vocabulary"},
          "batch": TB_BATCH, "padded_len": TB_LEN,
          "src_tokens": src_tokens, "tgt_tokens": tgt_tokens,
          "recipe": {"amp": "O2 bf16, fp32 masters",
                     "optimizer": "AdamW(multi-tensor, beta2 0.98, eps 1e-9, "
                                  "wd 0)",
                     "lr": "NoamDecay(512, 4000)",
                     "loss": "cross_entropy(label_smoothing=0.1, "
                             "ignore_index=0)"},
          "warmup_steps": TB_WARM, "timed_steps": TB_TIMED,
          "flops_multiply_adds_forward": macs, "train_flops": train_flops,
          "eval_loss_before": before, "eval_loss_after": after,
          "runs": {t: {k: v for k, v in r.items() if k != "digests"}
                   for t, r in runs.items()},
          "captured_bit_equal_to_eager": True, "vs_cpu": vs_cpu,
          "seconds": time.monotonic() - t_phase})
    launches = runs["eager"]["launches"]
    return launches



# ---------------------------------------------------------------------------
# K10 batch norm and the ResNet-50 training step (BASELINE config #1)
# ---------------------------------------------------------------------------

# K10's tolerance: outputs and gradients rtol (one bf16 rounding, or fp32
# sums in another order) plus a share of the reference's rms (cancellation
# in dx); per-channel sums of 10^3-10^6 elements (running buffers, stats,
# fp32 dw and db) 1e-4 of each and of their rms
K10_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-4),
           "bfloat16_add": (2.0 ** -6, 1e-4), "sum": (1e-4, 1e-4),
           "bfloat16_swish": (2.0 ** -6, 2.0 ** -8)}
# a bf16 swish tail's input z is the fp32 norm rounded to bf16 (and, with
# the residual, the bf16 sum rounded again): a last-bit difference of the
# fp32 value moves z by an ulp (2^-8 of |z|), which the swish, its
# derivative and the gradients after it carry to elements of any size; so
# the swish forms' out, dx and the residual's gradient are held by 2^-6 of
# |ref| (+ |res|) plus 2^-8 of the reference's rms
# a ReLU tail's mask may differ from the plain version's where the
# pre-activation lies within a rounding of 0 (the two sum in other orders):
# at most K10_FLIPS[0] + K10_FLIPS[1] x the elements may; dx and the
# residual's gradient are compared off those elements, and each sum they
# feed (dw, db, dx's mean terms) is allowed the flipped elements' share
K10_FLIPS = (8, 1e-6)
K10_REPLACES = "paddle_tpu/ops/nn_ops.py:210"
# K10's kernels by name: the statistics, apply, reduce and apply of the
# col and run routes and the folds (bn_col_*, bn_run_*, bn_fold_*), and a
# tree's before the routes (bn_stats, bn_apply, bn_bwd_*)
K10_KERNEL_KEYS = ("bn_col_", "bn_run_", "bn_fold_", "bn_stats", "bn_apply",
                   "bn_bwd")
K10_SOURCE = "paddle_tpu_torch/csrc/batch_norm.cu"
K10_FORMS = ("none", "relu", "add_relu", "swish", "add_swish")
# the forms on PP-YOLOE's path (and ResNet's none)
K10_SWISH_FORMS = ("swish", "add_swish")
K10_LEAVES = ("x", "w", "b", "res")
# (name, shape, dtype, tail, training, data_format, O2, use_global_stats):
# the stem's BN + ReLU, layer 1's bn3 + residual + ReLU, layer 4's
# downsample BN, an NHWC view, each in bf16 under O2 and in fp32, two eval
# forms and one under use_global_stats
K10_CASES = (
    ("stem_relu_bf16", (64, 64, 112, 112), "bfloat16", "relu", True,
     "NCHW", True, None),
    ("layer1_add_relu_bf16", (64, 256, 56, 56), "bfloat16", "add_relu",
     True, "NCHW", True, None),
    ("layer4_bf16", (64, 2048, 7, 7), "bfloat16", "none", True, "NCHW",
     True, None),
    ("nhwc_relu_bf16", (64, 28, 28, 128), "bfloat16", "relu", True, "NHWC",
     True, None),
    ("stem_relu_fp32", (64, 64, 112, 112), "float32", "relu", True, "NCHW",
     False, None),
    ("layer1_add_relu_fp32", (64, 256, 56, 56), "float32", "add_relu", True,
     "NCHW", False, None),
    ("layer4_fp32", (64, 2048, 7, 7), "float32", "none", True, "NCHW",
     False, None),
    ("layer1_add_relu_bf16_eval", (64, 256, 56, 56), "bfloat16", "add_relu",
     False, "NCHW", True, None),
    ("stem_relu_fp32_eval", (64, 64, 112, 112), "float32", "relu", False,
     "NCHW", False, None),
    ("layer4_bf16_global_stats", (64, 2048, 7, 7), "bfloat16", "none", True,
     "NCHW", True, True),
    # PP-YOLOE-l at batch 8, 640 x 640, NHWC: the stem's first BN + swish
    # (stride 2), a RepVGG pair of backbone stage 1 at stride 8 (ch_half 96
    # of CSPResStage(128, 256): bn2 plain, bn1 + bn2's output + swish), the
    # first neck stage's BN + swish at stride 32
    ("ppyoloe_stem_swish_fp32", (8, 320, 320, 32), "float32", "swish", True,
     "NHWC", False, None),
    ("ppyoloe_repvgg_none_fp32", (8, 80, 80, 96), "float32", "none", True,
     "NHWC", False, None),
    ("ppyoloe_repvgg_add_swish_fp32", (8, 80, 80, 96), "float32",
     "add_swish", True, "NHWC", False, None),
    ("ppyoloe_neck_swish_fp32", (8, 20, 20, 384), "float32", "swish", True,
     "NHWC", False, None),
    ("ppyoloe_neck_swish_fp32_eval", (8, 20, 20, 384), "float32", "swish",
     False, "NHWC", False, None),
    ("ppyoloe_repvgg_add_swish_fp32_eval", (8, 80, 80, 96), "float32",
     "add_swish", False, "NHWC", False, None),
    ("ppyoloe_stem_swish_bf16", (8, 320, 320, 32), "bfloat16", "swish", True,
     "NHWC", True, None),
    ("ppyoloe_repvgg_add_swish_bf16", (8, 80, 80, 96), "bfloat16",
     "add_swish", True, "NHWC", True, None),
    ("ppyoloe_neck_swish_bf16_eval", (8, 20, 20, 384), "bfloat16", "swish",
     False, "NHWC", True, None),
)
# the timed case of each form, at the ResNet-50 step's shapes (bf16 under
# O2) and PP-YOLOE-l's (fp32, its path's dtype)
K10_TIMED = {"relu": "stem_relu_bf16", "add_relu": "layer1_add_relu_bf16",
             "none": "layer4_bf16", "swish": "ppyoloe_stem_swish_fp32",
             "add_swish": "ppyoloe_repvgg_add_swish_fp32"}
# the NHWC view at the detector's shapes, timed besides: RepVGG's plain
# BN, the neck's, and the stem's in bf16 (8 values a 16-byte load)
K10_NHWC_TIMED = ("ppyoloe_repvgg_none_fp32", "ppyoloe_neck_swish_fp32",
                  "ppyoloe_stem_swish_bf16")
# the cases called three times (bit-equal), one on each route of the
# kernel's planner (ops/batch_norm.py, bn_plan), and the case on which each
# route's planted fault (PLANTED_FAULTS) must be rejected
K10_REPEATED = ("stem_relu_bf16", "ppyoloe_stem_swish_fp32")
K10_PLANTED = {"run": "stem_relu_bf16", "col": "ppyoloe_stem_swish_fp32"}
# the case whose gradients are also taken a subset at a time: the leaves
# asked for and the backward launches that takes (the reduce for dw / db
# and, with batch statistics, for dx; the apply for dx / dres)
K10_SUBSETS_CASE = "layer4_bf16"
K10_SUBSETS = ((("x",), 2), (("w", "b"), 1))


def k10_name(tail: str) -> str:
    return "batch_norm" + ("" if tail == "none" else f"[{tail}]")


def k10_act(tail: str):
    """The ``act`` of ``batch_norm`` that gives the tail."""
    return None if tail == "none" else ("swish" if tail in K10_SWISH_FORMS
                                        else "relu")


def k10_close(torch, got, want, kind: str, mag=None, slack=None):
    """``(ok, max-abs)`` of got against want (same shape and dtype) under
    K10_TOL[kind], the relative part of ``mag`` (default |want|), plus
    ``slack``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    g, w = got.float(), want.float()
    rtol, arel = K10_TOL[kind]
    lim = rtol * (w.abs() if mag is None else mag) \
        + arel * float(w.square().mean().sqrt())
    if slack is not None:
        lim = lim + slack
    d = (g - w).abs()
    return (bool(torch.isfinite(g).all()) and bool((d <= lim).all()),
            float(d.max()))


def k10_compare(torch, pairs: dict, what: str, expect_ok: bool = True):
    res = {n: k10_close(torch, *p) for n, p in pairs.items()}
    ok = all(v[0] for v in res.values())
    require(ok == expect_ok, f"{what}: " + (
        f"not within K10_TOL {res}" if expect_ok
        else f"the planted fault passed the check {res}"))
    return max(v[1] for v in res.values()), {n: v[1] for n, v in res.items()}


def k10_amp(o2: bool):
    from paddle_tpu_torch import amp
    return amp.auto_cast(enable=True, level="O2", dtype="bfloat16") if o2 \
        else contextlib.nullcontext()


@contextlib.contextmanager
def k10_library(K10, lib):
    """K10's wrapper launching from another build of its library (the
    planted fault) while the block runs."""
    real = K10._kernels
    K10._kernels = lambda: K10.bind(lib)
    try:
        yield
    finally:
        K10._kernels = real


def k10_inputs(torch, gen, shape, dtype, tail, fmt):
    dt = getattr(torch, dtype)
    c = shape[1] if fmt.startswith("NC") else shape[-1]

    def rn(*s):
        return torch.randn(*s, generator=gen, device="cuda")
    x = (rn(*shape) * 1.5 + 0.3).to(dt)
    w = (1.0 + 0.2 * rn(c)).to(dt)
    b = (0.1 * rn(c)).to(dt)
    res = rn(*shape).to(dt) if tail.startswith("add") else None
    rm = 0.1 * rn(c)
    rv = 1.0 + 0.2 * torch.rand(c, generator=gen, device="cuda")
    return x, w, b, res, rm, rv


def k10_call(torch, K10, ins, case, dy, plain=False, grads=K10_LEAVES):
    """One call of the wrapper ``K10.batch_norm`` (``plain``: of its plain
    version) on fresh leaves and running buffers under the case's amp, and
    autograd's gradients for ``dy`` of the leaves named in ``grads``:
    ``{"out", "run_mean", "run_var", "dx", "dw", "db", "dres"}``, and the
    batch ``mean`` and ``var`` the wrapper saved for its backward."""
    _, _, _, tail, training, fmt, o2, ugs = case
    rm, rv = ins[4].clone(), ins[5].clone()
    leaves = {k: None if t is None else t.detach().requires_grad_(k in grads)
              for k, t in zip(K10_LEAVES, ins[:4])}
    with k10_amp(o2):
        out = (K10.batch_norm_reference if plain else K10.batch_norm)(
            leaves["x"], rm, rv, leaves["w"], leaves["b"], training, 0.9,
            1e-5, fmt, ugs, residual=leaves["res"], act=k10_act(tail))
    got = {"out": out.detach(), "run_mean": rm, "run_var": rv}
    if not plain and training and not ugs:
        got["mean"], got["var"] = out.grad_fn.saved_tensors[2:4]
    asked = [k for k in grads if leaves[k] is not None]
    got.update(zip(("d" + k for k in asked), torch.autograd.grad(
        out, [leaves[k] for k in asked], dy)))
    return got


def k10_pairs(torch, K10, got, ref, ins, case, dy):
    """``({name: k10_close's arguments}, mask flips)``: the wrapper's
    output, running buffers, gradients and batch statistics against the
    plain version's (the statistics against x's own in fp32)."""
    name, _, _, tail, training, fmt, _, ugs = case
    x, _, _, res, rm, rv = ins
    grads = ["d" + k for k in K10_LEAVES]
    require(sorted(k for k in got if k in grads)
            == sorted(k for k in ref if k in grads),
            f"batch_norm {name}: gradients {sorted(got)} / {sorted(ref)}")
    pairs = {k: (got[k], ref[k], dtype_name(got[k].dtype))
             for k in ("out", "dx", "dres") if k in ref}
    if tail in K10_SWISH_FORMS and got["out"].dtype != torch.float32:
        mag = None if res is None else res.float().abs()
        for k in ("out", "dx", "dres"):
            if k in ref:
                m = ref[k].float().abs() + (0 if mag is None else mag)
                pairs[k] = (got[k], ref[k], "bfloat16_swish", m)
    elif res is not None and got["out"].dtype != torch.float32:
        # the normalised value is rounded to bf16 before the add, and the
        # sum again: a last-bit difference in fp32 moves each by up to an
        # ulp, 2^-7 of |bn| and of |sum|, at most 2^-6 of |out| + |res|
        pairs["out"] = (got["out"], ref["out"], "bfloat16_add",
                        ref["out"].float().abs() + res.float().abs())
    for k in ("dw", "db"):
        if k in ref:
            pairs[k] = (got[k], ref[k], "sum" if ref[k].dtype
                        == torch.float32 else dtype_name(ref[k].dtype))
    for k in ("run_mean", "run_var"):
        pairs[k] = (got[k], ref[k], "sum")
    n, s, c = K10.bn_geometry(x, fmt)

    def v3(t):
        return t.reshape(n // s, c, s)
    x3 = v3(x).float()
    batch = training and not ugs
    if batch:
        mu = x3.mean((0, 2))
        var = (x3 - mu.view(1, c, 1)).square().mean((0, 2))
        pairs["mean"] = (got["mean"], mu, "sum")
        pairs["var"] = (got["var"], var, "sum")
    else:
        mu, var = rm, rv
    flips = 0
    if tail in ("relu", "add_relu"):
        flip = (got["out"] > 0) != (ref["out"] > 0)
        flips = int(flip.sum())
        require(flips <= K10_FLIPS[0] + K10_FLIPS[1] * x.numel(),
                f"batch_norm {name}: {flips} elements' ReLU masks differ")
    if flips:
        g3 = v3(dy).float().abs() * v3(flip)
        xh = ((x3 - mu.view(1, c, 1)) * torch.rsqrt(var.view(1, c, 1)
                                                    + 1e-5)).abs()
        sdb, sdw = g3.sum((0, 2)), (g3 * xh).sum((0, 2))
        for k, sl in (("db", sdb), ("dw", sdw)):
            if k in pairs:
                pairs[k] += (None, sl.view(pairs[k][0].shape))
        for k in ("dx", "dres"):
            if k in pairs:
                slack = None
                if k == "dx" and batch:
                    w = ins[1].float().view(1, c, 1)
                    slack = (w.abs() * torch.rsqrt(var.view(1, c, 1) + 1e-5)
                             * (sdb.view(1, c, 1) + xh * sdw.view(1, c, 1))
                             / n).reshape(x.shape)
                pairs[k] = (got[k].masked_fill(flip, 0),
                            ref[k].masked_fill(flip, 0), pairs[k][2], None,
                            slack)
    return pairs, flips


def k10_timing(torch, K10, ins, tail, fmt, dy, o2: bool = True) -> dict:
    """The wrapper's forward (stats + apply) beside its plain version and
    ``F.batch_norm`` (+ the add and ``F.relu`` or ``F.silu``; on the
    channels-last view of an NHWC x), and its backward by autograd beside
    the plain version's and the library's, at a training form, under O2
    where ``o2``; bounds by bytes (each input read once, each output
    written once)."""
    import torch.nn.functional as TF
    x, w, b, res, rm, rv = ins
    act = k10_act(tail)
    rm_l, rv_l = rm.clone(), rv.clone()
    last = not fmt.startswith("NC")

    def call(fn):
        rm_, rv_ = rm.clone(), rv.clone()

        def f(xx, ww, bb, *r):
            with k10_amp(o2):
                return fn(xx, rm_, rv_, ww, bb, True, 0.9, 1e-5, fmt,
                          residual=r[0] if r else None, act=act)
        return f
    kernel_fn, plain_fn = call(K10.batch_norm), call(K10.batch_norm_reference)
    k_in = (x, w, b) + (() if res is None else (res,))

    def library_fn(xx, ww, bb, *r):
        y = TF.batch_norm(xx.movedim(-1, 1) if last else xx, rm_l, rv_l, ww,
                          bb, True, 0.1, 1e-5)
        y = y.movedim(1, -1) if last else y
        if r:
            y = y + r[0]
        return y if act is None else (TF.relu(y) if act == "relu"
                                      else TF.silu(y))

    def held(fn):
        """A backward by autograd, repeatable on one forward's graph."""
        leaves = [t.detach().requires_grad_() for t in k_in]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)

    def no_grad(fn, args):
        def f():
            with torch.no_grad():
                return fn(*args)
        return f
    lib_in = (x, w.float(), b.float()) + (() if res is None else (res,))
    t = fused_timing(torch, no_grad(kernel_fn, k_in), no_grad(plain_fn, k_in),
                     no_grad(library_fn, lib_in))
    out = no_grad(kernel_fn, k_in)()
    fwd_bytes = nbytes(x, res, out)
    t["bound_ms"], t["bound_by"] = bound(0, fwd_bytes, "float32")
    # the backward reads x and dy and writes dx (and the residual's
    # gradient); the ReLU's mask follows from x and the statistics, and
    # only the residual's tail needs a tensor more (the output, or the
    # residual) to know it
    mask = out if tail == "add_relu" else None
    # a swish tail's backward recomputes its input: the residual again
    mask = res if tail == "add_swish" else mask
    bwd_bytes = nbytes(x, dy, mask, x, res)
    bwd_ms, bwd_host = event_and_host(torch, held(kernel_fn), FUSED_ITERS)
    t.update({
        "bwd_ms": bwd_ms, "bwd_host_us": bwd_host,
        "bwd_device_ms": library_backward_device_ms(torch, kernel_fn, k_in,
                                                    dy),
        "bwd_plain_ms": cuda_ms(torch, held(plain_fn), 3),
        "bwd_library_device_ms": library_backward_device_ms(
            torch, library_fn, lib_in, dy),
        "bwd_bound_ms": bound(0, bwd_bytes, "float32")[0],
        "case": f"{tuple(x.shape)} {dtype_name(x.dtype)} {fmt}, training, "
                f"tail {tail}, {'O2' if o2 else 'no amp'} (out "
                f"{dtype_name(out.dtype)}); library: "
                f"F.batch_norm{' + add' if res is not None else ''}"
                f"{f' + F.{act}' if act == 'relu' else ''}"
                f"{' + F.silu' if act == 'swish' else ''} (fp32 weight), its "
                f"autograd"})
    # the bound's bytes over the card's time: GB/s, and the bound's share
    for pre, nb in (("", fwd_bytes), ("bwd_", bwd_bytes)):
        dev = t[pre + "device_ms"]
        t[pre + "bound_gbps"] = None if not dev else nb / dev / 1e6
        t[pre + "bound_share"] = None if not dev else \
            t[pre + "bound_ms"] / dev
    return t


def k10_subsets(torch, K10, ins, case, dy, full) -> dict:
    """The wrapper's gradients a subset of the leaves at a time
    (``K10_SUBSETS``): bit-equal to those of all of them, nothing more
    returned, and the backward launches each subset needs."""
    tail = case[3]
    out = {}
    for sub, calls in K10_SUBSETS:
        before = K10.launches_bwd[tail].count
        part = k10_call(torch, K10, ins, case, dy, grads=sub)
        ran = K10.launches_bwd[tail].count - before
        keys = sorted(k for k in part if k.startswith("d"))
        require(ran == calls and keys == sorted("d" + k for k in sub)
                and all(torch.equal(part[k], full[k]) for k in keys),
                f"batch_norm {case[0]} gradients of {sub}: {ran} backward "
                f"launches (want {calls}), {keys}, bit-equal "
                f"{[torch.equal(part[k], full[k]) for k in keys]}")
        out["+".join(sub)] = {"bwd_launches": ran}
    return out


def k10_plan(K10, x, fmt):
    """The statistics launch's plan of the kernel's planner for x (route,
    vector width, grid, threads a block), or None for a tree without the
    planner."""
    if not hasattr(K10, "bn_plan"):
        return None
    p = K10._plan(K10.bn_geometry(x, fmt), K10._codes("none", x=x.dtype)[1],
                  x)
    return {"route": p.route, "mode": p.mode, "vec": p.vec,
            "grid": list(p.grid),
            "threads": p.threads, "chunks": p.chunks}


def batch_norm_check(torch, planted_libs) -> dict:
    """K10's wrapper (``ops.batch_norm.batch_norm``, its autograd function)
    against its plain version on the same inputs, in every form
    ``K10_CASES`` lists: output, running buffers, batch statistics, and
    the gradients of x, weight, bias and the residual by autograd, within
    K10_TOL (K10_FLIPS for the ReLU masks); every case on its planner's
    16-byte vector route; three calls bit-equal (``K10_REPEATED``: one
    case a route); the gradients of a subset of the leaves
    (``K10_SUBSETS``); the planted fault (the statistics' fold skips block
    1's partial; ``planted_libs`` by route, None to skip) rejected on a
    case of each route (``K10_PLANTED``); each form timed at its path's
    shape (``K10_TIMED``, ``K10_NHWC_TIMED``). Returns rows by form."""
    from paddle_tpu_torch.ops import batch_norm as K10
    t_phase = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(24)
    cases, rows, nhwc = [], {}, {}
    for case in K10_CASES:
        name, shape, dtype, tail, training, fmt, o2, ugs = case
        ins = k10_inputs(torch, gen, shape, dtype, tail, fmt)
        with k10_amp(o2):
            out_dt = K10.bn_spec(ins[0], ins[1], ins[2], ins[3],
                                 k10_act(tail)).out
        dy = torch.randn(shape, generator=gen, device="cuda").to(out_dt)
        got = k10_call(torch, K10, ins, case, dy)
        ref = k10_call(torch, K10, ins, case, dy, plain=True)
        pairs, flips = k10_pairs(torch, K10, got, ref, ins, case, dy)
        err, errs = k10_compare(torch, pairs, f"batch_norm {name}")
        plan = k10_plan(K10, ins[0], fmt)
        require(plan is None or plan["vec"] == 16 // ins[0].element_size(),
                f"batch_norm {name}: plan {plan} is not 16 bytes a load")
        row = {"case": name, "shape": list(shape), "dtype": dtype,
               "tail": tail, "training": training, "data_format": fmt,
               "o2": o2, "use_global_stats": ugs,
               "out_dtype": dtype_name(out_dt), "max_abs_err": err,
               "errs": errs, "mask_flips": flips, "plan": plan}
        if name in K10_REPEATED:
            keys = list(got)
            for _ in range(2):
                again = k10_call(torch, K10, ins, case, dy)
                require(all(torch.equal(got[k], again[k]) for k in keys),
                        f"batch_norm {name}: three calls differ")
            row["bit_identical_calls"] = 3
        for route, pcase in K10_PLANTED.items():
            if pcase != name or planted_libs is None:
                continue
            require(plan is None or (plan["route"] == "run") == (
                route == "run"), f"batch_norm {name}: plan {plan} is not on "
                                 f"the {route} route")
            with k10_library(K10, planted_libs[route]):
                bad = k10_call(torch, K10, ins, case, dy)
            # the case's own gate on the output, the running buffers and
            # the batch statistics
            row[f"planted_{route}_max_abs_err"], _ = k10_compare(
                torch, {k: (bad[k], *pairs[k][1:]) for k in (
                    "out", "run_mean", "run_var", "mean", "var")},
                f"batch_norm {name} planted ({route} fold)", expect_ok=False)
        if name == K10_SUBSETS_CASE:
            row["subsets"] = k10_subsets(torch, K10, ins, case, dy, got)
        for form, timed in K10_TIMED.items():
            if timed == name:
                rows[form] = k10_timing(torch, K10, ins, tail, fmt, dy, o2)
                rows[form]["plan"] = plan
        if name in K10_NHWC_TIMED:
            nhwc[name] = k10_timing(torch, K10, ins, tail, fmt, dy, o2)
            nhwc[name]["plan"] = plan
        cases.append(row)
        del ins, got, ref, pairs, dy
        gc.collect()
        torch.cuda.empty_cache()
    for form in rows:
        rows[form]["max_abs_err"] = max(
            c["max_abs_err"] for c in cases if c["tail"] == form)
    emit({"phase": "batch_norm_check", "cases": cases,
          "timing": {k10_name(f): r for f, r in rows.items()},
          "nhwc_timing": nhwc,
          "tolerance": K10_TOL, "mask_flips_allowed": K10_FLIPS,
          "seconds": time.monotonic() - t_phase})
    return rows


RN_BATCH, RN_HW, RN_WARM, RN_TIMED, RN_SEED = 64, 224, 2, 10, 0
RN_CPU_BATCH, RN_CPU_HW, RN_CPU_CLASSES = 2, 64, 10
# the damping of every block's last BN weight in the card-vs-CPU check (a
# random ResNet-50 at batch 2 amplifies fp32 rounding into gradients that
# differ by tens of percent between two correct runs; 0.1 bounds it)
RN_CPU_BN3_SCALE = 0.1
RN_EVAL_ITERS = 10
# the rescaled run's images: x times 1 + 2^-7, the same step in exact
# arithmetic (the stem's BN takes the scale out) with other roundings
RN_RESCALE = 1.0 + 2.0 ** -7
# the K10 run's losses against the plain-BN witness's over the first
# RN_WITNESS_STEPS steps, rel, within RN_WITNESS_FACTOR x the largest
# distance the rescale alone puts between two K10 runs over those steps.
# At lr 0.1 on one batch the loss climbs to 15-26 from the fourth step on,
# and there runs that differ only in roundings part by tens of percent,
# so the later steps are reported and not held
RN_WITNESS_STEPS, RN_WITNESS_FACTOR = 4, 2.0
# K10 launches of one ResNet-50 training step, forward (statistics and
# apply) and backward (reduce and apply): 4 downsample BNs, 33 with a
# ReLU (the stem's and each bottleneck's bn1, bn2), 16 with the residual
# add and ReLU (each bottleneck's bn3)
RN_K10_PER_STEP = {"batch_norm": 8, "batch_norm[relu]": 66,
                   "batch_norm[add_relu]": 32, "batch_norm_bwd": 8,
                   "batch_norm[relu]_bwd": 66, "batch_norm[add_relu]_bwd": 32,
                   "batch_norm[swish]": 0, "batch_norm[add_swish]": 0,
                   "batch_norm[swish]_bwd": 0, "batch_norm[add_swish]_bwd": 0}


def resnet_family(name: str) -> str:
    """A ResNet step's kernel family: K10, cuDNN's convolutions and their
    layout transposes, the pools, K4, the fc's products, else ``other``
    (the optimizer's and the casts' elementwise kernels among them)."""
    low = name.lower()
    for keys, fam in ((K10_KERNEL_KEYS, "batch_norm"),
                      (("nchwtonhwc", "nhwctonchw", "transpose"),
                       "conv_layout"),
                      (("conv", "fprop", "dgrad", "wgrad", "implicit",
                        "cudnn", "xmma"), "conv"),
                      (("pool",), "pool"),
                      (("softmax_cross_entropy", "ce_fwd", "ce_bwd"),
                       "cross_entropy"),
                      (("gemm", "gemv", "cutlass", "nvjet"), "matmul")):
        if any(k in low for k in keys):
            return fam
    return "other"


# the ResNet-50 step's library calls at its shapes, bf16 under O2 (name,
# function, x shape, weight shape or None, keyword arguments)
RN_LIBRARY_CASES = (
    ("conv2d_stem_7x7_s2", "conv2d", (64, 3, 224, 224), (64, 3, 7, 7),
     dict(stride=2, padding=3)),
    ("conv2d_layer1_3x3", "conv2d", (64, 64, 56, 56), (64, 64, 3, 3),
     dict(padding=1)),
    ("conv2d_layer1_1x1_expand", "conv2d", (64, 64, 56, 56),
     (256, 64, 1, 1), {}),
    ("conv2d_layer4_3x3", "conv2d", (64, 512, 7, 7), (512, 512, 3, 3),
     dict(padding=1)),
    ("max_pool2d_3x3_s2", "max_pool2d", (64, 64, 112, 112), None,
     dict(kernel_size=3, stride=2, padding=1)),
    ("adaptive_avg_pool2d_1x1", "adaptive_avg_pool2d", (64, 2048, 7, 7),
     None, dict(output_size=(1, 1))),
)


def resnet_library_rows(torch) -> dict:
    """The port's conv and pool functions at the ResNet-50 step's shapes
    (cuDNN's and PyTorch's kernels, no kernel of the port's own): device
    ms forward and backward beside the bound (a convolution's 2 x
    multiply-adds at 989 TFLOP/s against its bytes; a pool's bytes)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import conv_pool
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, fn_name, xs, ws, kw in RN_LIBRARY_CASES:
        fn = getattr(conv_pool, fn_name)
        x = torch.randn(xs, generator=gen, device="cuda").to(torch.bfloat16)
        w = None if ws is None else (0.05 * torch.randn(
            ws, generator=gen, device="cuda")).to(torch.bfloat16)
        args = (x,) if w is None else (x, w)

        def call(*a, fn=fn, kw=kw):
            with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
                return fn(*a, **kw)
        out = call(*args)
        dy = torch.randn(out.shape, generator=gen, device="cuda").to(
            out.dtype)
        if w is None:
            flops_, nb = 0, nbytes(x, out)
        else:
            macs = out.numel() * ws[1] * ws[2] * ws[3]
            flops_, nb = 2 * macs, nbytes(x, w, out)
        b_ms, b_by = bound(flops_, nb, "bfloat16")
        bb_ms, bb_by = bound(2 * flops_, nb + nbytes(dy, x) + (
            0 if w is None else nbytes(w)), "bfloat16")
        rows[name] = {
            "x": list(xs), "weight": None if ws is None else list(ws),
            "out": list(out.shape), "kwargs": kw,
            "device_ms": device_ms(torch, lambda: call(*args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "bwd_device_ms": library_backward_device_ms(torch, call, args,
                                                        dy),
            "bwd_bound_ms": bb_ms, "bwd_bound_by": bb_by}
        del x, w, out, dy
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def k10_counters() -> dict:
    from paddle_tpu_torch.ops import batch_norm as K10
    return {**{k10_name(t): K10.launches_fwd[t] for t in K10_FORMS},
            **{k10_name(t) + "_bwd": K10.launches_bwd[t] for t in K10_FORMS}}


def resnet_vs_cpu(torch) -> dict:
    """``resnet50(num_classes=10)`` in fp32 at 2 x 3 x 64 x 64, one
    training forward and backward on the card (K10, cuDNN without TF32)
    and on the CPU (the plain versions) from one state, every block's last
    BN weight scaled by RN_CPU_BN3_SCALE: loss rel 1e-4, logits 1e-4 of
    their largest, each gradient 1e-3 of its largest element, the BN
    buffers 1e-4; K10 launches 106 forward and 106 backward on the card, 0
    on the CPU."""
    import numpy as np

    from paddle_tpu_torch.ops.loss_ops import cross_entropy
    from paddle_tpu_torch.vision import models
    rng = np.random.default_rng(7)
    x = rng.standard_normal((RN_CPU_BATCH, 3, RN_CPU_HW, RN_CPU_HW)).astype(
        np.float32)
    y = rng.integers(0, RN_CPU_CLASSES, RN_CPU_BATCH)
    counters = k10_counters()
    runs, init = {}, None
    for dev in ("cuda", "cpu"):
        model = models.resnet50(num_classes=RN_CPU_CLASSES, device=dev,
                                seed=RN_SEED)
        if init is None:
            init = {k: (v * RN_CPU_BN3_SCALE if re.search(
                r"layer\d\.\d+\.bn3\.weight", k) else v).cpu()
                for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        for c in counters.values():
            c.reset()
        logits = model(torch.as_tensor(x, device=dev))
        loss = cross_entropy(logits, torch.as_tensor(y, device=dev))
        loss.backward()
        runs[dev] = dict(
            loss=float(loss), logits=logits.detach().cpu(),
            grads={k: p.grad.detach().cpu()
                   for k, p in model.named_parameters()},
            bufs={k: v.detach().cpu() for k, v in model.state_dict().items()
                  if k.endswith(("_mean", "_variance"))},
            launches={k: c.count for k, c in counters.items()})
        del model, loss, logits
    a, b = runs["cuda"], runs["cpu"]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    logit_err = float((a["logits"] - b["logits"]).abs().max()) / float(
        b["logits"].abs().max())
    grad_rel = max(float((a["grads"][k] - g).abs().max())
                   / max(float(g.abs().max()), 1e-30)
                   for k, g in b["grads"].items())
    buf_rel = max(float((a["bufs"][k] - v).abs().max())
                  / max(float(v.abs().max()), 1e-30)
                  for k, v in b["bufs"].items())
    want = RN_K10_PER_STEP
    require(loss_rel < 1e-4 and logit_err < 1e-4 and grad_rel < 1e-3
            and buf_rel < 1e-4 and a["launches"] == want
            and not any(b["launches"].values()),
            f"ResNet-50 card vs CPU: loss rel {loss_rel}, logits {logit_err},"
            f" grad rel {grad_rel}, buffers {buf_rel}, launches "
            f"{a['launches']} / {b['launches']}")
    out = {"shape": [RN_CPU_BATCH, 3, RN_CPU_HW, RN_CPU_HW],
           "num_classes": RN_CPU_CLASSES, "dtype": "float32",
           "bn3_weight_scale": RN_CPU_BN3_SCALE, "loss_card": a["loss"],
           "loss_cpu": b["loss"], "loss_rel": loss_rel,
           "logits_rel": logit_err, "grad_max_rel": grad_rel,
           "buffers_max_rel": buf_rel, "launches_card": a["launches"],
           "tolerance": {"loss_rel": 1e-4, "logits_rel": 1e-4,
                         "grad_rel": 1e-3, "buffers_rel": 1e-4}}
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_batch_norm():
    """Every batch norm of the port's layers on its plain version
    (``batch_norm_reference``, plain PyTorch on the card, the JAX
    package's rounding points) while the block runs: the witness that
    K10's training step takes the same course."""
    from paddle_tpu_torch.ops import batch_norm as K10
    from paddle_tpu_torch.ops import nn_ops
    real = nn_ops.batch_norm
    nn_ops.batch_norm = K10.batch_norm_reference
    try:
        yield
    finally:
        nn_ops.batch_norm = real


def rn_witness(losses: list, plain: dict, rescaled: dict) -> dict:
    """The eager K10 run's losses against the plain-BN run's (no K10
    launch): each of the first RN_WITNESS_STEPS within RN_WITNESS_FACTOR x
    the largest distance over those steps between the K10 run and the
    rescaled K10 run (roundings alone); every step's distances
    reported."""
    require(not any(plain["launches"].values()),
            f"train_resnet50 plain_bn: K10 launched {plain['launches']}")

    def rel(a, b):
        return [abs(u - v) / abs(v) for u, v in zip(a, b)]
    held = rel(losses, plain["losses"])
    rounding = rel(rescaled["losses"], losses)
    bound = RN_WITNESS_FACTOR * max(rounding[:RN_WITNESS_STEPS])
    require(max(held[:RN_WITNESS_STEPS]) <= bound,
            f"train_resnet50: K10's losses {losses} leave the plain "
            f"version's {plain['losses']} (rel {held}) by more than "
            f"{RN_WITNESS_FACTOR} x the rescale's {rounding} over the first "
            f"{RN_WITNESS_STEPS} steps")
    return {"plain_losses": plain["losses"], "rel": held, "bound": bound,
            "steps_held": RN_WITNESS_STEPS,
            "rescaled_losses": rescaled["losses"],
            "rescaled_rel_to_k10": rounding,
            "plain_step_p50_s": plain["step_p50_s"],
            "plain_images_per_s": plain["images_per_s"],
            "plain_peak_mem_gb": plain["peak_mem_gb"]}


def train_resnet50(torch, card) -> dict:
    """``vision.models.resnet50(num_classes=1000)`` at
    ``benchmarks/bench_resnet.py``'s settings: batch 64 of 3 x 224 x 224
    images and labels from seed 0, AMP O2 bf16 through ``amp.decorate``
    (fp32 masters), ``Momentum(0.1, 0.9)``, ``cross_entropy``. The eager
    tier runs 2 warm-up and 10 timed steps, then the captured tier
    (``jit.capture_step``) the same 12 from the same state: losses and the
    digests of parameters, masters, velocity, step count and BN buffers
    bit-equal. cuDNN runs deterministic with autotuning off in this phase:
    an autotuned or atomic algorithm may differ between the eager and the
    captured call (so would their bits); TF32 is off for the whole run.
    K10 launches a step: 106 forward (53 BNs, stats and apply) and 106
    backward. MFU = 3 x 2 x ``paddle_tpu_torch.flops`` multiply-adds an
    image x images/s / 989 TFLOP/s. The first step must lower the loss,
    and the eager losses must follow those of a third run of the same 12
    steps from the same state with every BN on its plain version
    (:func:`plain_batch_norm`), which launches no K10 kernel, over the
    first RN_WITNESS_STEPS steps as closely as a fourth run, K10 on the
    images times RN_RESCALE, follows K10's own (:func:`rn_witness`).
    Then one more eager step under ``torch.profiler`` (device time by
    :func:`resnet_family`), the eval forward's images/s on the running
    buffers, :func:`resnet_vs_cpu` and :func:`resnet_library_rows`."""
    import numpy as np

    from paddle_tpu_torch import amp, flops, jit
    from paddle_tpu_torch.ops.loss_ops import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models
    t_phase = time.monotonic()
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        model = models.resnet50(num_classes=1000, device="cuda",
                                seed=RN_SEED)
        n_params = sum(p.numel() for p in model.parameters())
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        rng = np.random.default_rng(RN_SEED)
        x = torch.as_tensor(rng.normal(size=(
            RN_BATCH, 3, RN_HW, RN_HW)).astype(np.float32), device="cuda")
        y = torch.as_tensor(rng.integers(0, 1000, RN_BATCH), device="cuda")

        def step(x, y):
            with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
                loss = cross_entropy(model(x), y)
            loss.backward()
            return loss

        def update():
            opt.step()
            opt.clear_grad()

        state = (list(model.parameters())
                 + [t for _, _, t in opt._state_views()] + [opt._step_t]
                 + [b for k, b in model.state_dict(keep_vars=True).items()
                    if k.endswith(("_mean", "_variance"))])
        saved = [s.detach().clone() for s in state]
        path = k10_counters()
        steps = RN_WARM + RN_TIMED
        runs = {}
        for tier in ("eager", "captured", "plain_bn", "rescaled"):
            with torch.no_grad():
                for s, c in zip(state, saved):
                    s.copy_(c)
            call = (jit.capture_step(step, update_fn=update,
                                     clear_fn=opt.clear_grad, nan_gate=True)
                    if tier == "captured" else
                    captured_step(jit, step, "off", update_fn=update,
                                  clear_fn=opt.clear_grad, nan_gate=True))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in path.values():
                c.reset()
            xin = x * RN_RESCALE if tier == "rescaled" else x
            stop = sample_card()
            losses, times = [], []
            try:
                with (plain_batch_norm() if tier == "plain_bn"
                      else contextlib.nullcontext()):
                    for _ in range(steps):
                        t1 = time.monotonic()
                        loss = call(xin, y)
                        torch.cuda.synchronize()
                        times.append(time.monotonic() - t1)
                        losses.append(float(loss))
            finally:
                clocks = stop()
            timed = times[RN_WARM:]
            p50 = statistics.median(timed)
            runs[tier] = {"losses": losses, "step_s": times,
                          "step_p50_s": p50,
                          "step_spread_s": max(timed) - min(timed),
                          "images_per_s": RN_BATCH / p50,
                          **memory_gb(torch),
                          "launches": {k: c.count for k, c in path.items()},
                          "card_during_steps": clocks,
                          "digests": [digest(torch, s) for s in state],
                          "stats": dict(call.stats)}
            del call, loss
        e, c = runs["eager"], runs["captured"]
        plain, rescaled = runs.pop("plain_bn"), runs.pop("rescaled")
        require(all(math.isfinite(v) for v in e["losses"]),
                f"train_resnet50: losses {e['losses']}")
        require(e["losses"] == c["losses"] and e["digests"] == c["digests"],
                f"train_resnet50: the captured steps are not bit-equal to "
                f"the eager ones: losses {e['losses']} / {c['losses']}")
        require(c["stats"]["hits"] == steps - 1
                and not c["stats"]["bypasses"],
                f"train_resnet50 captured: {c['stats']}")
        for tier, r in runs.items():
            require(r["launches"] == {k: n * steps for k, n in
                                      RN_K10_PER_STEP.items()},
                    f"train_resnet50 {tier}: K10 launches {r['launches']}")
        # the witness: the same steps from the same state with every BN on
        # its plain version (no K10 launch) take the same losses
        witness = rn_witness(e["losses"], plain, rescaled)
        require(e["losses"][1] < e["losses"][0],
                f"train_resnet50: the first step does not lower the loss: "
                f"{e['losses']}")
        profiled = profile_step(torch, card, lambda: (step(x, y), update()),
                                e["step_p50_s"], "train_resnet50_profile",
                                resnet_family)
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            macs = flops(model, [1, 3, RN_HW, RN_HW])
        for r in runs.values():
            r["mfu_vs_989tflops"] = 6 * macs * r["images_per_s"] / 989e12
        model.eval()

        def infer():
            with torch.no_grad(), amp.auto_cast(enable=True, level="O2",
                                                dtype="bfloat16"):
                return model(x)
        for c in path.values():
            c.reset()
        for _ in range(2):
            infer()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for _ in range(RN_EVAL_ITERS):
            infer()
        torch.cuda.synchronize()
        eval_s = (time.monotonic() - t1) / RN_EVAL_ITERS
        eval_launches = {k: n for k, n in ((k, c.count)
                                           for k, c in path.items()) if n}
        require(eval_launches == {"batch_norm": 4 * (RN_EVAL_ITERS + 2),
                                  "batch_norm[relu]": 33 * (RN_EVAL_ITERS
                                                            + 2),
                                  "batch_norm[add_relu]": 16 * (
                                      RN_EVAL_ITERS + 2)},
                f"train_resnet50 eval: K10 launches {eval_launches}")
        del model, opt, state, saved
        gc.collect()
        torch.cuda.empty_cache()
        vs_cpu = resnet_vs_cpu(torch)
        library = resnet_library_rows(torch)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev
    emit({"phase": "train_resnet50", "card": card, "params": n_params,
          "config": {"model": "resnet50", "num_classes": 1000,
                     "source": "benchmarks/bench_resnet.py:34-62 "
                               "(PaddleClas ResNet-50 ImageNet train, "
                               "BASELINE config #1)"},
          "batch": RN_BATCH, "image": [3, RN_HW, RN_HW],
          "recipe": {"amp": "O2 bf16 (amp.decorate), fp32 masters",
                     "optimizer": "Momentum(0.1, 0.9)",
                     "loss": "cross_entropy"},
          "cudnn": {"deterministic": True, "benchmark": False,
                    "allow_tf32": torch.backends.cudnn.allow_tf32},
          "warmup_steps": RN_WARM, "timed_steps": RN_TIMED,
          "flops_multiply_adds_per_image": macs,
          "train_flops_per_image": 6 * macs,
          "runs": {t: {k: v for k, v in r.items() if k != "digests"}
                   for t, r in runs.items()},
          "captured_bit_equal_to_eager": True, "plain_bn_witness": witness,
          "eval": {"step_s": eval_s, "images_per_s": RN_BATCH / eval_s,
                   "launches": eval_launches},
          "profile_families": profiled["families"],
          "library_rows": library, "vs_cpu": vs_cpu,
          "seconds": time.monotonic() - t_phase})
    return runs["eager"]["launches"]


# ---------------------------------------------------------------------------
# K11 NMS and PP-YOLOE-l (BASELINE config #3)
# ---------------------------------------------------------------------------

K11_REPLACES = "paddle_tpu/ops/vision.py:58"
K11_SOURCE = "paddle_tpu_torch/csrc/nms.cu"
# PaddleDetection's PP-YOLOE post-process (configs/ppyoloe/_base_/
# ppyoloe_crn.yml, MultiClassNMS)
PP_NMS = dict(nms_top_k=1000, keep_top_k=300, score_threshold=0.01,
              nms_threshold=0.7)
PP_BATCH, PP_HW, PP_SEED, PP_CLASSES = 8, 640, 0, 80
PP_ANCHORS = sum((PP_HW // s) ** 2 for s in (8, 16, 32))
PP_SERVE_WARM, PP_SERVE_ITERS = 2, 10
PP_TRAIN_STEPS = 6
# ground truth an image: PP_GT padded boxes, the last PP_GT_MASKED masked
PP_GT, PP_GT_MASKED = 32, 4
# the -s copy on the card against the CPU: 128 x 128, batch 1, eval mode,
# fp32 (TF32 off): cls_logits and reg_dist within this share of each
# tensor's largest element (the sums of cuDNN and oneDNN in other orders)
PP_S_HW, PP_S_TOL = 128, 1e-4
# the witness of the first training step, every K10 call on its plain
# version from the same state: each loss rel, each parameter's gradient
# as a share of its largest element (K10's statistics and sums run in
# another order than the plain version's; the step amplifies that through
# 100 BNs in fp32, and the assignment's top-13 and argmax may move an
# anchor whose metric ties within a rounding)
PP_WITNESS_LOSS_REL, PP_WITNESS_GRAD = 1e-3, 1e-2


def nms_boxes(torch, gen, lead, n: int, hw: float = float(PP_HW)):
    """``lead + (n, 4)`` xyxy boxes: centres uniform over the image, sides
    4-124 pixels."""
    c = torch.rand(*lead, n, 2, generator=gen, device="cuda") * hw
    wh = torch.rand(*lead, n, 2, generator=gen, device="cuda") * 120 + 4
    return torch.cat([c - wh / 2, c + wh / 2], -1)


@contextlib.contextmanager
def k11_recorded(V):
    """K11's wrapper records each call's boxes, threshold and keep."""
    real, calls = V.nms_suppress, []

    def rec(boxes, thr):
        keep = real(boxes, thr)
        calls.append((boxes, thr, keep))
        return keep
    V.nms_suppress = rec
    try:
        yield calls
    finally:
        V.nms_suppress = real


@contextlib.contextmanager
def k11_plain(V):
    """Every NMS on K11's plain version while the block runs."""
    real = V.nms_suppress
    V.nms_suppress = V.nms_suppress_reference
    try:
        yield
    finally:
        V.nms_suppress = real


@contextlib.contextmanager
def k11_library(V, lib):
    """K11's wrapper launching from another build (the planted fault)."""
    real = V._kernels
    V._kernels = lambda: V.bind(lib)
    try:
        yield
    finally:
        V._kernels = real


def nms_check(torch, planted_lib) -> dict:
    """K11 (``ops.vision.nms_suppress``) against its plain version on the
    card: at PP-YOLOE-l's ``multiclass_nms`` (B 8, C 80, the 1000 best of
    8400 anchors a class, threshold 0.7: 640 problems), ``nms`` over 8400
    boxes with scores, with categories and ``top_k`` 300, and problems of
    130 and of 1 candidate: ``keep`` bit-equal, the whole op's output
    bit-equal to the same call on the plain version, three launches
    bit-equal, a planted fault (the sweep reads row 2's words for row 1)
    rejected; K11 timed at the multiclass shape beside its plain version
    and its bound (operations: the IoU of each pair)."""
    from paddle_tpu_torch.ops import vision as V
    t_phase = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows = []

    def check(name, op, kwargs_note):
        with k11_recorded(V) as calls:
            got = op()
        with k11_plain(V):
            ref = op()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        require(len(calls) == 1 and all(torch.equal(a, b)
                                        for a, b in zip(got, ref)),
                f"nms_check {name}: the op's output differs from the plain "
                f"version's")
        boxes, thr, keep = calls[0]
        plain = V.nms_suppress_reference(boxes, thr)
        require(torch.equal(keep, plain),
                f"nms_check {name}: keep differs from the plain version's "
                f"in {int((keep != plain).sum())} of {keep.numel()}")
        for _ in range(2):
            require(torch.equal(V.nms_suppress(boxes, thr), keep),
                    f"nms_check {name}: three launches differ")
        rows.append({"case": name, "problems": int(boxes.shape[0]),
                     "candidates": int(boxes.shape[1]), "threshold": thr,
                     "kept": int(keep.sum()), "bit_equal": True,
                     "call": kwargs_note})
        return boxes, thr, keep, plain

    bx = nms_boxes(torch, gen, (PP_BATCH,), PP_ANCHORS)
    sc = torch.rand(PP_BATCH, PP_CLASSES, PP_ANCHORS, generator=gen,
                    device="cuda")
    mc_boxes, mc_thr, mc_keep, mc_plain = check(
        "ppyoloe_l_multiclass", lambda: V.multiclass_nms(bx, sc, **PP_NMS),
        f"multiclass_nms B={PP_BATCH} C={PP_CLASSES} N={PP_ANCHORS} "
        f"{PP_NMS}")
    b1 = nms_boxes(torch, gen, (), PP_ANCHORS)
    s1 = torch.rand(PP_ANCHORS, generator=gen, device="cuda")
    cat = torch.randint(0, PP_CLASSES, (PP_ANCHORS,), generator=gen,
                        device="cuda")
    check("nms_8400", lambda: V.nms(b1, 0.7, s1),
          f"nms over {PP_ANCHORS} boxes, scores, threshold 0.7")
    check("nms_8400_categories_top_k",
          lambda: V.nms(b1, 0.7, s1, cat, list(range(PP_CLASSES)), 300),
          f"nms over {PP_ANCHORS} boxes, scores, {PP_CLASSES} categories, "
          f"top_k 300")
    for name, (p, k) in (("k_130", (16, 130)), ("k_1", (4, 1))):
        b = nms_boxes(torch, gen, (p,), k)
        check(name, lambda b=b: V.nms_suppress(b, 0.5),
              f"nms_suppress of {p} problems of {k}, threshold 0.5")
    with k11_library(V, planted_lib):
        bad = V.nms_suppress(mc_boxes, mc_thr)
    flipped = int((bad != mc_plain).sum())
    require(flipped > 0, "nms_check: the planted fault passed the check")
    t = fused_timing(torch, lambda: V.nms_suppress(mc_boxes, mc_thr),
                     lambda: V.nms_suppress_reference(mc_boxes, mc_thr))
    ops, nb = V.nms_cost(mc_boxes, mc_keep)
    t["bound_ms"], t["bound_by"] = bound(ops, nb, "float32")
    t.update({"max_abs_err": 0.0, "planted_keep_flips": flipped,
              "case": f"{tuple(mc_boxes.shape)} fp32 boxes (PP-YOLOE-l's "
                      f"multiclass_nms), threshold {mc_thr}; no library "
                      f"call computes greedy NMS (torchvision is not "
                      f"installed)"})
    b8400 = nms_boxes(torch, gen, (1,), PP_ANCHORS)
    t["nms_8400"] = {
        "ms": cuda_ms(torch, lambda: V.nms_suppress(b8400, 0.7), 5),
        "plain_ms": cuda_ms(torch,
                            lambda: V.nms_suppress_reference(b8400, 0.7), 2),
        "bound_ms": bound(*V.nms_cost(b8400, mc_keep[:1, :1].expand(
            1, PP_ANCHORS)), "float32")[0]}
    emit({"phase": "nms_check", "cases": rows, "timing": t,
          "seconds": time.monotonic() - t_phase})
    del bx, sc, mc_boxes, mc_keep, mc_plain, bad
    gc.collect()
    torch.cuda.empty_cache()
    return t


def pp_family(name: str) -> str:
    """A PP-YOLOE step's kernel family: K10, K11, cuDNN's convolutions and
    their layout transposes, the pools, the sorts (NMS's and the
    assigner's top-k), the products, else ``other`` (the loss's and the
    optimizer's elementwise kernels, the concatenations, the upsample)."""
    low = name.lower()
    for keys, fam in ((K10_KERNEL_KEYS, "batch_norm"),
                      (("nms_mask", "nms_sweep"), "nms"),
                      (("nchwtonhwc", "nhwctonchw", "transpose"),
                       "conv_layout"),
                      (("conv", "fprop", "dgrad", "wgrad", "implicit",
                        "cudnn", "xmma"), "conv"),
                      (("pool",), "pool"),
                      (("sort", "radix", "topk", "bitonic"), "sort"),
                      (("gemm", "gemv", "cutlass", "nvjet"), "matmul")):
        if any(k in low for k in keys):
            return fam
    return "other"


def pp_counters() -> dict:
    from paddle_tpu_torch.ops import vision as V
    return {**k10_counters(), "nms": V.launches}


def pp_bn_forms(model) -> dict:
    """The model's batch norms by K10 form: a RepVGG block's bn2 plain and
    bn1 with the add and swish, every other ConvBNLayer's with the swish."""
    from paddle_tpu_torch.models import ppyoloe
    forms = {"none": 0, "swish": 0, "add_swish": 0}
    for m in model.modules():
        if isinstance(m, ppyoloe.RepVggBlock):
            forms["none"] += 1
            forms["add_swish"] += 1
        elif isinstance(m, ppyoloe.ConvBNLayer) and m.act == "swish":
            forms["swish"] += 1
    return forms


def pp_counts(counters) -> dict:
    return {k: c.count for k, c in counters.items() if c.count}


@contextlib.contextmanager
def cudnn_deterministic(torch):
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev


def pp_images(torch, batch: int, hw: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(batch, hw, hw, 3)).astype(
        np.float32), device="cuda")


def ppyoloe_s_vs_cpu(torch) -> dict:
    """``PPYOLOEConfig.s(80)`` at 1 x 128 x 128, eval mode, fp32: the
    card's forward (K10, cuDNN without TF32) against the CPU's (the plain
    versions) from one state: cls_logits and reg_dist within PP_S_TOL of
    each tensor's largest element; K10 launched on the card only."""
    from paddle_tpu_torch.models import PPYOLOE, PPYOLOEConfig
    counters = k10_counters()
    x = pp_images(torch, 1, PP_S_HW, 3)
    runs, state = {}, None
    for dev in ("cuda", "cpu"):
        model = PPYOLOE(PPYOLOEConfig.s(PP_CLASSES), device=dev, seed=1)
        if state is None:
            state = {k: v.cpu() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        model.eval()
        for c in counters.values():
            c.reset()
        with torch.no_grad():
            cls, reg = model(x.to(dev))
        runs[dev] = (cls.cpu(), reg.cpu(), pp_counts(counters))
        del model
    (ac, ar, al), (bc, br, bl) = runs["cuda"], runs["cpu"]
    errs = {n: float((a - b).abs().max() / b.abs().max())
            for n, a, b in (("cls_logits", ac, bc), ("reg_dist", ar, br))}
    require(all(v < PP_S_TOL for v in errs.values()) and al and not bl,
            f"PP-YOLOE-s card vs CPU: {errs} (tolerance {PP_S_TOL}), "
            f"launches {al} / {bl}")
    return {"config": "PPYOLOEConfig.s(80)", "shape": [1, PP_S_HW, PP_S_HW,
                                                       3],
            "mode": "eval", "dtype": "float32", "rel_err": errs,
            "tolerance": PP_S_TOL, "launches_card": al}


def serve_ppyoloe(torch, card) -> dict:
    """``PPYOLOE(PPYOLOEConfig.l(80))`` in eval mode, fp32, serving batch 8
    of 640 x 640 NHWC images from a seed through ``predict`` at
    PaddleDetection's post-process settings (PP_NMS): PP_SERVE_WARM
    warm-up and PP_SERVE_ITERS timed calls (p50 latency, images/s, peak
    memory), the K10 and K11 launches of one call, the whole output of a
    call bit-equal to the same call with K11 on its plain version (cuDNN
    deterministic, so the forward repeats bit for bit), one call profiled
    by :func:`pp_family`, and :func:`ppyoloe_s_vs_cpu`."""
    from paddle_tpu_torch.models import PPYOLOE, PPYOLOEConfig
    from paddle_tpu_torch.ops import vision as V
    t_phase = time.monotonic()
    with cudnn_deterministic(torch):
        model = PPYOLOE(PPYOLOEConfig.l(PP_CLASSES), device="cuda",
                        seed=PP_SEED)
        model.eval()
        n_params = sum(p.numel() for p in model.parameters())
        x = pp_images(torch, PP_BATCH, PP_HW, PP_SEED)
        counters = pp_counters()
        forms = pp_bn_forms(model)

        def call():
            with torch.no_grad():
                return model.predict(x, **PP_NMS)
        for _ in range(PP_SERVE_WARM):
            call()
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        out, nums = call()
        torch.cuda.synchronize()
        per_call = pp_counts(counters)
        want = {"nms": 2, **{k10_name(f): n for f, n in forms.items()}}
        require(per_call == want,
                f"serve_ppyoloe: launches of one predict {per_call}, want "
                f"{want}")
        with k11_plain(V):
            out_p, nums_p = call()
        require(torch.equal(out, out_p) and torch.equal(nums, nums_p),
                "serve_ppyoloe: predict on K11 differs from predict on its "
                "plain version")
        require(tuple(out.shape) == (PP_BATCH, PP_NMS["keep_top_k"], 6)
                and bool(torch.isfinite(out).all())
                and bool(((nums >= 0) & (nums <= PP_NMS["keep_top_k"])).all())
                and bool(((out[..., 0] >= -1) & (out[..., 0] < PP_CLASSES)
                          ).all()),
                f"serve_ppyoloe: output {tuple(out.shape)}, counts "
                f"{nums.tolist()}")
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        stop = sample_card()
        times = []
        try:
            for _ in range(PP_SERVE_ITERS):
                t1 = time.monotonic()
                call()
                torch.cuda.synchronize()
                times.append(time.monotonic() - t1)
        finally:
            clocks = stop()
        launches = pp_counts(counters)
        p50 = statistics.median(times)
        profiled = profile_step(torch, card, call, p50,
                                "serve_ppyoloe_profile", pp_family)
        del model, x, out, out_p
        gc.collect()
        torch.cuda.empty_cache()
        vs_cpu = ppyoloe_s_vs_cpu(torch)
    row = {"phase": "serve_ppyoloe", "card": card, "params": n_params,
           "config": {"model": "PPYOLOEConfig.l(80)",
                      "source": "PaddleDetection configs/ppyoloe/"
                                "ppyoloe_crn_l_300e_coco.yml (BASELINE "
                                "config #3), MultiClassNMS of "
                                "_base_/ppyoloe_crn.yml"},
           "batch": PP_BATCH, "image": [PP_HW, PP_HW, 3], "dtype": "float32",
           "nms": PP_NMS, "warmup_calls": PP_SERVE_WARM,
           "timed_calls": PP_SERVE_ITERS, "call_s": times,
           "latency_p50_s": p50, "images_per_s": PP_BATCH / p50,
           **memory_gb(torch), "card_during_calls": clocks,
           "launches_per_call": per_call, "launches": launches,
           "detections": nums.tolist(), "k11_plain_bit_equal": True,
           "profile_families": profiled["families"], "s_vs_cpu": vs_cpu,
           "seconds": time.monotonic() - t_phase}
    emit(row)
    return row


def pp_gt(torch, seed: int):
    """PP_GT padded ground-truth boxes an image (sides 16-256 pixels inside
    the image, labels of PP_CLASSES), the last PP_GT_MASKED masked off."""
    import numpy as np
    rng = np.random.default_rng(seed)
    wh = rng.uniform(16, 256, (PP_BATCH, PP_GT, 2))
    lo = rng.uniform(0, 1, (PP_BATCH, PP_GT, 2)) * (PP_HW - wh)
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    labels = rng.integers(0, PP_CLASSES, (PP_BATCH, PP_GT)).astype(np.int64)
    mask = np.ones((PP_BATCH, PP_GT), np.float32)
    mask[:, PP_GT - PP_GT_MASKED:] = 0.0
    return [torch.as_tensor(a, device="cuda") for a in (labels, boxes, mask)]


def pp_loss_profile(torch, card, model, x, gt) -> dict:
    """The loss alone (its forward and backward from the head's outputs,
    detached) under ``torch.profiler``: the loss's kernels, which the
    step's profile files under ``other``."""
    from paddle_tpu_torch.models import ppyoloe
    with torch.no_grad():
        feats = model.neck(model.backbone(x))
        cls, reg = model.head(feats)
        anchors, strides = model.head._anchors(feats)
    head = model.head
    cls, reg4 = cls.detach(), head._reg4(reg).detach()

    def loss():
        c, r = cls.requires_grad_(), reg4.requires_grad_()
        out = ppyoloe._vfl_giou_dfl_loss(
            c, r, anchors, strides, *gt, num_classes=head.num_classes,
            reg_max=head.reg_max, tal_topk=head.tal_topk,
            alpha=head.tal_alpha, beta=head.tal_beta,
            loss_weights=head.loss_weights)
        out[0].backward()
    loss()
    return profile_step(torch, card, loss, cuda_ms(torch, loss, 3) / 1e3,
                        "train_ppyoloe_loss_profile", pp_family)


def train_ppyoloe(torch, card) -> dict:
    """``PPYOLOE(PPYOLOEConfig.l(80))`` in train mode, fp32, batch 8 of 640
    x 640 NHWC images and PP_GT ground-truth boxes an image (the last
    PP_GT_MASKED masked off) from a seed, ``Adam(learning_rate=1e-3)`` as
    ``examples/train_ppyoloe.py`` sets it, PP_TRAIN_STEPS eager steps (the
    first a warm-up): step p50, images/s, MFU (3 x 2 x ``flops``
    multiply-adds an image x images/s over the fp32 peak), peak memory,
    the four losses of every step, all finite, and the K10 launches of the
    path (two forward and two backward a BN a step). The witness: the
    first step again from the saved state with every BN on its plain
    version (:func:`plain_batch_norm`, no K10 launch): the four losses
    within PP_WITNESS_LOSS_REL and each parameter's gradient within
    PP_WITNESS_GRAD of its largest element. No gate on the loss falling.
    One more step profiled by :func:`pp_family`, and the loss alone
    (:func:`pp_loss_profile`). cuDNN deterministic: the witness compares
    K10 with its plain version, not two convolution algorithms."""
    from paddle_tpu_torch import flops
    from paddle_tpu_torch.models import PPYOLOE, PPYOLOEConfig
    from paddle_tpu_torch.optimizer import Adam
    t_phase = time.monotonic()
    names = ("loss", "loss_cls", "loss_iou", "loss_dfl")
    with cudnn_deterministic(torch):
        model = PPYOLOE(PPYOLOEConfig.l(PP_CLASSES), device="cuda",
                        seed=PP_SEED)
        model.train()
        opt = Adam(learning_rate=1e-3, parameters=model.parameters())
        x = pp_images(torch, PP_BATCH, PP_HW, PP_SEED + 1)
        gt = pp_gt(torch, PP_SEED + 1)
        forms = pp_bn_forms(model)
        state = list(model.parameters()) + [
            b for k, b in model.state_dict(keep_vars=True).items()
            if k.endswith(("_mean", "_variance"))]
        saved = [s.detach().clone() for s in state]
        counters = k10_counters()

        def step():
            out = model.loss(x, *gt)
            out["loss"].backward()
            return out
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stop = sample_card()
        losses, times, grads0 = [], [], None
        try:
            for i in range(PP_TRAIN_STEPS):
                t1 = time.monotonic()
                out = step()
                if i == 0:
                    grads0 = {k: p.grad.detach().clone()
                              for k, p in model.named_parameters()}
                opt.step()
                opt.clear_grad()
                torch.cuda.synchronize()
                times.append(time.monotonic() - t1)
                losses.append([out[k].item() for k in names])
                del out
        finally:
            clocks = stop()
        mem = memory_gb(torch)
        launches = pp_counts(counters)
        want = {k10_name(f) + sfx: 2 * n * PP_TRAIN_STEPS
                for f, n in forms.items() for sfx in ("", "_bwd")}
        require(launches == want,
                f"train_ppyoloe: K10 launches {launches}, want {want}")
        require(all(math.isfinite(v) for row in losses for v in row),
                f"train_ppyoloe: losses {losses}")
        timed = times[1:]
        p50 = statistics.median(timed)
        # the witness: step 1 again from the saved state on the plain BN
        with torch.no_grad():
            for s, c in zip(state, saved):
                s.copy_(c)
        for c in counters.values():
            c.reset()
        with plain_batch_norm():
            out = step()
        require(not pp_counts(counters),
                f"train_ppyoloe plain_bn: K10 launched {pp_counts(counters)}")
        plain = [out[k].item() for k in names]
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses[0], plain)]
        grad_rel = {k: float((grads0[k] - p.grad).abs().max()
                             / max(float(p.grad.abs().max()), 1e-30))
                    for k, p in model.named_parameters()}
        worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:5]
        require(max(loss_rel) <= PP_WITNESS_LOSS_REL
                and worst[0][1] <= PP_WITNESS_GRAD,
                f"train_ppyoloe: step 1 on K10 against the plain BN: losses "
                f"{losses[0]} / {plain} (rel {loss_rel}), worst gradients "
                f"{worst}")
        opt.clear_grad()
        del out, grads0
        profiled = profile_step(torch, card, lambda: (step(), opt.step(),
                                                      opt.clear_grad()),
                                p50, "train_ppyoloe_profile", pp_family)
        loss_prof = pp_loss_profile(torch, card, model, x, gt)
        macs = flops(model, [1, PP_HW, PP_HW, 3])
        images_per_s = PP_BATCH / p50
        del model, opt, state, saved, x, gt
        gc.collect()
        torch.cuda.empty_cache()
    row = {"phase": "train_ppyoloe", "card": card,
           "config": {"model": "PPYOLOEConfig.l(80)",
                      "source": "PaddleDetection configs/ppyoloe/"
                                "ppyoloe_crn_l_300e_coco.yml (BASELINE "
                                "config #3); examples/train_ppyoloe.py's "
                                "Adam(1e-3)"},
           "batch": PP_BATCH, "image": [PP_HW, PP_HW, 3], "dtype": "float32",
           "gt_boxes": PP_GT, "gt_masked": PP_GT_MASKED,
           "steps": PP_TRAIN_STEPS, "step_s": times, "step_p50_s": p50,
           "step_spread_s": max(timed) - min(timed),
           "images_per_s": images_per_s, **mem,
           "card_during_steps": clocks, "losses": losses,
           "loss_names": list(names),
           "flops_multiply_adds_per_image": macs,
           "train_flops_per_image": 6 * macs,
           "fp32_peak_flops": PEAK_OPS_PER_S["float32"],
           "mfu_vs_fp32_peak": 6 * macs * images_per_s
           / PEAK_OPS_PER_S["float32"],
           "launches": launches,
           "witness": {"plain_losses": plain, "k10_losses": losses[0],
                       "loss_rel": loss_rel,
                       "grad_max_rel": worst[0][1], "worst_grads": worst,
                       "bounds": {"loss_rel": PP_WITNESS_LOSS_REL,
                                  "grad": PP_WITNESS_GRAD}},
           "profile_families": profiled["families"],
           "loss_profile_families": loss_prof["families"],
           "loss_profile_device_ms": loss_prof["device_ms"],
           "seconds": time.monotonic() - t_phase}
    emit(row)
    return row


PHASES = ("flash_check", "paged_check", "decode_graph_check", "serve_7b",
          "generate_sample_7b", "cost_check", "serve_7b_dense", "fmt",
          "serve_fmt_dense", "agree_2layer", "serve_chaos_check",
          "flash_train_check", "q8_adam_check", "multi_tensor_adam_check",
          "fused_ops_check", "loss_ops_check", "ernie_ops_check",
          "incubate_check", "train_llama_1p6b",
          "train_llama_1p6b_bf16_state", "train_vs_cpu",
          "flash_segs_dropout", "unpadded", "train_ernie3_base",
          "ernie_vs_cpu", "capture_check", "train_ernie3_base_captured",
          "train_ernie3_base_fp16", "moe", "grad_scaler_check",
          "optimizer_zoo_check", "train_transformer_base",
          "batch_norm_check", "train_resnet50", "nms_check",
          "serve_ppyoloe", "train_ppyoloe")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after the build "
                         f"(of {', '.join(PHASES)}); the kernels line is "
                         "then left out. Without it every phase runs.")
    args = ap.parse_args(argv)
    if args.only is not None:
        args.only = [p.strip() for p in args.only.split(",") if p.strip()]
        unknown = sorted(set(args.only) - set(PHASES))
        if unknown or not args.only:
            ap.error(f"unknown phases {unknown}; choose from {PHASES}")
    return args


def main() -> int:
    args = parse_args()
    only = None if args.only is None else set(args.only)

    def want(name: str) -> bool:
        return only is None or name in only
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from paddle_tpu_torch._native import build as native_build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import multi_tensor_adam as mta
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import q8_adam as q8
    from paddle_tpu_torch.serving import kv_cache as kvc

    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.monotonic()
    load_planted = build_planted(native_build)
    try:
        native_build.build()
    finally:
        planted = load_planted()
    tc_kernels = wgmma_kernels(native_build)
    bulk_kernels = paged_kernels(native_build)
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "sources": native_build.sources(),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in native_build.build_logs.items()},
          "wgmma_kernels": tc_kernels, "paged_kernels": bulk_kernels,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": smi})
    require(len(tc_kernels) == N_WGMMA_KERNELS and all(
        k["HGMMA"] > 0 and k["UTMALDG"] > 0 for k in tc_kernels.values()),
        f"the 16-bit flash kernels do not all run on wgmma and TMA: "
        f"{tc_kernels}")
    require(len(bulk_kernels) == N_PAGED_SPLIT_KERNELS and all(
        k[BULK_COPY_OP] > 0 for k in bulk_kernels.values()),
        f"the paged split kernels do not all copy by {BULK_COPY_OP}: "
        f"{bulk_kernels}")
    all_counters = (fa.launches, pa.launches, fa.launches_lse,
                    fa.launches_bwd_dq, fa.launches_bwd_dkv, q8.launches,
                    mta.launches, *fa.launches_variant.values(),
                    *step_counters().values())

    if want("flash_check"):
        flash_rows = check_flash(torch, fa, planted["flash_attention"])
    if want("paged_check"):
        paged_rows = check_paged(torch, pa, kvc, planted["paged_attention"])
    if want("decode_graph_check"):
        decode_graph_check(torch, pa, kvc)
    for c in all_counters:
        c.reset()
    model = None
    if want("serve_7b"):
        model, init_s = build_7b(torch)
        serve_launches, served = serve_7b(torch, smi, fa, pa, model, init_s)
        prefix_launches = serve_prefix_7b(torch, smi, fa, pa, kvc, model)
        prefill_graph_check(torch, smi, model, kvc)
        chaos_eng, chaos_launches = serve_chaos_7b(torch, smi, fa, pa, model,
                                                   served)
        obs_overhead_7b(torch, smi, chaos_eng, served)
        del chaos_eng
        gc.collect()
        torch.cuda.empty_cache()
        router_launches = serve_router_7b(torch, smi, fa, pa, model, served)
        serve_fleet_7b_width(torch, smi, served)
    # on the 7B in bf16, before serve_7b_fp16 casts its weights to fp16
    if want("generate_sample_7b") or want("cost_check"):
        if model is None:
            model, _ = build_7b(torch)
        if want("generate_sample_7b"):
            generate_sample_7b(torch, smi, model)
        if want("cost_check"):
            cost_check(torch, smi, model)
    if want("serve_7b_dense"):
        if model is None:
            model, _ = build_7b(torch)
        dense_launches = serve_7b_dense(torch, smi, fa, pa, kvc, model)
        left_on_card(torch, "serve_7b_dense")
    if want("serve_7b"):
        serve16_launches = serve_7b_fp16(torch, smi, fa, pa, model, served)
    if model is not None:
        del model
        gc.collect()
        torch.cuda.empty_cache()
    if want("fmt"):
        fmt_check(torch, fa, pa, kvc)
        fmt_times = fmt_kernel_times(torch, fa, pa, kvc)
        fmt_launches = serve_fmt(torch, smi, fa, pa)
    if want("serve_fmt_dense"):
        fmt_dense_launches = serve_fmt_dense(torch, smi, fa, pa)
        left_on_card(torch, "serve_fmt_dense")
    if want("agree_2layer"):
        agree_2layer(torch, fa, pa)
    if want("serve_chaos_check"):
        serve_chaos_check(torch, smi, fa, pa)
    if want("flash_train_check"):
        flash_errs, flash_times, flash16_errs, flash16_times = \
            check_flash_train(torch, fa, planted["flash_attention"])
    if want("q8_adam_check"):
        q8_err, q8_time = check_q8_adam(torch, q8)
    if want("multi_tensor_adam_check"):
        mt_row = check_multi_tensor_adam(torch, q8, mta)
        mt16_row = check_multi_tensor_adam(torch, q8, mta, torch.float16)
        mt_forms = check_multi_tensor_adam_forms(torch, q8, mta)
    if want("fused_ops_check"):
        fused_rows = fused_ops_check(torch, planted)
    if want("loss_ops_check"):
        loss_rows = loss_ops_check(
            torch, torch.Generator(device="cuda").manual_seed(23))
        left_on_card(torch, "loss_ops_check")
    if want("ernie_ops_check"):
        ernie_rows = ernie_ops_check(torch, planted)
    if want("incubate_check"):
        incubate_row = incubate_check(torch)
    if want("train_llama_1p6b"):
        train_launches, llama_captured = train_1p6b(torch, smi, fa, q8,
                                                    all_counters)
        left_on_card(torch, "train_llama_1p6b")
    if want("train_llama_1p6b_bf16_state"):
        bf16_state = train_llama_1p6b_bf16_state(torch, smi, fa, q8, mta)
        left_on_card(torch, "train_llama_1p6b_bf16_state")
    if want("train_vs_cpu"):
        train_vs_cpu(torch, fa, q8)
    if want("flash_segs_dropout"):
        check_flash_segs_dropout(torch, fa, planted["flash_attention:b0"])
        var_times = time_variants(torch, fa, *ERNIE_SHAPE)
        var16_times = time_variants(torch, fa, *ERNIE_SHAPE, torch.float16)
    # each path's variant launches, counted from 0 just before its own run
    path_launches = {}
    if want("unpadded"):
        path_launches["unpadded"] = check_unpadded(torch, fa,
                                                   fa.launches_variant)
    if want("train_ernie3_base"):
        path_launches.update(train_ernie3_base(torch, smi, fa,
                                               all_counters))
    if want("ernie_vs_cpu"):
        ernie_vs_cpu(torch, fa)
        left_on_card(torch, "ernie_vs_cpu")
    if want("capture_check"):
        capture_check(torch, fa, mta)
    if want("train_ernie3_base_captured"):
        captured_launches = train_ernie3_base_captured(torch, smi, fa, mta)
        left_on_card(torch, "train_ernie3_base_captured")
        path_launches.update({k: {e: n for e, n in v.items()
                                  if e != "multi_tensor_adam"}
                              for k, v in captured_launches.items()})
    if want("train_ernie3_base_fp16"):
        fp16_launches = train_ernie3_base_fp16(torch, smi, fa, mta)
        left_on_card(torch, "train_ernie3_base_fp16")
    if want("moe"):
        moe_rows = moe_check(torch, planted)
        moe_launches = train_moe_jamba2(torch, smi)
        ec_launches = ec_moe_jamba2(torch, smi)
        moe_vs_cpu(torch)
        left_on_card(torch, "moe")
    if want("grad_scaler_check"):
        grad_scaler_check(torch)
        left_on_card(torch, "grad_scaler_check")
    if want("optimizer_zoo_check"):
        zoo_launches = optimizer_zoo_check(torch, mta)
        left_on_card(torch, "optimizer_zoo_check")
    if want("train_transformer_base"):
        tb_launches = train_transformer_base(torch, smi, fa, mta)
        left_on_card(torch, "train_transformer_base")
        path_launches["transformer_base"] = {
            k: n for k, n in tb_launches.items() if k.endswith("[segs_drop]")}
    if want("batch_norm_check"):
        k10_rows = batch_norm_check(torch, {
            r: planted["batch_norm"] for r in K10_PLANTED})
        left_on_card(torch, "batch_norm_check")
    if want("train_resnet50"):
        rn_launches = train_resnet50(torch, smi)
        left_on_card(torch, "train_resnet50")
    if want("nms_check"):
        nms_row = nms_check(torch, planted["nms"])
        left_on_card(torch, "nms_check")
    if want("serve_ppyoloe"):
        pp_serve = serve_ppyoloe(torch, smi)
        left_on_card(torch, "serve_ppyoloe")
    if want("train_ppyoloe"):
        pp_train = train_ppyoloe(torch, smi)
        left_on_card(torch, "train_ppyoloe")
    if only is not None:
        # a subset of phases: no kernels line (it reads every phase)
        emit({"only": sorted(only, key=PHASES.index),
              "seconds": time.monotonic() - t_start, "card": smi})
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    k1 = next(r for r in flash_rows if r["case"] == "causal_1000_ragged")
    k2 = next(r for r in paged_rows if r["case"] == "bf16_h32")
    k1_16 = next(r for r in flash_rows
                 if r["case"] == "fp16_causal_1000_ragged")
    k2_16 = {r["case"]: r for r in paged_rows if r["case"].startswith("fp16")}
    ernie16 = fp16_launches["ernie_fp16_captured"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the card's own time a call (graph_ms) of B1-B6 and their yardsticks
    b_keys = ("device_ms", "library_device_ms")
    # the port's own kernels (K1-K9, multi-tensor AdamW) also carry the
    # card's own time a call and the wrapper's host time
    k_keys = keys + ("device_ms", "device_source", "library_device_ms",
                     "host_us")
    serve16_path = "serve_llama2_7b_fp16, prefill and decode graph replays"
    fp16_rows = [
        {"name": "flash_prefill[fp16]", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:82",
         "launches": serve16_launches["flash_prefill"],
         "launches_path": serve16_path,
         "max_abs_err": max(r["max_abs_err"] for r in flash_rows
                            if r["dtype"] == "float16"),
         "case": "B=1 H=32 L=1000 D=128 causal fp16",
         **{k: k1_16[k] for k in keys}, **{k: k1_16.get(k) for k in b_keys},
         "tail_prefill": {k: next(r for r in flash_rows if r["case"]
                                  == "fp16_causal_lq200_lk1224").get(k)
                          for k in keys + b_keys}},
        {"name": "paged_decode[fp16]", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:178",
         "launches": serve16_launches["paged_decode"],
         "launches_path": serve16_path,
         "max_abs_err": max(r["max_abs_err"] for r in k2_16.values()),
         "case": "fp16 q on an fp16 pool, B=16 H=32 D=128 page 64, "
                 "contexts 0-2047",
         **{k: k2_16["fp16_h32"][k] for k in keys},
         **{k: k2_16["fp16_h32"].get(k) for k in b_keys},
         "other_pools": {n: {k: k2_16[n].get(k) for k in keys + b_keys}
                         for n in ("fp16_q_bf16_pool_h32",
                                   "fp16_q_int8_pool_h32")}},
    ] + [
        {"name": f"{VARIANT_KERNEL[e][0]}[segs_drop][fp16]", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py"
                     + VARIANT_LINES[e]["segs_drop"],
         "launches": ernie16[e],
         "launches_path": "ernie_fp16_captured (12 steps)",
         "launches_ernie_fp16_eager":
             fp16_launches["ernie_fp16_eager"][e],
         "max_abs_err": var16_times[e, "segs_drop"]["max_abs_err"],
         "case": "B=%d H=%d L=%d D=%d fp16 not causal, dropout 0.1, no ids"
                 % ERNIE_SHAPE,
         **{k: var16_times[e, "segs_drop"][k] for k in keys},
         **{k: var16_times[e, "segs_drop"].get(k) for k in b_keys}}
        for e in ("fwd_lse", "bwd_dq", "bwd_dkv")
    ] + [
        {"name": "multi_tensor_adam[fp16]", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/multi_tensor_adam.cu",
         "replaces": "paddle_tpu/optimizer/__init__.py:976",
         "replaces_pallas_call": False,
         "launches": ernie16["multi_tensor_adam"],
         "launches_path": "ernie_fp16_captured (12 steps)",
         "max_abs_err": max(mt16_row["max_abs_err"].values()),
         "case": "n=%d (ERNIE-3.0-base) fp16 params and grads, fp32 master "
                 "and moments, global-norm scale, wd" % mt16_row["n"],
         **{k: mt16_row.get(k) for k in k_keys}},
    ]
    train_rows = [
        ("flash_fwd_lse", "paddle_tpu_torch/csrc/flash_attention.cu",
         "paddle_tpu/ops/flash_attention.py:163",
         max(flash_errs["out"], flash_errs["lse"]),
         flash_times["flash_fwd_lse"], "B=6 H=20 L=4096 D=128 causal bf16",
         max(flash16_errs["out"], flash16_errs["lse"])),
        ("flash_bwd_dq", "paddle_tpu_torch/csrc/flash_attention.cu",
         "paddle_tpu/ops/flash_attention.py:228", flash_errs["dq"],
         flash_times["flash_bwd_dq"], "B=6 H=20 L=4096 D=128 causal bf16",
         flash16_errs["dq"]),
        ("flash_bwd_dkv", "paddle_tpu_torch/csrc/flash_attention.cu",
         "paddle_tpu/ops/flash_attention.py:288", flash_errs["dkv"],
         flash_times["flash_bwd_dkv"], "B=6 H=20 L=4096 D=128 causal bf16",
         flash16_errs["dkv"]),
        ("q8_adam", "paddle_tpu_torch/csrc/q8_adam.cu",
         "paddle_tpu/ops/q8_adam_pallas.py:42", q8_err, q8_time,
         "n=17694720 bf16 base and grad, SR", None),
    ]
    emit({"kernels": [
        {"name": "flash_prefill", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:82",
         "launches": serve_launches["flash_prefill"],
         "launches_path": "serve_llama2_7b run 1, prefill graph replays",
         "note": "every serving launch of B1 (Llama and FMT, full and tail "
                 "prefills) is counted from the replays of the engine's "
                 "prefill graphs, by the launches each capture recorded",
         **{f"launches_prefix_{m}": v["flash_by_prefill"]
            for m, v in prefix_launches.items()},
         **{f"launches_fmt_{p}": v["flash_prefill"]
            for p, v in fmt_launches.items()},
         **{f"launches_serve_chaos_7b_{leg}": v["flash_prefill"]
            for leg, v in chaos_launches.items()},
         "launches_serve_router_7b": router_launches["flash_prefill"],
         "launches_serve_7b_dense": dense_launches["flash_prefill"],
         "launches_serve_fmt_dense": fmt_dense_launches["flash_prefill"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
         "case": k1["case"], **{k: k1[k] for k in keys},
         **{k: k1.get(k) for k in b_keys},
         "fmt_shapes": {k: fmt_times[k] for k in ("flash_prefill",
                                                  "flash_prefill_tail")}},
        {"name": "paged_decode", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:178",
         "launches": serve_launches["paged_decode"],
         "launches_path": "serve_llama2_7b run 1, graph replays",
         **{f"launches_prefix_{m}": v["paged_decode"]
            for m, v in prefix_launches.items()},
         **{f"launches_fmt_{p}": v["paged_decode"]
            for p, v in fmt_launches.items()},
         **{f"launches_serve_chaos_7b_{leg}": v["paged_decode"]
            for leg, v in chaos_launches.items()},
         "launches_serve_router_7b": router_launches["paged_decode"],
         "max_abs_err": max(r["max_abs_err"] for r in paged_rows),
         "case": k2["case"], **{k: k2[k] for k in keys},
         **{k: k2.get(k) for k in b_keys},
         "fmt_shapes": {k: fmt_times[k] for k in ("paged_decode_bf16",
                                                  "paged_decode_int8")}},
    ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": train_launches[name],
         "launches_train_llama_1p6b_bf16_state":
             bf16_state.get(name, 0),
         "max_abs_err": err,
         "case": case, **{k: t[k] for k in keys},
         **{k: t.get(k) for k in b_keys},
         **({} if err16 is None else {"fp16_same_shape": {
             "note": "the fp16 instantiation at the same shape (no fp16 "
                     "path runs the flag-free training kernels: held and "
                     "timed in flash_train_check)",
             "max_abs_err": err16,
             **{k: flash16_times[name].get(k) for k in keys + b_keys}}})}
        for name, src, rep, err, t, case, err16 in train_rows
    ] + fp16_rows + [
        {"name": f"{VARIANT_KERNEL[e][0]}[{v}]", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py" + VARIANT_LINES[e][v],
         "launches": path_launches[variant_path(e, v)].get(f"{e}[{v}]", 0),
         "launches_path": variant_path(e, v),
         **{f"launches_{p}": n.get(f"{e}[{v}]", 0)
            for p, n in path_launches.items()},
         "max_abs_err": var_times[e, v]["max_abs_err"],
         "case": "B=%d H=%d L=%d D=%d bf16 not causal, ids %s" % (
             *ERNIE_SHAPE, var_times[e, v]["ids"]),
         **{k: var_times[e, v][k] for k in keys},
         **{k: var_times[e, v].get(k) for k in b_keys}}
        for e in VARIANT_LINES for v in fa.VARIANTS
    ] + [
        {"name": "multi_tensor_adam", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/multi_tensor_adam.cu",
         "replaces": "paddle_tpu/optimizer/__init__.py:976",
         "replaces_pallas_call": False,
         "note": "the port's own kernel: the JAX package's Adam._fused_step "
                 "is XLA-fused jnp, no pallas_call",
         "launches": captured_launches["ernie_captured_leg1"][
             "multi_tensor_adam"],
         "launches_path": "ernie_captured_leg1",
         **{f"launches_{p}": n["multi_tensor_adam"]
            for p, n in captured_launches.items()},
         "max_abs_err": max(mt_row["max_abs_err"].values()),
         "case": "n=%d (ERNIE-3.0-base) bf16 params and grads, fp32 master "
                 "and moments, global-norm scale, wd" % mt_row["n"],
         **{k: mt_row.get(k) for k in k_keys}},
    ] + [
        {"name": f"multi_tensor_adam[{form}]", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/multi_tensor_adam.cu",
         "replaces": "paddle_tpu/optimizer/__init__.py:976",
         "replaces_pallas_call": False,
         "note": "the port's own kernel in a form of this slice (see "
                 "MT_FORMS): the JAX package's Adam._fused_step is "
                 "XLA-fused jnp, no pallas_call; library_ms is "
                 "torch._fused_adamw_ on bf16 parameters, gradients and "
                 "moments, a yardstick that rounds to nearest",
         "launches": (bf16_state["multi_tensor_adam"]
                      if zoo_case is None else zoo_launches[zoo_case]),
         "launches_path": ("train_llama_1p6b_bf16_state (6 eager steps)"
                           if zoo_case is None else
                           f"optimizer_zoo_check {zoo_case} (5 eager steps)"),
         "max_abs_err": max(mt_forms[form]["max_abs_err"].values()),
         "elements_differing": mt_forms[form]["elements_differing"],
         "case": "n=%d (bench_config()) bf16 grads, %s storage, %s moments"
                 "%s, global-norm scale, wd" % (
                     mt_forms[form]["n"], mt_forms[form]["storage"],
                     mt_forms[form]["moments"],
                     ", stochastic rounding" if MT_FORMS[form][3] else ""),
         **{k: mt_forms[form].get(k) for k in k_keys}}
        for form, zoo_case in (("master_free_sr", None),
                               ("bf16_moments", "AdamW_mt_bf16_moments"),
                               ("master_free_rn", "AdamW_mt_master_free_rn"))
    ] + [
        {"name": k, "route": "cuda", "source": FUSED_SOURCES[k],
         "replaces": FUSED_REPLACES[k], "replaces_pallas_call": False,
         "note": "the port's own kernel, forward and backward: the JAX "
                 "package computes it with XLA-fused jnp, no pallas_call",
         "launches": train_launches[k],
         "launches_path": "train_llama_1p6b (6 eager steps)",
         "launches_train_llama_1p6b_bf16_state": bf16_state[k],
         "launches_llama_captured": llama_captured["launches"][k],
         "launches_ernie_captured_leg1":
             captured_launches["ernie_captured_leg1"].get(k, 0),
         "launches_serve_run1": serve_launches.get(k, 0),
         "launches_serve_router_7b": router_launches.get(k, 0),
         **{f"launches_fmt_{p}": v.get(k, 0)
            for p, v in fmt_launches.items()},
         **({"fmt_shapes": {k: fmt_times[k]}} if k in fmt_times else {}),
         "max_abs_err": fused_rows[k]["max_abs_err"],
         "case": fused_rows[k]["case"],
         **({"timed_cases": fused_rows[k]["timed_cases"]}
            if "timed_cases" in fused_rows[k] else {}),
         **{key: fused_rows[k].get(key) for key in k_keys},
         **{key: fused_rows[k][key] for key in fused_rows[k]
            if key.startswith("bwd_")}}
        for k in FUSED_KERNELS
    ] + [
        {"name": k, "route": "cuda", "source": ERNIE_OP_SOURCES[k],
         "replaces": ERNIE_OP_REPLACES[k], "replaces_pallas_call": False,
         "note": "the port's own kernel, forward and backward: the JAX "
                 "package computes it with XLA-fused jnp, no pallas_call",
         **({"launches": incubate_row["launches"][k],
             "launches_path": "incubate_check"} if k == "softmax_mask" else
            {"launches": captured_launches["ernie_captured_leg1"][k],
             "launches_path": "ernie_captured_leg1 (12 calls)"}),
         "launches_ernie_leg1": path_launches["ernie_leg1"].get(k, 0),
         "launches_llama_eager": train_launches.get(k, 0),
         "launches_train_llama_1p6b_bf16_state":
             bf16_state.get(k, 0),
         "launches_serve_run1": serve_launches.get(k, 0),
         "launches_serve_router_7b": router_launches.get(k, 0),
         **{f"launches_fmt_{p}": v.get(k, 0)
            for p, v in fmt_launches.items()},
         **({"fmt_shapes": {n: fmt_times[n] for n in ("bias_act_512",
                                                      "bias_act_16")}}
            if k == "bias_act" else {}),
         "launches_incubate_check": incubate_row["launches"][k],
         "max_abs_err": ernie_rows[k]["max_abs_err"],
         "case": ernie_rows[k]["case"],
         **({"timed_cases": ernie_rows[k]["timed_cases"]}
            if "timed_cases" in ernie_rows[k] else {}),
         **{key: ernie_rows[k].get(key) for key in k_keys},
         **{key: ernie_rows[k][key] for key in ernie_rows[k]
            if key.startswith("bwd_")}}
        for k in ERNIE_OP_KERNELS
    ] + [
        {"name": k, "route": "cuda", "source": "paddle_tpu_torch/csrc/moe.cu",
         "replaces": MOE_REPLACES[k], "replaces_pallas_call": False,
         "note": "the port's own kernel (K9), forward and backward: the JAX "
                 "package routes with one-hot einsums (moe.py:75-77) and a "
                 "gather and scatter-add (nn.py:230, :236-238), no "
                 "pallas_call; library_ms is index_select (dispatch) or "
                 "index_add_ of pre-weighted rows (combine), a yardstick",
         "launches": moe_launches["launches"][k],
         "launches_path": "train_moe_jamba2 (6 eager steps)",
         "launches_per_replay": moe_launches["replay"][k],
         "launches_ec_moe_jamba2": ec_launches["launches"][k],
         "max_abs_err": moe_rows["moe_route"]["max_abs_err"],
         "case": "8192 tokens x 4096, 16 experts, top-2, capacity 1536, "
                 "bf16 (O2)",
         **{key: moe_rows["moe_route"]["timing"]["token_choice"][
             k.replace("moe_", "") + "_fwd"].get(key) for key in k_keys},
         **{f"bwd_{key}": moe_rows["moe_route"]["timing"]["token_choice"][
             k.replace("moe_", "") + "_bwd"].get(key) for key in k_keys},
         "ec_shapes": {n: moe_rows["moe_route"]["timing"]["expert_choice"][n]
                       for n in moe_rows["moe_route"]["timing"][
                           "expert_choice"] if n.startswith(
                               k.replace("moe_", ""))}}
        for k in MOE_REPLACES
    ] + [
        {"name": "softmax_cross_entropy[smooth]", "route": "cuda",
         "source": FUSED_SOURCES["softmax_cross_entropy"],
         "replaces": FUSED_REPLACES["softmax_cross_entropy"],
         "replaces_pallas_call": False,
         "note": "K4 with label smoothing 0.1 (and ignore_index 0 on the "
                 "path): the JAX package's cross_entropy is XLA-fused jnp, "
                 "no pallas_call. forms: the slice's other forms (class "
                 "weights, reductions none and sum, labels outside the "
                 "vocabulary), held and timed in loss_ops_check only",
         "launches": tb_launches["softmax_cross_entropy"],
         "launches_path": "train_transformer_base eager (12 steps)",
         "max_abs_err": loss_rows["smooth"]["max_abs_err"],
         "case": loss_rows["smooth"]["case"],
         **{key: loss_rows["smooth"].get(key) for key in k_keys},
         **{key: loss_rows["smooth"][key] for key in loss_rows["smooth"]
            if key.startswith("bwd_")},
         "forms": {n: {key: r.get(key) for key in ("case", "max_abs_err")
                       + k_keys}
                   for n, r in loss_rows.items() if n != "smooth"}},
    ] + [
        {"name": "bias_act[period]", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/bias_act.cu",
         "replaces": "paddle_tpu/incubate/nn.py:231",
         "replaces_pallas_call": False,
         "note": "K6 with a bias row period (FusedEcMoe's per-expert b0): "
                 "the JAX package adds the bias and applies GELU in XLA, no "
                 "pallas_call",
         "launches": ec_launches["launches"]["bias_act"],
         "launches_path": "ec_moe_jamba2 (one forward and backward)",
         "max_abs_err": moe_rows["bias_act_period"]["max_abs_err"],
         "case": moe_rows["bias_act_period"]["case"],
         **{key: moe_rows["bias_act_period"].get(key) for key in k_keys},
         **{key: moe_rows["bias_act_period"][key] for key in (
             "bwd_ms", "bwd_device_ms", "bwd_plain_ms", "bwd_library_ms",
             "bwd_library_device_ms", "bwd_bound_ms")}},
    ] + [
        {"name": k10_name(form), "route": "cuda", "source": K10_SOURCE,
         "replaces": K10_REPLACES, "replaces_pallas_call": False,
         "note": "K10, the port's own kernel (stats + apply forward, reduce "
                 "+ apply backward): the JAX package's batch_norm_stats and "
                 "batch_norm are XLA-fused jnp, no pallas_call; launches "
                 "forward and backward",
         **k10_path_launches(form, rn_launches, pp_train, pp_serve),
         "max_abs_err": k10_rows[form]["max_abs_err"],
         "case": k10_rows[form]["case"],
         **{key: k10_rows[form].get(key) for key in k_keys},
         **{key: k10_rows[form][key] for key in k10_rows[form]
            if key.startswith("bwd_")}}
        for form in K10_FORMS
    ] + [
        {"name": "nms", "route": "cuda", "source": K11_SOURCE,
         "replaces": K11_REPLACES,
         "note": "K11: the JAX package's _nms_suppress is a lax.fori_loop "
                 "(XLA), no pallas_call; two launches a call (the "
                 "suppression bitmask, then the sweep); no PyTorch call "
                 "computes greedy NMS (library_ms null)",
         "launches": pp_serve["launches"]["nms"],
         "launches_path": f"serve_ppyoloe ({PP_SERVE_ITERS} predict calls)",
         "launches_per_call": pp_serve["launches_per_call"]["nms"],
         "max_abs_err": nms_row["max_abs_err"], "case": nms_row["case"],
         **{key: nms_row.get(key) for key in k_keys},
         "nms_8400": nms_row["nms_8400"]},
    ], "card": smi, "seconds": time.monotonic() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def k10_path_launches(form: str, rn_launches: dict, pp_train: dict,
                      pp_serve: dict) -> dict:
    """A K10 form's launches on its path's run: ResNet-50's 12 eager steps
    for its forms, PP-YOLOE-l's training steps for the swish forms (and
    the plain form there too), with the serving calls beside."""
    name = k10_name(form)
    pp = {"launches_train_ppyoloe": pp_train["launches"].get(name, 0)
          + pp_train["launches"].get(name + "_bwd", 0),
          "launches_serve_ppyoloe": pp_serve["launches"].get(name, 0)}
    if form in K10_SWISH_FORMS:
        return {"launches": pp["launches_train_ppyoloe"],
                "launches_fwd": pp_train["launches"].get(name, 0),
                "launches_bwd": pp_train["launches"].get(name + "_bwd", 0),
                "launches_path": f"train_ppyoloe eager ({PP_TRAIN_STEPS} "
                                 f"steps)", **pp}
    return {"launches": rn_launches[name] + rn_launches[name + "_bwd"],
            "launches_fwd": rn_launches[name],
            "launches_bwd": rn_launches[name + "_bwd"],
            "launches_path": "train_resnet50 eager (12 steps)", **pp}


if __name__ == "__main__":
    sys.exit(main())
