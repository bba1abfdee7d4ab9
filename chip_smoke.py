#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``. It builds every kernel in ``paddle_tpu_torch/csrc`` from source
(and requires that the SASS of every bf16 flash kernel, forward, dq and
dk/dv, holds wgmma and TMA instructions) and runs, printing one JSON line
per phase:

* serving: holds the flash-prefill and paged-decode kernels against their
  plain PyTorch versions at the shapes the serving path gives them, serves
  Llama-2-7B at full width (random bf16 weights from a seed, 32 layers)
  through the continuous-batching engine, serves the same traffic again
  under ``torch.profiler``, and checks that engine and ``generate`` agree
  token for token on a 2-layer full-width fp32 model;
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
  ERNIE layers with attention dropout on the card and on the CPU.

The line before the last lists each kernel with its launches on its path's
run, error, times and bound; the last line is ``{"ok": true, "device":
{...}}``. Any failed check raises and the script exits non-zero; without a
card it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain, elementwise |out - ref| <= atol + rtol * |ref|, keyed by
# (kernel, output dtype). bf16 outputs are one rounding (half an ulp,
# <= 2^-9 relative) from the fp32 plain version. The paged kernel does its
# products in fp32 (max-abs 0.00098 seen), so its limit is 2x the output
# rounding and tight enough to catch one skipped 64-position page. fp32
# outputs differ only by summation order. lse is fp32 from either flash
# kernel: the bf16 kernel forms the same exact bf16 products and differs
# from the plain version only in summation order.
TOL = {("paged", "bfloat16"): (2e-3, 4e-3),
       ("flash", "float32"): (1e-4, 1e-4),
       ("paged", "float32"): (1e-4, 1e-4),
       ("lse", "bfloat16"): (1e-4, 1e-5),
       ("lse", "float32"): (1e-4, 1e-5),
       ("flash_bwd", "float32"): (1e-4, 1e-4)}
# bf16 flash outputs (K1/B2 out, B3 dq, B4 dk and dv) are held against their
# size: for every tile of 64 sequence rows of every (batch, head),
# ||out - ref|| / ||ref|| <= limit. The kernels round P (and dS in the
# backward) to bf16 for their tensor-core products and round the output:
# 0.0025-0.0030 seen in every case on random inputs, the output rounding
# alone 0.0027. An absolute limit holds small elements loosely: at L=4096
# a typical element of out or of a gradient is about 0.03 to 0.06.
REL_TOL = {("flash", "bfloat16"): 1e-2,
           ("flash_bwd", "bfloat16"): 1e-2}
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
# it at bf16_h32.
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
     "      if (sp == 1) continue;\n"))


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

def check_flash(torch, fa):
    import torch.nn.functional as TF
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, H, Hkv, Lq, Lk, causal, dtype, D
        ("causal_512", 1, 32, 32, 512, 512, True, bf, 128),
        ("causal_2048", 1, 32, 32, 2048, 2048, True, bf, 128),
        ("causal_1000_ragged", 1, 32, 32, 1000, 1000, True, bf, 128),
        ("gqa_causal_1024_h32_kv8", 1, 32, 8, 1024, 1024, True, bf, 128),
        ("causal_lq256_lk1024", 1, 32, 32, 256, 1024, True, bf, 128),
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
        if causal:
            shift = lk - lq
            pairs = sum(min(lk, max(0, i + shift + 1)) for i in range(lq))
        else:
            pairs = lq * lk
        flops = 4.0 * b * h * d * pairs
        nbytes = q.element_size() * d * b * (2 * lq * h + 2 * lk * hkv)
        bms, by = bound(flops, nbytes, dtype_name(dt))
        row = dict(case=name, dtype=dtype_name(dt), max_abs_err=err,
                   tile_rel_err=res.get("tile_rel"), ref_rms=res["ref_rms"],
                   library_max_abs_err=lib_err,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9)
        emit({"phase": "flash_check", **row})
        rows.append(row)
    return rows


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
    own pages in random order (``leg``: "f32", "bf16" or "int8" with
    scales), q and the current token in ``qdt``, and the case's byte and
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
    elif leg == "bf16":
        pool, scales = poolf.to(torch.bfloat16), None
    else:
        pool, scales = poolf, None
    del poolf
    q = torch.randn(b, h, d, generator=gen, device="cuda", dtype=qdt)
    kn = torch.randn(b, hkv, d, generator=gen, device="cuda", dtype=qdt)
    vn = torch.randn(b, hkv, d, generator=gen, device="cuda", dtype=qdt)
    args = (q, kn, vn, pool, scales, torch.as_tensor(tables_host, device="cuda"),
            torch.as_tensor(t_host, device="cuda"), layer)
    npages = int(sum(-(-int(tv) // ps) for tv in t_host))
    nbytes = (2.0 * int(t_host.sum()) * hkv * d * pool.element_size()
              + q.element_size() * (2 * b * h * d + 2 * b * hkv * d)
              + 4.0 * (b * s + b)
              + (8.0 * npages * hkv if scales is not None else 0.0))
    flops = 4.0 * h * d * float((t_host + 1).sum())
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
    bf, f32 = torch.bfloat16, torch.float32
    edges = split_edges(pa, 16, 32, 64, 32)
    # name, q heads, kv heads, pool, q dtype, D, page size, table width,
    # contexts; the first four are timed. The fp32 leg is the engine's
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
             ("int8_rep8_h32_kv4", 32, 4, "int8", bf, 128, 64, 32, PAGED_T))
    rows = []
    for i, (name, h, hkv, leg, qdt, d, ps, s, t_host) in enumerate(cases):
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
        if name == "bf16_h32":
            # the kernels have no atomics and fold splits in order
            runs = [pa.paged_attention(*args, page_size=ps) for _ in range(3)]
            same = all(torch.equal(r.view(torch.int16), runs[0].view(torch.int16))
                       for r in runs[1:])
            require(same, "paged bf16_h32: three launches on the same inputs "
                          "differ")
            fn = planted_lib.paged_decode
            fn.argtypes, fn.restype = pa._ARGTYPES, ctypes.c_int
            bad = pa.call_kernel(fn, *args, page_size=ps)
            torch.cuda.synchronize()
            require(not within_tol(bad, ref, "paged"),
                    "paged bf16_h32: the planted fault (the combine skips "
                    "the second live split) passed TOL")
            row.update(bit_identical_launches=3, planted_fault_max_abs=(
                bad.float() - ref.float()).abs().max().item())
        if i < 4:
            lib = paged_sdpa(torch, case)
            row.update(ms=cuda_ms(torch, lambda: pa.paged_attention(
                           *args, page_size=ps), 20),
                       plain_ms=cuda_ms(torch, lambda: pa.paged_attention_dense(
                           *args, page_size=ps), 3, warmup=1),
                       library_ms=cuda_ms(torch, lib, 20))
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
# phase 4: serve Llama-2-7B at full width
# ---------------------------------------------------------------------------

def serve_7b(torch, card, fa, pa):
    import numpy as np
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (Engine, GenerationRequest,
                                          ServingConfig)
    cfg = LlamaConfig.llama2_7b()
    cfg.dtype = "bfloat16"
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prefill_fn, step_fn = model.serving_callables(2048)
    batches = []

    def counted_step(tok, cache, t):
        batches.append(int(tok.shape[0]))
        return step_fn(tok, cache, t)

    scfg = ServingConfig(
        num_layers=cfg.num_hidden_layers, num_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, max_len=2048, max_batch=16, page_size=64,
        compute_dtype="bfloat16", kv_dtype="native", policy="budget",
        prefill_token_budget=2048, device="cuda")
    eng = Engine(prefill_fn, counted_step, scfg).warmup([128])
    rng = np.random.default_rng(0)
    lens = rng.permutation(np.linspace(128, 1000, 16).astype(int))
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in lens]

    def serve():
        t0 = time.monotonic()
        futs = [eng.submit(GenerationRequest(pr, max_new_tokens=64))
                for pr in prompts]
        eng.run()
        torch.cuda.synchronize()
        return time.monotonic() - t0, [f.result(timeout=0) for f in futs]

    batches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches.reset()
    pa.launches.reset()
    wall, results = serve()
    launches = {"flash_prefill": fa.launches.count,
                "paged_decode": pa.launches.count}
    for r in results:
        require(len(r.tokens) == 64 and r.finish_reason == "length",
                f"request {r.request_id}: {len(r.tokens)} tokens, "
                f"{r.finish_reason}")
        require(all(0 <= x < cfg.vocab_size for x in r.tokens),
                f"request {r.request_id}: token out of range")
    require(launches["flash_prefill"] == 16 * cfg.num_hidden_layers,
            f"flash launches {launches['flash_prefill']} != 16 prefills x 32")
    require(launches["paged_decode"] == len(batches) * cfg.num_hidden_layers
            and launches["paged_decode"] > 0,
            f"paged launches {launches['paged_decode']} != "
            f"{len(batches)} steps x 32")
    require(eng.kv.outstanding_pages == 0
            and eng.kv.free_pages == eng.kv.config.num_pages - 1,
            "pages leaked after the drain")
    ntok = sum(len(r.tokens) for r in results)
    emit({"phase": "serve_llama2_7b", "card": card, "layers": 32,
          "dtype": "bfloat16", "requests": 16,
          "prompt_lens": [int(x) for x in lens], "new_tokens": 64,
          "wall_s": wall, "tokens_per_s": ntok / wall,
          "ttft_median_s": statistics.median(r.ttft_s for r in results),
          "tpot_median_s": statistics.median(r.tpot_s for r in results),
          "decode_steps": len(batches),
          "batch_sizes": {str(k): batches.count(k)
                          for k in sorted(set(batches))},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "weights_init_s": init_s, "launches": launches})
    profile_serving(torch, card, serve, wall)
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def kernel_family(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_prefill"
    if "paged_decode" in low:
        return "paged_decode"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")):
        return "matmul"
    return "other"


def profile_serving(torch, card, serve, unprofiled_wall_s: float) -> None:
    """Serve the same traffic again under ``torch.profiler``; emit where the
    device time goes. The busy share is kernel time over this pass's wall
    time, which the profiler's host overhead inflates; kernel time over the
    unprofiled pass's wall is the estimate for the run without it."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, _ = serve()

    def device_us(evt) -> float:
        v = getattr(evt, "self_device_time_total", None)
        return float(v if v is not None else evt.self_cuda_time_total)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    total_s = sum(device_us(e) for e in kernels) / 1e6
    require(total_s > 0, "profiler recorded no device time")
    fams = {}
    for e in kernels:
        f = fams.setdefault(kernel_family(e.key), {"device_ms": 0.0, "calls": 0})
        f["device_ms"] += device_us(e) / 1e3
        f["calls"] += e.count
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    emit({"phase": "serve_profile", "card": card, "wall_s": wall,
          "device_ms": total_s * 1e3, "device_busy_share": total_s / wall,
          "unprofiled_wall_s": unprofiled_wall_s,
          "device_busy_share_est_unprofiled": total_s / unprofiled_wall_s,
          "families": fams,
          "top": [{"kernel": e.key[:90], "device_ms": device_us(e) / 1e3,
                   "calls": e.count} for e in top]})


# ---------------------------------------------------------------------------
# phase 5: engine tokens == generate tokens (full width, 2 layers, fp32)
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
    fa.launches.reset()
    pa.launches.reset()
    refs = []
    for pr in prompts:
        ids = torch.as_tensor(pr[None, :].astype(np.int64), device="cuda")
        refs.append(model.generate(ids, max_new_tokens=16)[0, pr.size:]
                    .tolist())
    gen_launches = {"flash_prefill": fa.launches.count,
                    "paged_decode": pa.launches.count}
    prefill_fn, step_fn = model.serving_callables(1024)
    eng = Engine(prefill_fn, step_fn, ServingConfig(
        num_layers=2, num_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, max_len=1024, max_batch=4, buckets=(1, 4),
        page_size=64, compute_dtype="float32", device="cuda"))
    fa.launches.reset()
    pa.launches.reset()
    futs = [eng.submit(GenerationRequest(pr, max_new_tokens=16))
            for pr in prompts]
    eng.run()
    got = [f.result(timeout=0).tokens for f in futs]
    eng_launches = {"flash_prefill": fa.launches.count,
                    "paged_decode": pa.launches.count}
    require(got == refs, f"engine tokens {got} != generate tokens {refs}")
    require(gen_launches["flash_prefill"] == 4 * 16 * 2
            and gen_launches["paged_decode"] == 0,
            f"generate launches {gen_launches}")
    require(eng_launches["flash_prefill"] == 4 * 2
            and eng_launches["paged_decode"] > 0,
            f"engine launches {eng_launches}")
    emit({"phase": "engine_vs_generate", "layers": 2, "dtype": "float32",
          "prompts": [int(p.size) for p in prompts], "new_tokens": 16,
          "identical": True, "generate_launches": gen_launches,
          "engine_launches": eng_launches})
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# training phase 1: forward with lse, flash backward against plain versions
# ---------------------------------------------------------------------------

# the bf16 flash kernels (forward, dq, dk/dv): each must run on wgmma and TMA
WGMMA_KERNEL = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel)"
                          r"I((?:L[ib]\d+E)+)E")
# forward <D, LSE, SEGS, DROP>, dq and dk/dv <D, SEGS, DROP>; D in 64, 128;
# (SEGS, DROP) in (0, 0), (1, 0), (1, 1): dropout always carries ids
N_WGMMA_KERNELS = 24


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


def wgmma_kernels(native_build) -> dict:
    """Each bf16 flash kernel of the built library (forward, dq, dk/dv): the
    ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in its SASS,
    and its registers and spills, keyed e.g.
    ``flash_fwd_wgmma_kernel<D, LSE>``."""
    kernels = sass_functions(native_build, "flash_attention", WGMMA_KERNEL,
                             ("HGMMA", "UTMALDG"))
    named = {}
    for fn, v in kernels.items():
        m = WGMMA_KERNEL.search(fn)
        named["%s<%s>" % (m[1], ", ".join(re.findall(r"L[ib](\d+)E", m[2])))] = v
    return named


# the paged split kernel (pool type, D, q heads per kv head bucket): each
# must copy its pages by cp.async.bulk, whose SASS is UBLKCP
PAGED_SPLIT_KERNEL = re.compile(r"paged_decode_split_kernel")
BULK_COPY_OP = "UBLKCP"
N_PAGED_SPLIT_KERNELS = 24     # f32, bf16, int8 pools x D 64, 128 x rep 1, 2, 4, 8


def paged_kernels(native_build) -> dict:
    """Each paged split kernel of the built library: its bulk copies
    (``BULK_COPY_OP``) in SASS, registers and spills, by mangled name."""
    return sass_functions(native_build, "paged_attention", PAGED_SPLIT_KERNEL,
                          (BULK_COPY_OP,))


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: the causal rule's count
    where causal (bottom-right aligned), lq * lk where not."""
    if not causal:
        return lq * lk
    shift = lk - lq
    return sum(min(lk, max(0, i + shift + 1)) for i in range(lq))


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
    ``(entry suffix, arguments, tensors to keep alive)``; the stream is
    last."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    tail = (b, lq, lk, h, hkv, d, fa._DTYPE_CODES[q.dtype], int(causal),
            1.0 / math.sqrt(d))
    extra, keep, suffix = (), (), ""
    if var is not None:
        extra, keep = fa._segdrop_args(*var, b, lq, lk, q.device)
        suffix = "_segdrop"
    return suffix, (*tail, *extra, torch.cuda.current_stream().cuda_stream), keep


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
        fns.append(lambda fn=fn, args=args, keep=(keep, delta): fn(*args))
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
    return out, lse, lambda keep=keep: fn(*ptrs, *tail)


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
        limit = REL_TOL[kernel, "bfloat16"]
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
        "shape": list(q.shape), "out": "skips the K/V tile at Lk/2",
        "dq": "skips the K tile at Lk/2", "dk_dv": "skip the Q tile at Lq/2",
        **row}})


def check_flash_train(torch, fa, planted_lib):
    import torch.nn.functional as TF
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32
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
    ]
    errs = {"lse": 0.0, "out": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, b, h, hkv, lq, lk, causal, dt, d in cases:
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
        if name == "causal_4096_h20":
            check_planted(torch, fa, planted_lib, q, k, v, rout, rlse, do,
                          (rq, rk, rv))
        del q, k, v, do, out, lse, rout, rlse, dq, dk, dv, rq, rk, rv
    gc.collect()
    torch.cuda.empty_cache()

    # times at the main path's shape: bench.py's B=6, H=20, L=4096, D=128
    b, h, L, d = 6, 20, 4096, 128
    q, k, v, do = (torch.randn(b, L, h, d, generator=gen, device="cuda",
                               dtype=bf) for _ in range(4))
    # the forward has no atomics: launches that differ in any bit race in
    # its pipeline
    runs = [fa.flash_attention_lse(q, k, v, causal=True) for _ in range(3)]
    same = all(torch.equal(o.view(torch.int16), runs[0][0].view(torch.int16))
               and torch.equal(l.view(torch.int32), runs[0][1].view(torch.int32))
               for o, l in runs[1:])
    require(same, "flash_fwd_lse at B=6 H=20 L=4096: three launches on the "
                  "same inputs differ")
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
    require(all(bwd_same.values()), f"flash backward at B=6 H=20 L=4096: "
                                    f"three launches on the same inputs "
                                    f"differ {bwd_same}")
    emit({"phase": "flash_train_check", "determinism": {
        "shape": [b, L, h, d], "launches": 3, "bit_identical": same,
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
    pairs = attention_pairs(L, L, True)
    item = 2  # bf16
    qbytes = b * L * h * d * item
    lse_bytes = b * h * L * 4
    timings = {}
    for kname, ms, plain, lib, products, nbytes in (
            ("flash_fwd_lse", ms_fwd, plain_fwd, lib_fwd, 2,
             4 * qbytes + lse_bytes),
            ("flash_bwd_dq", ms_dq, plain_bwd, lib_bwd, 3,
             5 * qbytes + 2 * lse_bytes),
            ("flash_bwd_dkv", ms_dkv, plain_bwd, lib_bwd, 4,
             6 * qbytes + 2 * lse_bytes)):
        flops = products * 2.0 * b * h * d * pairs
        bms, by = bound(flops, nbytes, "bfloat16")
        timings[kname] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bms, bound_by=by,
                              tflops=flops / ms / 1e9)
    emit({"phase": "flash_train_timing", "shape": [b, L, h, d],
          "dtype": "bfloat16", "causal": True, **timings,
          "plain_note": "plain_ms of dq and dkv is the whole plain backward",
          "library_note": "library_ms of dq and dkv is SDPA's whole "
                          "backward"})
    del q, k, v, do, out, lse, grads, qh, kh, vh, doh, lib_out
    gc.collect()
    torch.cuda.empty_cache()
    return errs, timings


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
            kw = dict(hp, c1=c1, c2=c2, decay=decay, seed=1234, use_sr=sr)
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
                # the main path's case: bf16 base and grad, SR, wd
                nb = st_k[0].shape[0]
                ms = cuda_ms(torch, lambda: q8.q8_adam_update(*st_k, g, **kw), 20)
                plain = cuda_ms(torch, lambda: q8.q8_adam_update_reference(
                    *st_r, g, **kw), 3, warmup=1)
                nbytes = 10.0 * n + 16.0 * nb   # codes, base, grad; scales
                bms, by = bound(25.0 * n, nbytes, "float32")
                timing = dict(n=n, ms=ms, plain_ms=plain, bound_ms=bms,
                              bound_by=by, library_ms=None,
                              gbytes_per_s=nbytes / ms / 1e6)
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
                          lr=1e-3, c1=0.1, c2=0.001, eps=1e-8, beta1=0.9,
                          beta2=0.999, decay=0.9997, seed=seed, use_sr=True)
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
            "flash_bwd_dkv": fa.launches_bwd_dkv, "q8_adam": q8.launches}


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
    del model, opt, ids
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_family(name: str) -> str:
    low = name.lower()
    for key, fam in (("flash_fwd", "flash_fwd_lse"),
                     ("flash_bwd_dq", "flash_bwd_dq"),
                     ("flash_bwd_dkv", "flash_bwd_dkv"),
                     ("q8_adam", "q8_adam")):
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
    launches per kernel family (``family`` of a kernel's name) and the
    busy share."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0

    def device_us(evt) -> float:
        v = getattr(evt, "self_device_time_total", None)
        return float(v if v is not None else evt.self_cuda_time_total)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    total_s = sum(device_us(e) for e in kernels) / 1e6
    require(total_s > 0, "profiler recorded no device time")
    fams = {}
    for e in kernels:
        f = fams.setdefault(family(e.key), {"device_ms": 0.0, "calls": 0})
        f["device_ms"] += device_us(e) / 1e3
        f["calls"] += e.count
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    emit({"phase": phase, "card": card, **(extra or {}), "wall_s": wall,
          "device_ms": total_s * 1e3, "device_busy_share": total_s / wall,
          "unprofiled_step_s": unprofiled_step_s,
          "device_busy_share_est_unprofiled": total_s / unprofiled_step_s,
          "families": fams,
          "top": [{"kernel": e.key[:90], "device_ms": device_us(e) / 1e3,
                   "calls": e.count} for e in top]})


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
    bf, f32 = torch.bfloat16, torch.float32
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


def time_variants(torch, fa, b: int, h: int, L: int, d: int) -> dict:
    """Times of every variant entry point (raw launches) at one shape, bf16,
    not causal, on the ids VARIANT_IDS names, with the bound, the plain
    version and the library yardstick: SDPA with a boolean key-padding mask
    (segs), with dropout_p=0.1 (segs_drop: no ids, as ERNIE calls it); for
    dq and dk/dv SDPA's whole backward and the whole plain backward. Each
    variant's wrappers are held against the plain version on the timed
    inputs (``max_abs_err``). The flag-free kernels ("none") are timed too,
    as the variants' baseline; they are not returned."""
    import torch.nn.functional as TF
    gen = torch.Generator(device="cuda").manual_seed(7)
    lib = fa._native.load("flash_attention")
    q, k, v, do = (torch.randn(b, L, h, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    rows = {}
    pairs = b * h * L * L
    item = 2
    qbytes = b * L * h * d * item
    rowbytes = b * h * L * 4
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
        seg_bytes = 2 * b * L * 4 if args[0] is not None else 0
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
        for entry, run, plain, libms, products, nbytes in (
                ("fwd", run_fwd, plain_fwd, lib_fwd, 2, 4 * qbytes),
                ("fwd_lse", run_lse, plain_fwd, lib_fwd, 2,
                 4 * qbytes + rowbytes),
                ("bwd_dq", run_dq, plain_bwd, lib_bwd, 3,
                 5 * qbytes + 2 * rowbytes),
                ("bwd_dkv", run_dkv, plain_bwd, lib_bwd, 4,
                 6 * qbytes + 2 * rowbytes)):
            ms = cuda_ms(torch, run, 20)
            flops = products * 2.0 * d * pairs
            bms, by = bound(flops, nbytes + seg_bytes, "bfloat16")
            rows[entry, variant] = dict(ms=ms, plain_ms=plain, library_ms=libms,
                                        bound_ms=bms, bound_by=by,
                                        tflops=flops / ms / 1e9,
                                        max_abs_err=errs.get(entry),
                                        ids=VARIANT_IDS.get(variant))
        del out, lse, qh, kh, vh, lib_out, doh, run_fwd, run_lse, run_dq, \
            run_dkv
    emit({"phase": "flash_segs_dropout_timing", "shape": [b, L, h, d],
          "dtype": "bfloat16", "causal": False, "dropout_p": DROPOUT_P,
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
             for dt in (torch.bfloat16, torch.float32)
             for ids in ("none", "zeros")
             for seed in (2024, -7)]
    emit({"phase": "flash_segs_dropout_check", "keep_mask_exact": masks})
    # three launches of each variant kernel at the second ERNIE leg's
    # shape, as ERNIE calls it (dropout, no ids), each against the plain
    # version and all three bit for bit
    b, h, L, d = 8, 12, 512, 64
    q, k, v, do = (torch.randn(b, L, h, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    var = variant_var(torch, gen, "segs_drop", b, L, L, "none")
    det_row, runs = check_variant(torch, fa, "determinism", q, k, v, do,
                                  False, var, runs=3)

    def bits(x):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    same = {n: all(torch.equal(bits(r[i]), bits(runs[0][i])) for r in runs[1:])
            for i, n in enumerate(det_row)}
    require(all(same.values()),
            f"segs_drop at B={b} H={h} L={L}: three launches differ: {same}")
    del runs, q, k, v, do
    # the planted fault: B4's dropout keyed on the kv head, at GQA 8/2
    b, h, hkv, L = 2, 8, 2, 512
    q, do = (torch.randn(b, L, h, 128, generator=gen, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, L, hkv, 128, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
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
    limit = REL_TOL["flash_bwd", "bfloat16"]
    require(all(e > limit for e in planted.values()),
            f"the planted fault (B4 dropout keyed on the kv head) passed "
            f"REL_TOL {limit}: {planted}")
    emit({"phase": "flash_segs_dropout_check", "determinism": {
        "shape": [8, 512, 12, 64], "variant": "segs_drop", "ids": "none",
        "launches": 3, "bit_identical": same, **det_row},
        "planted_fault": {"fault": "B4 dropout keyed on the kv head",
                          "shape": [b, L, h, hkv, 128], "tile_rel": planted,
                          "limit": limit}})
    del q, k, v, do, rout, rlse, rk, rv, dk, dv
    gc.collect()
    torch.cuda.empty_cache()
    return errs, masks


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
        others = {c.name: c.count for c in all_counters
                  if c not in path.values() and c.count}
        after = eval_loss()
        require(all(math.isfinite(x) for x in losses), f"losses {losses}")
        require(all(n == cfg.num_hidden_layers * steps
                    for n in launches.values()) and not others,
                f"ERNIE B={batch} L={seq}: launches {launches} (want "
                f"{cfg.num_hidden_layers} a step), others {others}")
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
               "launches_per_step": {k: n / steps for k, n in launches.items()}}
        emit(row)
        profile_step(torch, card, step, p50, "train_ernie_profile",
                     train_family, {"batch": batch, "seq": seq})
        legs.append(row)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    # each leg's launches, counted from 0 over its own steps
    return {f"ernie_leg{i}": r["launches"] for i, r in enumerate(legs, 1)}


def ernie_vs_cpu(torch, fa) -> None:
    """Two full-width ERNIE-3.0-base layers in fp32, training mode, on the
    card (the fp32 kernels' SEGS+DROP variants) and on the CPU (their plain
    versions), from one state dict: attention dropout draws the same seeds
    on both (each model's DropoutRNG, seed 5) and B0 gives the same mask;
    hidden dropout is 0 (its masks come from each device's own generator).
    Logits, loss and every gradient must agree."""
    import numpy as np
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForSequenceClassification)
    cfg = ErnieConfig.ernie3_base()
    cfg.num_hidden_layers = 2
    cfg.hidden_dropout_prob = 0.0
    batch, seq = 4, 128
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)))
    labels = torch.as_tensor(rng.integers(0, 2, (batch,)))
    init = None
    runs = {}
    counters = {e: fa.launches_variant[e, "segs_drop"]
                for e in ("fwd_lse", "bwd_dq", "bwd_dkv")}
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
    require(all(n == cfg.num_hidden_layers for n in a["launches"].values())
            and not any(b["launches"].values()),
            f"ERNIE card vs CPU launches: card {a['launches']}, cpu "
            f"{b['launches']}")
    emit({"phase": "ernie_vs_cpu", "layers": 2, "dtype": "float32",
          "batch": batch, "seq": seq, "attention_dropout":
              cfg.attention_probs_dropout_prob,
          "loss_card": a["loss"], "loss_cpu": b["loss"], "loss_rel": loss_rel,
          "logits_max_abs": logit_err, "grad_max_rel": grad_rel,
          "tolerance": {"loss_rel": 1e-4, "logits_abs": 1e-4,
                        "grad_rel": 1e-3},
          "launches_card": a["launches"]})
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from paddle_tpu_torch._native import build as native_build
    from paddle_tpu_torch.ops import flash_attention as fa
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
        f"the bf16 flash kernels do not all run on wgmma and TMA: "
        f"{tc_kernels}")
    require(len(bulk_kernels) == N_PAGED_SPLIT_KERNELS and all(
        k[BULK_COPY_OP] > 0 for k in bulk_kernels.values()),
        f"the paged split kernels do not all copy by {BULK_COPY_OP}: "
        f"{bulk_kernels}")
    all_counters = (fa.launches, pa.launches, fa.launches_lse,
                    fa.launches_bwd_dq, fa.launches_bwd_dkv, q8.launches,
                    *fa.launches_variant.values())

    flash_rows = check_flash(torch, fa)
    paged_rows = check_paged(torch, pa, kvc, planted["paged_attention"])
    for c in all_counters:
        c.reset()
    serve_launches = serve_7b(torch, smi, fa, pa)
    agree_2layer(torch, fa, pa)
    flash_errs, flash_times = check_flash_train(torch, fa,
                                                planted["flash_attention"])
    q8_err, q8_time = check_q8_adam(torch, q8)
    train_launches = train_1p6b(torch, smi, fa, q8, all_counters)
    train_vs_cpu(torch, fa, q8)
    check_flash_segs_dropout(torch, fa, planted["flash_attention:b0"])
    var_times = time_variants(torch, fa, *ERNIE_SHAPE)
    # each path's variant launches, counted from 0 just before its own run
    path_launches = {"unpadded": check_unpadded(torch, fa,
                                                fa.launches_variant)}
    path_launches.update(train_ernie3_base(torch, smi, fa, all_counters))
    ernie_vs_cpu(torch, fa)

    k1 = next(r for r in flash_rows if r["case"] == "causal_1000_ragged")
    k2 = next(r for r in paged_rows if r["case"] == "bf16_h32")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    train_rows = [
        ("flash_fwd_lse", "paddle_tpu_torch/csrc/flash_attention.cu",
         "paddle_tpu/ops/flash_attention.py:163",
         max(flash_errs["out"], flash_errs["lse"]),
         flash_times["flash_fwd_lse"], "B=6 H=20 L=4096 D=128 causal bf16"),
        ("flash_bwd_dq", "paddle_tpu_torch/csrc/flash_attention.cu",
         "paddle_tpu/ops/flash_attention.py:228", flash_errs["dq"],
         flash_times["flash_bwd_dq"], "B=6 H=20 L=4096 D=128 causal bf16"),
        ("flash_bwd_dkv", "paddle_tpu_torch/csrc/flash_attention.cu",
         "paddle_tpu/ops/flash_attention.py:288", flash_errs["dkv"],
         flash_times["flash_bwd_dkv"], "B=6 H=20 L=4096 D=128 causal bf16"),
        ("q8_adam", "paddle_tpu_torch/csrc/q8_adam.cu",
         "paddle_tpu/ops/q8_adam_pallas.py:42", q8_err, q8_time,
         "n=17694720 bf16 base and grad, SR"),
    ]
    emit({"kernels": [
        {"name": "flash_prefill", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:82",
         "launches": serve_launches["flash_prefill"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
         "case": k1["case"], **{k: k1[k] for k in keys}},
        {"name": "paged_decode", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:178",
         "launches": serve_launches["paged_decode"],
         "max_abs_err": max(r["max_abs_err"] for r in paged_rows),
         "case": k2["case"], **{k: k2[k] for k in keys}},
    ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": train_launches[name], "max_abs_err": err,
         "case": case, **{k: t[k] for k in keys}}
        for name, src, rep, err, t, case in train_rows
    ] + [
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
         **{k: var_times[e, v][k] for k in keys}}
        for e in VARIANT_LINES for v in fa.VARIANTS
    ], "card": smi, "seconds": time.monotonic() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
