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
  fp32 model on the card and on the CPU side by side.

The line before the last lists each kernel with its launches on its path's
run, error, times and bound; the last line is ``{"ok": true, "device":
{...}}``. Any failed check raises and the script exits non-zero; without a
card it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
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
# A copy of csrc/flash_attention.cu with one fault planted in each bf16
# kernel: the forward's consumers skip the K/V tile at Lk/2 and dq's skip
# the K tile at Lk/2 (their scores are masked), dk/dv's skip the Q tile at
# Lq/2. flash_train_check requires that REL_TOL rejects all three at
# L=4096.
PLANTED_FAULTS = (
    ("  if (n0 + FW_BN > min(Lk, wg_end)) {\n",
     "  if (n0 == (Lk / 2) / FW_BN * FW_BN) {\n"
     "#pragma unroll\n"
     "    for (int i = 0; i < FW_BN / 2; ++i) s[i] = -INFINITY;\n"
     "  }\n"),
    ("  if (n0 + BW_BN > min(Lk, wg_end)) {\n",
     "  if (n0 == (Lk / 2) / BW_BN * BW_BN) {\n"
     "#pragma unroll\n"
     "    for (int i = 0; i < BW_BN / 2; ++i) s[i] = -INFINITY;\n"
     "  }\n"),
    ("      if (causal && q0 + BW_BN - 1 + shift < kw) {\n",
     "      if (q0 == (Lq / 2) / BW_BN * BW_BN) {\n"
     "        mbar_arrive(bar_empty(s));\n"
     "        continue;\n"
     "      }\n"))


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
        out = fa.flash_attention(q, k, v, causal=causal)
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
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal), 10)
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

def check_paged(torch, pa, kvc):
    import numpy as np
    import torch.nn.functional as TF
    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, ps, s, layers, d, layer = 16, 64, 32, 2, 128, 1
    t_host = np.array([0, 1, 63, 64, 65, 127, 300, 500, 700, 1000, 1023,
                       1024, 1234, 1500, 2000, 2047], np.int32)
    p = b * s + 1
    tables_host = np.zeros((b, s), np.int32)
    perm = rng.permutation(np.arange(1, p))
    for i, tv in enumerate(t_host):
        n = tv // ps + 1                          # pages up to position t
        tables_host[i, :n] = perm[i * s:i * s + n]
    tables = torch.as_tensor(tables_host, device="cuda")
    t = torch.as_tensor(t_host, device="cuda")
    rows = []
    bf, f32 = torch.bfloat16, torch.float32
    # the fp32 leg is the engine's default (compute_dtype float32, native
    # pool), which the engine_vs_generate phase runs
    for name, h, hkv, leg, qdt in (("bf16_h32", 32, 32, "bf16", bf),
                                   ("int8_h32", 32, 32, "int8", bf),
                                   ("bf16_gqa_h32_kv8", 32, 8, "bf16", bf),
                                   ("f32_h32", 32, 32, "f32", f32)):
        poolf = torch.randn(p, layers, 2, hkv, ps, d, generator=gen,
                            device="cuda")
        if leg == "int8":
            pool, scales = kvc.quantize_pages(poolf)
        elif leg == "bf16":
            pool, scales = poolf.to(torch.bfloat16), None
        else:
            pool, scales = poolf.clone(), None
        del poolf
        q = torch.randn(b, h, d, generator=gen, device="cuda", dtype=qdt)
        kn = torch.randn(b, hkv, d, generator=gen, device="cuda", dtype=qdt)
        vn = torch.randn(b, hkv, d, generator=gen, device="cuda", dtype=qdt)
        args = (q, kn, vn, pool, scales, tables, t, layer)
        out = pa.paged_attention(*args, page_size=ps)
        ref = pa.paged_attention_dense(*args, page_size=ps)
        torch.cuda.synchronize()
        err = check_close(torch, out, ref, "paged", f"paged {name}")["max_abs"]
        t0_err = (out[0].float() - vn[0].float().repeat_interleave(
            h // hkv, dim=0)).abs().max().item()
        require(t0_err == 0.0, f"paged {name}: t=0 row is not v_new "
                               f"({t0_err})")
        # library yardstick: SDPA over the gathered dense K/V (gather and
        # current-token insert done before timing), span mask pos <= t
        m = s * ps
        idx = tables.long() * layers + layer
        taken = pool.reshape(p * layers, 2, hkv, ps, d)[idx].to(qdt)
        if scales is not None:
            sc = scales.reshape(p * layers, 2, hkv)[idx]
            taken = (taken.float() * sc[..., None, None]).to(qdt)
        kd = taken[:, :, 0].permute(0, 2, 1, 3, 4).reshape(b, hkv, m, d)
        vd = taken[:, :, 1].permute(0, 2, 1, 3, 4).reshape(b, hkv, m, d)
        kd = kd.clone()
        vd = vd.clone()
        ar = torch.arange(b, device="cuda")
        kd[ar, :, t.long()] = kn
        vd[ar, :, t.long()] = vn
        if hkv != h:
            kd = kd.repeat_interleave(h // hkv, dim=1)
            vd = vd.repeat_interleave(h // hkv, dim=1)
        span = (torch.arange(m, device="cuda")[None, :]
                <= t.long()[:, None])[:, None, None, :]
        qd = q[:, :, None, :]
        lib = lambda: TF.scaled_dot_product_attention(  # noqa: E731
            qd, kd, vd, attn_mask=span)
        ms = cuda_ms(torch, lambda: pa.paged_attention(*args, page_size=ps), 20)
        plain_ms = cuda_ms(torch, lambda: pa.paged_attention_dense(
            *args, page_size=ps), 3, warmup=1)
        library_ms = cuda_ms(torch, lib, 20)
        live = int(t_host.sum())
        item = pool.element_size()
        npages = int(sum(-(-int(tv) // ps) for tv in t_host))
        qitem = q.element_size()
        nbytes = (2.0 * live * hkv * d * item                 # live K/V
                  + qitem * (2 * b * h * d + 2 * b * hkv * d)  # q, out, k/v_new
                  + 4.0 * (b * s + b)                          # tables, t
                  + (8.0 * npages * hkv if scales is not None else 0.0))
        flops = 4.0 * h * d * float((t_host + 1).sum())
        bms, by = bound(flops, nbytes, dtype_name(qdt))
        row = dict(case=name, dtype=dtype_name(qdt), max_abs_err=err,
                   ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=by,
                   gbytes_per_s=nbytes / ms / 1e6)
        emit({"phase": "paged_check", **row})
        rows.append(row)
        del pool, scales, taken, kd, vd
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
N_WGMMA_KERNELS = 8     # forward <D, LSE>, dq <D>, dk/dv <D>; D in 64, 128


def wgmma_kernels(native_build) -> dict:
    """Each bf16 flash kernel of the built library (forward, dq, dk/dv): the
    ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in its SASS
    (``cuobjdump -sass``), and its registers and spills as ptxas reported
    them when this run built it."""
    bindir = Path(native_build.nvcc()).parent
    sass = subprocess.run(
        [str(bindir / "cuobjdump"), "-sass",
         str(native_build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    kernels, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1) if WGMMA_KERNEL.search(m.group(1)) else None
            if fn:
                kernels[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn:
            for op in ("HGMMA", "UTMALDG"):
                kernels[fn][op] += op in ln
    fn = None
    for ln in native_build.build_logs.get("flash_attention", "").splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1) if m.group(1) in kernels else None
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                    r"spill loads", ln)):
            kernels[fn].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            kernels[fn]["registers"] = int(m[1])
    # e.g. flash_fwd_wgmma_kernel<D, LSE>, read from the mangled name's
    # template arguments (ILi<D>ELb<LSE>E)
    named = {}
    for fn, v in kernels.items():
        m = WGMMA_KERNEL.search(fn)
        named["%s<%s>" % (m[1], ", ".join(re.findall(r"L[ib](\d+)E", m[2])))] = v
    return named


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: the causal rule's count
    where causal (bottom-right aligned), lq * lk where not."""
    if not causal:
        return lq * lk
    shift = lk - lq
    return sum(min(lk, max(0, i + shift + 1)) for i in range(lq))


def build_planted(native_build):
    """Start ``nvcc`` on a copy of ``csrc/flash_attention.cu`` with
    PLANTED_FAULTS applied, into the git-ignored build directory; return a
    function that waits for it and loads the library."""
    src = (native_build.CSRC / "flash_attention.cu").read_text()
    for anchor, fault in PLANTED_FAULTS:
        require(src.count(anchor) == 1, f"planted fault: anchor {anchor!r} "
                                        f"not found once")
        src = src.replace(anchor, fault + anchor)
    out_dir = native_build.BUILD_DIR / "planted"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "flash_attention.cu", out_dir / "libflash_attention.so"
    cu.write_text(src)
    proc = subprocess.Popen([native_build.nvcc(), *native_build.NVCC_FLAGS,
                             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def load():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"planted build failed:\n{log}")
        return ctypes.CDLL(str(so))
    return load


def bwd_launches(torch, fa, lib, q, k, v, out, lse, do):
    """The two launches of ``flash_attention_bwd`` (bf16, causal) from the
    library ``lib``, as closures over fresh dq, dk, dv: for timing the
    kernels alone and for running the planted library."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = tuple(torch.empty_like(x) for x in (q, k, v))
    dims = (b, lq, lk, h, hkv, d, 1, 1, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    fns = []
    for name, argtypes, outs in (("flash_bwd_dq", fa._ARGTYPES_BWD_DQ, grads[:1]),
                                 ("flash_bwd_dkv", fa._ARGTYPES_BWD_DKV, grads[1:])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        args = (*ptrs, *(x.data_ptr() for x in outs), *dims)
        fns.append(lambda fn=fn, args=args, name=name:
                   fa._native.check(fn(*args), name))
    return grads, fns[0], fns[1]


def fwd_lse_launch(torch, fa, lib, q, k, v):
    """``flash_fwd_lse`` (bf16, causal) of the library ``lib`` as a closure
    over fresh out and lse."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device="cuda")
    fn = lib.flash_fwd_lse
    fn.argtypes, fn.restype = fa._ARGTYPES_LSE, ctypes.c_int
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, lq, lk, h, hkv, d, 1, 1, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)
    return out, lse, lambda: fa._native.check(fn(*args), "flash_fwd_lse")


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
    """One more training step under ``torch.profiler``: device time and
    launches per kernel family and the busy share."""
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
        f = fams.setdefault(train_family(e.key), {"device_ms": 0.0, "calls": 0})
        f["device_ms"] += device_us(e) / 1e3
        f["calls"] += e.count
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    emit({"phase": "train_profile", "card": card, "wall_s": wall,
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
        planted_lib = load_planted()
    tc_kernels = wgmma_kernels(native_build)
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "sources": native_build.sources(),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in native_build.build_logs.items()},
          "wgmma_kernels": tc_kernels,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": smi})
    require(len(tc_kernels) == N_WGMMA_KERNELS and all(
        k["HGMMA"] > 0 and k["UTMALDG"] > 0 for k in tc_kernels.values()),
        f"the bf16 flash kernels do not all run on wgmma and TMA: "
        f"{tc_kernels}")
    all_counters = (fa.launches, pa.launches, fa.launches_lse,
                    fa.launches_bwd_dq, fa.launches_bwd_dkv, q8.launches)

    flash_rows = check_flash(torch, fa)
    paged_rows = check_paged(torch, pa, kvc)
    for c in all_counters:
        c.reset()
    serve_launches = serve_7b(torch, smi, fa, pa)
    agree_2layer(torch, fa, pa)
    flash_errs, flash_times = check_flash_train(torch, fa, planted_lib)
    q8_err, q8_time = check_q8_adam(torch, q8)
    train_launches = train_1p6b(torch, smi, fa, q8, all_counters)
    train_vs_cpu(torch, fa, q8)

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
    ], "card": smi, "seconds": time.monotonic() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
