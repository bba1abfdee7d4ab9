#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``. It builds every kernel in ``paddle_tpu_torch/csrc`` from source,
holds each against its plain PyTorch version at the shapes the serving
path gives it, serves Llama-2-7B at full width (random bf16 weights from a
seed, 32 layers) through the port's continuous-batching engine, serves the
same traffic once more under ``torch.profiler`` to show where the device
time goes, checks that engine and ``generate`` agree token for token on a
2-layer full-width fp32 model, and prints one JSON line per phase. The line before the last
lists each kernel with its launches on the serving run, error, times and
bound; the last line is ``{"ok": true, "device": {...}}``. Any failed
check raises and the script exits non-zero; without a card it exits 2 and
prints no result.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain, elementwise |out - ref| <= atol + rtol * |ref|, keyed by
# (kernel, output dtype). bf16 outputs are one rounding (half an ulp,
# <= 2^-9 relative) from the fp32 plain version. The flash kernel also
# rounds its probabilities to bf16 for the P.V product on tensor cores
# (max-abs 0.0156 seen at L=2048); the paged kernel does its products in
# fp32 (max-abs 0.00098 seen), so its limit is 2x the output rounding and
# tight enough to catch one skipped 64-position page. fp32 outputs differ
# only by summation order.
TOL = {("flash", "bfloat16"): (2e-2, 1e-2),
       ("paged", "bfloat16"): (2e-3, 4e-3),
       ("flash", "float32"): (1e-4, 1e-4),
       ("paged", "float32"): (1e-4, 1e-4)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def check_close(torch, out, ref, kernel: str, what: str) -> float:
    """Require out within TOL of ref; return the max-abs."""
    atol, rtol = TOL[kernel, dtype_name(out.dtype)]
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    ok = bool(torch.isfinite(out.float()).all()) and bool(
        (diff <= atol + rtol * ref.float().abs()).all())
    require(ok, f"{what}: max-abs {err} beyond {atol} + {rtol} * |ref|")
    return err


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
    cases = [  # name, B, H, Hkv, Lq, Lk, causal, dtype
        ("causal_512", 1, 32, 32, 512, 512, True, bf),
        ("causal_2048", 1, 32, 32, 2048, 2048, True, bf),
        ("causal_1000_ragged", 1, 32, 32, 1000, 1000, True, bf),
        ("gqa_causal_1024_h32_kv8", 1, 32, 8, 1024, 1024, True, bf),
        ("causal_lq256_lk1024", 1, 32, 32, 256, 1024, True, bf),
        ("full_512", 1, 32, 32, 512, 512, False, bf),
        # the fp32 CUDA-core kernel, at the engine_vs_generate phase's
        # prefill lengths and its generate step (one query over the cache)
        ("f32_causal_37", 1, 32, 32, 37, 37, True, f32),
        ("f32_causal_513", 1, 32, 32, 513, 513, True, f32),
        ("f32_lq1_lk528", 1, 32, 32, 1, 528, True, f32),
    ]
    d = 128
    rows = []
    for name, b, h, hkv, lq, lk, causal, dt in cases:
        q = torch.randn(b, lq, h, d, generator=gen, device="cuda", dtype=dt)
        k = torch.randn(b, lk, hkv, d, generator=gen, device="cuda", dtype=dt)
        v = torch.randn(b, lk, hkv, d, generator=gen, device="cuda", dtype=dt)
        out = fa.flash_attention(q, k, v, causal=causal)
        ref = fa.flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = check_close(torch, out, ref, "flash", f"flash {name}")
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
        lib_err = (lib().transpose(1, 2).float() - ref.float()).abs().max().item()
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
        err = check_close(torch, out, ref, "paged", f"paged {name}")
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from paddle_tpu_torch._native import build as native_build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
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
    native_build.build()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "sources": native_build.sources(),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in native_build.build_logs.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": smi})

    flash_rows = check_flash(torch, fa)
    paged_rows = check_paged(torch, pa, kvc)
    launches = serve_7b(torch, smi, fa, pa)
    agree_2layer(torch, fa, pa)

    k1 = next(r for r in flash_rows if r["case"] == "causal_1000_ragged")
    k2 = next(r for r in paged_rows if r["case"] == "bf16_h32")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "flash_prefill", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:82",
         "launches": launches["flash_prefill"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
         "case": k1["case"], **{k: k1[k] for k in keys}},
        {"name": "paged_decode", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:178",
         "launches": launches["paged_decode"],
         "max_abs_err": max(r["max_abs_err"] for r in paged_rows),
         "case": k2["case"], **{k: k2[k] for k in keys}},
    ], "card": smi, "seconds": time.monotonic() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
