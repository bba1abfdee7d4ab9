"""Time the bf16 flash kernels of this checkout against another version of
``csrc/flash_attention.cu``, in turns, on one card.

    python3 -m paddle_tpu_torch.tools.ab_flash --other PATH

Builds both sources (one ``nvcc`` each, in parallel) into the git-ignored
build directory and, at the shapes the port's paths give the bf16 kernels
(the training step's ``flash_fwd_lse``, ``flash_bwd_dq`` and
``flash_bwd_dkv`` at B=6 H=20 L=4096 D=128 causal; a serving prefill's
``flash_fwd`` at B=1 H=32 L=1000 D=128 causal), holds each version's
outputs against the plain versions and times the two with CUDA events in
the order other, this, this, other. Prints the card's name and power
limit, one JSON line for the build (what ptxas said about each flash
kernel, registers and spills, of both builds) and one per case: each
version's times, its TFLOP/s and share of the bound, and SDPA's time as a
yardstick (for the backward cases SDPA's whole backward). Both versions
must export the four entry points with the C signatures that
``ops/flash_attention.py`` binds. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

CASES = (  # name, entry point, B, H, L, D, causal
    ("train_fwd_lse", "flash_fwd_lse", 6, 20, 4096, 128, True),
    ("train_bwd_dq", "flash_bwd_dq", 6, 20, 4096, 128, True),
    ("train_bwd_dkv", "flash_bwd_dkv", 6, 20, 4096, 128, True),
    ("prefill_fwd", "flash_fwd", 1, 32, 1000, 128, True),
)
# products of 2 * L^2-pairs * D operations each; bf16 tensors of (B, L, H,
# D) read or written (q, k, v, out / dO, grads) and fp32 (B, H, L) rows
# (lse, delta)
WORK = {"flash_fwd": (2, 4, 0), "flash_fwd_lse": (2, 4, 1),
        "flash_bwd_dq": (3, 5, 2), "flash_bwd_dkv": (4, 6, 2)}


def start_build(nb, src: Path, tag: str):
    """Start ``nvcc`` on ``src``; return a function that waits for it and
    returns the loaded library and the flash kernels' ptxas lines."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out_dir = nb.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{tag}-{digest}.so"
    proc = subprocess.Popen([nb.nvcc(), *nb.NVCC_FLAGS, "-o", str(so),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {src} failed:\n{log}")
        return ctypes.CDLL(str(so)), ptxas_lines(log, ("flash_fwd", "flash_bwd"))
    return wait


def ptxas_lines(log: str, keys) -> list:
    """ptxas's register, spill and warning lines for the entry functions
    whose (mangled) names contain one of ``keys``."""
    keep, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            inside = any(k in ln for k in keys)
        if inside or ("warning" in ln.lower() and any(k in ln for k in keys)):
            keep.append(ln.strip())
    return keep


def chip_smoke_module():
    """``chip_smoke.py`` of this checkout, for its error, timing and bound
    helpers (the bf16 kernels are held and timed here as they are there)."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bind(fa, lib, entry: str):
    fn = getattr(lib, entry)
    fn.argtypes = fa._ARGTYPES_OF[entry]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other flash_attention.cu to time against")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("ab_flash: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch._native import build as nb
    from paddle_tpu_torch.ops import flash_attention as fa
    cs = chip_smoke_module()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    waits = {"this": start_build(nb, nb.CSRC / "flash_attention.cu", "this"),
             "other": start_build(nb, args.other.resolve(), "other")}
    libs, ptxas = {}, {}
    for tag, wait in waits.items():
        libs[tag], ptxas[tag] = wait()
    print(json.dumps({"phase": "ab_build", "other": str(args.other),
                      "ptxas": ptxas}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(7)
    inputs = {}     # (B, H, L, D) -> q, k, v, dO, plain out, lse, grads
    sdpa = {}       # (B, H, L, D, fwd or bwd) -> SDPA ms
    for name, entry, b, h, L, d, causal in CASES:
        key = (b, h, L, d)
        if key not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            q, k, v, do = (torch.randn(b, L, h, d, generator=gen, device="cuda",
                                       dtype=torch.bfloat16) for _ in range(4))
            rout, rlse = fa.flash_attention_lse_reference(q, k, v, causal=causal)
            rgrads = fa.flash_attention_bwd_reference(q, k, v, rout, rlse, do,
                                                      causal=causal)
            torch.cuda.empty_cache()
            inputs[key] = (q, k, v, do, rout, rlse, rgrads)
        q, k, v, do, rout, rlse, rgrads = inputs[key]
        delta = (do.float() * rout.float()).sum(-1).transpose(1, 2).contiguous()
        scale = 1.0 / math.sqrt(d)
        stream = torch.cuda.current_stream().cuda_stream
        tail = (b, L, L, h, h, d, 1, int(causal), scale, stream)
        runs, errs, keep = {}, {}, {}
        for tag, lib in libs.items():
            fn = bind(fa, lib, entry)
            if entry.startswith("flash_fwd"):
                outs = (torch.empty_like(q),
                        torch.empty(b, h, L, dtype=torch.float32, device="cuda"))
                ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        outs[0].data_ptr())
                if entry == "flash_fwd_lse":
                    ptrs += (outs[1].data_ptr(),)
                refs = {"out": (outs[0], rout)}
            else:
                ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                        rlse.data_ptr(), delta.data_ptr())
                outs = ((torch.empty_like(q),) if entry == "flash_bwd_dq"
                        else (torch.empty_like(k), torch.empty_like(v)))
                ptrs += tuple(x.data_ptr() for x in outs)
                refs = ({"dq": (outs[0], rgrads[0])} if entry == "flash_bwd_dq"
                        else {"dk": (outs[0], rgrads[1]),
                              "dv": (outs[1], rgrads[2])})
            keep[tag] = outs    # the launches write into these
            runs[tag] = (lambda fn=fn, a=ptrs + tail, tag=tag:
                         fa._native.check(fn(*a), f"{tag} {entry}"))
            runs[tag]()
            torch.cuda.synchronize()
            errs[tag] = {f"{n}_tile_rel": cs.tile_rel_err(torch, got, ref)
                         for n, (got, ref) in refs.items()}
            if entry == "flash_fwd_lse":
                errs[tag]["lse_max_abs"] = float((outs[1] - rlse).abs().max())
        ms = {"this": [], "other": []}
        for tag in ("other", "this", "this", "other"):
            ms[tag].append(cs.cuda_ms(torch, runs[tag], args.iters))
        direction = "fwd" if entry.startswith("flash_fwd") else "bwd"
        if key + (direction,) not in sdpa:
            qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            if direction == "fwd":
                sdpa[key + (direction,)] = cs.cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qh.detach(), kh.detach(), vh.detach(),
                        is_causal=causal), args.iters)
            else:
                lib_out = F.scaled_dot_product_attention(qh, kh, vh,
                                                         is_causal=causal)
                doh = do.transpose(1, 2).contiguous()
                sdpa[key + (direction,)] = cs.cuda_ms(
                    torch, lambda: torch.autograd.grad(
                        lib_out, (qh, kh, vh), doh, retain_graph=True),
                    args.iters)
                del lib_out, doh
            del qh, kh, vh
        products, n_tensors, n_rows = WORK[entry]
        flops = products * 2.0 * b * h * d * cs.attention_pairs(L, L, causal)
        nbytes = 2.0 * d * b * h * L * n_tensors + 4.0 * b * h * L * n_rows
        bound_ms, bound_by = cs.bound(flops, nbytes, "bfloat16")
        row = {"phase": "ab_flash", "case": name, "entry": entry,
               "B": b, "H": h, "L": L, "D": d, "causal": causal,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "sdpa_ms": sdpa[key + (direction,)],
               "sdpa_note": ("SDPA's forward" if direction == "fwd"
                             else "SDPA's whole backward (dq, dk, dv)"),
               "card": smi}
        for tag in ("this", "other"):
            mean = sum(ms[tag]) / len(ms[tag])
            row[tag] = {"ms": ms[tag], "ms_mean": mean,
                        "tflops": flops / mean / 1e9,
                        "share_of_bound": bound_ms / mean, **errs[tag]}
        print(json.dumps(row), flush=True)
        del runs, keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
