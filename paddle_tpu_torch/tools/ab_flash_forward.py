"""Time the bf16 flash forward of this checkout against another version of
``csrc/flash_attention.cu``, in turns, on one card.

    python3 -m paddle_tpu_torch.tools.ab_flash_forward --other PATH

Builds both sources (one ``nvcc`` each, in parallel) into the git-ignored
build directory and, at the two shapes the port's paths give the bf16
forward (the training step's ``flash_fwd_lse`` at B=6 H=20 L=4096 D=128
causal; a serving prefill's ``flash_fwd`` at B=1 H=32 L=1000 D=128
causal), holds each version's output against the plain version and times
the two with CUDA events in the order other, this, this, other. Prints the
card's name and power limit, one JSON line for the build (what ptxas said
about each forward kernel) and one per shape: each version's times, its
TFLOP/s and share of the bound, and SDPA's time as a yardstick. Both
versions must export ``flash_fwd`` and ``flash_fwd_lse`` with the C
signatures that ``ops/flash_attention.py`` binds. Needs a card and nvcc.
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

SHAPES = (  # name, entry point, B, H, L, D, causal
    ("train_fwd_lse", "flash_fwd_lse", 6, 20, 4096, 128, True),
    ("prefill_fwd", "flash_fwd", 1, 32, 1000, 128, True),
)


def start_build(nb, src: Path, tag: str):
    """Start ``nvcc`` on ``src``; return a function that waits for it and
    returns the loaded library and the forward kernels' ptxas lines."""
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
        return ctypes.CDLL(str(so)), ptxas_lines(log, "flash_fwd")
    return wait


def ptxas_lines(log: str, key: str) -> list:
    """ptxas's register, spill and warning lines for the entry functions
    whose (mangled) names contain ``key``."""
    keep, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            inside = key in ln
        if inside or ("warning" in ln.lower() and key in ln):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other flash_attention.cu to time against")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("ab_flash_forward: no CUDA device", file=sys.stderr)
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
    for name, entry, b, h, L, d, causal in SHAPES:
        q, k, v = (torch.randn(b, L, h, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        rout, rlse = fa.flash_attention_lse_reference(q, k, v, causal=causal)
        scale = 1.0 / math.sqrt(d)
        stream = torch.cuda.current_stream().cuda_stream
        runs, errs = {}, {}
        for tag, lib in libs.items():
            fn = getattr(lib, entry)
            fn.argtypes = fa._ARGTYPES_OF[entry]
            fn.restype = ctypes.c_int
            out = torch.empty_like(q)
            lse = torch.empty(b, h, L, dtype=torch.float32, device="cuda")
            tail = (b, L, L, h, h, d, 1, int(causal), scale, stream)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
            if entry == "flash_fwd_lse":
                ptrs += (lse.data_ptr(),)
            runs[tag] = (lambda fn=fn, a=ptrs + tail, tag=tag:
                         fa._native.check(fn(*a), f"{tag} {entry}"))
            runs[tag]()
            torch.cuda.synchronize()
            errs[tag] = {"tile_rel": cs.tile_rel_err(torch, out, rout)}
            if entry == "flash_fwd_lse":
                errs[tag]["lse_max_abs"] = float((lse - rlse).abs().max())
        del rout, rlse
        ms = {"this": [], "other": []}
        for tag in ("other", "this", "this", "other"):
            ms[tag].append(cs.cuda_ms(torch, runs[tag], args.iters))
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_ms = cs.cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), args.iters)
        flops = 4.0 * b * h * d * cs.attention_pairs(L, L, causal)
        # q, k, v read and out written (bf16), lse written (fp32)
        nbytes = 2.0 * d * b * h * 4 * L + (4.0 * b * h * L
                                            if entry == "flash_fwd_lse" else 0)
        bound_ms, bound_by = cs.bound(flops, nbytes, "bfloat16")
        row = {"phase": "ab_flash_forward", "shape": name, "entry": entry,
               "B": b, "H": h, "L": L, "D": d, "causal": causal,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "sdpa_ms": sdpa_ms, "card": smi}
        for tag in ("this", "other"):
            mean = sum(ms[tag]) / len(ms[tag])
            row[tag] = {"ms": ms[tag], "ms_mean": mean,
                        "tflops": flops / mean / 1e9,
                        "share_of_bound": bound_ms / mean, **errs[tag]}
        print(json.dumps(row), flush=True)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
