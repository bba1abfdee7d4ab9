"""Time the paged decode kernel of this checkout against another version of
``csrc/paged_attention.cu``, in turns, on one card.

    python3 -m paddle_tpu_torch.tools.ab_paged --other PATH

Builds both sources (one ``nvcc`` each, in parallel) into the git-ignored
build directory and, for each case below, holds each version's output
against the plain version (``TOL`` of ``chip_smoke.py``) and times the two
with CUDA events in the order other, this, this, other, beside SDPA over
the gathered dense K/V as a yardstick. Prints the card's name and power
limit, one JSON line for the build (what ptxas said about each paged
kernel, registers and spills, of both builds) and one per case: each
version's times, its rate and share of the byte bound.

Both versions export ``paged_decode``; each is called with the arguments
its own C signature names (an older source takes no split scratch), read
from the source text. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from .ab_flash import chip_smoke_module, start_build

_SERVE_T = tuple(int(x) + 32 for x in
                 (128, 186, 244, 302, 360, 418, 476, 534, 593, 651, 709, 767,
                  825, 883, 941, 1000))    # linspace(128, 1000, 16) + 32
CASES = (  # name, q heads, kv heads, pool, contexts (None: chip_smoke's)
    ("bf16_h32", 32, 32, "bf16", None),
    # the serving run's decode steps: 16 prompts of 128-1000 tokens, 32
    # tokens into their 64 new ones; and its batch of four
    ("serve_b16", 32, 32, "bf16", _SERVE_T),
    ("serve_b4", 32, 32, "bf16", _SERVE_T[:4]),
    ("gqa_kv8", 32, 8, "bf16", None),
    ("int8_h32", 32, 32, "int8", None),
)
_CTYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}


def c_params(src: str, fn: str) -> list:
    """``[(ctype, name), ...]`` of ``extern "C" int fn(...)`` in ``src``."""
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)", src, re.S)
    if m is None:
        raise ValueError(f"{fn} not found")
    params = []
    for p in m.group(1).split(","):
        typ, name = p.replace("const ", "").split()
        typ += "*" * name.count("*")
        params.append((_CTYPES[typ], name.strip("*")))
    return params


def bind(lib, params):
    """``paged_decode`` of ``lib`` as a function of its arguments by name."""
    fn = lib.paged_decode
    fn.argtypes = [ty for ty, _ in params]
    fn.restype = ctypes.c_int
    names = [n for _, n in params]
    return lambda **kw: fn(*(kw[n] for n in names))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other paged_attention.cu to time against")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import math
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ab_paged: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch._native import build as nb
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import kv_cache as kvc
    cs = chip_smoke_module()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    srcs = {"this": (nb.CSRC / "paged_attention.cu").resolve(),
            "other": args.other.resolve()}
    waits = {tag: start_build(nb, src, tag, keys=("paged_decode",))
             for tag, src in srcs.items()}
    fns, ptxas = {}, {}
    for tag, wait in waits.items():
        lib, ptxas[tag] = wait()
        fns[tag] = bind(lib, c_params(srcs[tag].read_text(), "paged_decode"))
    print(json.dumps({"phase": "ab_build", "other": str(args.other),
                      "ptxas": ptxas}), flush=True)

    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, h, hkv, leg, t_host in CASES:
        case = cs.paged_case(torch, kvc, gen, rng, t_host or cs.PAGED_T, h,
                             hkv, leg, torch.bfloat16)
        q, kn, vn, pool, scales, tables, t, layer = case["args"]
        b, _, d = q.shape
        ps, s = case["ps"], tables.shape[1]
        ref = pa.paged_attention_dense(*case["args"], page_size=ps)
        pps, nsplit = pa.split_plan(s, b * hkv)
        out = torch.empty_like(q)
        part = torch.empty(b, h, nsplit, d + 2, dtype=torch.float32,
                           device="cuda")
        named = dict(
            q=q.data_ptr(), k_new=kn.data_ptr(), v_new=vn.data_ptr(),
            pool=pool.data_ptr(),
            scales=None if scales is None else scales.data_ptr(),
            tables=tables.data_ptr(), t=t.data_ptr(), part=part.data_ptr(),
            out=out.data_ptr(), B=b, H=h, Hkv=hkv, D=d, L=pool.shape[1],
            ps=ps, S=s, layer=layer, pps=pps, nsplit=nsplit,
            q_dtype=pa._Q_CODES[q.dtype], pool_dtype=pa._POOL_CODES[pool.dtype],
            sm_scale=1.0 / math.sqrt(d),
            stream=torch.cuda.current_stream().cuda_stream)
        runs, errs = {}, {}
        for tag, fn in fns.items():
            runs[tag] = (lambda fn=fn, tag=tag:
                         pa._native.check(fn(**named), f"{tag} paged_decode"))
            runs[tag]()
            torch.cuda.synchronize()
            errs[tag] = {"max_abs_err": (out.float() - ref.float()).abs().max().item(),
                         "within_tol": cs.within_tol(out, ref, "paged")}
        ms = {"this": [], "other": []}
        for tag in ("other", "this", "this", "other"):
            ms[tag].append(cs.cuda_ms(torch, runs[tag], args.iters))
        sdpa_ms = cs.cuda_ms(torch, cs.paged_sdpa(torch, case), args.iters)
        bound_ms, bound_by = cs.bound(case["flops"], case["nbytes"], "bfloat16")
        row = {"phase": "ab_paged", "case": name, "B": b, "H": h, "Hkv": hkv,
               "D": d, "ps": ps, "S": s, "pool": leg,
               "contexts": [int(x) for x in case["t_host"]],
               "split_plan": [pps, nsplit], "live_kv_mb": 2.0 * int(
                   case["t_host"].sum()) * hkv * d * pool.element_size() / 1e6,
               "bound_ms": bound_ms, "bound_by": bound_by, "sdpa_ms": sdpa_ms,
               "card": smi}
        for tag in ("this", "other"):
            mean = sum(ms[tag]) / len(ms[tag])
            row[tag] = {"ms": ms[tag], "ms_mean": mean,
                        "gbytes_per_s": case["nbytes"] / mean / 1e6,
                        "share_of_bound": bound_ms / mean, **errs[tag]}
        print(json.dumps(row), flush=True)
        del case, q, kn, vn, pool, scales, ref, out, part
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
