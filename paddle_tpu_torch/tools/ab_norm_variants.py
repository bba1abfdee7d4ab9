"""K1's design choices on one card: the shipped kernels of
``csrc/fused_norm.cu`` against the variants of ``tools/k1_variants.cu``,
at ``chip_smoke.py``'s K1 timed cases (``norm_timed_cases``)::

    python3 -m paddle_tpu_torch.tools.ab_norm_variants [--rounds N] [--out FILE]

The variants: ``any``, the row-group and block-per-row kernels with every
dtype code read at run time, in place of the instantiation with the
case's dtypes fixed (forward and backward; a case the shipped kernel
already runs with run-time codes has no ``any`` leg); ``cp_async``, the
row-group forward with each thread copying its own chunks of the rows
ahead by ``cp.async`` in place of one ``cp.async.bulk`` copy a row on an
mbarrier (cases on the row-group kernel with a ring deeper than one
row). Each variant's outputs must equal the shipped kernel's bit for bit.
Device ms a call are ``chip_smoke.graph_ms``'s (CUDA events over a
captured graph of calls), read after one unkept reading in rounds of
shipped, variant, variant, shipped. Each case's JSON line
(to ``FILE``, default ``ab_norm_variants.jsonl``) holds every reading; the
last line printed gives, by case, leg and variant, the mean, min and max,
and the shipped kernel's spread (its max less its min).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

if __package__:
    from . import _ab
else:
    import _ab

VARIANTS = Path(__file__).resolve().with_name("k1_variants.cu")
# the instantiation each timed case takes in the shipped kernel, forward and
# backward (None: run-time codes already, so no ``any`` leg)
FIXED = {"llama_o2_residual": ("FwdO2 ring", "BwdO2 ring"),
         "ernie_o2_residual": ("FwdO2F32Res ring", "BwdO2 ring"),
         "fmt_prefill_ln": ("FwdBf16 ring", None),
         "fmt_decode_ln": ("FwdBf16 row", None),
         "serve_decode_bf16_residual": ("FwdBf16 row", None)}


def _build_variants(build) -> ctypes.CDLL:
    """``k1_variants.cu`` built with the port's flags (it includes
    ``csrc/fused_norm.cu``), while the shipped library builds beside it."""
    digest = hashlib.sha256(VARIANTS.read_bytes()
                            + (build.CSRC / "fused_norm.cu").read_bytes()
                            + " ".join(build.NVCC_FLAGS).encode())
    out = (build.BUILD_DIR / "variants"
           / f"libk1_variants-{digest.hexdigest()[:16]}.so")
    proc = None
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o",
                                 str(out), str(VARIANTS)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    build.build(["fused_norm"])
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k1_variants.cu failed to build:\n{log}")
    return ctypes.CDLL(str(out))


def _typed(fn, argtypes):
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _stats(xs: list) -> dict:
    return {"mean": statistics.fmean(xs), "min": min(xs), "max": max(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=Path("ab_norm_variants.jsonl"))
    args = ap.parse_args()
    torch, cs, card = _ab.load(_ab.ROOT, "ab_norm_variants")
    from paddle_tpu_torch._native import build
    from paddle_tpu_torch.ops import fused_norm as fn
    lib = _build_variants(build)
    shipped = fn._kernels()
    fwd_t, bwd_t = fn._ARGTYPES_FWD, fn._ARGTYPES_BWD
    fns = {"any": {"fused_norm_fwd": _typed(lib.k1_fwd_any, fwd_t),
                   "fused_norm_bwd": _typed(lib.k1_bwd_any, bwd_t)},
           "cp_async": {"fused_norm_fwd": _typed(lib.k1_fwd_cp_async, fwd_t),
                        "fused_norm_bwd": shipped["fused_norm_bwd"]}}
    gen = torch.Generator(device="cuda").manual_seed(9)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rn(shape, dt, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dt)

    def timed(f):
        f()
        return cs.graph_ms(torch, f, cs.graph_calls(cs.cuda_ms(torch, f, 5)))

    summary = {}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for name, rows, cols, xd, rd, wd, bd, spec, bwd in cs.norm_timed_cases(
            torch, fn):
        x = rn((rows, cols), xd)
        res = None if rd is None else rn((rows, cols), rd)
        w = rn((cols,), wd, 0.1, 1.0)
        b = None if bd is None else rn((cols,), bd, 0.1)
        plan = fn.launch_plan(rows, cols, 8, sms,
                              row_bytes=x.element_size()
                              + (0 if res is None else res.element_size()),
                              cta_vecs=3)
        fixed_fwd, fixed_bwd = FIXED[name]
        legs = {"fwd": {}}
        legs["fwd"]["any"] = fixed_fwd is not None
        legs["fwd"]["cp_async"] = plan.ring and plan.stages > 1

        def fwd(v=None):
            return fn._launch_fwd(x, w, b, res, None, spec,
                                  fns=None if v is None else fns[v])
        got = fwd()
        h = x if got[1] is None else got[1]
        dy = rn((rows, cols), spec.out)
        dres = None if spec.add is None else rn((rows, cols), spec.add)
        dx_dtype = xd if spec.add is None else spec.add

        def bwd_run(v=None):
            return fn._launch_bwd(dy, dres, h, got[2], got[3], w, spec,
                                  dx_dtype=dx_dtype, want_w=True,
                                  bias_dtype=bd, pre_bias_dtype=None,
                                  fns=None if v is None else fns[v])
        runs = {"fwd": fwd}
        if bwd:
            legs["bwd"] = {"any": fixed_bwd is not None}
            runs["bwd"] = bwd_run
        row = {"phase": "k1_variants", "card": card, "case": name,
               "rows": rows, "cols": cols, "fixed": FIXED[name],
               "plan": {k: getattr(plan, k) for k in (
                   "ring", "grid", "threads", "group_warps", "groups", "nc",
                   "stages")}}
        for leg, variants in legs.items():
            run = runs[leg]
            ref = run()
            for v, on in variants.items():
                if not on:
                    continue
                out = run(v)
                equal = all(torch.equal(p, q) for p, q in zip(ref, out)
                            if p is not None)
                if not equal:
                    raise SystemExit(f"{name} {leg} {v}: outputs differ "
                                     f"from the shipped kernel's")
                readings = {"shipped": [], v: []}
                timed(run)   # the card's clocks up
                for _ in range(args.rounds):
                    for which in ("shipped", v, v, "shipped"):
                        readings[which].append(timed(
                            lambda: run(None if which == "shipped" else
                                        which)))
                row[f"{leg}_{v}"] = readings
                s = {k: _stats(r) for k, r in readings.items()}
                s["shipped_spread"] = s["shipped"]["max"] - s["shipped"]["min"]
                s["change"] = s[v]["mean"] / s["shipped"]["mean"] - 1
                summary.setdefault(name, {})[f"{leg}_{v}"] = s
        with args.out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))
    print(json.dumps({"ab_norm_variants": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
