"""K2's and K3's design choices on one card: the shipped kernels of
``csrc/rope.cu`` and ``csrc/swiglu.cu`` against the variants of
``tools/k2_variants.cu`` and ``tools/k3_variants.cu`` and against other
launch plans, at ``chip_smoke.py``'s timed cases (``rope_timed_cases``,
``swiglu_timing``'s)::

    python3 -m paddle_tpu_torch.tools.ab_rope_swiglu_variants [--rounds N] [--out FILE]

The variants: K2 ``any`` (dtype codes read at run time), ``unr2`` (two
heads a lane at a time, four 16-byte loads in flight) and ``bulk`` (a
warp's heads at its position copied into shared memory by
``cp.async.bulk`` on an mbarrier); K3 ``any``, ``div`` (the backward's
``1 / e`` by ``__fdiv_rn`` and bf16 stored an element at a time) and
``k2``, ``k4`` (that many vectors a thread in the shipped kernels). Each
variant's outputs must equal the shipped kernel's bit for bit. Device ms a
call are ``chip_smoke.graph_ms``'s, read after one unkept reading in
rounds of shipped, variant, variant, shipped. Each case's JSON line (to
``FILE``, default ``ab_rope_swiglu_variants.jsonl``) holds every reading;
the last line printed gives, by case, leg and variant, the mean, min and
max, and the shipped kernel's spread (its max less its min).
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

TOOLS = Path(__file__).resolve().parent
VARIANT_SOURCES = {"rope": TOOLS / "k2_variants.cu",
                   "swiglu": TOOLS / "k3_variants.cu"}


def _start(build, kernel: str):
    """``(path, nvcc process or None)`` of a variants library (it includes
    ``csrc/<kernel>.cu``), built with the port's flags."""
    src = VARIANT_SOURCES[kernel]
    digest = hashlib.sha256(src.read_bytes()
                            + (build.CSRC / f"{kernel}.cu").read_bytes()
                            + (build.CSRC / "fused_io.cuh").read_bytes()
                            + " ".join(build.NVCC_FLAGS).encode())
    out = (build.BUILD_DIR / "variants"
           / f"lib{src.stem}-{digest.hexdigest()[:16]}.so")
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    return out, subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(out, proc):
    """``(library, ptxas lines)`` of a started build."""
    log = ""
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{out.name} failed to build:\n{log}")
    return ctypes.CDLL(str(out)), _regs(log)


def _regs(log: str) -> list:
    """ptxas's ``(kernel, registers, spill bytes)`` a kernel, from -v."""
    out, name, spill = [], None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = ln.strip().split(", ")[1]
        elif "registers" in ln and name is not None:
            out.append([name[:90], ln.split("Used ")[1].split(" ")[0],
                        spill])
    return out


def _typed(fn, argtypes):
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _stats(xs: list) -> dict:
    return {"mean": statistics.fmean(xs), "min": min(xs), "max": max(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path,
                    default=Path("ab_rope_swiglu_variants.jsonl"))
    args = ap.parse_args()
    torch, cs, card = _ab.load(_ab.ROOT, "ab_rope_swiglu_variants")
    from paddle_tpu_torch._native import build
    from paddle_tpu_torch.ops import rope as rp
    from paddle_tpu_torch.ops import swiglu as sw
    started = {k: _start(build, k) for k in VARIANT_SOURCES}
    build.build(["rope", "swiglu"])
    (k2, k2_regs), (k3, k3_regs) = (_finish(*started[k])
                                    for k in ("rope", "swiglu"))
    print(json.dumps({"ptxas": {
        "rope": _regs(build.build_logs.get("rope", "")), "k2_variants":
        k2_regs, "swiglu": _regs(build.build_logs.get("swiglu", "")),
        "k3_variants": k3_regs}}), flush=True)
    rope_fns = {v: {"rope": _typed(getattr(k2, f"k2_{v}"), rp._ARGTYPES)}
                for v in ("any", "unr2", "bulk")}
    shipped = sw._kernels()
    sw_fns = {v: {"swiglu_fwd": _typed(getattr(k3, f"k3_fwd_{v}"),
                                       sw._ARGTYPES_FWD),
                  "swiglu_bwd": _typed(getattr(k3, f"k3_bwd_{v}"),
                                       sw._ARGTYPES_BWD)}
              for v in ("any", "k2", "k4")}
    sw_fns["div"] = {"swiglu_fwd": shipped["swiglu_fwd"],
                     "swiglu_bwd": _typed(k3.k3_bwd_div, sw._ARGTYPES_BWD)}
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16

    def timed(f):
        f()
        return cs.graph_ms(torch, f, cs.graph_calls(cs.cuda_ms(torch, f, 5)))

    cases = []   # (kernel, case, leg, run(variant or None), variants)
    for name, shapes, off, pdt, dt, tdt, bwd in cs.rope_timed_cases(torch):
        ang = torch.rand((4096, 64), generator=gen, device="cuda") * 6.3
        cos, sin = ang.cos(), ang.sin()
        xs = [torch.randn(s, generator=gen, device="cuda").to(bf)
              for s in shapes]
        b, n = shapes[0][:2]
        pos = None if pdt is None else torch.randint(
            0, 4096, (b, n), generator=gen, device="cuda", dtype=pdt)
        kw = dict(offset=off, positions=pos, neox=True, dtype=dt,
                  table_dtype=tdt)
        out_dt = dt or bf
        gs = [torch.randn(s, generator=gen, device="cuda").to(out_dt)
              for s in shapes]

        def run(v=None, back=False, xs=xs, gs=gs, kw=kw, out_dt=out_dt,
                cos=cos, sin=sin):
            src = gs if back else xs
            return rp._launch(src, cos, sin, backward=back,
                              out_dtypes=[bf if back else out_dt] * len(src),
                              fns=None if v is None else rope_fns[v],
                              **dict(kw, dtype=out_dt if back
                                     else kw["dtype"]))
        legs = [("fwd", run)] + ([("bwd", lambda v=None, run=run: run(
            v, back=True))] if bwd else [])
        for leg, r in legs:
            cases.append(("rope", name, leg, r, ("any", "unr2", "bulk")))
    for name, rows, d, bwd in (("llama", 24576, 6912, True),
                               ("serve", 16, 11008, False)):
        g, u, dy = (torch.randn((rows, d), generator=gen, device="cuda")
                    .to(bf) for _ in range(3))

        def fwd(v=None, g=g, u=u):
            return (sw._launch_fwd(g, u, False,
                                   fns=None if v is None else sw_fns[v]),)

        def back(v=None, g=g, u=u, dy=dy):
            return sw._launch_bwd(g, u, dy, False,
                                  fns=None if v is None else sw_fns[v])
        cases.append(("swiglu", name, "fwd", fwd, ("any", "k2", "k4")))
        if bwd:
            cases.append(("swiglu", name, "bwd", back,
                          ("any", "div", "k2", "k4")))

    summary = {}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for kernel, name, leg, run, variants in cases:
        row = {"phase": "k2k3_variants", "card": card, "kernel": kernel,
               "case": name, "leg": leg}
        ref = run()
        for v in variants:
            out = run(v)
            if not all(torch.equal(p, q) for p, q in zip(ref, out)):
                raise SystemExit(f"{kernel} {name} {leg} {v}: outputs differ "
                                 f"from the shipped kernel's")
            readings = {"shipped": [], v: []}
            timed(run)   # the card's clocks up
            for _ in range(args.rounds):
                for which in ("shipped", v, v, "shipped"):
                    readings[which].append(timed(
                        lambda: run(None if which == "shipped" else which)))
            row[v] = readings
            s = {k: _stats(r) for k, r in readings.items()}
            s["shipped_spread"] = s["shipped"]["max"] - s["shipped"]["min"]
            s["change"] = s[v]["mean"] / s["shipped"]["mean"] - 1
            summary.setdefault(f"{kernel}:{name}:{leg}", {})[v] = s
        with args.out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))
    print(json.dumps({"ab_rope_swiglu_variants": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
