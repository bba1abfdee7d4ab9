"""K5's backward against variants of its source on one card: this tree's
``csrc/embedding.cu`` held by ``chip_smoke.check_embedding`` (every case
bit-equal to the plain version, the planted copy rejected, three launches
equal, ``embedding_timing``'s graph device ms and split by kernel), then
each variant, a copy of the source with text patches built beside it::

    python3 -m paddle_tpu_torch.tools.ab_embedding_variants [--variants a,b] [--rounds N] [--sort-probes] [--out FILE]

The variants: ``ring8`` / ``ring24`` (dy rows a window thread has in
flight, in place of 16), ``window32`` (sorted positions a window, in
place of 16), ``tile1024`` (sorted positions a sort CTA takes, in place
of 512), ``rows8`` / ``rows32`` (a zero-row CTA's rows), ``windows_only``
and ``zeros_only`` (the table kernel's zero rows or its windows left out:
a measure of the other, their outputs not held). Every
other variant's gradient must equal the plain version's bit for bit at
``chip_smoke.embedding_cases``. Device ms a call are
``chip_smoke.graph_ms``'s over the backward's wrapper at
``chip_smoke.EMBEDDING_TIMED``, in rounds of shipped, variant, variant,
shipped. ``--sort-probes`` also times ``torch.sort`` (int64 and int32,
stable and not) at 4096 and 24576 keys and ``torch.zeros`` at ERNIE's and
Llama's tables. Each JSON line goes to ``FILE`` (default
``ab_embedding_variants.jsonl``); the last line printed gives, by case and
variant, the mean, min and max and the shipped source's spread.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

if __package__:
    from . import _ab
else:
    import _ab

_WINDOW_SHARED = ("  __shared__ int s_tok[WINDOW + CHUNK], "
                  "s_end[WINDOW + CHUNK];\n")
# (name, [(anchor, replacement)], outputs held bit-equal)
VARIANTS = (
    ("ring8", [("constexpr int RING = 16;", "constexpr int RING = 8;")],
     True),
    ("ring24", [("constexpr int RING = 16;", "constexpr int RING = 24;")],
     True),
    ("window32", [("constexpr int WINDOW = 16;",
                   "constexpr int WINDOW = 32;")], True),
    ("tile1024", [("constexpr int ITEMS = 4;", "constexpr int ITEMS = 8;")],
     True),
    ("rows8", [("constexpr int ROWS_PER_CTA = 16;",
                "constexpr int ROWS_PER_CTA = 8;")], True),
    ("rows32", [("constexpr int ROWS_PER_CTA = 16;",
                 "constexpr int ROWS_PER_CTA = 32;")], True),
    ("windows_only", [("  __shared__ int s_rp[ROWS_PER_CTA + 1];\n",
                       "  if (a.rows > 0) return;\n"
                       "  __shared__ int s_rp[ROWS_PER_CTA + 1];\n")],
     False),
    ("zeros_only", [(_WINDOW_SHARED, "  if (a.n > 0) return;\n"
                     + _WINDOW_SHARED)], False),
)


def _stats(xs: list) -> dict:
    return {"mean": statistics.fmean(xs), "min": min(xs), "max": max(xs)}


def build_variants(build, names) -> dict:
    """Each named variant's library: the source patched, one ``nvcc`` each,
    all started together; returns ``{name: (CDLL, exact, ptxas lines)}``."""
    src = (build.CSRC / "embedding.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches, exact in VARIANTS:
        if name not in names:
            continue
        text = src
        for anchor, new in patches:
            if text.count(anchor) != 1:
                raise SystemExit(f"variant {name}: anchor {anchor!r} not "
                                 f"found once")
            text = text.replace(anchor, new)
        cu, so = out_dir / f"embedding_{name}.cu", \
            out_dir / f"libembedding_{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            so, exact)
    libs = {}
    for name, (proc, so, exact) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        libs[name] = (ctypes.CDLL(str(so)), exact,
                      [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln])
    return libs


def sort_probes(torch, cs) -> dict:
    out = {}
    for n in (4096, 24576):
        g = torch.Generator(device="cuda").manual_seed(n)
        i64 = torch.randint(0, 32000, (n,), generator=g, device="cuda")
        i32 = i64.int()
        for label, fn in (
                ("i64_stable", lambda: torch.sort(i64, stable=True)),
                ("i32_stable", lambda: torch.sort(i32, stable=True)),
                ("i64", lambda: torch.sort(i64)),
                ("i32", lambda: torch.sort(i32))):
            fn()
            out[f"sort_{label}_{n}"] = cs.device_ms(torch, fn)
    for rows, d in ((40000, 768), (32000, 2560)):
        def zeros(rows=rows, d=d):
            return torch.zeros(rows, d, dtype=torch.bfloat16, device="cuda")
        zeros()
        out[f"zeros_{rows}x{d}_bf16"] = cs.device_ms(torch, zeros)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(v[0] for v in VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sort-probes", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=Path("ab_embedding_variants.jsonl"))
    args = ap.parse_args()
    torch, cs, card = _ab.load(_ab.ROOT, "ab_embedding_variants")
    from paddle_tpu_torch._native import build
    from paddle_tpu_torch.ops import embedding as em
    names = [v for v in args.variants.split(",") if v]
    cs.PLANTED_FAULTS = tuple(f for f in cs.PLANTED_FAULTS
                              if f[0] == "embedding")
    load_planted = cs.build_planted(build)
    build.build(["embedding"])
    planted = load_planted()
    libs = build_variants(build, names)
    args.out.parent.mkdir(parents=True, exist_ok=True)

    def emit(row):
        with args.out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    emit({"card": card, "ptxas": [
        ln.strip() for ln in build.build_logs.get("embedding", "")
        .splitlines() if "registers" in ln or "spill" in ln],
        "variants_ptxas": {k: v[2] for k, v in libs.items()}})
    check = cs.check_embedding(torch, em, planted["embedding"],
                               torch.Generator(device="cuda").manual_seed(10))
    emit({"phase": "check_embedding", "card": card, **check})
    if args.sort_probes:
        emit({"phase": "sort_probes", "card": card,
              **sort_probes(torch, cs)})
    gen = torch.Generator(device="cuda").manual_seed(19)
    cases = cs.embedding_cases(torch, gen)
    fns = {k: em.bind(lib) for k, (lib, _, _) in libs.items()}
    for name, ids, rows, d, dt, pad in cases:
        dy = torch.randn((*ids.shape, d), generator=gen, device="cuda").to(dt)
        ref = em.embedding_bwd_reference(ids, dy, rows, pad, dt)
        for v, (_, exact, _) in libs.items():
            got = em._launch_bwd(ids, dy, rows, pad, dt, fns=fns[v])
            if exact and not torch.equal(got, ref):
                raise SystemExit(f"variant {v} at {name}: the gradient is "
                                 f"not bit-equal to the plain version")

    def timed(f):
        f()
        return cs.graph_ms(torch, f, cs.graph_calls(cs.cuda_ms(torch, f, 5)))
    summary = {}
    for name, ids, rows, d, dt, pad in cases:
        if name not in cs.EMBEDDING_TIMED:
            continue
        dy = torch.randn((*ids.shape, d), generator=gen, device="cuda").to(dt)

        def run(f=None, ids=ids, dy=dy, rows=rows, pad=pad, dt=dt):
            return em._launch_bwd(ids, dy, rows, pad, dt, fns=f)
        row = {"phase": "embedding_variants", "card": card, "case": name}
        timed(run)   # the card's clocks up
        for v in libs:
            readings = {"shipped": [], v: []}
            for _ in range(args.rounds):
                for which in ("shipped", v, v, "shipped"):
                    f = None if which == "shipped" else fns[v]
                    readings[which].append(timed(lambda: run(f)))
            row[v] = readings
            s = {k: _stats(r) for k, r in readings.items()}
            s["shipped_spread"] = s["shipped"]["max"] - s["shipped"]["min"]
            s["change"] = s[v]["mean"] / s["shipped"]["mean"] - 1
            summary.setdefault(name, {})[v] = s
        emit(row)
    print(json.dumps({"card": card}))
    print(json.dumps({"ab_embedding_variants": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
