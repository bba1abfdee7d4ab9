"""K8's and K6's launch-plan choices on one card: the shipped plans of
``ops/softmax_mask.py::launch_plan`` and ``ops/bias_act.py::launch_plan``
against the other plans the built kernels take, at ``chip_smoke.py``'s
timed cases (``softmax_mask_timing``'s, ``bias_act_timed_cases``)::

    python3 -m paddle_tpu_torch.tools.ab_bias_act_softmax_mask_variants [--rounds N] [--out FILE]

The variants: K8 ``rpw1``, ``rpw2`` (rows a warp, in place of 4),
``rows`` (a warp's rows consecutive, each reading its own mask row, in
place of one (b, q) over four heads), ``t256`` (CTAs of 256 threads);
K6 ``rt1``, ``rt2``, ``rt4``, ``rt8``, ``rt16`` (rows a warp: its run of
rows, four in flight), ``ty4`` (CTAs of four warps), ``direct`` (the
activation computed, not looked up in its table) and ``ctasN`` (a
lookup launch's CTAs an SM). Each variant's outputs must
equal the shipped plan's bit for bit, but K6's bias gradient, whose
partials follow the CTAs' runs of rows (within ``FUSED_TOL`` ``sum`` of
the shipped plan's). Device ms a call are ``chip_smoke.graph_ms``'s, read
after one unkept reading in rounds of shipped, variant, variant, shipped.
Each case's JSON line (to ``FILE``, default
``ab_bias_act_softmax_mask_variants.jsonl``) holds every reading; the last
line printed gives, by case, leg and variant, the mean, min and max, and
the shipped plan's spread (its max less its min).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

if __package__:
    from . import _ab
else:
    import _ab


def _stats(xs: list) -> dict:
    return {"mean": statistics.fmean(xs), "min": min(xs), "max": max(xs)}


def _k8_cases(torch, cs, sm, gen):
    """(case, leg, run(plan or None), {variant: plan}, exact outputs)."""
    bf = torch.bfloat16
    out = []
    for name, shape, mshape in (("ernie", (32, 12, 128, 128),
                                 (32, 1, 128, 128)),
                                ("upper_triangle", (8, 12, 128, 128), None)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(bf)
        dy = torch.randn(shape, generator=gen, device="cuda").to(bf)
        mask = None if mshape is None else torch.randn(
            mshape, generator=gen, device="cuda").to(bf)
        causal = mask is None
        rows, heads, lk = x.numel() // shape[-1], shape[1], shape[-1]
        y = sm._launch_fwd(x, mask, causal)

        def fwd(plan=None, x=x, mask=mask, causal=causal):
            return (sm._launch_fwd(x, mask, causal, plan=plan),)

        def bwd(plan=None, y=y, dy=dy):
            return (sm._launch_bwd(y, dy, plan=plan),)
        lp = sm.launch_plan
        shared = not causal
        fv = {"rpw1": lp(rows, lk, heads, shared_mask=shared, rpw=1),
              "rpw2": lp(rows, lk, heads, shared_mask=shared, rpw=2),
              "t256": lp(rows, lk, heads, shared_mask=shared, threads=256)}
        if shared:
            fv["rows"] = lp(rows, lk, heads, shared_mask=True,
                            head_major=False)
        out.append(("softmax_mask", name, "fwd", fwd,
                    {k: {"plan": v} for k, v in fv.items()}))
        if not causal:
            out.append(("softmax_mask", name, "bwd", bwd, {
                k: {"plan": v} for k, v in (
                    ("rpw1", lp(rows, lk, backward=True, rpw=1)),
                    ("rpw2", lp(rows, lk, backward=True, rpw=2)),
                    ("t256", lp(rows, lk, backward=True, threads=256)))}))
    return out


def _k6_cases(torch, cs, ba, gen):
    out = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, rows, n, dt, brows, period, act, bwd in \
            cs.bias_act_timed_cases(torch):
        if name in ("ernie_fp32", "fmt_decode"):
            continue
        y = torch.randn((rows, n), generator=gen, device="cuda").to(dt)
        b = (torch.randn((brows, 1, n) if period else (n,), generator=gen,
                         device="cuda") * 0.5).to(dt)
        dy = torch.randn((rows, n), generator=gen, device="cuda").to(dt)
        spec = ba.ActSpec(act, dt, dt)

        def fwd(y=y, b=b, spec=spec, period=period, **kw):
            return (ba._launch_fwd(y, b, spec, period, **kw),)

        def back(y=y, b=b, dy=dy, spec=spec, period=period, **kw):
            return ba._launch_bwd(y, b, dy, spec, period, **kw)

        def plans(backward):
            lp = ba.launch_plan
            kw = dict(period=period, backward=backward,
                      table=ba._table_ok(y, b, spec))
            shipped = lp(rows, n, 8, sms, **kw)
            vs = {f"rt{r}": lp(rows, n, 8, sms, rt=r, **kw)
                  for r in (1, 2, 4, 8, 16)}
            vs["ty4"] = lp(rows, n, 8, sms, ty=4, **kw)
            if shipped.table:
                vs["direct"] = lp(rows, n, 8, sms, **dict(kw, table=False))
                vs.update({f"ctas{c}": lp(rows, n, 8, sms, ctas=c, **kw)
                           for c in (1, 2, 4)})
            return {k: {"plan": v} for k, v in vs.items() if v != shipped}
        out.append(("bias_act", name, "fwd", fwd, plans(False)))
        if bwd:
            out.append(("bias_act", name, "bwd", back, plans(True)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path,
                    default=Path("ab_bias_act_softmax_mask_variants.jsonl"))
    args = ap.parse_args()
    torch, cs, card = _ab.load(_ab.ROOT, "ab_bias_act_softmax_mask_variants")
    from paddle_tpu_torch._native import build
    from paddle_tpu_torch.ops import bias_act as ba
    from paddle_tpu_torch.ops import softmax_mask as sm
    build.build(["bias_act", "softmax_mask"])
    print(json.dumps({"card": card, "ptxas": {
        k: [ln.strip() for ln in build.build_logs.get(k, "").splitlines()
            if "registers" in ln or "spill" in ln]
        for k in ("bias_act", "softmax_mask")}}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(19)

    def timed(f):
        f()
        return cs.graph_ms(torch, f, cs.graph_calls(cs.cuda_ms(torch, f, 5)))

    summary = {}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for kernel, name, leg, run, variants in (
            _k8_cases(torch, cs, sm, gen)
            + _k6_cases(torch, cs, ba, gen)):
        row = {"phase": "k6k8_variants", "card": card, "kernel": kernel,
               "case": name, "leg": leg}
        ref = run()
        for v, kw in variants.items():
            got = run(**kw)
            for i, (p, q) in enumerate(zip(ref, got)):
                same = torch.equal(p, q) if (kernel, leg, i) != (
                    "bias_act", "bwd", 1) else \
                    cs.fused_close(torch, q, p, "sum")[0]
                if not same:
                    raise SystemExit(f"{kernel} {name} {leg} {v}: output "
                                     f"{i} differs from the shipped plan's")
            readings = {"shipped": [], v: []}
            timed(run)   # the card's clocks up
            for _ in range(args.rounds):
                for which in ("shipped", v, v, "shipped"):
                    readings[which].append(timed(
                        lambda: run() if which == "shipped" else run(**kw)))
            row[v] = {"plan": kw["plan"]._asdict() if "plan" in kw
                      else None, "readings": readings}
            s = {k: _stats(r) for k, r in readings.items()}
            s["shipped_spread"] = s["shipped"]["max"] - s["shipped"]["min"]
            s["change"] = s[v]["mean"] / s["shipped"]["mean"] - 1
            summary.setdefault(f"{kernel}:{name}:{leg}", {})[v] = s
        with args.out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))
    print(json.dumps({"ab_bias_act_softmax_mask_variants": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
