"""Before and after the fused small-op kernels, on one card: K1's
forward and backward (with its fold) at the four shapes of its paths
(``chip_smoke.fused_norm_timing``: the card's time by kernel), K2's and
K3's forward and backward at theirs (``chip_smoke.rope_timing``,
``swiglu_timing``: Llama training's O2 q and k and g and u, a Llama-2-7B
decode step and tail prefill; three graph device ms readings a case and
leg in each run), the Llama
training step of ``bench.py`` (eager and profiled, then captured), the
ERNIE-3.0-base fine-tune step captured (both legs, profiled), Llama-2-7B
serving (three runs, profiled) and the FMT stack's serving (three runs,
profiled), for two trees of the repository in one call, each tree in its
own process, in the order other, this, this, other::

    python3 -m paddle_tpu_torch.tools.ab_fused_ops --other DIR [--out FILE]

``DIR`` holds another tree of the repository, e.g. the parent commit
unpacked by ``git archive`` into a git-ignored directory. Every run drives
``chip_smoke.py``'s own phases of this tree (``fused_norm_timing``,
``rope_timing``, ``swiglu_timing``, ``train_1p6b``, ``train_ernie3_base_captured``, ``serve_7b``,
``serve_fmt`` without its parity, prefix leg and prefill graph check) on
the package of the tree it runs, so both trees run the same workloads,
checks and kernel families (``other`` split into the fused kernels'
families and the rest). Each phase's JSON line goes to ``FILE`` (default
``ab_fused_ops.jsonl`` in the working directory) tagged with its run; the
last line printed sums up, for each run, K1's device ms by case and
kernel, K2's and K3's device ms and readings by case and leg, step p50, peak memory, device ms by family and kernels a step,
and the serving tok/s, TTFT and TPOT.
"""

from __future__ import annotations

import gc
import sys
from pathlib import Path

if __package__:
    from . import _ab
else:   # a run's process: this file as a script, beside another package
    import _ab

PHASES = ("fused_norm_timing", "rope_timing", "swiglu_timing",
          "train_llama_1p6b", "train_profile",
          "train_llama_1p6b_captured", "train_ernie3_base_captured",
          "train_ernie_captured_profile", "serve_llama2_7b", "serve_profile",
          "serve_fmt", "serve_fmt_profile")


def _run(tree: Path) -> None:
    """One run, in this process: ``tree``'s package, this tree's phases."""
    torch, cs, card = _ab.load(tree, "ab_fused_ops")
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import multi_tensor_adam as mta
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import q8_adam as q8
    if not (tree / "paddle_tpu_torch" / "ops" / "fused_norm.py").exists():
        cs.fused_counters = dict   # a tree without the fused kernels
    if not (tree / "paddle_tpu_torch" / "ops" / "embedding.py").exists():
        cs.ernie_op_counters = dict   # a tree without K5-K8
    counters = (fa.launches, pa.launches, fa.launches_lse,
                fa.launches_bwd_dq, fa.launches_bwd_dkv, q8.launches,
                mta.launches, *fa.launches_variant.values(),
                *cs.fused_counters().values())
    if cs.fused_counters():
        from paddle_tpu_torch.ops import fused_norm as fn
        gen = torch.Generator(device="cuda").manual_seed(9)
        cs.emit({"phase": "fused_norm_timing", "card": card,
                 **cs.fused_norm_timing(torch, fn, gen)})
        from paddle_tpu_torch.ops import rope as rp
        from paddle_tpu_torch.ops import swiglu as sw
        cs.emit({"phase": "rope_timing", "card": card,
                 **cs.rope_timing(torch, rp, gen)})
        cs.emit({"phase": "swiglu_timing", "card": card,
                 **cs.swiglu_timing(torch, sw, gen)})
    cs.train_1p6b(torch, card, fa, q8, counters)
    cs.train_ernie3_base_captured(torch, card, fa, mta)
    model, init_s = cs.build_7b(torch)
    for c in counters:
        c.reset()
    cs.serve_7b(torch, card, fa, pa, model, init_s)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("fmt_parity", "fmt_prefill_graph_check"):
        setattr(cs, name, lambda *a, **k: None)
    cs.serve_fmt_prefix = lambda *a, **k: {}
    cs.serve_fmt(torch, card, fa, pa)


def _summary(rows: list) -> dict:
    """Per run: K1's device ms by case, leg and kernel; K2's and K3's
    device ms and readings by case and leg; step p50 and peak
    memory of each workload; serving tok/s, TTFT and TPOT of each run;
    device ms by family and kernels of each profiled step."""
    out = {}
    for r in rows:
        s = out.setdefault(r["run"], {})
        ph = r["phase"]
        if ph == "fused_norm_timing":
            s[ph] = {case: {leg: {"device_ms": v[leg]["device_ms"],
                                  "kernels": v[leg]["device_kernels"] and {
                                      k: round(t["ms"], 5) for k, t
                                      in v[leg]["device_kernels"].items()}}
                            for leg in ("fwd", "bwd") if leg in v}
                     for case, v in r.items()
                     if isinstance(v, dict) and "fwd" in v}
        elif ph in ("rope_timing", "swiglu_timing"):
            s[ph] = {case: {leg: v[leg] for leg in ("fwd", "bwd")
                            if leg in v}
                     for case, v in r.items()
                     if isinstance(v, dict) and "fwd" in v}
        elif ph in ("serve_llama2_7b", "serve_fmt"):
            s[ph] = {k: [x[k] for x in r["runs"]] for k in (
                "tokens_per_s", "ttft_median_s", "tpot_median_s",
                "peak_mem_gb")}
        elif ph in ("train_llama_1p6b", "train_llama_1p6b_captured"):
            s[ph] = {"step_p50_s": r["step_p50_s"],
                     "peak_mem_gb": r["peak_mem_gb"]}
        elif ph == "train_ernie3_base_captured":
            s[f"{ph}_leg{r['leg']}"] = {"step_p50_s": r["step_p50_s"],
                                        "peak_mem_gb": r["peak_mem_gb"]}
        elif ph in ("train_profile", "train_ernie_captured_profile",
                    "serve_profile", "serve_fmt_profile"):
            key = ph + "".join(f"_{r[k]}" for k in ("seq", "tier") if k in r)
            s[key] = {"device_ms": r["device_ms"],
                      "device_kernels": r.get("device_kernels"),
                      "families": {f: round(v["device_ms"], 4)
                                   for f, v in r["families"].items()},
                      "calls": {f: v["calls"]
                                for f, v in r["families"].items()}}
    return out



if __name__ == "__main__":
    sys.exit(_ab.main(__file__, __doc__, PHASES, _run, _summary, 1800))
