"""Before and after the ERNIE small-op kernels (embedding, bias and
activation, dropout, masked softmax), on one card: K8's and K6's forward
and backward at their paths' shapes (``chip_smoke.softmax_mask_timing``,
``bias_act_timing``: ERNIE's scores and the upper triangle; ERNIE's O2
and fp32 linear1 epilogues, FMT serving's prefill and decode epilogues and
the expert-choice MoE's bias period; three graph device ms readings a case
and leg in each run, beside the library call's), K5's backward
(``embedding_timing``: ERNIE's four tables, its word table in fp32 and
Llama's table, with the split by kernel), the ERNIE-3.0-base
fine-tune step captured (legs 1 and 2, each profiled; leg 1 also on its
eager tier) and the FMT stack's serving (three runs, profiled; without its
parity, prefix leg and prefill graph check), for two trees of the
repository in one call, each tree in its own process, in the order other,
this, this, other::

    python3 -m paddle_tpu_torch.tools.ab_ernie_ops --other DIR [--out FILE]

``DIR`` holds another tree of the repository, e.g. the parent commit
unpacked by ``git archive`` into a git-ignored directory. Every run drives
``chip_smoke.py``'s phases of this tree on the package of the tree it
runs, so both trees run the same workloads, checks and kernel families
(``other`` split into the fused kernels' families and the rest; the launch
counts of kernels a tree lacks are not required). Each phase's JSON line
goes to ``FILE`` (default ``ab_ernie_ops.jsonl`` in the working
directory) tagged with its run; the last line printed sums up, for each
run, K8's, K6's and K5's device ms and readings by case and leg, and for
each leg step p50, peak memory, device ms, kernels a step and device ms
by family, and FMT serving's tok/s, TTFT and TPOT.
"""

from __future__ import annotations

import sys
from pathlib import Path

if __package__:
    from . import _ab
else:   # a run's process: this file as a script, beside another package
    import _ab

PHASES = ("softmax_mask_timing", "bias_act_timing", "embedding_timing",
          "train_ernie3_base_captured", "train_ernie_captured_profile",
          "train_ernie3_base_captured_vs_eager", "serve_fmt",
          "serve_fmt_profile")


def _run(tree: Path) -> None:
    """One run, in this process: ``tree``'s package, this tree's phases."""
    torch, cs, card = _ab.load(tree, "ab_ernie_ops")
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import multi_tensor_adam as mta
    from paddle_tpu_torch.ops import paged_attention as pa
    if not (tree / "paddle_tpu_torch" / "ops" / "embedding.py").exists():
        cs.ernie_op_counters = dict   # a tree without K5-K8
    else:
        from paddle_tpu_torch.ops import bias_act as ba
        from paddle_tpu_torch.ops import embedding as em
        from paddle_tpu_torch.ops import softmax_mask as sm
        cs.emit({"phase": "softmax_mask_timing", "card": card,
                 **cs.softmax_mask_timing(torch, sm, torch.Generator(
                     device="cuda").manual_seed(18))})
        cs.emit({"phase": "bias_act_timing", "card": card,
                 **cs.bias_act_timing(torch, ba, torch.Generator(
                     device="cuda").manual_seed(17))})
        cs.emit({"phase": "embedding_timing", "card": card,
                 **cs.embedding_timing(torch, em, torch.Generator(
                     device="cuda").manual_seed(19))})
    cs.train_ernie3_base_captured(torch, card, fa, mta)
    for name in ("fmt_parity", "fmt_prefill_graph_check"):
        setattr(cs, name, lambda *a, **k: None)
    cs.serve_fmt_prefix = lambda *a, **k: {}
    cs.serve_fmt(torch, card, fa, pa)


def _summary(rows: list) -> dict:
    """Per run: K8's, K6's and K5's device ms and readings by case and leg
    (K5's backward also by kernel); per
    leg step p50, peak memory, and the profiled step's device ms, kernels
    and device ms by family (captured and, leg 1, the eager tier); FMT
    serving's tok/s, TTFT, TPOT and peak memory by run, and its profile's
    device ms by family."""
    out = {}
    for r in rows:
        s = out.setdefault(r["run"], {})
        ph = r["phase"]
        if ph in ("softmax_mask_timing", "bias_act_timing",
                  "embedding_timing"):
            s[ph] = {case: {k: v[k] for k in (
                "fwd", "bwd", "bound_ms", "bwd_bound_ms",
                "library_device_ms", "bwd_library_device_ms",
                "bwd_kernels") if k in v}
                for case, v in r.items()
                if isinstance(v, dict) and "fwd" in v}
        elif ph == "train_ernie3_base_captured":
            s.setdefault(f"seq{r['seq']}", {}).update(
                step_p50_s=r["step_p50_s"], peak_mem_gb=r["peak_mem_gb"])
        elif ph == "train_ernie_captured_profile":
            tier = "captured" if r["tier"] == "captured" else "eager"
            s.setdefault(f"seq{r['seq']}", {})[f"profile_{tier}"] = {
                "device_ms": r["device_ms"],
                "device_kernels": r["device_kernels"],
                "host_launch_calls": r["host_launch_calls"],
                "other_ms": r["families"].get("other", {}).get("device_ms"),
                "families": {f: round(v["device_ms"], 4)
                             for f, v in r["families"].items()}}
        elif ph == "train_ernie3_base_captured_vs_eager":
            s.setdefault(f"seq{r['seq']}", {})["eager_step_p50_s"] = \
                r["step_p50_s"]["eager"]
        elif ph == "serve_fmt":
            s[ph] = {k: [x[k] for x in r["runs"]] for k in (
                "tokens_per_s", "ttft_median_s", "tpot_median_s",
                "peak_mem_gb")}
        elif ph == "serve_fmt_profile":
            s[ph] = {"device_ms": r["device_ms"],
                     "families": {f: round(v["device_ms"], 4)
                                  for f, v in r["families"].items()}}
    return out


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, __doc__, PHASES, _run, _summary, 1200))
