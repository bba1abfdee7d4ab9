"""Before and after the ERNIE small-op kernels (embedding, bias and
activation, dropout, masked softmax), on one card: the ERNIE-3.0-base
fine-tune step captured (legs 1 and 2, each profiled; leg 1 also on its
eager tier) for two trees of the repository in one call, each tree in its
own process, in the order other, this, this, other::

    python3 -m paddle_tpu_torch.tools.ab_ernie_ops --other DIR [--out FILE]

``DIR`` holds another tree of the repository, e.g. the parent commit
unpacked by ``git archive`` into a git-ignored directory. Every run drives
``chip_smoke.py``'s ``train_ernie3_base_captured`` of this tree on the
package of the tree it runs, so both trees run the same workload, checks
and kernel families (``other`` split into the fused kernels' families and
the rest; the launch counts of kernels a tree lacks are not required).
Each phase's JSON line goes to ``FILE`` (default ``ab_ernie_ops.jsonl`` in
the working directory) tagged with its run; the last line printed sums up,
for each run and leg, step p50, peak memory, device ms, kernels a step and
device ms by family.
"""

from __future__ import annotations

import sys
from pathlib import Path

if __package__:
    from . import _ab
else:   # a run's process: this file as a script, beside another package
    import _ab

PHASES = ("train_ernie3_base_captured", "train_ernie_captured_profile",
          "train_ernie3_base_captured_vs_eager")


def _run(tree: Path) -> None:
    """One run, in this process: ``tree``'s package, this tree's phase."""
    torch, cs, card = _ab.load(tree, "ab_ernie_ops")
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import multi_tensor_adam as mta
    if not (tree / "paddle_tpu_torch" / "ops" / "embedding.py").exists():
        cs.ernie_op_counters = dict   # a tree without K5-K8
    cs.train_ernie3_base_captured(torch, card, fa, mta)


def _summary(rows: list) -> dict:
    """Per run and leg: step p50, peak memory, and the profiled step's
    device ms, kernels and device ms by family (captured and, leg 1, the
    eager tier)."""
    out = {}
    for r in rows:
        s = out.setdefault(r["run"], {})
        if r["phase"] == "train_ernie3_base_captured":
            s.setdefault(f"seq{r['seq']}", {}).update(
                step_p50_s=r["step_p50_s"], peak_mem_gb=r["peak_mem_gb"])
        elif r["phase"] == "train_ernie_captured_profile":
            tier = "captured" if r["tier"] == "captured" else "eager"
            s.setdefault(f"seq{r['seq']}", {})[f"profile_{tier}"] = {
                "device_ms": r["device_ms"],
                "device_kernels": r["device_kernels"],
                "host_launch_calls": r["host_launch_calls"],
                "other_ms": r["families"].get("other", {}).get("device_ms"),
                "families": {f: round(v["device_ms"], 4)
                             for f, v in r["families"].items()}}
        elif r["phase"] == "train_ernie3_base_captured_vs_eager":
            s.setdefault(f"seq{r['seq']}", {})["eager_step_p50_s"] = \
                r["step_p50_s"]["eager"]
    return out



if __name__ == "__main__":
    sys.exit(_ab.main(__file__, __doc__, PHASES, _run, _summary, 900))
