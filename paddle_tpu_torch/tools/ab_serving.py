"""Before and after the prefill graphs, on one card: Llama-2-7B serving
(three runs of 16 prompts of 128-1000 tokens with every prompt length
warmed, the same traffic profiled, one decode step profiled, then the
traffic once on a fresh engine warmed with the 128-token length only) and
the FMT stack's serving (three runs of 16 x 512 tokens with the length
warmed, a bucket-16 replay, the traffic profiled, then once on a fresh
engine warmed with no length) for two trees of the repository in one
call, each tree in its own process, in the order other, this, this,
other::

    python3 -m paddle_tpu_torch.tools.ab_serving --other DIR [--out FILE]

``DIR`` holds another tree of the repository, e.g. the parent commit
unpacked by ``git archive`` into a git-ignored directory. Every run drives
``chip_smoke.py``'s ``serve_7b`` and ``serve_fmt`` of this tree on the
package of the tree it runs, so both trees run the same traffic, warm-up
and checks (the FMT parity, prefix leg and prefill graph check are left
out). A tree whose engine prefills eagerly has no prefill graphs: its
replays are not required, and it reports none captured. Each phase's JSON
line goes to ``FILE`` (default ``ab_serving.jsonl`` in the working
directory) tagged with its run; the last line printed sums up, for each
run, tok/s, TTFT, TPOT, peak memory, warm-up seconds, the prefill graphs
captured inside the first-use runs and their seconds, and the prefill
span's share of the wall and its device share under the profiler.
"""

from __future__ import annotations

import gc
import sys
from pathlib import Path

if __package__:
    from . import _ab
else:   # a run's process: this file as a script, beside another package
    import _ab

PHASES = ("serve_llama2_7b", "serve_profile", "decode_step_profile",
          "serve_llama2_7b_first_use", "serve_fmt", "serve_fmt_profile",
          "serve_fmt_first_use")
# what an engine without prefill graphs has of them
NO_PREFILL_GRAPHS = {"prefill_replays": {}, "prefill_graphs": 0,
                     "prefill_capture_s": 0.0}


def _run(tree: Path) -> None:
    """One run, in this process: ``tree``'s package, this tree's phases."""
    torch, cs, card = _ab.load(tree, "ab_serving")
    from paddle_tpu_torch._native import build as native_build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import engine as engine_mod
    if not hasattr(engine_mod, "PrefillGraph"):
        cs.PREFILL = "eager"
        cs.require_prefill_replays = lambda *a, **k: None
        stats = engine_mod.Engine.decode_stats
        engine_mod.Engine.decode_stats = \
            lambda self: {**stats(self), **NO_PREFILL_GRAPHS}
    for name in ("fmt_parity", "fmt_prefill_graph_check"):
        setattr(cs, name, lambda *a, **k: None)
    cs.serve_fmt_prefix = lambda *a, **k: {}
    native_build.build()
    model, init_s = cs.build_7b(torch)
    cs.serve_7b(torch, card, fa, pa, model, init_s)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cs.serve_fmt(torch, card, fa, pa)


def _serving(r: dict) -> dict:
    runs = r["runs"]
    return {k: [x[k] for x in runs] for k in (
        "tokens_per_s", "ttft_median_s", "tpot_median_s", "peak_mem_gb",
        "peak_reserved_gb")} | {
        "prefill": r["prefill"], "warmup_s": r["warmup_s"],
        "prefill_graphs": r["prefill_graphs"],
        "prefill_capture_s": r["prefill_capture_s"]}


def _first_use(r: dict) -> dict:
    return {k: r[k] for k in (
        "tokens_per_s", "ttft_median_s", "ttft_max_s", "tpot_median_s",
        "peak_mem_gb", "peak_reserved_gb", "warmup_s", "captured_in_run")}


def _profile(r: dict) -> dict:
    return {"device_busy_share": r["device_busy_share"],
            "device_busy_share_est_unprofiled":
                r["device_busy_share_est_unprofiled"],
            **{name: {k: v[k] for k in (
                "share_of_wall", "device_share_of_span", "host_wall_ms",
                "device_ms_in_span", "calls")}
               for name, v in r["spans"].items()}}


def _summary(rows: list) -> dict:
    """Per run: the serving numbers of each model, its first-use run and
    its profile's spans."""
    out = {}
    for r in rows:
        s = out.setdefault(r["run"], {})
        ph = r["phase"]
        if ph in ("serve_llama2_7b", "serve_fmt"):
            s[ph] = _serving(r)
            if ph == "serve_fmt":
                s[ph]["replay_b16_t560_ms"] = r["replay_b16_t560"]["ms"]
        elif ph.endswith("_first_use"):
            s[ph] = _first_use(r)
        elif ph in ("serve_profile", "serve_fmt_profile"):
            s[ph] = _profile(r)
        elif ph == "decode_step_profile":
            s[ph] = {k: r["graph"][k] for k in (
                "step_ms_cuda_events", "host_launch_calls")}
    return out


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, __doc__, PHASES, _run, _summary, 1200))
