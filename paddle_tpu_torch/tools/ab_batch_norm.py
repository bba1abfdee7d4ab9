"""Before and after K10 (the batch-norm kernel), on one card: its forms held
and timed (``chip_smoke.batch_norm_check``: every case against the plain
version, each form's forward and backward device ms beside its byte
bound, ``F.batch_norm`` and the wrapper's host us), the ResNet-50 training
step (``train_resnet50``: eager and captured p50, one eager step by kernel
family), PP-YOLOE-l serving and training (``serve_ppyoloe``,
``train_ppyoloe``: p50, one call and one step by family), for two trees of
the repository in one call, each tree in its own process, in the order
other, this, this, other::

    python3 -m paddle_tpu_torch.tools.ab_batch_norm --other DIR [--out FILE]

``DIR`` holds another tree of the repository, e.g. the parent commit
unpacked by ``git archive`` into a git-ignored directory. Every run drives
this tree's ``chip_smoke.py`` phases on the package of the tree it runs
(the planted faults are left out: they patch this tree's source), so both
trees run the same workloads and checks. Each phase's JSON line goes to
``FILE`` (default ``ab_batch_norm.jsonl`` in the working directory) tagged
with its run; the last line printed sums up, for each run, K10's device ms
by form and shape, the wrapper's host us, the three phases' p50s and
their K10 family's device ms and launches from the profile phases.
"""

from __future__ import annotations

import sys
from pathlib import Path

if __package__:
    from . import _ab
else:   # a run's process: this file as a script, beside another package
    import _ab

PHASES = ("batch_norm_check", "train_resnet50", "train_resnet50_profile",
          "serve_ppyoloe", "serve_ppyoloe_profile", "train_ppyoloe",
          "train_ppyoloe_profile")
# a K10 timing row's numbers kept in the summary
K10_KEYS = ("device_ms", "bwd_device_ms", "bound_ms", "bwd_bound_ms",
            "bound_share", "bwd_bound_share", "library_device_ms",
            "bwd_library_device_ms", "host_us", "bwd_host_us")


def _run(tree: Path) -> None:
    """One run, in this process: ``tree``'s package, this tree's phases."""
    torch, cs, card = _ab.load(tree, "ab_batch_norm")
    cs.emit({"phase": "ab_batch_norm_card", "card": card})
    cs.batch_norm_check(torch, None)
    cs.train_resnet50(torch, card)
    cs.serve_ppyoloe(torch, card)
    cs.train_ppyoloe(torch, card)


def _family(row: dict) -> dict:
    fam = row.get("families", {}).get("batch_norm", {})
    return {"device_ms": row.get("device_ms"),
            "k10_device_ms": fam.get("device_ms"),
            "k10_calls": fam.get("calls"),
            "busy_share": row.get("device_busy_share")}


def _summary(rows: list) -> dict:
    """Per run: K10's rows by form (and the NHWC extras), the phases' p50s,
    and each profiled step's K10 device ms and launches."""
    out = {}
    for r in rows:
        s = out.setdefault(r["run"], {})
        ph = r["phase"]
        if ph == "batch_norm_check":
            s["k10"] = {name: {k: t.get(k) for k in K10_KEYS}
                        for name, t in {**r["timing"],
                                        **r["nhwc_timing"]}.items()}
            s["k10_max_abs_err"] = max(c["max_abs_err"] for c in r["cases"])
            s["batch_norm_check_s"] = r["seconds"]
        elif ph == "train_resnet50":
            s[ph] = {t: v.get("step_p50_s") for t, v in r["runs"].items()}
            s[ph]["card"] = r["card"]
        elif ph == "serve_ppyoloe":
            s[ph] = {"p50_s": r["latency_p50_s"], "card": r["card"]}
        elif ph == "train_ppyoloe":
            s[ph] = {"p50_s": r["step_p50_s"], "card": r["card"]}
        elif ph.endswith("_profile"):
            s[ph] = _family(r)
    return out


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, __doc__, PHASES, _run, _summary, 3000))
