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

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PHASES = ("train_ernie3_base_captured", "train_ernie_captured_profile",
          "train_ernie3_base_captured_vs_eager")


def _run(tree: Path) -> None:
    """One run, in this process: ``tree``'s package, this tree's phase."""
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_ernie_ops: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import paddle_tpu_torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import multi_tensor_adam as mta
    if Path(paddle_tpu_torch.__file__).resolve().parents[1] != tree.resolve():
        raise SystemExit(f"ab_ernie_ops: imported {paddle_tpu_torch.__file__}"
                         f", not {tree}'s package")
    if not (tree / "paddle_tpu_torch" / "ops" / "embedding.py").exists():
        cs.ernie_op_counters = dict   # a tree without K5-K8
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    cs.train_ernie3_base_captured(torch, smi, fa, mta)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="another tree of the repository")
    ap.add_argument("--out", type=Path, default=Path("ab_ernie_ops.jsonl"))
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run is not None:
        _run(args.run)
        return 0
    if args.other is None:
        ap.error("--other DIR is required")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    order = [("other", args.other), ("this", ROOT), ("this", ROOT),
             ("other", args.other)]
    for i, (label, tree) in enumerate(order):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--run",
             str(tree.resolve())], cwd=tree, capture_output=True, text=True,
            timeout=900)
        run = f"{i + 1}:{label}"
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                row = json.loads(ln)
                if row.get("phase") in PHASES:
                    rows.append({"run": run, **row})
        with args.out.open("a") as f:
            for r in rows:
                if r["run"] == run:
                    f.write(json.dumps(r) + "\n")
        print(json.dumps({"run": run, "rc": proc.returncode,
                          "seconds": time.monotonic() - t0}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    print(json.dumps({"ab_ernie_ops": _summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
