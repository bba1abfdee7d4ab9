"""What the before-and-after tools share (``ab_fused_ops``, ``ab_ernie_ops``,
``ab_serving``): each tree of the repository in its own process, in the
order other, this, this, other, every run driving this tree's
``chip_smoke.py`` phases on the package of the tree it runs. Each phase's
JSON line goes to the output file tagged with its run; the last line
printed sums the runs up."""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Iterable

ROOT = Path(__file__).resolve().parents[2]


def load(tree: Path, tool: str):
    """In a run's process: ``tree``'s package first on the path, and this
    tree's ``chip_smoke`` module; returns ``(torch, chip_smoke, card)``,
    ``card`` the card's name and power limit."""
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import paddle_tpu_torch
    if Path(paddle_tpu_torch.__file__).resolve().parents[1] != tree.resolve():
        raise SystemExit(f"{tool}: imported {paddle_tpu_torch.__file__}, "
                         f"not {tree}'s package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    return torch, cs, card


def main(tool_file: str, doc: str, phases: Iterable[str],
         run: Callable[[Path], None], summary: Callable[[list], dict],
         timeout: int) -> int:
    """The tool's command line: ``--other DIR [--out FILE]`` drives the four
    runs (each a process calling ``run(tree)`` through the hidden
    ``--run TREE``), keeps the rows of ``phases`` and prints
    ``{tool: summary(rows)}`` last."""
    tool = Path(tool_file).stem
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="another tree of the repository")
    ap.add_argument("--out", type=Path, default=Path(f"{tool}.jsonl"))
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run is not None:
        run(args.run)
        return 0
    if args.other is None:
        ap.error("--other DIR is required")
    phases = set(phases)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    order = [("other", args.other), ("this", ROOT), ("this", ROOT),
             ("other", args.other)]
    for i, (label, tree) in enumerate(order):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, str(Path(tool_file).resolve()), "--run",
             str(tree.resolve())], cwd=tree, capture_output=True, text=True,
            timeout=timeout)
        run_name = f"{i + 1}:{label}"
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                row = json.loads(ln)
                if row.get("phase") in phases:
                    rows.append({"run": run_name, **row})
        with args.out.open("a") as f:
            for r in rows:
                if r["run"] == run_name:
                    f.write(json.dumps(r) + "\n")
        print(json.dumps({"run": run_name, "rc": proc.returncode,
                          "seconds": time.monotonic() - t0}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    print(json.dumps({tool: summary(rows)}), flush=True)
    return 0
