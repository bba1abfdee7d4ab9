"""What each captured prefill key holds, on one card: Llama-2-7B (bf16,
random weights from seed 0) behind ``chip_smoke.py``'s serving engine
(max_batch 16, max_len 2048, page 64, its decode buckets captured), then
``--keys`` full-prefill keys of distinct lengths spread over [16, 2000]
captured one after another, each replayed once on the scratch page::

    python3 -m paddle_tpu_torch.tools.prefill_graph_memory [--keys 200]
        [--warm-steps N] [--out FILE]

For every key: the seconds of its warm-up calls and capture, the first
replay's CUDA-event ms, and, before and after, the free device memory
(``cudaMemGetInfo``), the caching allocator's reserved and
allocated bytes and the process's resident host memory. The device bytes
a graph holds outside the allocator (its executable) are the free
memory's drop less the reserved bytes' growth (the first key's include
the pool's primer). Then the least recently used half is dropped, as
``Engine.prefill_graph`` does while memory is short, and what came back
is read; then half as many new keys again are captured with one graph
dropped for each, and what they added is read. ``--warm-steps`` sets the
eager calls before each capture (the engine's ``_WARM_STEPS``). One JSON
line a key goes to ``FILE`` (default ``prefill_graph_memory.jsonl``);
the last line printed sums up.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _memory(torch) -> dict:
    torch.cuda.synchronize()
    return {"device_free": torch.cuda.mem_get_info()[0],
            "reserved": torch.cuda.memory_reserved(),
            "allocated": torch.cuda.memory_allocated(), "rss": _rss()}


def _delta(before: dict, after: dict) -> dict:
    d = {k: after[k] - before[k] for k in before}
    d["device_free"] = -d["device_free"]        # bytes taken
    d["executable"] = d["device_free"] - d["reserved"]
    return d


def _stats(xs) -> dict:
    return {"median": statistics.median(xs), "mean": statistics.fmean(xs),
            "max": max(xs), "sum": sum(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=200)
    ap.add_argument("--warm-steps", type=int, default=None)
    ap.add_argument("--out", type=Path,
                    default=Path("prefill_graph_memory.jsonl"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("prefill_graph_memory: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch._native import build as native_build
    from paddle_tpu_torch.serving import engine as engine_mod
    if args.warm_steps is not None:
        engine_mod._WARM_STEPS = args.warm_steps
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    native_build.build()
    model, _ = cs.build_7b(torch)
    prefill_fn, _ = model.serving_callables(2048)
    eng = cs.engine_7b(model, prefill_fn, "off", [])
    rng = np.random.default_rng(0)
    lens = sorted(set(np.linspace(16, 2000, args.keys).astype(int)))
    rng.shuffle(lens)

    def capture(n: int) -> dict:
        before = _memory(torch)
        g = eng.prefill_graph(0, n)
        g.load(rng.integers(0, model.config.vocab_size, (1, n)),
               np.zeros((eng.kv.pages_for(n),), np.int32))
        replay_ms = cs.cuda_ms(torch, g.replay, 1, warmup=0)
        return {"n": n, "capture_s": g.capture_s, "replay_ms": replay_ms,
                "kernels": sum(g.launches.values()),
                **_delta(before, _memory(torch))}

    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w") as f:
        rows = []
        for n in lens:
            rows.append(capture(int(n)))
            f.write(json.dumps(rows[-1]) + "\n")
    # the engine's own rule made short: the least recently used half goes
    live = len(eng._prefill_graphs)
    oldest = weakref.ref(next(iter(eng._prefill_graphs.values())))
    eng._memory_short = lambda: len(eng._prefill_graphs) > live // 2
    before = _memory(torch)
    eng.prefill_graph(0, 2001)
    evicted = _delta(before, _memory(torch))
    oldest_gone = oldest() is None
    # as many new keys as were dropped, one graph dropped for each
    keep = len(eng._prefill_graphs)
    eng._memory_short = lambda: len(eng._prefill_graphs) >= keep
    before = _memory(torch)
    refill = [capture(int(n) + 3) for n in lens[:live // 2]]
    refilled = _delta(before, _memory(torch))
    del eng._memory_short
    stats = eng.decode_stats()
    later = rows[1:]
    print(json.dumps({"prefill_graph_memory": {
        "card": card, "model": "llama2_7b bf16", "keys": len(rows),
        "warm_steps": engine_mod._WARM_STEPS,
        "first_key": rows[0],
        "per_key_after_first": {k: _stats([r[k] for r in later]) for k in (
            "device_free", "executable", "reserved", "allocated", "rss",
            "capture_s", "kernels")},
        "capture_s_by_len": [[r["n"], r["capture_s"], r["replay_ms"]]
                             for r in sorted(rows, key=lambda r: r["n"])],
        "evictions": stats["prefill_evictions"],
        "live_after": stats["prefill_graphs_live"],
        "evicting_half_then_one_capture": evicted,
        "evicted_graph_collected": oldest_gone,
        "refill": {"keys": len(refill), "added": refilled,
                   "capture_s": _stats([r["capture_s"] for r in refill])},
        "memory_short_now": eng._memory_short()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
