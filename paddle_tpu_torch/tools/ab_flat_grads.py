"""Time the captured ERNIE-3.0-base fine-tune step under two layouts of
the multi-tensor AdamW's gradients, in turns, on one card.

    python3 -m paddle_tpu_torch.tools.ab_flat_grads

* ``copy``: ``clear_grad`` sets every gradient to None, so backward
  hands each parameter a fresh gradient (autograd keeps the tensor it
  computed, no copy), and the step gathers them into the flat gradient
  with one ``torch._foreach_copy_``;
* ``views``: every gradient is its view of the flat gradient, so backward
  accumulates into it in place (one add per parameter), and
  ``clear_grad`` zeroes the flat gradient with one memset.

Both run the recipe of ``chip_smoke.py``'s ``train_ernie3_base_captured``
(AMP O2 bf16 with fp32 masters, dropout 0.1, ``AdamW(use_multi_tensor=
True, weight_decay=0.01)``, ``LinearWarmup`` over ``PolynomialDecay``,
``ClipGradByGlobalNorm(1.0)``, ``jit.capture_step(nan_gate=True)``) at
B=32, L=128 from the same random weights (seed 0), in the order views,
copy, copy, views. Each turn prints: the replay's time (CUDA events around
each of 10 calls after 2 warm-up calls, the first of which captures),
the wall time a step, the peak memory allocated over those 12 calls, the
kernels of one profiled call and their device time, the losses (the
layouts' must agree to 1e-3 relative; the largest difference is printed)
and, for ``copy``, the gather's own time
(CUDA events around 20 ``_foreach_copy_`` calls of the step's gradients).
Prints the card's name and power limit first. Needs a card.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

ORDER = ("views", "copy", "copy", "views")
BATCH, SEQ, WARMUP, TIMED = 32, 128, 2, 10


def _layout(torch, opt, kind: str) -> None:
    """Give ``opt`` (a multi-tensor AdamW) the gradient layout ``kind``,
    whatever its own ``clear_grad`` and ``gather_grads`` do."""
    fs = opt._flat
    params, views = fs.params, fs.views(fs.grad)
    every = tuple(True for _ in params)   # the step reaches every parameter
    if kind == "views":
        for p, v in zip(params, views):
            p.grad = v

        def clear(set_to_zero=False):
            fs.grad.zero_()

        def gather():
            if not all(p.grad is v for p, v in zip(params, views)):
                raise RuntimeError("a gradient left its view")
            return every
    else:
        def clear(set_to_zero=False):
            for p in params:
                p.grad = None

        def gather():
            torch._foreach_copy_(views, [p.grad for p in params])
            return every
    clear()
    opt.clear_grad = clear
    fs.gather_grads = gather


def _turn(torch, kind: str) -> dict:
    import numpy as np
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForSequenceClassification)
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as lr_mod
    model = ErnieForSequenceClassification(
        ErnieConfig.ernie3_base(), num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0), seed=0)
    steps = WARMUP + TIMED + 1
    sched = lr_mod.LinearWarmup(
        lr_mod.PolynomialDecay(5e-5, steps, end_lr=0.0, power=1.0),
        max(1, steps // 10), 0.0, 5e-5)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                weight_decay=0.01, use_multi_tensor=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    _layout(torch, opt, kind)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 40000, (BATCH, SEQ),
                                       dtype=np.int32), device="cuda")
    labels = torch.as_tensor(rng.integers(0, 2, (BATCH,)).astype(np.int64),
                             device="cuda")

    def step(ids, labels):
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            loss, _ = model(ids, labels=labels)
        loss.backward()
        return loss

    def update():
        opt.step()
        opt.clear_grad()
    cap = jit.capture_step(step, update_fn=update, clear_fn=opt.clear_grad,
                           nan_gate=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, replay_ms, wall_s = [], [], []
    for i in range(WARMUP + TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.monotonic()
        start.record()
        loss = cap(ids, labels)
        end.record()
        torch.cuda.synchronize()
        wall_s.append(time.monotonic() - t0)
        if i >= WARMUP:
            replay_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        sched.step()
    peak = torch.cuda.max_memory_allocated() / 1e9
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cap(ids, labels)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))]
    dev_us = sum(getattr(e, "device_time_total", 0.0) or
                 getattr(e, "cuda_time_total", 0.0) for e in kern)
    row = {"layout": kind, "replay_ms_p50": statistics.median(replay_ms),
           "replay_ms": replay_ms,
           "wall_step_s_p50": statistics.median(wall_s[WARMUP:]),
           "peak_mem_gb": peak, "kernels": sum(e.count for e in kern),
           "kernel_device_ms": dev_us / 1e3, "losses": losses,
           "stats": cap.stats}
    if kind == "copy":
        fs = opt._flat
        views = fs.views(fs.grad)
        grads = [torch.empty_like(v) for v in views]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch._foreach_copy_(views, grads)
        start.record()
        for _ in range(20):
            torch._foreach_copy_(views, grads)
        end.record()
        torch.cuda.synchronize()
        row["gather_copy_ms"] = start.elapsed_time(end) / 20
        row["gather_copy_bytes"] = 2 * fs.grad.numel() * fs.grad.element_size()
    del cap, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ab_flat_grads: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rows = []
    for kind in ORDER:
        row = _turn(torch, kind)
        rows.append(row)
        print(json.dumps({"phase": "ab_flat_grads_turn", **row}), flush=True)
    first = {r["layout"]: r["losses"] for r in rows}
    rel = max(abs(a - b) / abs(b) for a, b in zip(first["views"],
                                                   first["copy"]))
    if rel > 1e-3:   # the two layouts must do the same work
        print(f"ab_flat_grads: the layouts' losses differ: {first}",
              file=sys.stderr)
        return 1
    summary = {k: {m: [r[m] for r in rows if r["layout"] == k]
                   for m in ("replay_ms_p50", "wall_step_s_p50",
                             "peak_mem_gb", "kernels", "kernel_device_ms")}
               for k in ("views", "copy")}
    summary["copy"]["gather_copy_ms"] = [r["gather_copy_ms"] for r in rows
                                         if r["layout"] == "copy"]
    print(json.dumps({"phase": "ab_flat_grads", "order": ORDER,
                      "losses_max_rel": rel, **summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
