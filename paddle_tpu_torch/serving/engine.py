"""The serving step loop: continuous batching over a paged KV pool. The
port of ``paddle_tpu/serving/engine.py``.

* The model enters as two callables (``LlamaForCausalLM.serving_callables``,
  or ``tools/fmt_stack.py``'s ``FMTStack.serving_callables`` for the
  ``FusedMultiTransformer`` stack); nothing here depends on the model:

  - ``prefill_fn(ids (1, n), cache (L, 2, 1, H, M, D), start=0) ->
    (first_token (1, 1), cache)``, filling positions ``[start, start + n)``
    of ``cache`` in place; ``[0, start)`` is a resident shared prefix. A
    2-argument ``prefill_fn(ids, cache)`` (``start`` always 0) works too,
    with prefix sharing off;
  - ``step_fn(tok (B, 1), cache, t (B,)) -> (next_token (B, 1), cache)``.
    On the kernel tier ``cache`` is a ``PagedDecodeCache``, whose attention
    reads the pool through the page tables and writes position ``t`` into
    it; on the dense tier it is the stacked cache ``(L, 2, B, H, M, D)``
    (``M = max_len``) gathered from the slots' pages, in which the step
    writes position ``t``.

* The decode tier (``ServingConfig.paged_attention``, else the
  ``PADDLE_TPU_PAGED_ATTENTION`` knob; ``ops.paged_attention.decode_path``):
  ``auto`` and ``on`` run the paged kernel tier, ``off`` the dense tier,
  which gathers the slots' pages into a static dense buffer, runs
  ``step_fn`` on it and writes position ``t``'s page back
  (:func:`dense_decode_body`; :class:`DenseDecodeGraph` on a card). So any
  pair of callables whose step reads the dense stacked cache can be served.
  A kernel-tier engine on a card whose shape the JAX package's tiling rule
  refuses (``ops.paged_attention.kernel_eligible``) is built on the dense
  tier, with a warning, at its construction, as the JAX engine is on a TPU;
  a shape that rule accepts and the kernel's own limits refuse raises
  ``NotImplementedError`` there (``require_kernel_shape``).
  ``serving.paged_attention_steps_total``
  carries the tier as ``path``.

* Batch rows are assigned to active slots per step (per-slot state is on
  the host: a page-table row, a position, the last token), so the batch is
  compact. It is padded up to a bucket size (default {1, 4, 16}); padded
  rows read and write only the scratch page.

* On a card each bucket's decode step is one CUDA graph (the port's form of
  the JAX engine's one compiled program per bucket): ``step_fn`` captured
  over static ``tok``/``tables``/``t`` buffers, the pool and the weights.
  :meth:`Engine.warmup` captures every bucket; a bucket first met without
  it is captured at its first step. A step copies the host arrays into the
  static buffers, replays, and reads the next tokens back: one host sync.
  A capture or replay that fails raises; there is no eager fallback. On
  the CPU (``device="cpu"``) the step runs eagerly.

* Likewise each prefill key ``(start, n)`` is one CUDA graph on a card
  (:class:`PrefillGraph`, the JAX engine's ``prefill_program`` per prompt
  length and tail program per ``start``): :func:`prefill_body` captured
  over static ``ids (1, n)`` and page-row buffers. ``warmup(prompt_lens)``
  captures the full prefills of those lengths; any other key is captured
  at the admission that first meets it, which then costs an eager warm-up
  call and the capture besides the replay, with every live slot waiting.
  Prompts are not padded to a length bucket: padding would change the
  attention. The CPU engine calls :func:`prefill_body` eagerly, so its
  tests run the code a card replays. The engine's first prefill capture
  is preceded by one of ``max_len`` tokens, dropped once the key's own
  graph holds the pool: the shared pool then holds the largest prefill's
  temporaries, which every later key reuses (met shortest first, each
  longer key would add its whole footprint to the pool). The prefill
  graphs are kept least recently used first out: before a new capture,
  while the card has no room for a ``max_len`` prefill or the host is
  short of memory (:meth:`Engine._memory_short`), the oldest are dropped.

* Admission happens at step boundaries by prefill-into-slot: the scheduler
  pops what fits (a slot, and pages for the request's whole lifetime), the
  prompt is prefilled into a buffer of the prompt's pages
  (``M = pages * page_size``), the buffer is stored into the pool
  (``kv_cache.scatter_prefill_pages``), and the first token is emitted.
  With prefix sharing (``ServingConfig.prefix_sharing``) the admission
  first maps the longest resident chain of full prompt pages read-only
  (``PagedKVCache.acquire_prefix``), gathers it into the buffer, prefills
  only the tail from ``start`` and stores only the tail's pages; then it
  publishes its own full prompt pages. The scheduler's budget charges the
  tail only.

* A slot is evicted on eos, on length, or on cancel; its pages return to
  the pool (shared ones lose one reference).

The pool is updated **in place** and never reallocated (the JAX engine
threads it through its compiled programs as functional state); a replay
checks that it has not moved.

Failure semantics, as the JAX engine's (``resilience`` seams, the same
site names and counters):

* ``serving.admit`` fires once per admission attempt, before the prefill.
  One retry; a second fault fails that request and frees its pages.
* ``serving.step`` fires once per (step, included slot), in admission
  order. A faulted slot sits the step out; a second fault fails it alone.
* ``serving.watchdog`` fires once per batched-decode attempt, inside the
  armed watchdog window (``watchdog_s``, ``PADDLE_TPU_SERVING_WATCHDOG_S``)
  and before the launch: a ``delay`` is a hung step, an ``error`` a
  whole-batch fault. A fault is retried once; a second one, or a watchdog
  trip, abandons the step's outputs and recovers the included slots by
  **bounded prefill replay**: each slot's prompt + tokens so far is
  requeued at the queue head and re-prefilled into fresh pages (at most
  ``max_replays`` times, then the request fails); the flight recorder
  dumps (``serving_recover``).
* ``serving.drain`` fires at ``stop(drain=True)``; an injected error
  degrades the drain to an immediate stop. Either way every Future
  resolves and every page returns to the pool.

Where the in-place pool changes the argument. The JAX engine's recovery
rests on "nothing was committed". Here a launched decode step has written
position ``t`` of every included slot, so: (1) a step that launched is
never launched again: an exception after the launch (the token read-back)
retries the read of the same output, so a retried step leaves the pool
bit-equal to one step (and a repeated int8 token write is a no-op,
``ops.paged_attention.scatter_token_inplace``); (2) a step whose outputs
are abandoned wrote only into its slots' own pages at ``t`` >= the
prompt length, never a published prefix page, and recovery frees those
pages. A replay's re-prefill is a prefill key nobody warmed: on a card it
is captured at its admission, outside the watchdog's window.

An abandoned step still runs on the stream (a graph replay cannot be
cancelled). A tripped step that returned has finished. A loop thread that
``stop()`` abandons as a zombie has not: it may still be in its read-back,
with its copies and kernels queued. Every replay records an event; after
an abandonment no graph refills its pinned staging and no admission
reuses a freed page until the graph's last replay event has completed,
and the zombie launches nothing more (it checks under the launch lock).
All of an engine's work runs on its own stream (:attr:`Engine.stream`), so
stream order covers its pool; two engines in one process (a router's
replicas) neither wait for each other's replays at their host reads nor
share a capture: captures take one process-wide lock, as PyTorch allows
one capture at a time in a process, and each engine captures on its own
side stream, so its graphs' cuBLAS workspace (one per handle and stream)
is its own and two engines' replays may overlap on the card.

A real asynchronous CUDA error (an illegal address) is sticky: the
process's context cannot run another kernel. The engine does not loop on
it: the retry and the replays' re-prefills fail again, every involved
Future resolves with the error within ``max_replays``, and the flight
recorder dumps. Restart the process.

Observability, as the JAX engine's: ``serving.requests_total{status}``,
``tokens_total``, ``steps_total``, ``prefills_total``,
``step_retries_total``, ``admit_retries_total``, ``replays_total``,
``rejected_total{reason}``, ``watchdog_trips_total{kind}``, the
``queue_depth``/``active_slots``/``batch_utilization`` gauges and the
``ttft_seconds``/``tpot_seconds``/``queue_wait_seconds`` histograms; a
trace root per request from ``submit()``; a ``/healthz`` beacon;
``PADDLE_TPU_OBS_HTTP_PORT`` opts into the scrape endpoint. All of it is
host code in the step loop, reading host state: nothing inside a captured
region (``prefill_body``, ``step_fn``), which runs once at capture and
never at replay. Disabled (the default), each seam is one bool probe, and
with no watchdog budget none is armed.
"""

from __future__ import annotations

import inspect
import logging
import os
import threading
import time
from collections import Counter, OrderedDict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _native
from .. import observability as _obs
from ..device import resolve_device
from ..observability import cost as _cost
from ..observability import http as _obs_http
from ..observability import trace as _trace
from ..ops import paged_attention as _pa
from ..ops.paged_attention import PagedDecodeCache
from ..resilience import deadline_scope, faults as _faults, jitter_sleep
from . import kv_cache as _kv
from .scheduler import (GenerationRequest, GenerationResult, Scheduler,
                        _Pending)
from .watchdog import StepWatchdog, WatchdogTimeout

__all__ = ["ServingConfig", "Engine", "EngineStopped", "DrainTimeout",
           "DecodeGraph", "DenseDecodeGraph", "PrefillGraph",
           "dense_decode_body", "prefill_body", "TTFT_BUCKETS",
           "TPOT_BUCKETS"]

_log = logging.getLogger(__name__)

# extra seconds past the drain budget the loop thread is given to come back
# from its device call before stop() proceeds without it
_JOIN_GRACE_S = 1.0
# bound on joining the loop thread when stop() was given no drain budget
# (PADDLE_TPU_STOP_JOIN_S overrides): past it a wedged thread is abandoned
_STOP_JOIN_S = 30.0

# SLO-shaped latency boundaries (the JAX engine's), registered at import so
# every later observe joins these families
TTFT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
    10.0, 30.0,
)
TPOT_BUCKETS = (
    0.0005, 0.001, 0.002, 0.004, 0.006, 0.008, 0.01, 0.015, 0.025,
    0.05, 0.1, 0.25, 1.0,
)
_obs.histogram("serving.ttft_seconds",
               "submit -> first token (once per request)",
               buckets=TTFT_BUCKETS)
_obs.histogram("serving.tpot_seconds",
               "inter-token time after the first", buckets=TPOT_BUCKETS)

# every Nth decode step drops an instant on the request's trace
_DECODE_TRACE_EVERY = 8

# the engine's liveness beacon ttl (/healthz goes 503 past this)
_HEARTBEAT_TTL_S = 60.0
# eager calls on a side stream before a decode or prefill capture (PyTorch's
# graph API wants the call's lazy work, here the kernels' first build and
# load and cuBLAS's handles, done before it records; one call does it all)
_WARM_STEPS = 1
# below this share of the host's memory available, the least recently used
# prefill graphs are dropped before another is captured
_HOST_AVAILABLE_SHARE = 1 / 8
# one CUDA graph capture at a time in the process (PyTorch's rule), whichever
# engine's thread captures, held from its warm-up calls on; other threads go
# on replaying meanwhile
_CAPTURE_LOCK = threading.Lock()


class EngineStopped(RuntimeError):
    """The engine is draining or stopped: ``submit`` rejects new work, and
    queued requests that were never admitted resolve with this at a
    drained stop."""


class DrainTimeout(EngineStopped):
    """An admitted request was still decoding when the drain budget ran
    out and ``on_timeout="fail"`` evicted it."""


class _Abandoned(Exception):
    """Raised in a loop thread that ``stop()`` abandoned as a zombie, at
    its next launch: it launches nothing more."""


def _env_seconds(name: str) -> Optional[float]:
    """Float seconds from the environment; 0, empty or absent mean off."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    val = float(raw)
    return val if val > 0 else None


def _prefill_accepts_start(fn: Callable) -> bool:
    """Whether ``prefill_fn`` takes the ``start`` offset (its third
    positional argument) and can prefill only a prompt's unshared tail."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return False
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return True
    return len([p for p in params if p.kind in (
        p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]) >= 3


@dataclass
class ServingConfig:
    """Engine sizing and policy. The model-shape fields must match the
    cache layout the callables consume (``num_heads`` counts KV heads)."""

    num_layers: int
    num_heads: int
    head_dim: int
    max_len: int
    # replica identity: names the liveness beacon serving.engine.<name>
    # (empty: serving.engine)
    name: str = ""
    max_batch: int = 16
    buckets: Tuple[int, ...] = (1, 4, 16)
    max_queue: int = 64
    page_size: int = 64
    num_pages: Optional[int] = None      # default: full coverage + scratch
    kv_dtype: str = "native"             # native | bf16 | int8
    compute_dtype: str = "float32"       # float32 | bfloat16 | float16
    policy: str = "fifo"
    prefill_token_budget: Optional[int] = None
    device: Optional[str] = None         # None -> cuda (raises without one)
    # prefix-cache page sharing: auto = share when prefill_fn takes a start
    # offset, on = require that (a 2-argument prefill_fn raises), off =
    # never consult the index
    prefix_sharing: str = "auto"
    min_shared_pages: int = 1            # shortest chain worth mapping
    # bounded prefill replay: how many times an unrecoverable step fault or
    # a watchdog trip may requeue a slot before its Future fails
    max_replays: int = 1
    # step watchdog budget in seconds; None -> PADDLE_TPU_SERVING_WATCHDOG_S
    # (0 or absent: off); 0 forces it off whatever the environment says
    watchdog_s: Optional[float] = None
    # cap on queue wait; None -> PADDLE_TPU_SERVING_MAX_QUEUE_WAIT (0 or
    # absent: unbounded); 0 forces it off
    max_queue_wait_s: Optional[float] = None
    # decode tier: "" -> the PADDLE_TPU_PAGED_ATTENTION knob (default auto);
    # auto and on = the paged kernel tier, off = the dense stacked-cache
    # tier. The field wins when set
    paged_attention: str = ""

    def __post_init__(self):
        self.buckets = tuple(sorted(set(int(b) for b in self.buckets)))
        if not self.buckets or self.buckets[-1] < self.max_batch:
            raise ValueError(f"buckets {self.buckets} must cover max_batch "
                             f"{self.max_batch}")
        if self.prefix_sharing not in ("auto", "on", "off"):
            raise ValueError(f"prefix_sharing must be auto|on|off, got "
                             f"{self.prefix_sharing!r}")
        if self.min_shared_pages < 1:
            raise ValueError(f"min_shared_pages must be >= 1, got "
                             f"{self.min_shared_pages}")
        if self.max_replays < 0:
            raise ValueError(f"max_replays must be >= 0, got "
                             f"{self.max_replays}")
        if self.watchdog_s is None:
            self.watchdog_s = _env_seconds("PADDLE_TPU_SERVING_WATCHDOG_S")
        elif self.watchdog_s <= 0:
            self.watchdog_s = None
        if self.max_queue_wait_s is None:
            self.max_queue_wait_s = _env_seconds(
                "PADDLE_TPU_SERVING_MAX_QUEUE_WAIT")
        elif self.max_queue_wait_s <= 0:
            self.max_queue_wait_s = None
        self.paged_attention = self.paged_attention.strip().lower() \
            or _pa.mode()
        _pa.decode_path(self.paged_attention)     # raises on a typo

    def kv_config(self) -> _kv.KVCacheConfig:
        cfg = _kv.KVCacheConfig(
            num_layers=self.num_layers, num_heads=self.num_heads,
            head_dim=self.head_dim, max_len=self.max_len,
            page_size=self.page_size, num_pages=self.num_pages,
            compute_dtype=self.compute_dtype, kv_dtype=self.kv_dtype,
            min_shared_pages=self.min_shared_pages)
        if cfg.num_pages is None:
            cfg.num_pages = self.max_batch * cfg.pages_per_slot + 1
        return cfg


@dataclass(eq=False)
class _Slot:
    """Host-side state of one admitted request."""

    pending: _Pending
    page_ids: List[int]
    table_row: np.ndarray               # (pages_per_slot,) int32
    t: int                              # next cache write position
    last_tok: int
    tokens: List[int] = field(default_factory=list)
    faults: int = 0
    first_token_time: float = 0.0
    last_token_time: float = 0.0
    # leading pages mapped read-only from the prefix index: this slot holds
    # one reference on each, which free() hands back
    shared_pages: int = 0
    # submit_time + deadline_s, when the request has a deadline
    until: Optional[float] = None

    @property
    def request(self) -> GenerationRequest:
        return self.pending.request


def _host_memory() -> Optional[Tuple[int, int]]:
    """``(available, total)`` bytes of host memory, from
    ``/proc/meminfo``; None where there is none."""
    try:
        with open("/proc/meminfo") as f:
            info = dict(ln.split(":", 1) for ln in f if ":" in ln)
        return (int(info["MemAvailable"].split()[0]) * 1024,
                int(info["MemTotal"].split()[0]) * 1024)
    except (OSError, KeyError, ValueError):
        return None


def prefill_body(prefill_fn: Callable, kv: _kv.PagedKVCache,
                 ids: torch.Tensor, pages: torch.Tensor,
                 start: int = 0) -> torch.Tensor:
    """One admission's prefill on the card's (or the CPU's) tensors: the
    JAX engine's ``prefill_body`` (``start == 0``) and ``tail_body``.

    ``ids (1, n)`` int64 are the prompt's tokens from ``start`` on,
    ``pages (k,)`` int32 the slot's pages covering ``[0, start + n)``;
    ``start`` is a page-aligned Python int. Zeroes a dense ``(L, 2, 1, H,
    k * page_size, D)`` buffer, gathers the shared prefix pages
    ``pages[:start // page_size]`` into it, runs ``prefill_fn`` and stores
    the pages from ``start`` on (positions past ``start + n`` zeroed);
    returns the first token ``(1, 1)`` on the device. No host read: the
    CPU engine calls it eagerly and :class:`PrefillGraph` captures it."""
    cfg = kv.config
    ps = cfg.page_size
    dtype = cfg.torch_compute_dtype
    dense = torch.zeros((cfg.num_layers, 2, 1, cfg.num_heads,
                         pages.shape[0] * ps, cfg.head_dim),
                        dtype=dtype, device=ids.device)
    with torch.no_grad():
        if start:
            dense[:, :, :, :, :start] = _kv.gather_pages(
                kv.pool, kv.scales, pages[:start // ps], dtype)
            nxt, dense = prefill_fn(ids, dense, start)
        else:
            nxt, dense = prefill_fn(ids, dense)
        _kv.scatter_prefill_pages(dense, kv.pool, kv.scales,
                                  pages[start // ps:],
                                  start + int(ids.shape[1]), ps, start=start)
    return nxt


def dense_decode_body(step_fn: Callable, kv: _kv.PagedKVCache,
                      tok: torch.Tensor, tables: torch.Tensor,
                      t: torch.Tensor,
                      dense: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step on the dense tier: the JAX engine's dense
    ``decode_fn``. Gathers the rows' pages (``tables (b, S)`` int32) into
    the stacked cache ``(L, 2, b, H, max_len, D)`` (into ``dense`` when
    given), runs ``step_fn(tok (b, 1), cache, t (b,))`` and writes each
    row's page holding position ``t`` back into the pool, in place (int8
    pages quantized anew); returns the next tokens ``(b, 1)`` on the
    device. No host read: the CPU engine calls it eagerly and
    :class:`DenseDecodeGraph` captures it."""
    cfg = kv.config
    with torch.no_grad():
        dense = _kv.gather_pages(kv.pool, kv.scales, tables,
                                 cfg.torch_compute_dtype, out=dense)
        nxt, dense = step_fn(tok, dense, t)
        _kv.scatter_token_page(dense.to(cfg.torch_compute_dtype), kv.pool,
                               kv.scales, tables, t, cfg.page_size)
    return nxt


def _dense_bytes(cfg: _kv.KVCacheConfig, bucket: int) -> int:
    """The dense tier's stacked cache of ``bucket`` rows, in bytes."""
    return (cfg.num_layers * 2 * bucket * cfg.num_heads * cfg.max_len
            * cfg.head_dim * cfg.torch_compute_dtype.itemsize)


def _kernel_tier_serves(device: torch.device, cfg: _kv.KVCacheConfig
                        ) -> bool:
    """Whether a kernel-tier engine stays on that tier. On the CPU the
    kernel's plain version serves every shape. On a card, not where the
    JAX package's rule (``kernel_eligible``) refuses the shape, as the JAX
    engine demotes on a TPU; a shape that rule accepts and the kernel's
    own limits refuse raises ``NotImplementedError``
    (``require_kernel_shape``)."""
    if device.type != "cuda":
        return True
    if not _pa.kernel_eligible(cfg.page_size, cfg.head_dim,
                               cfg.storage_dtype):
        return False
    _pa.require_kernel_shape(cfg.page_size, cfg.head_dim, cfg.storage_dtype)
    return True


def _decode_key(bucket: int) -> str:
    return f"decode:{bucket}"


def _decode_label(bucket: int) -> str:
    return f"decode[b={bucket}]"


def _prefill_key(start: int, n: int) -> str:
    return f"prefill:{start}:{n}"


def _prefill_label(start: int, n: int) -> str:
    """A prefill program's label: ``prefill[len=n]``, a tail after a
    resident prefix ``prefill[start=s][len=n]``."""
    return (f"prefill[start={start}]" if start else "prefill") + \
        f"[len={n}]"


class _EngineGraph:
    """What the decode and prefill graphs share: static device buffers
    filled through pinned staging, a capture after warm-up calls on a side
    stream, and replays that check the pool and count launches.

    The capture bakes in the addresses of the static buffers, the pool,
    its scales and the model's weights, so the pool must never be
    reallocated: :meth:`replay` raises if it moved. Replays count the
    kernel launches the capture recorded (``_native.recorded_launches``)
    and record :attr:`done` after the launch. Graphs of one engine share a
    memory pool, so a graph's output is valid only until another graph
    replays."""

    def __init__(self, kv: _kv.PagedKVCache, buffers: Tuple[torch.Tensor, ...],
                 what: str):
        if kv.device.type != "cuda":
            raise ValueError(f"a {what} needs a pool on a CUDA device, not "
                             f"{kv.device}")
        self.what = what
        self._kv = kv
        self._buffers = buffers
        # pinned staging, so the host-to-card copies are asynchronous
        self._staging = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                         for x in buffers]
        self._pool_ptrs = self._pointers()
        self.replays = 0
        # recorded after every replay: after an abandoned loop thread, the
        # next step waits for it (Engine._await_quarantine)
        self.done = torch.cuda.Event()

    def _capture(self, fn: Callable, mempool,
                 side: Optional[torch.cuda.Stream]) -> torch.Tensor:
        """Run ``fn`` ``_WARM_STEPS`` times on the side stream ``side`` (a
        stream of its own if None), then capture one call of it on that
        stream into ``mempool``; returns the call's output (the graph's).
        Warm-up memory stays cached for its stream, so the engine gives all
        its graphs one side stream. Holds the process-wide capture lock
        throughout: no other engine captures, or launches a kernel through
        a wrapper, meanwhile (the launch counters record this capture's,
        and the cost registry counts the last warm-up call's: ``tally``,
        None while it is off; ``temp_bytes`` is the pool's growth in
        reserved memory over the capture)."""
        dev = self._kv.device
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            if side is None:
                side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), torch.no_grad():
                for i in range(_WARM_STEPS):
                    with _cost.counted(i == _WARM_STEPS - 1) as self.tally:
                        fn()
            torch.cuda.current_stream(dev).wait_stream(side)
            # the capture frees the cached blocks first (as torch.cuda.graph
            # does on entry), so the pool's growth is what it reserves anew
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            self.graph = torch.cuda.CUDAGraph()
            # captured on the engine's own side stream: cuBLAS keeps a
            # workspace per (handle, stream), and a graph bakes in the one
            # its capture used, so two engines' graphs replaying at once on
            # their streams must not share one (PyTorch's default capture
            # stream would give every engine's graphs the same).
            # thread_local: CUDA calls of the process's other threads (a
            # caller's tensors, another engine's replays) neither fail nor
            # spoil the capture; this thread makes none, and the engine's
            # replays run one at a time
            with _native.recorded_launches() as self.launches, \
                    torch.no_grad(), \
                    torch.cuda.graph(self.graph, pool=mempool, stream=side,
                                     capture_error_mode="thread_local"):
                out = fn()
            torch.cuda.synchronize(dev)
            self.temp_bytes = torch.cuda.memory_reserved(dev) - reserved
            self.capture_s = time.perf_counter() - t0
        return out

    def _pointers(self) -> Tuple[int, int]:
        sc = self._kv.scales
        return (self._kv.pool.data_ptr(),
                sc.data_ptr() if sc is not None else 0)

    def load(self, *arrays: np.ndarray) -> None:
        """Copy one call's host arrays into the static buffers (queued on
        the current stream). The previous replay's output read has retired
        the previous copies, so the staging is free (after an abandoned
        loop thread, the engine's next step first waits for every graph's
        last replay)."""
        for host, dev, arr in zip(self._staging, self._buffers, arrays):
            host.numpy()[...] = arr
            dev.copy_(host, non_blocking=True)

    def replay(self) -> torch.Tensor:
        """Launch the captured call on the current buffers; returns its
        output."""
        if self._pointers() != self._pool_ptrs:
            raise RuntimeError(
                f"{self.what}: the KV pool moved since its capture; the pool "
                f"must be updated in place")
        self.graph.replay()
        self.done.record()
        for counter, n in self.launches.items():
            counter.add(n)
        self.replays += 1
        return self.next


class DecodeGraph(_EngineGraph):
    """One bucket's decode step as a CUDA graph.

    ``tok (b, 1)`` int64, ``tables (b, S)`` int32 and ``t (b,)`` int32 are
    static device buffers (:meth:`load` fills them), ``next (b, 1)`` the
    graph's output. Warm-up calls write page 0 only."""

    def __init__(self, step_fn: Callable, kv: _kv.PagedKVCache, bucket: int,
                 mempool, side: Optional[torch.cuda.Stream] = None):
        dev = kv.device
        S = kv.config.pages_per_slot
        self.bucket = bucket
        self.tok = torch.zeros((bucket, 1), dtype=torch.int64, device=dev)
        self.tables = torch.zeros((bucket, S), dtype=torch.int32, device=dev)
        self.t = torch.zeros((bucket,), dtype=torch.int32, device=dev)
        super().__init__(kv, (self.tok, self.tables, self.t),
                         f"{type(self).__name__} of bucket {bucket}")
        self.next = self._capture(lambda: self._step(step_fn), mempool,
                                  side)

    def _step(self, step_fn: Callable) -> torch.Tensor:
        """The captured call: ``step_fn`` over the pool's page-table
        view."""
        view = PagedDecodeCache(pool=self._kv.pool, tables=self.tables,
                                t=self.t, page_size=self._kv.config.page_size,
                                scales=self._kv.scales)
        return step_fn(self.tok, view, self.t)[0]


class DenseDecodeGraph(DecodeGraph):
    """One bucket's decode step on the dense tier as a CUDA graph:
    :func:`dense_decode_body` over :class:`DecodeGraph`'s static buffers and
    a static stacked cache ``dense`` ``(L, 2, b, H, max_len, D)`` in the
    compute dtype (:func:`_dense_bytes`), allocated here, which each replay
    fills from the pool. Warm-up calls read and write page 0 only."""

    def __init__(self, step_fn: Callable, kv: _kv.PagedKVCache, bucket: int,
                 mempool, side: Optional[torch.cuda.Stream] = None):
        cfg = kv.config
        self.dense = torch.zeros((cfg.num_layers, 2, bucket, cfg.num_heads,
                                  cfg.max_len, cfg.head_dim),
                                 dtype=cfg.torch_compute_dtype,
                                 device=kv.device)
        super().__init__(step_fn, kv, bucket, mempool, side)

    def _step(self, step_fn: Callable) -> torch.Tensor:
        return dense_decode_body(step_fn, self._kv, self.tok, self.tables,
                                 self.t, self.dense)


class PrefillGraph(_EngineGraph):
    """One prefill key as a CUDA graph: :func:`prefill_body` over static
    ``ids (1, n)`` int64 and ``pages (k,)`` int32 buffers, ``k`` the pages
    covering ``start + n`` positions (:meth:`load` fills them); ``next (1,
    1)`` is the first token. The key ``(start, n)`` fixes every shape and
    the true length ``start + n``, as the JAX engine's program is fixed by
    its input shapes and tail ``start``. Warm-up calls run with the page
    row all 0: they write the scratch page only."""

    def __init__(self, prefill_fn: Callable, kv: _kv.PagedKVCache,
                 start: int, n: int, mempool,
                 side: Optional[torch.cuda.Stream] = None):
        dev = kv.device
        cfg = kv.config
        if start % cfg.page_size or start < 0 or n < 1 \
                or start + n > cfg.max_len:
            raise ValueError(
                f"prefill key (start {start}, n {n}): start must be "
                f"page-aligned ({cfg.page_size}), n >= 1 and start + n <= "
                f"max_len {cfg.max_len}")
        self.key = (start, n)
        self.ids = torch.zeros((1, n), dtype=torch.int64, device=dev)
        self.pages = torch.zeros((kv.pages_for(start + n),),
                                 dtype=torch.int32, device=dev)
        super().__init__(kv, (self.ids, self.pages),
                         f"prefill graph of (start {start}, n {n})")
        self.next = self._capture(
            lambda: prefill_body(prefill_fn, kv, self.ids, self.pages, start),
            mempool, side)


class Engine:
    """Continuous-batching decode engine over a paged KV pool.

    ``step()`` is single-consumer (your own loop, :meth:`run`, or the
    :meth:`start` thread); ``submit``, ``cancel`` and ``stop`` are safe
    from any other thread."""

    def __init__(self, prefill_fn: Callable, step_fn: Callable,
                 config: ServingConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self._prefill_fn = prefill_fn
        self._step_fn = step_fn
        # the decode tier, decided here from the configuration and the
        # shape, before the pool is allocated: "kernel" hands step_fn the
        # pool's PagedDecodeCache view, "dense" the stacked cache gathered
        # from it
        kcfg = config.kv_config()
        self.decode_path = _pa.decode_path(config.paged_attention)
        if self.decode_path == "kernel" and \
                not _kernel_tier_serves(self.device, kcfg):
            _log.warning(
                "paged-attention kernel ineligible for page_size=%d "
                "head_dim=%d kv storage %s (tiling floors: see "
                "ops.paged_attention.kernel_eligible) -- serving on the "
                "dense decode tier", kcfg.page_size, kcfg.head_dim,
                kcfg.storage_dtype)
            self.decode_path = "dense"
        self.kv = _kv.PagedKVCache(kcfg, self.device)
        # the HBM ledger's sources: the pool and the model the callables
        # hold (weakly); the cost records of programs counted on the CPU
        _cost.register_kv_cache(self.kv)
        _cost.register_state(*_cost.state_owners(prefill_fn, step_fn))
        self._cost_keys: set = set()
        capable = _prefill_accepts_start(prefill_fn)
        if config.prefix_sharing == "on" and not capable:
            raise ValueError(
                "prefix_sharing='on' needs a prefill callable that takes a "
                "start offset (prefill_fn(ids, cache, start)); this one "
                "takes 2 arguments: pass 'auto' or 'off', or extend it")
        self._share_prefix = config.prefix_sharing != "off" and capable
        # prompt tokens asked for and computed (guarded by _slot_lock)
        self._prefill_tokens_requested = 0
        self._prefill_tokens_computed = 0
        self.scheduler = Scheduler(
            max_queue=config.max_queue, policy=config.policy,
            prefill_token_budget=config.prefill_token_budget,
            max_queue_wait_s=config.max_queue_wait_s,
            prefill_cost=self._prefill_cost if self._share_prefix else None)
        # decode graphs by bucket and prefill graphs by (start, n), least
        # recently used first (a card only), sharing one memory pool;
        # replays run one at a time on the step thread
        self._graphs: Dict[int, DecodeGraph] = {}
        self._prefill_graphs: "OrderedDict[Tuple[int, int], PrefillGraph]" \
            = OrderedDict()
        # prefill graphs captured and dropped, their capture seconds, and
        # the replays of dropped ones (guarded by _graph_lock)
        self._prefill_captures = 0
        self._prefill_evictions = 0
        self._pool_primed = False
        self._prefill_capture_s = 0.0
        self._evicted_replays: Counter = Counter()
        self._graph_lock = threading.Lock()
        self._capture_pool = None
        # the engine's own stream for its device work (a card only): the
        # loop thread and warmup() run on it, so stream order covers the
        # pool, and another engine's replays never sit between this one's
        # launch and its read; it starts after the pool's zero fill
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        # held from the zombie check through a launch: stop() takes it to
        # mark an abandoned loop thread, which then launches nothing more
        self._launch_lock = threading.Lock()
        self._zombies: set = set()
        # set when a loop thread was abandoned: the next step waits for
        # every graph's last replay before it refills a staging buffer or
        # reuses a freed page
        self._quarantined = False
        # the output of a launched step whose read-back failed: a retry
        # reads it again instead of launching the step twice
        self._unread: Optional[torch.Tensor] = None
        # the step loop's own counts: decode steps by live rows, prefills
        # by kind (guarded by _slot_lock)
        self._batch_sizes: Counter = Counter()
        self._prefills: Counter = Counter()
        self._slots: List[_Slot] = []    # admission order == batch row order
        # guards slot admission and eviction and the in-transit count: a
        # budgeted stop() that gave up on a wedged loop thread resolves
        # stragglers from the caller's thread while the wedged call may
        # return concurrently; _release decides each slot's winner once
        self._slot_lock = threading.Lock()
        # requests between queue and slot (popped, prefill not finished) or
        # between slot and queue (evicted by recovery, not yet requeued):
        # the drain's owed-work probe must not read either as nothing left
        self._in_transit = 0
        # live slots whose requests carry a deadline (guarded by _slot_lock)
        self._deadline_slots = 0
        # orders submit's draining check + enqueue against stop's latch, so
        # a request is either refused or swept by the drain, never stranded
        self._submit_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._draining = threading.Event()
        # how the last stop() resolves stragglers ("fail" | "requeue"; a
        # pause requeues), and whether its sweep ran: an admission that
        # lands after the sweep is resolved the same way (guarded by
        # _slot_lock)
        self._drain_on_timeout = "fail"
        self._swept = False
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[StepWatchdog] = (
            StepWatchdog(config.watchdog_s) if config.watchdog_s else None)
        self._beacon = (f"serving.engine.{config.name}" if config.name
                        else "serving.engine")
        # one trace track for the engine's own batched steps (requests
        # carry their own), and the opt-in scrape endpoint
        self._engine_trace = None
        self._obs_http = _obs_http.maybe_serve_from_env()

    # -- device calls -------------------------------------------------------
    def _check_live(self) -> None:
        """Raise :class:`_Abandoned` in a loop thread ``stop()`` gave up on
        (call with ``_launch_lock`` held)."""
        if self._zombies and threading.get_ident() in self._zombies:
            raise _Abandoned("this loop thread was abandoned by stop()")

    def _prefill(self, prompt: np.ndarray, row: np.ndarray,
                 start: int = 0) -> int:
        """Prefill ``prompt`` into the pages of ``row``; returns the first
        token (one host sync). With ``start > 0`` the pages covering
        ``[0, start)`` are a shared prefix: they are read into the buffer,
        and only the tail is computed and stored. A replay of the key's
        graph on a card, an eager :func:`prefill_body` call on the CPU."""
        pages = row[:self.kv.pages_for(int(prompt.size))]
        if self.device.type == "cuda":
            g = self.prefill_graph(start, int(prompt.size) - start)
            with self._launch_lock:
                self._check_live()
                g.load(prompt[None, start:], pages)
                out = g.replay()
            return int(out.reshape(-1)[0])
        ids = torch.as_tensor(prompt[None, start:], dtype=torch.int64,
                              device=self.device)
        n = int(prompt.size) - start
        with self._launch_lock, self._first_call_counted(
                "serving.prefill", _prefill_key(start, n),
                _prefill_label(start, n)):
            self._check_live()
            nxt = prefill_body(self._prefill_fn, self.kv, ids,
                               torch.as_tensor(pages, device=self.device),
                               start)
        return int(nxt.reshape(-1)[0])

    def _decode(self, tok: np.ndarray, tables: np.ndarray,
                t: np.ndarray) -> np.ndarray:
        """One batched decode step over the pool; returns next tokens
        (bucket,) (one host sync). A replay of the bucket's graph on a
        card, an eager ``step_fn`` call on the CPU. If a launched step's
        read-back failed (``_unread``), this reads that output again
        instead of launching the step a second time."""
        out = self._unread
        if out is None:
            if self.device.type == "cuda":
                g = self.decode_graph(int(tok.shape[0]))
                with self._launch_lock:
                    self._check_live()
                    g.load(tok, tables, t)
                    out = g.replay()
            else:
                dev = self.device
                t_d = torch.as_tensor(t, device=dev)
                tables_d = torch.as_tensor(tables, device=dev)
                tok_d = torch.as_tensor(tok, device=dev)
                b = int(tok.shape[0])
                with self._launch_lock, torch.no_grad(), \
                        self._first_call_counted(
                            "serving.decode", _decode_key(b),
                            _decode_label(b), bucket=b):
                    self._check_live()
                    if self.decode_path == "dense":
                        out = dense_decode_body(self._step_fn, self.kv,
                                                tok_d, tables_d, t_d)
                    else:
                        view = PagedDecodeCache(
                            pool=self.kv.pool, tables=tables_d, t=t_d,
                            page_size=self.kv.config.page_size,
                            scales=self.kv.scales)
                        out, _ = self._step_fn(tok_d, view, t_d)
            self._unread = out
        next_np = self._read(out)
        self._unread = None
        return next_np

    @contextmanager
    def _first_call_counted(self, site: str, key: str, label: str,
                            bucket: Optional[int] = None):
        """Around a program's eager call on the CPU: its first call is
        counted for the cost registry (while it is installed), and filed
        under ``key``."""
        first = _cost.installed() and key not in self._cost_keys
        with _cost.counted(first) as tally:
            yield
        if tally is not None:
            self._cost_keys.add(key)
            _cost.record_program(self, key, site, label, tally,
                                 bucket=bucket)

    def _file_graph(self, g: "_EngineGraph", site: str, key: str,
                    label: str, bucket: Optional[int] = None,
                    primer: Optional["_EngineGraph"] = None) -> None:
        """File a captured graph's count (its last warm-up call's), while
        the registry is installed; the pool's growth over its capture is
        its ``temp_bytes``, the primer's added where the primer was captured
        for it."""
        if not _cost.installed():
            return
        temp = g.temp_bytes + (0 if primer is None else primer.temp_bytes)
        _cost.record_program(self, key, site, label, g.tally, bucket=bucket,
                             temp_bytes=temp)

    @staticmethod
    def _read(out: torch.Tensor) -> np.ndarray:
        """The host read of a decode step's tokens (on a card the wait for
        the step; the copy releases the GIL while it waits)."""
        return out.reshape(-1).cpu().numpy()

    def _capture_args(self):
        """The memory pool every graph of this engine captures into, and
        the side stream of their warm-up calls."""
        if self._capture_pool is None:
            self._capture_pool = (torch.cuda.graph_pool_handle(),
                                torch.cuda.Stream(self.device))
        return self._capture_pool

    def decode_graph(self, bucket: int) -> DecodeGraph:
        """The CUDA graph of ``bucket``'s decode step (a
        :class:`DenseDecodeGraph` on the dense tier), captured on first use
        (a card only)."""
        if self.device.type != "cuda":
            raise RuntimeError("decode graphs need a CUDA device; the CPU "
                               "engine decodes eagerly")
        if bucket not in self.config.buckets:
            raise ValueError(f"{bucket} is not one of the buckets "
                             f"{self.config.buckets}")
        with self._graph_lock:
            g = self._graphs.get(bucket)
            if g is None:
                cls = DenseDecodeGraph if self.decode_path == "dense" \
                    else DecodeGraph
                g = cls(self._step_fn, self.kv, bucket,
                        *self._capture_args())
                self._graphs[bucket] = g
                self._file_graph(g, "serving.decode", _decode_key(bucket),
                                 _decode_label(bucket), bucket=bucket)
        return g

    def prefill_graph(self, start: int, n: int) -> PrefillGraph:
        """The CUDA graph of the prefill of ``n`` tokens after a resident
        prefix of ``start`` positions (0: a full prefill of an ``n``-token
        prompt), captured on first use (a card only). Before a capture,
        while :meth:`_memory_short`, the least recently used prefill graph
        is dropped; the engine's first is preceded by the pool's primer, a
        capture of ``max_len`` tokens (the module docstring), counted in
        ``prefill_graphs`` and ``prefill_capture_s``."""
        if self.device.type != "cuda":
            raise RuntimeError("prefill graphs need a CUDA device; the CPU "
                               "engine prefills eagerly")
        if start and not self._share_prefix:
            raise ValueError(f"a tail prefill (start {start}) needs prefix "
                             f"sharing on and a prefill_fn that takes start")
        key = (int(start), int(n))
        with self._graph_lock:
            g = self._prefill_graphs.get(key)
            if g is not None:
                self._prefill_graphs.move_to_end(key)
                return g
            while self._prefill_graphs and self._memory_short():
                old_key, old = self._prefill_graphs.popitem(last=False)
                self._evicted_replays[old_key] += old.replays
                self._prefill_evictions += 1
                _cost.retire_program(self, _prefill_key(*old_key))
                del old
            primer = None
            if not self._pool_primed:
                primer = self._count_capture(PrefillGraph(
                    self._prefill_fn, self.kv, 0, self.config.max_len,
                    *self._capture_args()))
                self._pool_primed = True
            g = self._count_capture(PrefillGraph(
                self._prefill_fn, self.kv, *key, *self._capture_args()))
            self._prefill_graphs[key] = g
            self._file_graph(g, "serving.prefill", _prefill_key(*key),
                             _prefill_label(*key), primer=primer)
            del primer
        return g

    def _count_capture(self, g: PrefillGraph) -> PrefillGraph:
        self._prefill_captures += 1
        self._prefill_capture_s += g.capture_s
        return g

    def _memory_short(self) -> bool:
        """Whether the card could not hold a ``max_len`` prefill's dense
        buffer twice over (``cudaMemGetInfo``'s free memory and what the
        caching allocator holds unused) beside the static stacked caches of
        the dense tier's buckets not captured yet, or the host has less
        than ``_HOST_AVAILABLE_SHARE`` of its memory available. A prefill
        graph holds its executable on both, and the shared pool's
        temporaries are reused by the next capture."""
        cfg = self.kv.config
        owed = 0
        if self.decode_path == "dense":
            owed = sum(_dense_bytes(cfg, b) for b in self.config.buckets
                       if b not in self._graphs)
        free = torch.cuda.mem_get_info(self.device)[0] \
            + torch.cuda.memory_reserved(self.device) \
            - torch.cuda.memory_allocated(self.device)
        host = _host_memory()
        return free < 2 * _dense_bytes(cfg, 1) + owed or (
            host is not None and host[0] < host[1] * _HOST_AVAILABLE_SHARE)

    def warmup(self, prompt_lens: Sequence[int] = ()) -> "Engine":
        """Make every batch bucket and the full prefill of each of
        ``prompt_lens`` ready before the first request: on a card capture
        their graphs (on the engine's stream), on the CPU run each once.
        Writes nothing outside page 0."""
        if self.stream is not None:
            with torch.cuda.stream(self.stream):
                return self._warmup(prompt_lens)
        return self._warmup(prompt_lens)

    def _warmup(self, prompt_lens: Sequence[int]) -> "Engine":
        S = self.kv.config.pages_per_slot
        on_card = self.device.type == "cuda"
        for b in self.config.buckets:
            if on_card:
                self.decode_graph(b)
            else:
                self._decode(np.zeros((b, 1), np.int64),
                             np.zeros((b, S), np.int32),
                             np.zeros((b,), np.int32))
        for lp in prompt_lens:
            if on_card:
                self.prefill_graph(0, int(lp))
            else:
                self._prefill(np.zeros((int(lp),), np.int32),
                              np.zeros((S,), np.int32))
        return self

    def decode_stats(self) -> Dict[str, object]:
        """The step loop's counts so far: ``steps`` (decode steps by their
        live rows), ``replays`` (decode graph replays by bucket),
        ``prefills`` (``"full"`` and ``"tail"`` admissions),
        ``prefill_replays`` (prefill graph replays by ``(start, n)``, with
        those of dropped graphs), ``prefill_graphs`` (prefill graphs
        captured), ``prefill_graphs_live`` (those kept),
        ``prefill_evictions`` (those dropped) and ``prefill_capture_s``
        (seconds their warm-ups and captures took). The CPU engine replays
        and captures nothing."""
        with self._graph_lock:
            replays = {b: g.replays for b, g in sorted(self._graphs.items())}
            prefill_replays = dict(self._evicted_replays)
            for k, g in self._prefill_graphs.items():
                prefill_replays[k] = prefill_replays.get(k, 0) + g.replays
            graphs = {"prefill_replays": dict(sorted(prefill_replays.items())),
                      "prefill_graphs": self._prefill_captures,
                      "prefill_graphs_live": len(self._prefill_graphs),
                      "prefill_evictions": self._prefill_evictions,
                      "prefill_capture_s": self._prefill_capture_s}
        with self._slot_lock:
            return {"steps": dict(self._batch_sizes), "replays": replays,
                    "prefills": dict(self._prefills), **graphs}

    # -- request surface ----------------------------------------------------
    def _pages_needed(self, request: GenerationRequest) -> int:
        last = min(self.config.max_len,
                   int(request.prompt.size) + request.max_new_tokens)
        return self.kv.pages_for(last)

    def _prefill_cost(self, request: GenerationRequest) -> int:
        """The scheduler's admission cost: prompt tokens the prefill will
        compute, the full prompt less the resident prefix chain (a peek:
        admission claims the chain itself)."""
        shared = self.kv.peek_prefix_pages(request.prompt) \
            * self.config.page_size
        return max(1, int(request.prompt.size) - shared)

    def prefix_summary(self) -> frozenset:
        """The pool's resident chain digests."""
        return self.kv.prefix_summary()

    @property
    def prefix_sharing_enabled(self) -> bool:
        return self._share_prefix

    def prefill_token_stats(self) -> Tuple[int, int]:
        """``(requested, computed)`` prompt tokens over all admissions."""
        with self._slot_lock:
            return (self._prefill_tokens_requested,
                    self._prefill_tokens_computed)

    def submit(self, request: GenerationRequest):
        """Enqueue; returns a Future resolving to GenerationResult. Raises
        QueueFull, DeadlineExceeded (shed on arrival), EngineStopped
        (draining) or ValueError (the request can never fit) here. With
        tracing on, the request gets its own trace root here, carried
        through the queue to the step thread."""
        ctx = _trace.new_trace(f"request-{request.request_id}",
                               rid=request.request_id) \
            if _trace.enabled() else None
        with _trace.span("serving.submit", parent=ctx,
                         rid=request.request_id):
            return self._submit(request, ctx)

    def _submit(self, request: GenerationRequest, ctx):
        if int(request.prompt.size) + request.max_new_tokens \
                > self.config.max_len:
            raise ValueError(
                f"prompt ({request.prompt.size}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_len "
                f"{self.config.max_len}")
        if self._pages_needed(request) > self.kv.config.num_pages - 1:
            raise ValueError("request needs more pages than the pool holds")
        with self._submit_lock:
            if self._draining.is_set():
                _obs.inc("serving.requests_total", status="rejected")
                _obs.inc("serving.rejected_total", reason="shed")
                raise EngineStopped("engine is draining/stopped: not "
                                    "admitting")
            fut = self.scheduler.submit(request, submit_time=time.monotonic(),
                                        trace_ctx=ctx)
        self._wake.set()
        return fut

    def cancel(self, request_id: int) -> bool:
        ok = self.scheduler.cancel(request_id)
        self._wake.set()
        return ok

    @property
    def active_requests(self) -> int:
        with self._slot_lock:
            return len(self._slots)

    @property
    def queue_depth(self) -> int:
        return self.scheduler.queue_depth

    @property
    def beacon(self) -> str:
        """This engine's ``/healthz`` component name."""
        return self._beacon

    @property
    def draining(self) -> bool:
        """True once ``stop(drain=...)`` latched new admissions off: the
        router takes a draining replica out of rotation."""
        return self._draining.is_set()

    # -- the step loop ------------------------------------------------------
    def step(self) -> bool:
        """One step boundary: evict cancellations, admit what fits, run one
        batched decode step. Returns False when there was nothing to do.
        While draining only crash-recovery requeues are admitted: they are
        work in flight, not new work."""
        if self._obs_http is not None or _obs.enabled():
            _trace.heartbeat(self._beacon, ttl_s=_HEARTBEAT_TTL_S)
        if self.stream is not None:
            with torch.cuda.stream(self.stream):
                return self._step()
        return self._step()

    def _step(self) -> bool:
        if self._quarantined:
            self._await_quarantine()
        progressed = self._process_cancellations()
        progressed |= self._admit(replay_only=self._draining.is_set())
        metrics = _obs.enabled()
        if not self._slots:
            if metrics:
                self._publish_gauges(0, 0)
            return progressed
        included = self._fault_gate() if _faults._SCHEDULE is not None \
            else list(self._slots)
        if included:
            self._decode_step(included)
            progressed = True
        if metrics:
            self._publish_gauges(len(included), self._bucket_for(
                len(included)) if included else 0)
        return progressed

    def run(self) -> None:
        """Drive step() until queue and slots drain (offline mode). Clears
        the draining latch first, so run() after ``stop(drain=True,
        on_timeout="requeue")`` resumes the requeued work."""
        self._stop.clear()
        self._draining.clear()
        self._swept = False
        while self.scheduler.queue_depth or self._slots:
            self.step()

    def start(self) -> "Engine":
        """Serve from a background thread until stop(). Re-entrant after a
        stop: clears the draining latch, so requests requeued by
        ``stop(drain=True, on_timeout="requeue")`` resume decoding."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._draining.clear()
        self._swept = False

        def loop():
            me = threading.current_thread()
            # an abandoned loop thread that comes back leaves at once, even
            # when a later start() cleared the stop flag
            while not self._stop.is_set() and self._thread is me:
                if not self.step():
                    self._wake.wait(0.01)
                    self._wake.clear()

        self._thread = threading.Thread(target=loop, name="serving-engine",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = False, timeout: Optional[float] = None,
             on_timeout: str = "fail") -> None:
        """Stop serving.

        ``drain=False`` pauses where it stands: in-flight slots and the
        queue stay, and ``start()`` resumes them.

        ``drain=True`` stops admitting (``submit`` raises
        :class:`EngineStopped`), keeps stepping until every in-flight
        sequence finishes or ``timeout`` seconds pass, then resolves the
        stragglers: ``on_timeout="fail"`` fails still-active slots with
        :class:`DrainTimeout` and never-admitted requests with
        :class:`EngineStopped`; ``on_timeout="requeue"`` puts the active
        ones back at the queue head with their tokens so far (prompt +
        tokens re-prefilled, not counted as a replay) and leaves the queue,
        so a later ``start()`` resumes where the drain stopped.

        Idempotent, callable from any thread but the step thread (a
        stream callback calling it raises; use :meth:`cancel`). The join
        is bounded by the budget + 1 s, or by ``PADDLE_TPU_STOP_JOIN_S``
        (default 30 s) without one: a loop thread still wedged in a device
        call past it is logged, its stragglers are resolved anyway, and the
        thread is abandoned as a zombie (it launches nothing more, its late
        return is dropped, and its graphs and freed pages are quarantined
        until its last replay completed)."""
        if on_timeout not in ("fail", "requeue"):
            raise ValueError(f"on_timeout must be fail|requeue, "
                             f"got {on_timeout!r}")
        if self._thread is not None \
                and threading.current_thread() is self._thread:
            raise RuntimeError("Engine.stop() called from the engine step "
                               "thread; use cancel()")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._slot_lock:
            self._drain_on_timeout = on_timeout if drain else "requeue"
        graceful = False
        if drain:
            with self._submit_lock:
                self._draining.set()
            self._wake.set()
            try:
                _faults.fault_point("serving.drain")
                graceful = True
            except Exception:
                # an injected drain fault degrades to an immediate stop:
                # no Future may be stranded either way
                graceful = False
        if graceful:
            def owed() -> bool:
                with self._slot_lock:
                    busy = bool(self._slots) or self._in_transit > 0
                return busy or self.scheduler.queued_replays() > 0

            if self._thread is not None:
                while owed() and not self._stop.is_set():
                    if deadline is not None and time.monotonic() >= deadline:
                        break
                    jitter_sleep(0.002)
            else:
                while owed() and (deadline is None
                                  or time.monotonic() < deadline):
                    self.step()
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            if deadline is None:
                join_s = _env_seconds("PADDLE_TPU_STOP_JOIN_S") \
                    or _STOP_JOIN_S
            else:
                join_s = max(0.0, deadline - time.monotonic()) \
                    + _JOIN_GRACE_S
            t.join(timeout=join_s)
            if t.is_alive():
                _log.warning(
                    "serving stop(): loop thread still wedged in a device "
                    "call past the drain budget; resolving stragglers "
                    "without it, its late return is abandoned")
                self._abandon(t)
        self._thread = None
        if self._watchdog is not None:
            self._watchdog.stop()
        if drain:
            # a wedged loop thread may be mid-admission (popped, prefill in
            # flight): give that window one bounded grace to land
            grace = time.monotonic() + _JOIN_GRACE_S
            while time.monotonic() < grace:
                with self._slot_lock:
                    if self._in_transit == 0:
                        break
                jitter_sleep(0.002)
            with self._slot_lock:
                self._swept = True
            self._resolve_stragglers(on_timeout)
        _trace.heartbeat_clear(self._beacon)
        _trace.maybe_export_chrome("serving")

    def _abandon(self, thread: threading.Thread) -> None:
        """Quarantine a loop thread ``stop()`` gave up on: it launches
        nothing more, and the engine's next step waits for every graph's
        last replay (the thread's queued copies may still read the
        staging, and its queued kernels still write its pages)."""
        self._zombies.add(thread.ident)
        # wait out a launch in progress (an enqueue on a card, the eager
        # step on the CPU); past the bound, the thread is wedged inside one
        if self._launch_lock.acquire(timeout=_JOIN_GRACE_S):
            self._launch_lock.release()
        else:
            _log.warning("serving stop(): the abandoned loop thread holds "
                         "the launch lock; quarantining without it")
        self._quarantined = True

    def _await_quarantine(self) -> None:
        """Before a step refills a staging buffer an abandoned step's
        copies may still read, or reuses a page its kernels may still
        write: wait for every graph's last replay."""
        with self._graph_lock:
            graphs = [*self._graphs.values(), *self._prefill_graphs.values()]
        for g in graphs:
            g.done.synchronize()
        self._quarantined = False

    def _resolve_stragglers(self, on_timeout: str) -> None:
        """A drain's terminal accounting: every straggler fails
        (``fail``) or is requeued resumable (``requeue``)."""
        requeue: List[_Pending] = []
        for slot in list(self._slots):
            pend = slot.pending
            if on_timeout == "requeue":
                # not a fault: it spends no replay budget; a restarted
                # engine re-prefills prompt + tokens and continues
                if not self._release(slot):
                    continue
                pend.replay_tokens = list(slot.tokens)
                requeue.append(pend)
            else:
                self._finish_error(slot, DrainTimeout(
                    f"request {slot.request.request_id} evicted at drain "
                    f"timeout after {len(slot.tokens)} tokens"))
        if requeue:
            self.scheduler.requeue(requeue)
        if on_timeout == "fail":
            for pend in self.scheduler.drain_queue():
                # settle the Future before the telemetry calls
                if pend.replays or pend.replay_tokens:
                    # admitted and decoding when recovery requeued it
                    pend.future.set_exception(DrainTimeout(
                        f"request {pend.request.request_id} evicted at "
                        f"drain timeout awaiting replay re-admission "
                        f"after {len(pend.replay_tokens)} tokens"))
                    _obs.inc("serving.requests_total", status="failed")
                    _trace.instant("serving.fault", parent=pend.trace_ctx,
                                   rid=pend.request.request_id,
                                   error="DrainTimeout")
                    continue
                pend.future.set_exception(EngineStopped(
                    f"request {pend.request.request_id} never admitted: "
                    f"engine stopped"))
                _obs.inc("serving.requests_total", status="shed")
                _obs.inc("serving.rejected_total", reason="shed")
                _trace.instant("serving.shed", parent=pend.trace_ctx,
                               rid=pend.request.request_id,
                               reason="engine_stopped")

    # -- step phases ----------------------------------------------------------
    def _process_cancellations(self) -> bool:
        cancelled = self.scheduler.take_cancelled_active()
        if not cancelled:
            return False
        hit = False
        for slot in [s for s in self._slots
                     if s.request.request_id in cancelled]:
            self._finish(slot, "cancelled")
            hit = True
        return hit

    def _admit(self, replay_only: bool = False) -> bool:
        free_slots = self.config.max_batch - len(self._slots)
        if free_slots <= 0:
            return False
        # pages reserved by this boundary's earlier admissions: free_pages
        # alone would let every queued request pass against the same pages
        claimed = 0

        def can_fit(req: GenerationRequest) -> bool:
            nonlocal claimed
            need = self._pages_needed(req)
            if claimed + need > self.kv.free_pages:
                return False
            claimed += need
            return True

        # hold one unit of in-transit across the pop, so the drain's probe
        # never reads the pop's window as nothing left to finish
        with self._slot_lock:
            self._in_transit += 1
        try:
            pending = self.scheduler.next_admissions(
                free_slots, can_fit, replay_only=replay_only)
        except BaseException:
            with self._slot_lock:
                self._in_transit -= 1
            raise
        admitted = False
        with self._slot_lock:
            self._in_transit += len(pending) - 1
        try:
            for i, p in enumerate(pending):
                status = self._admit_one(p)
                with self._slot_lock:
                    self._in_transit -= 1
                admitted |= status == "ok"
                if status == "noroom":
                    # the pool could not cover what can_fit reserved (single
                    # consumer: not expected); put this one and the rest back
                    self.scheduler.requeue(pending[i:])
                    break
        except BaseException as exc:
            # the popped requests behind this one go back in order; this one
            # fails (unless already resolved), and the error surfaces
            self.scheduler.requeue(pending[i + 1:])
            if not p.future.done():
                p.future.set_exception(exc)
            raise
        finally:
            with self._slot_lock:
                self._in_transit = 0
        return admitted

    def _deadline_ctx(self, pendings: Sequence[_Pending]):
        """The ambient deadline for work done on behalf of ``pendings``:
        the tightest ``submit_time + deadline_s`` among them as a
        ``resilience.deadline_scope``, or a no-op when none carries one."""
        until = [p.submit_time + p.request.deadline_s for p in pendings
                 if p.submit_time and p.request.deadline_s is not None]
        return deadline_scope(until=min(until)) if until else nullcontext()

    def _admit_one(self, pending: _Pending) -> str:
        """Admit one popped request: ``"ok"``, ``"failed"`` (its future
        holds the error) or ``"noroom"`` (untouched; the caller requeues
        it). A replayed request (``pending.replay_tokens``) re-prefills
        prompt + the tokens already generated, and re-acquires its shared
        prefix, so it continues as a never-faulted run would."""
        req = pending.request
        prompt = req.prompt
        if pending.replay_tokens:
            prompt = np.concatenate([
                prompt, np.asarray(pending.replay_tokens, np.int32)])
        shared: List[int] = []
        if self._share_prefix:
            shared = self.kv.acquire_prefix(prompt)
        try:
            pages = self.kv.alloc(self._pages_needed(req) - len(shared))
        except BaseException:
            if shared:
                self.kv.free(shared)
            raise
        if pages is None:
            if shared:
                self.kv.free(shared)
            return "noroom"
        pages = shared + pages
        start = len(shared) * self.config.page_size
        row = self.kv.table_row(pages)
        try:
            with _trace.span("serving.prefill", parent=pending.trace_ctx,
                             rid=req.request_id, prompt=int(prompt.size),
                             shared_pages=len(shared),
                             replay=len(pending.replay_tokens)), \
                    self._deadline_ctx([pending]):
                for attempt in (0, 1):
                    try:
                        _faults.fault_point("serving.admit")
                        break
                    except Exception as exc:
                        if attempt:
                            raise exc
                        _obs.inc("serving.admit_retries_total")
                        _trace.instant("serving.fault",
                                       parent=pending.trace_ctx,
                                       rid=req.request_id,
                                       site="serving.admit", retried=True,
                                       error=type(exc).__name__)
                first_tok = self._prefill(prompt, row, start)
            if self._share_prefix:
                # full prompt pages are frozen now: decode writes land at
                # t >= prompt length. Over the original prompt only: a
                # replay's tokens are generated content
                self.kv.publish(req.prompt, pages)
        except _Abandoned:
            # stop() gave up on this thread before the launch: resolve the
            # request as the drain resolved its stragglers
            self.kv.free(pages)
            self._late(pending)
            return "failed"
        except Exception as exc:
            self.kv.free(pages)     # shared pages lose one reference
            _obs.inc("serving.requests_total", status="failed")
            _trace.instant("serving.fault", parent=pending.trace_ctx,
                           rid=req.request_id, site="serving.admit",
                           error=type(exc).__name__)
            pending.future.set_exception(exc)
            return "failed"
        now = time.monotonic()
        _obs.inc("serving.prefills_total")
        _obs.inc("serving.prefill_tokens_requested_total", float(prompt.size))
        _obs.inc("serving.prefill_tokens_computed_total",
                 float(prompt.size - start))
        slot = _Slot(pending=pending, page_ids=pages, table_row=row,
                     t=int(prompt.size), last_tok=first_tok,
                     tokens=list(pending.replay_tokens),
                     first_token_time=now, last_token_time=now,
                     shared_pages=len(shared),
                     until=(pending.submit_time + req.deadline_s
                            if pending.submit_time
                            and req.deadline_s is not None else None))
        # one event for a concurrent budgeted stop() sweeping stragglers
        with self._slot_lock:
            self._slots.append(slot)
            self._deadline_slots += slot.until is not None
            self._prefill_tokens_requested += int(prompt.size)
            self._prefill_tokens_computed += int(prompt.size) - start
            self._prefills["tail" if start else "full"] += 1
            late_dead = self._swept
        if late_dead:
            # in flight on a wedged loop thread when a budgeted drain swept
            # the stragglers: nobody will step this slot
            if self._release(slot):
                self._late(pending, slot.tokens)
            return "ok"
        self._emit_token(slot, first_tok, now, first=True,
                         metrics=_obs.enabled())
        return "ok"

    def _late(self, pending: _Pending, tokens: Sequence[int] = ()) -> None:
        """Resolve a request that left the queue but whose admission
        finished after a drain resolved its stragglers, per the drain's
        mode: requeued with its tokens, or failed."""
        with self._slot_lock:
            mode = self._drain_on_timeout
        if mode == "requeue":
            pending.replay_tokens = list(pending.replay_tokens or tokens)
            self.scheduler.requeue([pending])
            return
        _obs.inc("serving.requests_total", status="failed")
        pending.future.set_exception(DrainTimeout(
            f"request {pending.request.request_id} admitted after the "
            f"drain resolved its stragglers"))

    def _fault_gate(self) -> List[_Slot]:
        """The per-slot ``serving.step`` seam, in admission order. A faulted
        slot sits this step out; everyone else proceeds."""
        included: List[_Slot] = []
        for slot in list(self._slots):
            try:
                _faults.fault_point("serving.step")
            except Exception as exc:
                slot.faults += 1
                if slot.faults > 1:
                    self._finish_error(slot, exc)
                else:
                    _obs.inc("serving.step_retries_total")
                    _trace.instant("serving.fault",
                                   parent=slot.pending.trace_ctx,
                                   rid=slot.request.request_id,
                                   site="serving.step", retried=True,
                                   error=type(exc).__name__)
                continue
            included.append(slot)
        return included

    def _bucket_for(self, n: int) -> int:
        for b in self.config.buckets:
            if b >= n:
                return b
        raise AssertionError(f"no bucket for batch {n}")  # __post_init__

    def _decode_step(self, included: List[_Slot]) -> None:
        if not _trace.enabled():
            self._decode_step_traced(included, False)
            return
        if self._engine_trace is None:
            self._engine_trace = _trace.new_trace("serving-engine")
        with _trace.span("serving.decode", parent=self._engine_trace,
                         batch=len(included)):
            self._decode_step_traced(included, True)

    def _decode_step_traced(self, included: List[_Slot],
                            traced: bool) -> None:
        bucket = self._bucket_for(len(included))
        S = self.kv.config.pages_per_slot
        tok = np.zeros((bucket, 1), np.int64)
        t = np.zeros((bucket,), np.int32)
        tables = np.zeros((bucket, S), np.int32)   # padded rows -> scratch
        for i, slot in enumerate(included):
            tok[i, 0] = slot.last_tok
            t[i] = slot.t
            tables[i] = slot.table_row
        if self.device.type == "cuda":
            # capture a bucket first met here before the watchdog's window
            self.decode_graph(bucket)
        self._unread = None
        wd = self._watchdog
        with (self._deadline_ctx([s.pending for s in included])
              if self._deadline_slots else nullcontext()):
            for attempt in (0, 1):
                gen = wd.arm() if wd is not None else None
                try:
                    # the device-step seam: delay = a hung step (trips the
                    # watchdog), error = a whole-batch fault
                    _faults.fault_point("serving.watchdog")
                    next_np = self._decode(tok, tables, t)
                except _Abandoned:
                    if gen is not None:
                        wd.disarm(gen)
                    return
                except Exception as exc:
                    if gen is not None:
                        wd.disarm(gen)
                    # a fault before the launch wrote nothing, and after the
                    # launch the retry reads the same output again
                    # (_unread): retry once, then recover by replay
                    if attempt:
                        self._unread = None
                        self._recover_slots(included, exc)
                        return
                    _obs.inc("serving.step_retries_total")
                    continue
                verdict = wd.disarm(gen) if gen is not None else None
                if verdict is not None:
                    # tripped: abandon the outputs (the step wrote only its
                    # slots' own pages, which recovery frees) and replay
                    self._recover_slots(included, WatchdogTimeout(
                        f"decode step classified {verdict} by the watchdog "
                        f"(budget {wd.timeout_s:.3f}s)"))
                    return
                break
        with self._slot_lock:
            abandoned = any(s not in self._slots for s in included)
            if not abandoned:
                self._batch_sizes[len(included)] += 1
        if abandoned:
            # a budgeted stop() resolved these slots while the step was in
            # flight: no late token reaches a settled Future
            return
        now = time.monotonic()
        metrics = _obs.enabled()
        if metrics:
            _obs.inc("serving.steps_total")
            _obs.inc("serving.paged_attention_steps_total",
                     path=self.decode_path)
        for i, slot in enumerate(included):
            slot.t += 1
            if traced and len(slot.tokens) % _DECODE_TRACE_EVERY == 0:
                _trace.instant("serving.decode_step",
                               parent=slot.pending.trace_ctx,
                               rid=slot.request.request_id, t=slot.t,
                               tokens=len(slot.tokens))
            self._emit_token(slot, int(next_np[i]), now, metrics=metrics)

    def _emit_token(self, slot: _Slot, token: int, now: float,
                    first: bool = False, metrics: bool = False) -> None:
        req = slot.request
        slot.tokens.append(token)
        slot.last_tok = token
        if metrics:
            _obs.inc("serving.tokens_total")
            if first:
                # a replay's re-prefill lands here too: TTFT is observed
                # for the request's true first token only
                sub = slot.pending.submit_time
                if sub and not slot.pending.ttft_done:
                    _obs.observe("serving.ttft_seconds", now - sub)
            else:
                _obs.observe("serving.tpot_seconds",
                             now - slot.last_token_time)
        if first:
            slot.pending.ttft_done = True
        slot.last_token_time = now
        if req.stream is not None:
            try:
                req.stream(req.request_id, token)
            except Exception as exc:
                # a raising callback fails its own request, not the batch
                self._finish_error(slot, exc)
                return
        if req.eos_token_id is not None and token == req.eos_token_id:
            self._finish(slot, "eos")
        elif len(slot.tokens) >= req.max_new_tokens \
                or slot.t >= self.config.max_len:
            self._finish(slot, "length")

    def _release(self, slot: _Slot) -> bool:
        """Evict ``slot`` and return its pages; False when it was already
        released (a wedged step returning after a budgeted stop() resolved
        it must not free pages twice or settle a Future again)."""
        with self._slot_lock:
            if slot not in self._slots:
                return False
            self._slots.remove(slot)
            self._deadline_slots -= slot.until is not None
        self.kv.free(slot.page_ids)
        return True

    def _finish(self, slot: _Slot, reason: str) -> None:
        if not self._release(slot):
            return
        _obs.inc("serving.requests_total", status=(
            "completed" if reason in ("eos", "length") else reason))
        _trace.instant("serving.complete", parent=slot.pending.trace_ctx,
                       rid=slot.request.request_id, reason=reason,
                       tokens=len(slot.tokens))
        n = len(slot.tokens)
        tpot = ((slot.last_token_time - slot.first_token_time) / (n - 1)
                if n > 1 else None)
        sub = slot.pending.submit_time
        slot.pending.future.set_result(GenerationResult(
            slot.request.request_id, slot.tokens, reason,
            ttft_s=slot.first_token_time - sub if sub else None,
            tpot_s=tpot))

    def _finish_error(self, slot: _Slot, exc: BaseException) -> None:
        if not self._release(slot):
            return
        _obs.inc("serving.requests_total", status="failed")
        # a faulted request's trace carries the fault event, whatever path
        # resolved it
        _trace.instant("serving.fault", parent=slot.pending.trace_ctx,
                       rid=slot.request.request_id,
                       error=type(exc).__name__)
        slot.pending.future.set_exception(exc)

    def _recover_slots(self, included: List[_Slot],
                       exc: BaseException) -> None:
        """Crash recovery for an unrecoverable batched step (a fault after
        the retry, or a watchdog trip): every included slot is evicted with
        its pages reclaimed and, replay budget permitting, requeued at the
        queue head with its prompt + tokens so far; past ``max_replays``
        its Future gets ``exc``. The flight recorder dumps first."""
        requeue: List[_Pending] = []
        _trace.record("serving.recover", error=type(exc).__name__,
                      slots=len(included))
        _trace.flight_dump("serving_recover", error=type(exc).__name__,
                           slots=len(included))
        # cover the eviction -> requeue gap for the drain's probe
        with self._slot_lock:
            self._in_transit += len(included)
        try:
            for slot in list(included):
                pend = slot.pending
                if pend.replays >= self.config.max_replays:
                    self._finish_error(slot, exc)
                    continue
                if not self._release(slot):
                    # already resolved by a budgeted stop()
                    continue
                pend.replays += 1
                pend.replay_tokens = list(slot.tokens)
                _obs.inc("serving.replays_total")
                _trace.instant("serving.replay", parent=pend.trace_ctx,
                               rid=pend.request.request_id,
                               replays=pend.replays,
                               error=type(exc).__name__)
                requeue.append(pend)
            if requeue:
                self.scheduler.requeue(requeue)
                self._wake.set()
        finally:
            with self._slot_lock:
                self._in_transit -= len(included)

    def _publish_gauges(self, active: int, bucket: int) -> None:
        _obs.set_gauge("serving.active_slots", len(self._slots))
        _obs.set_gauge("serving.batch_utilization",
                       active / bucket if bucket else 0.0)
