"""The serving step loop: continuous batching over a paged KV pool. The
port of ``paddle_tpu/serving/engine.py``.

* The model enters as two callables (``LlamaForCausalLM.serving_callables``):

  - ``prefill_fn(ids (1, Lp), cache (L, 2, 1, H, M, D)) -> (first_token
    (1, 1), cache)``, filling positions ``[0, Lp)`` of ``cache`` in place;
  - ``step_fn(tok (B, 1), cache: PagedDecodeCache, t (B,)) -> (next_token
    (B, 1), cache)``, whose attention reads the pool through the page
    tables and writes position ``t`` into it.

* Batch rows are assigned to active slots per step (per-slot state is on
  the host: a page-table row, a position, the last token), so the batch is
  compact. It is padded up to a bucket size (default {1, 4, 16}); padded
  rows read and write only the scratch page.

* Admission happens at step boundaries by prefill-into-slot: the scheduler
  pops what fits (a slot, and pages for the request's whole lifetime), the
  prompt is prefilled into a buffer of the prompt's pages
  (``M = pages * page_size``), the buffer is stored into the pool
  (``kv_cache.scatter_prefill_pages``), and the first token is emitted.

* A slot is evicted on eos, on length, or on cancel; its pages return to
  the pool.

The pool is updated **in place** (the JAX engine threads it through its
compiled programs as functional state). The JAX engine's fault sites,
watchdog, replay, prefix sharing, metrics and traces are later slices.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.paged_attention import PagedDecodeCache
from . import kv_cache as _kv
from .scheduler import (GenerationRequest, GenerationResult, Scheduler,
                        _Pending)

__all__ = ["ServingConfig", "Engine", "EngineStopped", "DrainTimeout"]

# bound on joining the loop thread when stop() was given no drain budget
_STOP_JOIN_S = 30.0


class EngineStopped(RuntimeError):
    """The engine is draining or stopped: ``submit`` rejects new work, and
    queued requests that were never admitted resolve with this at a
    drained stop."""


class DrainTimeout(EngineStopped):
    """An admitted request was still decoding when the drain budget ran
    out."""


@dataclass
class ServingConfig:
    """Engine sizing and policy. The model-shape fields must match the
    cache layout the callables consume (``num_heads`` counts KV heads)."""

    num_layers: int
    num_heads: int
    head_dim: int
    max_len: int
    max_batch: int = 16
    buckets: Tuple[int, ...] = (1, 4, 16)
    max_queue: int = 64
    page_size: int = 64
    num_pages: Optional[int] = None      # default: full coverage + scratch
    kv_dtype: str = "native"             # native | bf16 | int8
    compute_dtype: str = "float32"       # float32 | bfloat16
    policy: str = "fifo"
    prefill_token_budget: Optional[int] = None
    device: Optional[str] = None         # None -> cuda (raises without one)

    def __post_init__(self):
        self.buckets = tuple(sorted(set(int(b) for b in self.buckets)))
        if not self.buckets or self.buckets[-1] < self.max_batch:
            raise ValueError(f"buckets {self.buckets} must cover max_batch "
                             f"{self.max_batch}")

    def kv_config(self) -> _kv.KVCacheConfig:
        cfg = _kv.KVCacheConfig(
            num_layers=self.num_layers, num_heads=self.num_heads,
            head_dim=self.head_dim, max_len=self.max_len,
            page_size=self.page_size, num_pages=self.num_pages,
            compute_dtype=self.compute_dtype, kv_dtype=self.kv_dtype)
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
    first_token_time: float = 0.0
    last_token_time: float = 0.0

    @property
    def request(self) -> GenerationRequest:
        return self.pending.request


class Engine:
    """Continuous-batching decode engine over a paged KV pool.

    ``step()`` is single-consumer (your own loop, :meth:`run`, or the
    :meth:`start` thread); ``submit`` and ``cancel`` are safe from any
    thread."""

    def __init__(self, prefill_fn: Callable, step_fn: Callable,
                 config: ServingConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self._prefill_fn = prefill_fn
        self._step_fn = step_fn
        self.kv = _kv.PagedKVCache(config.kv_config(), self.device)
        self.scheduler = Scheduler(
            max_queue=config.max_queue, policy=config.policy,
            prefill_token_budget=config.prefill_token_budget)
        self._slots: List[_Slot] = []    # admission order == batch row order
        self._slot_lock = threading.Lock()
        # orders submit's draining check + enqueue against stop's latch, so
        # a request is either refused or swept by the drain, never stranded
        self._submit_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- device calls -------------------------------------------------------
    def _prefill(self, prompt: np.ndarray, row: np.ndarray) -> int:
        """Prefill ``prompt`` into the pages of ``row``; returns the first
        token (one host sync)."""
        cfg = self.kv.config
        n = self.kv.pages_for(int(prompt.size))
        dense = torch.zeros(
            (cfg.num_layers, 2, 1, cfg.num_heads, n * cfg.page_size,
             cfg.head_dim), dtype=cfg.torch_compute_dtype, device=self.device)
        ids = torch.as_tensor(prompt[None, :], dtype=torch.int64,
                              device=self.device)
        with torch.no_grad():
            nxt, dense = self._prefill_fn(ids, dense)
            _kv.scatter_prefill_pages(
                dense, self.kv.pool, self.kv.scales,
                torch.as_tensor(row[:n], device=self.device),
                int(prompt.size), cfg.page_size)
        return int(nxt.reshape(-1)[0])

    def _decode(self, tok: np.ndarray, tables: np.ndarray,
                t: np.ndarray) -> np.ndarray:
        """One batched decode step over the pool; returns next tokens
        (bucket,) (one host sync)."""
        dev = self.device
        t_d = torch.as_tensor(t, device=dev)
        view = PagedDecodeCache(
            pool=self.kv.pool, tables=torch.as_tensor(tables, device=dev),
            t=t_d, page_size=self.kv.config.page_size, scales=self.kv.scales)
        with torch.no_grad():
            nxt, _ = self._step_fn(torch.as_tensor(tok, device=dev), view,
                                   t_d)
        return nxt.reshape(-1).cpu().numpy()

    def warmup(self, prompt_lens: Sequence[int] = ()) -> "Engine":
        """Run every batch bucket (and optional prefill lengths) once on the
        scratch page only: the kernels are built and loaded before the
        first request. Writes nothing outside page 0."""
        S = self.kv.config.pages_per_slot
        for b in self.config.buckets:
            self._decode(np.zeros((b, 1), np.int64), np.zeros((b, S), np.int32),
                         np.zeros((b,), np.int32))
        for lp in prompt_lens:
            self._prefill(np.zeros((int(lp),), np.int32),
                          np.zeros((S,), np.int32))
        return self

    # -- request surface ----------------------------------------------------
    def _pages_needed(self, request: GenerationRequest) -> int:
        last = min(self.config.max_len,
                   int(request.prompt.size) + request.max_new_tokens)
        return self.kv.pages_for(last)

    def submit(self, request: GenerationRequest):
        """Enqueue; returns a Future resolving to GenerationResult. Raises
        QueueFull, DeadlineExceeded (shed on arrival), EngineStopped
        (draining) or ValueError (the request can never fit) here."""
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
                raise EngineStopped("engine is draining/stopped: not "
                                    "admitting")
            fut = self.scheduler.submit(request,
                                        submit_time=time.monotonic())
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

    # -- the step loop ------------------------------------------------------
    def step(self) -> bool:
        """One step boundary: evict cancellations, admit what fits, run one
        batched decode step. Returns False when there was nothing to do."""
        progressed = self._process_cancellations()
        if not self._draining.is_set():
            progressed |= self._admit()
        if not self._slots:
            return progressed
        self._decode_step(list(self._slots))
        return True

    def run(self) -> None:
        """Drive step() until queue and slots drain (offline mode)."""
        self._stop.clear()
        self._draining.clear()
        while self.scheduler.queue_depth or self._slots:
            self.step()

    def start(self) -> "Engine":
        """Serve from a background thread until stop()."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._draining.clear()

        def loop():
            while not self._stop.is_set():
                if not self.step():
                    self._wake.wait(0.01)
                    self._wake.clear()

        self._thread = threading.Thread(target=loop, name="serving-engine",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = False,
             timeout: Optional[float] = None) -> None:
        """Stop serving. ``drain=False`` pauses where it stands (``start()``
        resumes). ``drain=True`` stops admitting, keeps stepping until every
        admitted request finishes or ``timeout`` seconds pass, then fails
        the still-active ones with :class:`DrainTimeout` and the
        never-admitted ones with :class:`EngineStopped`: every Future
        resolves and every page returns to the pool."""
        if self._thread is not None \
                and threading.current_thread() is self._thread:
            raise RuntimeError("Engine.stop() called from the engine step "
                               "thread; use cancel()")
        deadline = None if timeout is None else time.monotonic() + timeout
        if drain:
            with self._submit_lock:
                self._draining.set()
            self._wake.set()
            while self.active_requests and (
                    deadline is None or time.monotonic() < deadline):
                if self._thread is None:
                    self.step()
                else:
                    time.sleep(0.002)
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=_STOP_JOIN_S if deadline is None else
                   max(0.0, deadline - time.monotonic()) + 1.0)
            if t.is_alive():
                raise RuntimeError("serving loop thread did not stop")
        self._thread = None
        if drain:
            for slot in list(self._slots):
                self._finish_error(slot, DrainTimeout(
                    f"request {slot.request.request_id} evicted at drain "
                    f"timeout after {len(slot.tokens)} tokens"))
            for pend in self.scheduler.drain_queue():
                pend.future.set_exception(EngineStopped(
                    f"request {pend.request.request_id} never admitted: "
                    f"engine stopped"))

    # -- step phases ----------------------------------------------------------
    def _process_cancellations(self) -> bool:
        cancelled = self.scheduler.take_cancelled_active()
        hit = False
        for slot in [s for s in self._slots
                     if s.request.request_id in cancelled]:
            self._finish(slot, "cancelled")
            hit = True
        return hit

    def _admit(self) -> bool:
        free_slots = self.config.max_batch - len(self._slots)
        if free_slots <= 0:
            return False
        claimed = 0   # pages reserved by this boundary's earlier admissions

        def can_fit(req: GenerationRequest) -> bool:
            nonlocal claimed
            need = self._pages_needed(req)
            if claimed + need > self.kv.free_pages:
                return False
            claimed += need
            return True

        admitted = False
        for p in self.scheduler.next_admissions(free_slots, can_fit):
            admitted |= self._admit_one(p)
        return admitted

    def _admit_one(self, pending: _Pending) -> bool:
        req = pending.request
        pages = self.kv.alloc(self._pages_needed(req))
        if pages is None:     # can_fit reserved them: unreachable
            raise RuntimeError("page pool raced out from under admission")
        row = self.kv.table_row(pages)
        try:
            first_tok = self._prefill(req.prompt, row)
        except Exception as exc:
            self.kv.free(pages)
            pending.future.set_exception(exc)
            return False
        now = time.monotonic()
        slot = _Slot(pending=pending, page_ids=pages, table_row=row,
                     t=int(req.prompt.size), last_tok=first_tok,
                     first_token_time=now, last_token_time=now)
        with self._slot_lock:
            self._slots.append(slot)
        self._emit_token(slot, first_tok, now)
        return True

    def _bucket_for(self, n: int) -> int:
        for b in self.config.buckets:
            if b >= n:
                return b
        raise AssertionError(f"no bucket for batch {n}")  # __post_init__

    def _decode_step(self, included: List[_Slot]) -> None:
        bucket = self._bucket_for(len(included))
        S = self.kv.config.pages_per_slot
        tok = np.zeros((bucket, 1), np.int64)
        t = np.zeros((bucket,), np.int32)
        tables = np.zeros((bucket, S), np.int32)   # padded rows -> scratch
        for i, slot in enumerate(included):
            tok[i, 0] = slot.last_tok
            t[i] = slot.t
            tables[i] = slot.table_row
        next_np = self._decode(tok, tables, t)
        now = time.monotonic()
        for i, slot in enumerate(included):
            slot.t += 1
            self._emit_token(slot, int(next_np[i]), now)

    def _emit_token(self, slot: _Slot, token: int, now: float) -> None:
        req = slot.request
        slot.tokens.append(token)
        slot.last_tok = token
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
        with self._slot_lock:
            if slot not in self._slots:
                return False
            self._slots.remove(slot)
        self.kv.free(slot.page_ids)
        return True

    def _finish(self, slot: _Slot, reason: str) -> None:
        if not self._release(slot):
            return
        n = len(slot.tokens)
        tpot = ((slot.last_token_time - slot.first_token_time) / (n - 1)
                if n > 1 else None)
        sub = slot.pending.submit_time
        slot.pending.future.set_result(GenerationResult(
            slot.request.request_id, slot.tokens, reason,
            ttft_s=slot.first_token_time - sub if sub else None,
            tpot_s=tpot))

    def _finish_error(self, slot: _Slot, exc: BaseException) -> None:
        if self._release(slot):
            slot.pending.future.set_exception(exc)
