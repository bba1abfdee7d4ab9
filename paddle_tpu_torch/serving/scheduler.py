"""Continuous-batching admission control: the request queue and policies.
The port of ``paddle_tpu/serving/scheduler.py`` (metrics and tracing are
not ported yet).

The scheduler owns a request until it holds a slot: the bounded FIFO queue
(``max_queue``; overflow raises :class:`QueueFull` at ``submit``),
cancellation of queued requests, deadline shedding, and the admission
decision the engine asks for at every step boundary.

Policies:

* ``fifo`` -- strict arrival order. If the head request does not fit (no
  free slot, or the page pool cannot cover its whole lifetime), admission
  stops: a large request is never starved by small ones slipping past.
* ``budget`` -- FIFO plus a per-boundary prefill-token budget
  (``prefill_token_budget``): admission also stops once the prompt tokens
  admitted at this boundary would exceed it. Bounds the prefill stall a
  decode step can suffer (the TTFT/TPOT trade). A request's cost is
  ``prefill_cost(request)`` when the engine gives one (a prefix-sharing
  engine charges only the unshared tail), else its prompt length.

A request with ``deadline_s`` / ``ttft_budget_s`` that expires while queued
resolves with :class:`DeadlineExceeded`; one whose estimated queue wait
(EWMA of the admission interval x depth) already exceeds its budget is
refused at ``submit``. An admitted request is never shed.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

__all__ = ["GenerationRequest", "GenerationResult", "QueueFull",
           "DeadlineExceeded", "Scheduler"]

_EWMA_ALPHA = 0.3

_req_ids = itertools.count()


class DeadlineExceeded(TimeoutError):
    """A request's deadline or TTFT budget expired (or would, by the
    scheduler's wait estimate) before it was admitted."""


class QueueFull(RuntimeError):
    """submit() on a queue already holding ``max_queue`` requests."""


@dataclass(eq=False)   # identity equality: ``prompt`` is an ndarray
class GenerationRequest:
    """One decode job: a 1-D int32 prompt plus its stopping rule.

    ``stream(request_id, token)`` (optional) is called from the engine step
    thread as each token lands; a raising callback fails this request only.
    ``deadline_s`` bounds the request from submit while it is queued;
    ``ttft_budget_s`` bounds the wait for its first token."""

    prompt: np.ndarray
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    stream: Optional[Callable[[int, int], None]] = None
    deadline_s: Optional[float] = None
    ttft_budget_s: Optional[float] = None
    request_id: int = field(default_factory=lambda: next(_req_ids))

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        for name in ("deadline_s", "ttft_budget_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0 when set, got {v}")


@dataclass
class GenerationResult:
    """What a request's Future resolves to."""

    request_id: int
    tokens: List[int]
    finish_reason: str               # "eos" | "length" | "cancelled"
    ttft_s: Optional[float] = None   # submit -> first token
    tpot_s: Optional[float] = None   # mean inter-token time after the first


@dataclass(eq=False)
class _Pending:
    request: GenerationRequest
    future: "Future[GenerationResult]"
    submit_time: float = 0.0


class Scheduler:
    """Bounded queue + admission policy. Thread-safe; the engine is the
    only consumer (``next_admissions``), producers are any ``submit`` /
    ``cancel`` threads."""

    def __init__(self, max_queue: int = 64, policy: str = "fifo",
                 prefill_token_budget: Optional[int] = None,
                 prefill_cost: Optional[
                     Callable[[GenerationRequest], int]] = None):
        if policy not in ("fifo", "budget"):
            raise ValueError(f"unknown admission policy: {policy!r}")
        if policy == "budget" and not prefill_token_budget:
            raise ValueError("policy='budget' needs prefill_token_budget")
        self.max_queue = max_queue
        self.policy = policy
        self.prefill_token_budget = prefill_token_budget
        self.prefill_cost = prefill_cost
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._ewma_interval: Optional[float] = None
        self._last_pop_t: Optional[float] = None
        # ids cancelled while holding a slot; the engine evicts them at its
        # next step boundary
        self._cancelled_active: set = set()

    def _estimated_wait_locked(self) -> float:
        if self._ewma_interval is None:
            return 0.0
        return self._ewma_interval * len(self._queue)

    def _reset_wait_model_locked(self) -> None:
        # an empty queue makes both halves of the wait model stale
        self._last_pop_t = None
        self._ewma_interval = None

    def submit(self, request: GenerationRequest,
               submit_time: float = 0.0) -> "Future[GenerationResult]":
        fut: "Future[GenerationResult]" = Future()
        with self._lock:
            depth = len(self._queue)
            est = self._estimated_wait_locked()
            if depth >= self.max_queue:
                raise QueueFull(
                    f"serving queue full ({depth}/{self.max_queue} pending)")
            budget = min((b for b in (request.deadline_s,
                                      request.ttft_budget_s)
                          if b is not None), default=None)
            if submit_time and budget is not None and est > budget:
                raise DeadlineExceeded(
                    f"request {request.request_id} shed on arrival: "
                    f"estimated queue wait {est:.3f}s exceeds its "
                    f"{budget:.3f}s budget (queue depth {depth})")
            self._queue.append(_Pending(request, fut, submit_time))
        return fut

    def cancel(self, request_id: int) -> bool:
        """Queued: resolved ``cancelled`` now. Otherwise flagged for the
        engine's next step boundary (stale ids are ignored there)."""
        with self._lock:
            pend = None
            for i, p in enumerate(self._queue):
                if p.request.request_id == request_id:
                    pend = self._queue.pop(i)
                    break
            if pend is None:
                self._cancelled_active.add(request_id)
                return True
            if not self._queue:
                self._reset_wait_model_locked()
        pend.future.set_result(GenerationResult(request_id, [], "cancelled"))
        return True

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def take_cancelled_active(self) -> set:
        with self._lock:
            out, self._cancelled_active = self._cancelled_active, set()
        return out

    def shed_expired(self, now: Optional[float] = None) -> int:
        """Resolve queued requests whose deadline or TTFT budget expired
        with :class:`DeadlineExceeded`; returns how many."""
        now = time.monotonic() if now is None else now
        shed = []
        with self._lock:
            kept = []
            for p in self._queue:
                waited = now - p.submit_time
                r = p.request
                budget = min((b for b in (r.deadline_s, r.ttft_budget_s)
                              if b is not None), default=None)
                if p.submit_time and budget is not None and waited >= budget:
                    shed.append((p, waited, budget))
                else:
                    kept.append(p)
            self._queue = kept
            if not kept:
                self._reset_wait_model_locked()
        for p, waited, budget in shed:
            p.future.set_exception(DeadlineExceeded(
                f"request {p.request.request_id} expired in queue: waited "
                f"{waited:.3f}s against a {budget:.3f}s budget"))
        return len(shed)

    def next_admissions(self, free_slots: int,
                        can_fit: Callable[[GenerationRequest], bool]
                        ) -> List[_Pending]:
        """Pop the requests to admit at this step boundary, head first,
        stopping at the first that does not fit. The engine must admit
        or resolve every returned request."""
        now = time.monotonic()
        self.shed_expired(now)
        taken: List[_Pending] = []
        budget = (self.prefill_token_budget
                  if self.policy == "budget" else None)
        spent = 0
        with self._lock:
            while self._queue and len(taken) < free_slots:
                head = self._queue[0]
                if not can_fit(head.request):
                    break
                cost = (int(self.prefill_cost(head.request))
                        if self.prefill_cost is not None
                        else int(head.request.prompt.size))
                if budget is not None and taken and spent + cost > budget:
                    break
                spent += cost
                taken.append(self._queue.pop(0))
            if taken:
                # one drain-interval sample per boundary, per popped request
                if self._last_pop_t is not None:
                    dt = max(0.0, now - self._last_pop_t) / len(taken)
                    self._ewma_interval = dt if self._ewma_interval is None \
                        else (_EWMA_ALPHA * dt +
                              (1.0 - _EWMA_ALPHA) * self._ewma_interval)
                self._last_pop_t = now
            if not self._queue:
                self._reset_wait_model_locked()
        return taken

    def requeue(self, pendings: List[_Pending]) -> None:
        """Put popped requests back at the head, in order (an admission
        that found no room after all)."""
        with self._lock:
            self._queue[:0] = list(pendings)

    def drain_queue(self) -> List[_Pending]:
        """Pop every queued request (engine shutdown: the caller resolves
        their Futures)."""
        with self._lock:
            out, self._queue = self._queue, []
            self._reset_wait_model_locked()
        return out
