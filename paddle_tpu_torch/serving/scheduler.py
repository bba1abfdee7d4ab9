"""Continuous-batching admission control: the request queue and policies.
The port of ``paddle_tpu/serving/scheduler.py``, with its metrics, trace
events and the replay side of crash recovery.

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
  admitted at this boundary would exceed it. A request's cost is
  ``prefill_cost(request)`` when the engine gives one (a prefix-sharing
  engine charges only the unshared tail), else its prompt length.

Overload protection:

* **Shed on arrival**: a request with ``deadline_s`` / ``ttft_budget_s``
  whose estimated queue wait (EWMA of the admission interval x depth)
  already exceeds its budget is refused at ``submit`` with
  :class:`~paddle_tpu_torch.resilience.DeadlineExceeded`
  (``serving.rejected_total{reason=shed}``).
* **Shed at the admission boundary**: every ``next_admissions`` first
  sweeps the queue for requests whose deadline, TTFT budget or
  ``max_queue_wait_s`` (``PADDLE_TPU_SERVING_MAX_QUEUE_WAIT``) expired
  while queued (``reason=deadline``, or ``reason=shed`` for the operator
  cap). An admitted request is never shed, and a replayed request that
  already had its first token is exempt from the TTFT budget.
* ``serving.queue_wait_seconds`` is observed for every admitted request.

Crash recovery requeues a request at the head with ``replay_tokens`` (the
tokens generated so far); ``replay_only`` admission lets a draining engine
finish what was in flight without admitting new work. Nothing here touches
the device.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np

from .. import observability as _obs
from ..observability import trace as _trace
from ..resilience import DeadlineExceeded

__all__ = ["GenerationRequest", "GenerationResult", "QueueFull",
           "DeadlineExceeded", "Scheduler", "QUEUE_WAIT_BUCKETS"]

# EWMA smoothing for the admission drain interval (the shed-on-arrival
# wait model): ~10 admissions of memory
_EWMA_ALPHA = 0.3

# SLO-shaped queue-wait boundaries (the JAX package's): the 1-25 ms band an
# admission-time SLO routes on gets its own buckets. Registered at import
# so every later observe joins this family.
QUEUE_WAIT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 15.0, 60.0,
)
_obs.histogram("serving.queue_wait_seconds",
               "queue wait of each admitted request (one stint)",
               buckets=QUEUE_WAIT_BUCKETS)

_req_ids = itertools.count()


class QueueFull(RuntimeError):
    """submit() on a queue already holding ``max_queue`` requests.

    Carries the backpressure detail: the queue ``depth``/``capacity`` at
    rejection and the scheduler's EWMA ``estimated_wait_s`` at that
    instant (a "come back in N seconds" figure from the measured
    admission drain rate)."""

    def __init__(self, msg: str, *, depth: int = 0, capacity: int = 0,
                 estimated_wait_s: float = 0.0):
        super().__init__(msg)
        self.depth = depth
        self.capacity = capacity
        self.estimated_wait_s = estimated_wait_s


@dataclass(eq=False)   # identity equality: ``prompt`` is an ndarray, and a
class GenerationRequest:   # request is a job, not a value
    """One decode job: a prompt plus its stopping rule.

    ``prompt`` is a 1-D int32 token array; ``stream`` (optional) is called
    ``stream(request_id, token)`` from the engine step thread as each
    token lands — keep it cheap. A raising callback fails THIS request
    (its Future gets the exception, its pages free) and never touches its
    batchmates.

    ``deadline_s`` bounds the request END TO END from submit: if it
    expires while the request is still queued, the request sheds with
    :class:`DeadlineExceeded`; once admitted it also becomes the ambient
    ``resilience.deadline_scope`` around the request's prefill and every
    decode step it joins (a slot is never evicted mid-batch for an
    expired deadline — batchmates stay bit-identical). ``ttft_budget_s``
    bounds only the wait for the FIRST token and therefore only ever
    sheds in the queue."""

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
    finish_reason: str          # "eos" | "length" | "cancelled"
    ttft_s: Optional[float] = None   # submit -> first token
    tpot_s: Optional[float] = None   # mean inter-token time after the first


@dataclass(eq=False)
class _Pending:
    request: GenerationRequest
    future: "Future[GenerationResult]"
    submit_time: float = 0.0
    # when THIS stint in the queue began: equals submit_time on first
    # enqueue, reset by requeue() — queue-wait accounting (the histogram,
    # the max_queue_wait_s cap) must never charge a replayed request for
    # the time it spent DECODING before the fault evicted it
    queued_at: float = 0.0
    # crash-recovery state (engine-owned): tokens already generated before
    # an unrecoverable step fault evicted the slot; on re-admission the
    # engine re-prefills prompt + replay_tokens into a fresh slot. replays
    # counts recoveries against ServingConfig.max_replays; ttft_done keeps
    # the TTFT histogram honest across replays (first token only) AND
    # exempts a replayed request from the ttft_budget_s queue sweep — a
    # budget already met cannot expire retroactively.
    replays: int = 0
    replay_tokens: List[int] = field(default_factory=list)
    ttft_done: bool = False
    # the request's trace root (a trace.SpanContext, or None with tracing
    # off): the cross-thread handoff that lets the trace follow the request
    # from submit() through the engine's step thread
    trace_ctx: Any = None


class Scheduler:
    """Bounded queue + admission policy. Thread-safe; the engine is the
    only consumer (``next_admissions`` from the step loop), producers are
    arbitrary ``submit``/``cancel`` threads."""

    def __init__(self, max_queue: int = 64, policy: str = "fifo",
                 prefill_token_budget: Optional[int] = None,
                 max_queue_wait_s: Optional[float] = None,
                 prefill_cost: Optional[
                     Callable[[GenerationRequest], int]] = None):
        if policy not in ("fifo", "budget"):
            raise ValueError(f"unknown admission policy: {policy!r}")
        if policy == "budget" and not prefill_token_budget:
            raise ValueError("policy='budget' needs prefill_token_budget")
        if max_queue_wait_s is not None and max_queue_wait_s < 0:
            raise ValueError(
                f"max_queue_wait_s must be >= 0, got {max_queue_wait_s}")
        self.max_queue = max_queue
        self.policy = policy
        self.prefill_token_budget = prefill_token_budget
        # the admission cost model: prompt tokens the prefill will compute.
        # A prefix-sharing engine passes a callable that subtracts the
        # resident shared chain; None keeps the full prompt size.
        self.prefill_cost = prefill_cost
        # the operator's hard cap on queue wait (0/None = off); requests
        # queued past it shed with DeadlineExceeded even with no deadline
        self.max_queue_wait_s = max_queue_wait_s or None
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        # shed-on-arrival wait model: EWMA of the interval between
        # successive admission pops; estimated wait ~= depth * interval
        self._ewma_interval: Optional[float] = None
        self._last_pop_t: Optional[float] = None
        # request ids cancelled while HOLDING A SLOT; the engine consumes
        # these at its next step boundary (eviction is an engine action —
        # pages and slots are engine state)
        self._cancelled_active: set = set()

    # -- producer side ------------------------------------------------------
    def estimated_wait(self) -> float:
        """Seconds a request arriving now is expected to queue (0.0 until
        enough admissions were seen to estimate a drain rate): the
        router's placement signal."""
        with self._lock:
            return self._estimated_wait_locked()

    def _estimated_wait_locked(self) -> float:
        if self._ewma_interval is None:
            return 0.0
        return self._ewma_interval * len(self._queue)

    def _reset_wait_model_locked(self) -> None:
        """The queue just drained: both halves of the wait model are now
        stale. The next pop interval would measure idle (arrival-bound)
        time, and a drain rate learned under an earlier load regime would
        shed the first requests of the next burst against an empty,
        instantly-draining queue. Forget both — under sustained overload
        the queue never empties, which is exactly when the estimate is
        live and shedding matters."""
        self._last_pop_t = None
        self._ewma_interval = None

    def submit(self, request: GenerationRequest, submit_time: float = 0.0,
               trace_ctx: Any = None) -> "Future[GenerationResult]":
        fut: "Future[GenerationResult]" = Future()
        with self._lock:
            depth = len(self._queue)
            if depth >= self.max_queue:
                _obs.inc("serving.requests_total", status="rejected")
                _obs.inc("serving.rejected_total", reason="queue_full")
                _trace.instant("serving.rejected", parent=trace_ctx,
                               rid=request.request_id, reason="queue_full")
                raise QueueFull(
                    f"serving queue full ({depth}/{self.max_queue} pending)",
                    depth=depth, capacity=self.max_queue,
                    estimated_wait_s=self._estimated_wait_locked())
            # reject-on-arrival: queueing work whose wait estimate already
            # blows its budget only delays the DeadlineExceeded and steals
            # drain rate from requests that can still make theirs
            budget = min((b for b in (request.deadline_s,
                                      request.ttft_budget_s,
                                      self.max_queue_wait_s)
                          if b is not None), default=None)
            est = self._estimated_wait_locked()
            if submit_time and budget is not None and est > budget:
                _obs.inc("serving.requests_total", status="rejected")
                _obs.inc("serving.rejected_total", reason="shed")
                _trace.instant("serving.rejected", parent=trace_ctx,
                               rid=request.request_id, reason="shed",
                               estimated_wait_s=round(est, 4))
                exc = DeadlineExceeded(
                    f"request {request.request_id} shed on arrival: "
                    f"estimated queue wait {est:.3f}s exceeds its "
                    f"{budget:.3f}s budget (queue depth {depth})")
                # the same backpressure detail QueueFull carries
                exc.depth = depth
                exc.capacity = self.max_queue
                exc.estimated_wait_s = est
                raise exc
            self._queue.append(_Pending(request, fut, submit_time,
                                        queued_at=submit_time,
                                        trace_ctx=trace_ctx))
            depth += 1
        _obs.set_gauge("serving.queue_depth", depth)
        _trace.instant("serving.queued", parent=trace_ctx,
                       rid=request.request_id, depth=depth)
        return fut

    def _pop_queued_locked(self, request_id: int) -> Optional[_Pending]:
        """Remove one queued request by id and return it (lock held).
        Owns ALL the queue bookkeeping for a removal (wait-model reset on
        empty) so cancel/withdraw cannot diverge; the caller publishes
        the depth gauge after releasing the lock."""
        for i, p in enumerate(self._queue):
            if p.request.request_id == request_id:
                del self._queue[i]
                if not self._queue:
                    self._reset_wait_model_locked()
                return p
        return None

    def cancel(self, request_id: int) -> bool:
        """Cancel a request; always returns True. Queued: resolved
        ``cancelled`` immediately. Anything else is flagged as
        cancelled-while-active and consumed by the engine at its next
        step boundary — ids of already-finished (or never-submitted)
        requests are indistinguishable here and are silently ignored
        there; the request's Future is the source of truth for what
        actually happened."""
        with self._lock:
            pend = self._pop_queued_locked(request_id)
            if pend is None:
                # not queued: assume active; the engine ignores stale ids
                self._cancelled_active.add(request_id)
                return True
            depth = len(self._queue)
        _obs.set_gauge("serving.queue_depth", depth)
        _obs.inc("serving.requests_total", status="cancelled")
        _trace.instant("serving.cancelled", parent=pend.trace_ctx,
                       rid=request_id, queued=True)
        pend.future.set_result(GenerationResult(
            request_id, [], "cancelled"))
        return True

    # -- engine side --------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def take_cancelled_active(self) -> set:
        """Drain the cancelled-while-active set (engine, step boundary)."""
        with self._lock:
            out, self._cancelled_active = self._cancelled_active, set()
        return out

    def shed_expired(self, now: Optional[float] = None) -> int:
        """Sweep the queue for requests whose wait budget expired and
        resolve their Futures with :class:`DeadlineExceeded`. Runs at
        every admission boundary (``next_admissions`` calls it first) —
        NEVER against admitted slots. Returns the number shed."""
        if now is None:
            now = time.monotonic()
        shed: List[Tuple[_Pending, str, float, float]] = []
        with self._lock:
            kept: List[_Pending] = []
            for p in self._queue:
                reason = self._expiry_reason(p, now)
                if reason is None:
                    kept.append(p)
                else:
                    shed.append(reason)
            if shed:
                self._queue = kept
            if not self._queue:
                self._reset_wait_model_locked()
            depth = len(self._queue)
        if not shed:
            return 0
        _obs.set_gauge("serving.queue_depth", depth)
        for p, reason, waited, budget in shed:
            _obs.inc("serving.requests_total", status="shed")
            _obs.inc("serving.rejected_total", reason=reason)
            _trace.instant("serving.shed", parent=p.trace_ctx,
                           rid=p.request.request_id, reason=reason,
                           waited_s=round(waited, 4))
            p.future.set_exception(DeadlineExceeded(
                f"request {p.request.request_id} expired in queue: waited "
                f"{waited:.3f}s against a {budget:.3f}s "
                f"{'operator max_queue_wait' if reason == 'shed' else 'request'}"
                f" budget"))
        return len(shed)

    def _expiry_reason(self, p: _Pending, now: float):
        """None, or ``(pending, reason, waited, budget)`` — lock held."""
        if not p.submit_time:
            return None  # no clock reference: direct scheduler use
        waited = now - p.submit_time
        r = p.request
        if r.deadline_s is not None and waited >= r.deadline_s:
            return (p, "deadline", waited, r.deadline_s)
        # a replayed request that already produced its first token
        # (ttft_done) met its TTFT budget — it cannot expire retroactively
        if r.ttft_budget_s is not None and not p.ttft_done \
                and waited >= r.ttft_budget_s:
            return (p, "deadline", waited, r.ttft_budget_s)
        # the operator cap bounds QUEUE wait, not request age: measure
        # this stint only (queued_at resets on requeue), so a replayed
        # request is not charged for the time it spent decoding
        waited_q = now - (p.queued_at or p.submit_time)
        if self.max_queue_wait_s is not None \
                and waited_q >= self.max_queue_wait_s:
            return (p, "shed", waited_q, self.max_queue_wait_s)
        return None

    def queued_replays(self) -> int:
        """Queued requests that were already admitted once and are
        waiting on crash-recovery re-admission (``replays`` spent or
        ``replay_tokens`` carried). The drain wait loop blocks on these:
        they are work the engine still owes, not new admissions."""
        with self._lock:
            return sum(1 for p in self._queue
                       if p.replays or p.replay_tokens)

    def next_admissions(self, free_slots: int,
                        can_fit: Callable[[GenerationRequest], bool],
                        replay_only: bool = False) -> List[_Pending]:
        """Pop the requests to admit at this step boundary.

        Expired-in-queue requests are shed first (:meth:`shed_expired`).
        ``can_fit`` answers "can the page pool cover this request's whole
        lifetime right now" — it is consulted head-first and admission
        stops at the first miss (strict FIFO; no slip-ahead). With
        ``replay_only`` (a draining engine) admission also stops at the
        first request that is NOT a crash-recovery requeue — replays sit
        at the queue head, so the drain finishes what was in flight
        without admitting new work. The engine MUST admit every returned
        request or re-queue it: the pop is the handoff."""
        now = time.monotonic()
        self.shed_expired(now)
        taken: List[_Pending] = []
        budget = (self.prefill_token_budget
                  if self.policy == "budget" else None)
        spent = 0
        with self._lock:
            while self._queue and len(taken) < free_slots:
                head = self._queue[0]
                if replay_only and not (head.replays or head.replay_tokens):
                    break
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
                # drain-interval EWMA feeds the shed-on-arrival estimate.
                # One sample per BOUNDARY, divided by the pop count: the
                # per-request drain interval. (A per-pop update would
                # record dt=0 for every pop after the first — same `now`
                # — and collapse the estimate under exactly the batched
                # admission the engine is built for.)
                if self._last_pop_t is not None:
                    dt = max(0.0, now - self._last_pop_t) / len(taken)
                    self._ewma_interval = dt if self._ewma_interval is None \
                        else (_EWMA_ALPHA * dt +
                              (1.0 - _EWMA_ALPHA) * self._ewma_interval)
                self._last_pop_t = now
            if not self._queue:
                self._reset_wait_model_locked()
            depth = len(self._queue)
        for p in taken:
            if p.submit_time:
                _obs.observe("serving.queue_wait_seconds",
                             max(0.0, now - (p.queued_at or p.submit_time)))
        if taken:
            _obs.set_gauge("serving.queue_depth", depth)
        return taken

    def drain_queue(self) -> List[_Pending]:
        """Pop EVERY queued request (engine shutdown: the caller owns
        resolving their Futures — nothing may stay stranded)."""
        with self._lock:
            out, self._queue = self._queue, []
            self._reset_wait_model_locked()
        if out:
            _obs.set_gauge("serving.queue_depth", 0)
        return out

    def withdraw(self, request_id: int) -> Optional[_Pending]:
        """Silently remove a still-queued request and hand it back (no
        metrics, no Future resolution — the caller owns both). The
        engine's submit/stop race repair: a request enqueued just as a
        concurrent drain resolved the queue is withdrawn and rejected on
        the caller's thread instead of stranding its Future."""
        with self._lock:
            p = self._pop_queued_locked(request_id)
            if p is None:
                return None
            depth = len(self._queue)
        _obs.set_gauge("serving.queue_depth", depth)
        return p

    def requeue(self, pending: Sequence[_Pending]) -> None:
        """Return un-admitted requests to the queue head (engine aborting
        an admission it could not complete, or requeuing replayed slots).
        Resets each request's ``queued_at``: this is the start of a new
        queue stint, and the queue-wait cap/histogram must not charge the
        time the request spent holding a slot."""
        if not pending:
            return
        now = time.monotonic()
        with self._lock:
            for p in pending:
                if p.submit_time:
                    p.queued_at = now
            self._queue[:0] = list(pending)
            depth = len(self._queue)
        _obs.set_gauge("serving.queue_depth", depth)
