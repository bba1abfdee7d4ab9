"""Health-aware multi-replica router: the tier above one engine. The port's
copy of ``paddle_tpu/serving/router.py``: the same placement, health,
failover and hedging rules, the same trace entries, fault sites and
metrics, over the port's engines.

* **Placement**: weighted pick-2 by queue wait. Two candidate replicas are
  sampled (seeded RNG: same seed, same pick sequence) and the request goes
  to the one with the lower scheduler EWMA wait estimate (ties: shallower
  queue, then name order). A replica whose prefix index holds the prompt's
  leading pages is forced into the pair and its wait discounted by
  ``prefix_affinity_bias``.
* **Health**: a replica leaves the rotation when the router latched it out
  (``drain_replica``/``stop``, before its drain begins, so there is no
  new-admissions race), when its engine latched draining itself, or when
  its ``serving.engine.<name>`` beacon went stale
  (:func:`observability.trace.beacon_detail`: a loop thread wedged in a
  device call stops beating; the port's engine beats with observability
  on). A per-replica :class:`~paddle_tpu_torch.resilience.breaker.
  CircuitBreaker` turns a run of forward failures into a fast local
  failure, with a half-open probe after the cooldown.
* **Failover, at most once**: a request is re-sent to another replica only
  when the first provably never admitted it: the forward raised before the
  queue took it, the replica resolved the Future with the never-admitted
  :class:`EngineStopped` (a drained or killed replica's queued work;
  :class:`DrainTimeout`, the admitted case, is excluded by type), or a
  hedge's ``withdraw()`` removed it from the queue. Admission emits the
  request's first token, so "zero tokens observed" backs every one of
  those proofs: no token is emitted twice and no pages are spent twice.
  All attempts share the request's total ``deadline_s`` budget.
* **Hedging (off by default)**: with ``hedge_s`` (or
  ``PADDLE_TPU_ROUTER_HEDGE_S``), a request still queued on its replica
  after ``hedge_s`` seconds is withdrawn and re-routed once.

Every routing decision lands in ``Router.trace`` (appended under the router
lock): ``("pick", rid, replica)``, ``("affinity", rid, replica, depth)``,
``("pick_fault", rid)``, ``("forward_fault", rid, replica)``,
``("breaker_open", rid, replica)``, ``("queue_full", rid, replica)``,
``("shed", rid, replica)``, ``("failover", rid, frm)``,
``("hedge", rid, frm)``, ``("reject", rid, reason)``, ``("out",
replica)``, ``("in", replica)``. Under a scripted
:class:`~paddle_tpu_torch.resilience.faults.FaultSchedule` the trace is the
determinism witness: same seed, same trace.

Fault sites: ``router.pick`` before each placement attempt (an injected
error burns one attempt), ``router.forward`` before each replica submit (an
injected error is a transport failure before admission, counted against
the breaker).

Metrics: ``serving.router.picks_total{replica}``,
``serving.router.retries_total``, ``serving.router.failovers_total``,
``serving.router.hedges_total``, ``serving.router.rejected_total{reason}``
and the ``serving.router.in_rotation`` gauge; the router's poll thread
beats the ``serving.router`` beacon.

The router reads each engine through ``submit``, ``cancel``, ``start``,
``stop``, ``draining``, ``queue_depth``, ``beacon``,
``scheduler.estimated_wait()`` / ``scheduler.withdraw()`` and, for
affinity, ``prefix_sharing_enabled``, ``prefix_summary()`` and
``kv.config.page_size``: an in-process :class:`Engine`, or the fleet's
:class:`~paddle_tpu_torch.serving.fleet.RemoteEngine` over a worker
process.
"""

from __future__ import annotations

import os
import random
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from .. import observability as _obs
from ..observability import trace as _trace
from ..resilience import DeadlineExceeded, faults as _faults, jitter_sleep
from ..resilience.breaker import BreakerOpen, CircuitBreaker
from . import kv_cache as _kv
from .engine import DrainTimeout, Engine, EngineStopped
from .scheduler import GenerationRequest, GenerationResult, QueueFull

__all__ = ["NoHealthyReplica", "Replica", "RouterConfig", "Router"]

# router poll-thread liveness beacon ttl (/healthz goes 503 past this)
_HEARTBEAT_TTL_S = 60.0


class NoHealthyReplica(ConnectionError):
    """Every replica is out of rotation, tried, or breaker-guarded: the
    router has nowhere to place the request (HTTP tier: 503)."""


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    val = float(raw)
    return val if val > 0 else None


@dataclass
class RouterConfig:
    """Routing policy knobs (env defaults resolved at construction)."""

    # tail-latency hedging delay for queued-but-never-admitted requests;
    # None -> $PADDLE_TPU_ROUTER_HEDGE_S (0/absent = OFF, the default)
    hedge_s: Optional[float] = None
    # health-poll cadence (beacon refresh, in-rotation gauge, hedge scan)
    poll_s: float = 0.02
    # pick-2 sampling seed: same seed + same fault schedule => same trace
    seed: int = 0
    # per-replica breaker: consecutive forward failures before fast-fail,
    # and the open-state cooldown before the single half-open probe
    breaker_threshold: int = 3
    breaker_cooldown: float = 0.5
    # prefix-affine placement: when a replica's advertised
    # prefix index already holds the prompt's leading page chain, that
    # replica is forced into the pick-2 candidate set and its queue-wait
    # score is discounted by this factor (0..1; 1 = always prefer the
    # affine replica, 0 = off). None -> $PADDLE_TPU_ROUTER_PREFIX_AFFINITY
    # (absent = 0.75). With no resident chains the pick is byte-identical
    # to the legacy pick-2, so existing trace pins hold.
    prefix_affinity_bias: Optional[float] = None

    def __post_init__(self):
        if self.hedge_s is None:
            self.hedge_s = _env_float("PADDLE_TPU_ROUTER_HEDGE_S")
        elif self.hedge_s <= 0:
            self.hedge_s = None
        if self.poll_s <= 0:
            raise ValueError(f"poll_s must be > 0, got {self.poll_s}")
        if self.prefix_affinity_bias is None:
            raw = os.environ.get(
                "PADDLE_TPU_ROUTER_PREFIX_AFFINITY", "").strip()
            self.prefix_affinity_bias = float(raw) if raw else 0.75
        if not 0.0 <= self.prefix_affinity_bias <= 1.0:
            raise ValueError(
                f"prefix_affinity_bias must be in [0, 1], got "
                f"{self.prefix_affinity_bias} "
                "(env: PADDLE_TPU_ROUTER_PREFIX_AFFINITY)")


class Replica:
    """One engine in the rotation: identity + its breaker. The engine's
    scheduler (queue depth, EWMA wait) and liveness beacon are the
    routing signals — nothing here duplicates that state."""

    def __init__(self, name: str, engine: Engine, *,
                 breaker_threshold: int = 3, breaker_cooldown: float = 0.5):
        if not name:
            raise ValueError("replica needs a non-empty name")
        self.name = name
        self.engine = engine
        self.breaker = CircuitBreaker(
            f"serving.replica.{name}",
            failure_threshold=breaker_threshold, cooldown=breaker_cooldown)

    def queue_wait_estimate(self) -> float:
        return self.engine.scheduler.estimated_wait()

    def stale(self) -> bool:
        """The per-replica beacon detail: stale once the engine's step
        loop stopped beating past its ttl. A beacon that never beat (an
        engine not yet started) is NOT stale — offline-driven engines
        stay routable."""
        detail = _trace.beacon_detail(self.engine.beacon)
        return bool(detail and detail["stale"])

    def prefix_depth(self, request: GenerationRequest) -> int:
        """How many leading prompt pages are resident in this replica's
        prefix index (0 when the engine doesn't share prefixes). Walks
        the page-aligned chain digests through the engine's advertised
        summary and stops at the first miss — depth is the length of the
        longest resident chain, i.e. the pages an admission here would
        map instead of re-prefilling."""
        eng = self.engine
        if not getattr(eng, "prefix_sharing_enabled", False):
            return 0
        summary = eng.prefix_summary()
        if not summary:
            return 0
        prompt = request.prompt
        ps = eng.kv.config.page_size
        limit = max(0, (int(prompt.size) - 1) // ps)
        depth = 0
        for digest in _kv.prefix_chain_digests(prompt, ps, limit=limit):
            if digest not in summary:
                break
            depth += 1
        return depth


@dataclass(eq=False)
class _InFlight:
    """Router-side state of one request. Every mutable field is guarded
    by the router lock; ``tokens`` is bumped by the stream wrapper on the
    replica's engine step thread under the same lock — the at-most-once
    evidence (admission emits the first token) must be exact."""

    request: GenerationRequest
    client_future: "Future[GenerationResult]"
    t0: float                       # first-forward instant (budget anchor)
    deadline0: Optional[float]      # the request's ORIGINAL deadline_s
    ttft0: Optional[float]          # the request's ORIGINAL ttft_budget_s
    replica: str = ""
    replica_future: Optional[Future] = None
    tried: Set[str] = field(default_factory=set)
    tokens: int = 0                 # emitted to the client stream so far
    hedged: bool = False
    done: bool = False


class Router:
    """Spread :class:`GenerationRequest` load across K in-process engine
    replicas. ``submit``/``cancel`` are safe from any thread; ``start``
    spins up every replica engine plus the health-poll thread, ``stop``
    reverses both."""

    def __init__(self, replicas: Sequence,
                 config: Optional[RouterConfig] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.config = config or RouterConfig()
        self._replicas: Dict[str, Replica] = {}
        beacons = set()
        for item in replicas:
            # two spellings: (name, Engine) pairs get wrapped into the
            # default in-process Replica; a pre-built Replica (the fleet
            # tier's ProcessReplica subclass, carrying its own breaker and
            # health signal) is adopted as-is
            if isinstance(item, Replica):
                name, eng = item.name, item.engine
            else:
                name, eng = item
            if name in self._replicas:
                raise ValueError(f"duplicate replica name {name!r}")
            if eng.beacon in beacons:
                # two engines sharing one liveness beacon (unnamed
                # ServingConfigs) would mask a wedged replica: the live
                # one keeps beating the shared beacon and stale() never
                # fires — the per-replica health signal silently degrades
                # to process-global
                raise ValueError(
                    f"replica {name!r} shares liveness beacon "
                    f"{eng.beacon!r} with another replica — give each "
                    f"engine a distinct ServingConfig.name")
            beacons.add(eng.beacon)
            self._replicas[name] = item if isinstance(item, Replica) \
                else Replica(
                    name, eng,
                    breaker_threshold=self.config.breaker_threshold,
                    breaker_cooldown=self.config.breaker_cooldown)
        self._order = sorted(self._replicas)
        self._rng = random.Random(self.config.seed)
        self._lock = threading.Lock()
        self._inflight: Dict[int, _InFlight] = {}
        self._out: Set[str] = set()
        self._stopping = threading.Event()
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        #: ordered routing-decision log (the determinism witness)
        self.trace: List[tuple] = []

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "Router":
        """Start every replica engine's step loop and the router's
        health-poll thread. Idempotent, and the inverse of :meth:`stop`:
        every replica re-enters the rotation (stop latched them all out;
        a start that restarts every engine must not leave the router
        permanently answering 503)."""
        self._stopping.clear()
        with self._lock:
            for name in self._order:
                if name in self._out:
                    self._out.discard(name)
                    self.trace.append(("in", name))
        for name in self._order:
            self._replicas[name].engine.start()
        if self._poll_thread is None:
            self._poll_stop.clear()
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="paddle-tpu-router",
                daemon=True)
            self._poll_thread.start()
        return self

    def stop(self, drain: bool = False, timeout: Optional[float] = None,
             on_timeout: str = "fail") -> None:
        """Stop routing, then stop every replica. The router latches new
        submissions off and marks EVERY replica out of rotation BEFORE
        any engine drain begins — failover cannot re-admit into a replica
        that is about to drain. Per-replica drains share one ``timeout``
        budget; every in-flight client Future resolves (the engines'
        no-stranded-futures invariant composes through the done
        callbacks)."""
        self._stopping.set()
        with self._lock:
            for name in self._order:
                if name not in self._out:
                    self._out.add(name)
                    self.trace.append(("out", name))
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        for name in self._order:
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            self._replicas[name].engine.stop(
                drain=drain, timeout=left, on_timeout=on_timeout)
        self._poll_stop.set()
        t = self._poll_thread
        if t is not None:
            t.join(timeout=5.0)
        self._poll_thread = None
        _trace.heartbeat_clear("serving.router")

    def drain_replica(self, name: str, timeout: Optional[float] = None,
                      on_timeout: str = "fail") -> None:
        """Take ONE replica out of rotation, THEN drain it (the ordering
        is the no-new-admissions-race contract: once this returns no
        failover or hedge will ever target ``name`` again until
        :meth:`restore_replica`). Its queued-never-admitted work fails
        over to the surviving replicas through the normal done-callback
        path."""
        rep = self._replicas[name]          # KeyError for unknown names
        with self._lock:
            if name not in self._out:
                self._out.add(name)
                self.trace.append(("out", name))
        rep.engine.stop(drain=True, timeout=timeout, on_timeout=on_timeout)

    def latch_out(self, name: str) -> None:
        """Take ONE replica out of rotation WITHOUT draining it — the
        supervisor's dead-worker latch: the process behind the
        replica is already gone, so there is nothing to drain, but no
        failover or hedge may target it until :meth:`restore_replica`
        puts the respawned worker back."""
        if name not in self._replicas:
            raise KeyError(name)
        with self._lock:
            if name not in self._out:
                self._out.add(name)
                self.trace.append(("out", name))

    def restore_replica(self, name: str) -> None:
        """Put a drained replica back in rotation (after its engine was
        ``start()``-ed again). Resets its breaker: the old run of
        failures says nothing about the restarted engine."""
        rep = self._replicas[name]
        rep.engine.start()
        rep.breaker.reset()
        with self._lock:
            self._out.discard(name)
            self.trace.append(("in", name))

    # ------------------------------------------------------------------
    # request surface
    # ------------------------------------------------------------------
    def submit(self, request: GenerationRequest
               ) -> "Future[GenerationResult]":
        """Place ``request`` on a replica; returns the client-facing
        Future. Raises the typed backpressure/unavailability surface on
        THIS thread when no replica accepts: :class:`QueueFull` (every
        candidate full — HTTP 429), :class:`DeadlineExceeded` (shed —
        504), :class:`EngineStopped` (router/replicas stopped — 503),
        :class:`NoHealthyReplica` (nothing in rotation — 503),
        ``ValueError`` (malformed request — 400)."""
        if self._stopping.is_set():
            raise EngineStopped("router is stopped: not admitting")
        entry = _InFlight(
            request=request,
            client_future=Future(),
            t0=time.monotonic(),
            deadline0=request.deadline_s,
            ttft0=request.ttft_budget_s)
        self._wrap_stream(entry)
        with self._lock:
            self._inflight[request.request_id] = entry
        try:
            self._forward(entry, first=True)
        except BaseException:
            with self._lock:
                self._inflight.pop(request.request_id, None)
            raise
        return entry.client_future

    def cancel(self, request_id: int) -> bool:
        """Cancel wherever the request currently lives; the client
        Future resolves through the replica's normal cancel path."""
        with self._lock:
            entry = self._inflight.get(request_id)
            name = entry.replica if entry is not None else ""
        if not name:
            return False
        return self._replicas[name].engine.cancel(request_id)

    def estimated_wait(self) -> float:
        """Min queue-wait estimate over the rotation — the front door's
        Retry-After source when the whole tier pushes back."""
        with self._lock:
            names = self._rotation_locked()
        if not names:
            return 0.0
        return min(self._replicas[n].queue_wait_estimate() for n in names)

    @property
    def queue_depth(self) -> int:
        return sum(self._replicas[n].engine.queue_depth
                   for n in self._order)

    @property
    def replicas(self) -> List[Replica]:
        return [self._replicas[n] for n in self._order]

    def in_rotation(self) -> List[str]:
        with self._lock:
            return self._rotation_locked()

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _rotation_locked(self) -> List[str]:
        return [n for n in self._order
                if n not in self._out
                and not self._replicas[n].engine.draining
                and not self._replicas[n].stale()]

    def _pick_locked(self, tried: Set[str],
                     request: Optional[GenerationRequest] = None,
                     rid: Optional[str] = None) -> Optional[str]:
        """Weighted pick-2 by queue wait among in-rotation, untried
        replicas. Deterministic given the RNG state: candidates are
        sampled in sorted order, ties break (wait, depth, name).

        Prefix affinity: when some candidate's prefix index
        holds a non-empty chain of the prompt's leading pages, that best
        affine replica (deepest chain; ties by wait/depth/name) is forced
        into the candidate pair and its queue-wait score is discounted by
        ``prefix_affinity_bias`` — a warm prefix saves the whole shared
        prefill, so a moderately longer queue is still the faster TTFT.
        When no candidate holds the prefix (or bias is 0) the legacy
        pick-2 runs byte-identically, consuming the same RNG stream."""
        cands = [n for n in self._rotation_locked() if n not in tried]
        if not cands:
            return None
        bias = self.config.prefix_affinity_bias
        if bias and request is not None:
            depths = {n: self._replicas[n].prefix_depth(request)
                      for n in cands}
            if any(depths.values()):
                affine = min(cands, key=lambda n: (
                    -depths[n],
                    self._replicas[n].queue_wait_estimate(),
                    self._replicas[n].engine.queue_depth, n))
                others = [n for n in cands if n != affine]
                if len(others) > 1:
                    others = self._rng.sample(others, 1)
                cands = [affine] + others
                self.trace.append(("affinity", rid, affine, depths[affine]))
                # ties (idle cluster: every score is 0) go to the affine
                # replica — a warm prefix always beats an equally-idle
                # cold one, name order must not route away from the pages
                return min(cands, key=lambda n: (
                    self._replicas[n].queue_wait_estimate()
                    * ((1.0 - bias) if n == affine else 1.0),
                    self._replicas[n].engine.queue_depth,
                    n != affine, n))
        if len(cands) > 2:
            cands = self._rng.sample(cands, 2)
        return min(cands, key=lambda n: (
            self._replicas[n].queue_wait_estimate(),
            self._replicas[n].engine.queue_depth, n))

    def _forward(self, entry: _InFlight, first: bool,
                 exclude: Optional[Set[str]] = None) -> None:
        """The attempt loop shared by submit (sync), failover, and hedge:
        pick → breaker gate → forward, until a replica accepts or the
        candidates/budget run out (raises the LAST typed error, mapped).
        ``entry.tried`` accumulates across the request's lifetime — a
        replica is never offered the same request twice."""
        rid = entry.request.request_id
        if exclude:
            with self._lock:
                entry.tried |= exclude
        if not first:
            # the TOTAL budget contract: a re-routed request carries only
            # what is left of its original deadline/TTFT budget into the
            # next replica — the new scheduler measures from its own fresh
            # submit_time, so without this a failover would silently
            # restart the end-to-end clocks the headers promised
            now = time.monotonic()
            if entry.deadline0 is not None:
                entry.request.deadline_s = max(
                    1e-3, entry.t0 + entry.deadline0 - now)
            if entry.ttft0 is not None:
                entry.request.ttft_budget_s = max(
                    1e-3, entry.t0 + entry.ttft0 - now)
        last_exc: Optional[BaseException] = None
        # one placement attempt per replica plus one spare for an injected
        # pick fault: the loop is bounded even under a hostile schedule
        for attempt in range(len(self._order) + 1):
            if self._budget_left(entry) <= 0.0:
                break
            if attempt:
                _obs.inc("serving.router.retries_total")
            try:
                _faults.fault_point("router.pick")
            except Exception as exc:
                last_exc = exc
                with self._lock:
                    self.trace.append(("pick_fault", rid))
                continue
            with self._lock:
                name = self._pick_locked(entry.tried, entry.request, rid)
                if name is not None:
                    self.trace.append(("pick", rid, name))
            if name is None:
                break
            rep = self._replicas[name]
            try:
                rep.breaker.before_call()
            except BreakerOpen as exc:
                last_exc = exc
                with self._lock:
                    entry.tried.add(name)
                    self.trace.append(("breaker_open", rid, name))
                continue
            try:
                _faults.fault_point("router.forward")
                fut = rep.engine.submit(entry.request)
            except QueueFull as exc:
                # the replica answered: healthy, just full — backpressure,
                # not failure; the breaker must not open on load
                rep.breaker.record_success()
                last_exc = exc
                with self._lock:
                    entry.tried.add(name)
                    self.trace.append(("queue_full", rid, name))
                continue
            except DeadlineExceeded as exc:
                # shed on arrival: healthy replica, honest estimate — try
                # a less-loaded one inside the remaining budget
                rep.breaker.record_success()
                last_exc = exc
                with self._lock:
                    entry.tried.add(name)
                    self.trace.append(("shed", rid, name))
                continue
            except ValueError:
                # malformed request: no replica can fix it. The replica
                # ANSWERED (it validated and rejected) — return its
                # half-open probe like the QueueFull arm does, or the
                # breaker wedges half-open on a client mistake
                rep.breaker.record_success()
                raise
            except Exception as exc:
                # EngineStopped (replica dying under us) or an injected/
                # real transport fault before admission: never admitted,
                # counted against the breaker, safe to move on
                rep.breaker.record_failure()
                last_exc = exc
                with self._lock:
                    entry.tried.add(name)
                    self.trace.append(("forward_fault", rid, name))
                continue
            rep.breaker.record_success()
            _obs.inc("serving.router.picks_total", replica=name)
            with self._lock:
                entry.tried.add(name)
                entry.replica = name
                entry.replica_future = fut
            fut.add_done_callback(
                lambda f, e=entry: self._on_replica_done(e, f))
            return
        self._reject(entry, last_exc)

    def _budget_left(self, entry: _InFlight) -> float:
        """Seconds of end-to-end budget left. The TTFT budget counts as a
        live bound while NO token has been produced — an expired TTFT-only
        request is as dead as an expired deadline and must resolve 504,
        never be re-routed or told to retry. (``entry.tokens`` is a
        GIL-atomic int read; an in-flight increment only delays expiry by
        one scan, it cannot resurrect a dead budget.)"""
        now = time.monotonic()
        left = float("inf")
        if entry.deadline0 is not None:
            left = entry.t0 + entry.deadline0 - now
        if entry.ttft0 is not None and entry.tokens == 0:
            left = min(left, entry.t0 + entry.ttft0 - now)
        return left

    def _expired_exc(self, entry: _InFlight) -> DeadlineExceeded:
        """The 504-shaped terminal for an exhausted total budget: a plain
        DeadlineExceeded with NO backpressure detail attached, so the
        HTTP tier never answers Retry-After for a request that is dead."""
        which = "deadline" if entry.deadline0 is not None else "TTFT"
        budget = entry.deadline0 if entry.deadline0 is not None \
            else entry.ttft0
        return DeadlineExceeded(
            f"request {entry.request.request_id}: total {which} budget "
            f"({budget:.3f}s) exhausted before any replica admitted it")

    def _reject(self, entry: _InFlight, last_exc: Optional[BaseException]
                ) -> None:
        rid = entry.request.request_id
        if self._budget_left(entry) <= 0.0:
            # an exhausted total budget outranks whatever the last
            # attempt saw: the request is dead (504, no Retry-After),
            # not retryable backpressure
            last_exc = self._expired_exc(entry)
        if last_exc is None or isinstance(last_exc, (BreakerOpen,
                                                     EngineStopped)):
            reason = "no_replica"
            last_exc = NoHealthyReplica(
                f"request {rid}: no replica in rotation accepted it "
                f"(last: {type(last_exc).__name__ if last_exc else 'none'})")
        elif isinstance(last_exc, QueueFull):
            reason = "queue_full"
        elif isinstance(last_exc, DeadlineExceeded):
            reason = "deadline"
        else:
            reason = "error"
        _obs.inc("serving.router.rejected_total", reason=reason)
        with self._lock:
            self.trace.append(("reject", rid, reason))
            self._inflight.pop(rid, None)
        raise last_exc

    # ------------------------------------------------------------------
    # completion + failover
    # ------------------------------------------------------------------
    def _wrap_stream(self, entry: _InFlight) -> None:
        """Interpose the token counter: admission emits the first token,
        so ``entry.tokens > 0`` is proof the current replica admitted the
        request — the failover/hedge guards read it under the lock."""
        inner = entry.request.stream

        def counted(rid: int, token: int) -> None:
            with self._lock:
                entry.tokens += 1
            if inner is not None:
                inner(rid, token)

        entry.request.stream = counted

    def _never_admitted(self, entry: _InFlight,
                        exc: BaseException) -> bool:
        """The at-most-once proof for the done-callback path: zero tokens
        observed AND an exception type that can only mean the replica
        never admitted the request. ``DrainTimeout`` (admitted, evicted
        at the drain budget) is excluded by type; a plain
        ``EngineStopped`` future failure is the killed/drained replica's
        queued-never-admitted resolution; ``DeadlineExceeded`` is a queue
        shed (admitted requests are never shed — engine contract)."""
        if entry.tokens > 0:
            return False
        if isinstance(exc, DrainTimeout):
            return False
        return isinstance(exc, (EngineStopped, DeadlineExceeded))

    def _on_replica_done(self, entry: _InFlight, fut: Future) -> None:
        """Runs on whatever thread resolved the replica Future (engine
        step thread, drain resolver). Decides under the lock, resolves
        the client Future outside it."""
        failover_from = ""
        with self._lock:
            if entry.done or fut is not entry.replica_future:
                return   # stale callback: the entry moved on (hedge)
            exc = fut.exception()
            if exc is None or not self._never_admitted(entry, exc) \
                    or self._stopping.is_set() \
                    or self._budget_left(entry) <= 0.0:
                entry.done = True
                self._inflight.pop(entry.request.request_id, None)
                if exc is not None and self._never_admitted(entry, exc) \
                        and self._budget_left(entry) <= 0.0:
                    # the replica died AFTER the request's total budget
                    # did: the honest terminal is the expired budget
                    # (504, no Retry-After), not the replica's 503
                    exc = self._expired_exc(entry)
            else:
                failover_from = entry.replica
        if failover_from:
            _obs.inc("serving.router.failovers_total")
            with self._lock:
                self.trace.append(("failover",
                                   entry.request.request_id, failover_from))
            try:
                self._forward(entry, first=False)
            except BaseException as fexc:
                with self._lock:
                    entry.done = True
                entry.client_future.set_exception(fexc)
            return
        if exc is None:
            entry.client_future.set_result(fut.result())
        else:
            entry.client_future.set_exception(exc)

    # ------------------------------------------------------------------
    # the health-poll thread
    # ------------------------------------------------------------------
    def _poll_loop(self) -> None:
        while not self._poll_stop.is_set():
            _trace.heartbeat("serving.router", ttl_s=_HEARTBEAT_TTL_S)
            with self._lock:
                rotation = self._rotation_locked()
            _obs.set_gauge("serving.router.in_rotation", len(rotation))
            hedge_s = self.config.hedge_s
            if hedge_s is not None:
                self._hedge_scan(hedge_s)
            jitter_sleep(self.config.poll_s)

    def _hedge_scan(self, hedge_s: float) -> None:
        """One pass of the tail-latency hedge: requests queued (never
        admitted — zero tokens) on their replica past ``hedge_s`` are
        atomically withdrawn (the never-admitted proof IS the successful
        ``withdraw``) and re-routed once to a different replica."""
        if self._stopping.is_set():
            # a drain in progress: withdrawing queued work from a
            # draining replica would turn a request its drain was about
            # to complete into a 503 — the drain contract outranks the
            # hedge
            return
        now = time.monotonic()
        with self._lock:
            stale = [e for e in self._inflight.values()
                     if not e.done and not e.hedged and e.tokens == 0
                     and e.replica and now - e.t0 >= hedge_s]
        for entry in stale:
            if self._stopping.is_set():
                return
            with self._lock:
                if entry.done or entry.hedged or entry.tokens:
                    continue
                name = entry.replica
            pending = self._replicas[name].engine.scheduler.withdraw(
                entry.request.request_id)
            if pending is None:
                continue   # admitted (or resolved) in the meantime
            _obs.inc("serving.router.hedges_total")
            with self._lock:
                entry.hedged = True
                entry.replica_future = None   # the withdrawn Future is dead
                self.trace.append(("hedge", entry.request.request_id, name))
            try:
                self._forward(entry, first=False, exclude={name})
            except BaseException as exc:
                with self._lock:
                    entry.done = True
                entry.client_future.set_exception(exc)
