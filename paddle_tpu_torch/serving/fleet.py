"""The fleet tier: out-of-process replicas with crash supervision. The
port's copy of ``paddle_tpu/serving/fleet.py``: the same wire protocol,
router surface, respawn policy, metrics, fault sites and environment
variables, over worker processes that run the port's engine.

Each replica lives behind a real process boundary while the
:class:`Router` surface stays the same, so a "replica kill" is an actual
``SIGKILL`` and the at-most-once failover contract is tested against one:

* :class:`RemoteEngine`: the engine surface over the worker wire protocol
  (``fleet_worker.py``; ``distributed/rpc.py`` framing, a per-fleet HMAC
  secret handed to each worker through its environment). ``submit`` does
  the admission handshake synchronously: a dial or transport failure
  before the ``accepted`` ack raises on the caller's thread (never
  admitted: the router's ``forward_fault`` arm counts it against the
  breaker and tries another replica), and a typed server-side rejection
  (``QueueFull``/shed/``ValueError``/``EngineStopped``) re-raises with its
  original type, so every router arm carries over. After the ack a reader
  thread per request pumps token frames into the request's stream
  callback. A worker death mid-request is classified by the tokens
  streamed: none, the never-admitted ``EngineStopped`` (failover-
  eligible); some, admitted, a terminal
  :class:`~paddle_tpu_torch.distributed.rpc.RpcTransportError` (HTTP 503 +
  ``Retry-After``, never a silent re-send).
* :class:`ProcessReplica`: a ``Replica`` carrying a ``RemoteEngine``: the
  same breaker, and health from the worker's own engine beacon relayed by
  the heartbeat RPC (refused or stale beat: ``stale()``, out of rotation).
  Placement reads only heartbeat-cached signals: no RPC runs under the
  router lock.
* :class:`FleetSupervisor`: spawns N workers (``subprocess``, ``python -m
  paddle_tpu_torch.serving.fleet_worker``: a fresh interpreter, never a
  fork of a process that holds a CUDA context), monitors them (waitpid and
  heartbeat), respawns a crashed one under the jittered ``fleet.respawn``
  backoff capped by ``$PADDLE_TPU_FLEET_MAX_RESPAWNS``, latches a replica
  out of rotation before anything else happens to it, and exports
  ``fleet.replicas{state}``, ``fleet.respawns_total``,
  ``fleet.worker_deaths_total{reason}`` and the ``serving.fleet`` beacon.
  A respawn past the cap is a typed :class:`FleetWorkerLost` parked in
  :attr:`FleetSupervisor.lost`; the survivors keep serving.

A respawned worker builds its engine anew and re-captures its CUDA graphs
(``Engine.warmup`` over the spec's ``warmup`` lengths): a graph cannot
cross processes, and the kernels themselves are already built on disk
(``_native/_build/``). The JAX package's compile-cache directory has no
counterpart here.

Fault sites: ``fleet.spawn`` before each worker ``Popen``,
``fleet.heartbeat`` before each monitor heartbeat RPC, ``fleet.rpc``
before each data-plane RPC (submit/cancel/withdraw/drain/prefix_summary).

Environment: ``PADDLE_TPU_FLEET_MAX_RESPAWNS`` (default 3),
``PADDLE_TPU_FLEET_SPAWN_S`` (worker-ready budget, default 180),
``PADDLE_TPU_FLEET_STALE_S`` (heartbeat staleness latch, default 10),
``PADDLE_TPU_FLEET_DRAIN_S`` (the worker's SIGTERM drain budget), and the
``PADDLE_TPU_RETRY_FLEET_RESPAWN_*`` / ``_FLEET_DIAL_*`` policy knobs.
"""

from __future__ import annotations

import json
import os
import pickle
import secrets as _secrets
import signal as _signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

from .. import observability as _obs
from ..observability import trace as _trace
from ..resilience import faults as _faults, get_policy, jitter_sleep
from ..resilience.policy import env_int
from ..distributed.rpc import RpcTransportError, recv_msg, send_msg
from .engine import EngineStopped
from .router import Replica, Router, RouterConfig
from .scheduler import GenerationRequest, GenerationResult

__all__ = ["FleetWorkerSpec", "FleetWorkerLost", "RemoteEngine",
           "ProcessReplica", "FleetSupervisor"]

# the supervisor monitor thread's /healthz liveness beacon
_HEARTBEAT_TTL_S = 60.0


class FleetWorkerLost(ConnectionError):
    """A worker could not be (re)spawned inside its budget, or its respawn
    cap is exhausted: the replica is latched out of rotation for good and
    the supervisor keeps serving on the survivors (503 only when the LAST
    replica is gone — ``NoHealthyReplica``)."""


@dataclass
class FleetWorkerSpec:
    """One worker's launch recipe. ``factory`` is ``"module:callable"``;
    the callable receives ``config`` as kwargs and must return a built
    :class:`~paddle_tpu_torch.serving.engine.Engine` (give each replica a
    distinct ``ServingConfig.name`` — it becomes the worker's liveness
    beacon identity)."""

    name: str
    factory: str
    config: Dict[str, Any] = field(default_factory=dict)
    pythonpath: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    warmup: List[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.name:
            raise ValueError("fleet worker needs a non-empty name")
        if ":" not in self.factory:
            raise ValueError(
                f"factory must be 'module:callable', got {self.factory!r}")


class _RemoteScheduler:
    """The scheduler facet the router touches, over cached heartbeat state
    (``estimated_wait`` — the placement hot path must never RPC under the
    router lock) and one unary RPC (``withdraw`` — the hedge's
    never-admitted proof, evaluated on the worker's REAL queue)."""

    def __init__(self, engine: "RemoteEngine"):
        self._engine = engine

    def estimated_wait(self) -> float:
        return float(self._engine._cached("estimated_wait", 0.0))

    def withdraw(self, request_id: int):
        try:
            ok = self._engine._unary(
                "withdraw", {"request_id": request_id},
                timeout=self._engine.rpc_timeout_s)
        except (ConnectionError, OSError):
            # can't PROVE the withdrawal: no hedge (at-most-once outranks
            # tail latency)
            return None
        return object() if ok else None


class RemoteEngine:
    """The Engine surface the router needs, over one worker process."""

    def __init__(self, name: str, host: str, port: int, secret: bytes, *,
                 rpc_timeout_s: float = 5.0,
                 stale_after_s: float = 10.0):
        self.name = name
        self.host = host
        self.secret = secret
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.stale_after_s = float(stale_after_s)
        self.scheduler = _RemoteScheduler(self)
        self._lock = threading.Lock()
        self._port = int(port)
        self._stats: Dict[str, Any] = {}
        self._last_beat = 0.0          # monotonic; 0 = never beat

    # -- wire plumbing --------------------------------------------------
    def repoint(self, port: int) -> None:
        """Aim this adapter at a respawned worker's fresh port; the cached
        heartbeat state resets with it (the old process's numbers say
        nothing about the new one)."""
        with self._lock:
            self._port = int(port)
            self._stats = {}
            self._last_beat = 0.0

    def _cached(self, key: str, default):
        with self._lock:
            return self._stats.get(key, default)

    def _dial(self, timeout: Optional[float]) -> socket.socket:
        """Connect under the ``fleet.dial`` policy: a couple of jittered
        re-dials absorb listen-backlog races on a freshly (re)spawned
        worker; nothing was sent yet, so re-dialing is trivially safe."""
        with self._lock:
            addr = (self.host, self._port)
        policy = get_policy("fleet.dial", base_delay=0.05, multiplier=2.0,
                            max_delay=0.4, jitter=0.25, max_attempts=3)
        for attempt in policy.start(deadline=timeout):
            left = attempt.remaining()
            try:
                return socket.create_connection(
                    addr, timeout=None if left is None else max(0.01, left))
            except OSError as e:
                attempt.fail(e)

    def _roundtrip(self, method: str, payload: Dict[str, Any],
                   timeout: Optional[float], site: str):
        """Dial, send one request frame, read one reply frame. Transport
        failures (dial, reset, timeout, EOF) raise
        :class:`RpcTransportError`; a server-side ``("raise", exc)``
        envelope re-raises with its ORIGINAL type."""
        _faults.fault_point(site)
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            with self._dial(timeout) as sock:
                if deadline is not None:
                    sock.settimeout(max(1e-3, deadline - time.monotonic()))
                send_msg(sock, pickle.dumps((method, payload)), self.secret)
                kind, value = pickle.loads(recv_msg(sock, self.secret))
        except (ConnectionError, OSError, EOFError) as e:
            raise RpcTransportError(
                f"fleet rpc {method!r} to {self.name} failed in "
                f"transport: {e}") from e
        if kind == "raise":
            raise value
        return value

    def _unary(self, method: str, payload: Dict[str, Any],
               timeout: Optional[float]):
        return self._roundtrip(method, payload, timeout, "fleet.rpc")

    # -- heartbeat ------------------------------------------------------
    def beat(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """One heartbeat RPC (monitor-thread cadence): refreshes the
        cached routing signals and the staleness clock. Raises
        ``RpcTransportError`` when the worker is unreachable — the caller
        decides what a missed beat means; ``stale()`` answers from the
        LAST GOOD beat's age either way."""
        stats = self._roundtrip(
            "beat", {}, timeout if timeout is not None
            else self.rpc_timeout_s, "fleet.heartbeat")
        with self._lock:
            self._stats = dict(stats)
            self._last_beat = time.monotonic()
        return stats

    def beat_age(self) -> float:
        """Seconds since the last successful heartbeat (inf = never)."""
        with self._lock:
            last = self._last_beat
        return float("inf") if not last else time.monotonic() - last

    def stale(self) -> bool:
        """Out-of-rotation signal: no successful beat inside
        ``stale_after_s`` (dead/wedged/unreachable worker), or the last
        beat relayed a stale ENGINE beacon (the process answers RPCs but
        its step loop stopped beating inside a device call)."""
        return self.beat_age() > self.stale_after_s \
            or bool(self._cached("beacon_stale", False))

    # -- the Engine surface the router touches --------------------------
    @property
    def beacon(self) -> str:
        return f"serving.engine.{self.name}"

    @property
    def draining(self) -> bool:
        return bool(self._cached("draining", False))

    @property
    def queue_depth(self) -> int:
        return int(self._cached("queue_depth", 0))

    @property
    def prefix_sharing_enabled(self) -> bool:
        # prefix-affine placement stays an IN-PROCESS optimization: the
        # router's pick runs under its lock, and a cross-process
        # prefix_summary RPC there would be a lock-hold stall. The RPC
        # method exists (offline inspection, tests); the hot path says no.
        return False

    def prefix_summary(self) -> frozenset:
        return self._unary("prefix_summary", {},
                           timeout=self.rpc_timeout_s)

    def start(self) -> "RemoteEngine":
        return self     # the supervisor owns the worker lifecycle

    def stop(self, drain: bool = False, timeout: Optional[float] = None,
             on_timeout: str = "fail") -> None:
        """Remote ``Engine.stop``: a drain RPC bounded by ``timeout`` plus
        the rpc budget. A worker already dead is a completed stop — its
        in-flight work was resolved by the death classification, there is
        nothing left to drain."""
        budget = (timeout if timeout is not None else 30.0) \
            + self.rpc_timeout_s
        try:
            self._unary("drain", {"drain": drain, "timeout": timeout,
                                  "on_timeout": on_timeout},
                        timeout=budget)
        except RpcTransportError:
            # a worker already dead IS a completed stop (nothing left to
            # drain) — but count it: a fleet whose drains keep skipping
            # has workers dying under shutdown
            _obs.inc("fleet.drain_skipped_total", worker=self.name)

    def cancel(self, request_id: int) -> bool:
        try:
            return bool(self._unary("cancel", {"request_id": request_id},
                                    timeout=self.rpc_timeout_s))
        except (ConnectionError, OSError):
            return False   # dead worker: nothing left to cancel

    def submit(self, request: GenerationRequest) -> "Future[GenerationResult]":
        """The admission handshake + streaming read. Synchronous up to the
        worker's ``accepted`` ack: every failure before it raises on THIS
        thread with never-admitted semantics (dial/transport →
        ``RpcTransportError``; typed rejection → its original type).
        After the ack, a reader thread pumps the stream and resolves the
        returned Future."""
        doc = {
            "prompt": request.prompt.tolist(),
            "max_new_tokens": request.max_new_tokens,
            "eos_token_id": request.eos_token_id,
            "deadline_s": request.deadline_s,
            "ttft_budget_s": request.ttft_budget_s,
            "request_id": request.request_id,
        }
        _faults.fault_point("fleet.rpc")
        handshake_s = self.rpc_timeout_s if request.deadline_s is None \
            else min(self.rpc_timeout_s, request.deadline_s)
        sock = self._dial(handshake_s)
        try:
            sock.settimeout(handshake_s)
            send_msg(sock, pickle.dumps(("submit", doc)), self.secret)
            frame = pickle.loads(recv_msg(sock, self.secret))
        except (ConnectionError, OSError, EOFError) as e:
            sock.close()
            raise RpcTransportError(
                f"fleet submit to {self.name} failed before admission: "
                f"{e}") from e
        except BaseException:
            sock.close()
            raise
        if frame[0] == "raise":
            sock.close()
            raise frame[1]
        fut: "Future[GenerationResult]" = Future()
        reader = threading.Thread(
            target=self._read_stream, args=(sock, request, fut),
            name=f"paddle-tpu-fleet-read-{self.name}", daemon=True)
        reader.start()
        return fut

    def _read_stream(self, sock: socket.socket,
                     request: GenerationRequest, fut: Future) -> None:
        """Per-request reader thread: token frames → the request's stream
        callback (the router's counting wrapper — the at-most-once
        evidence), terminal frame → the Future. Transport death
        classifies by the streamed-token count: zero → the dead worker
        never admitted anything observable (never-admitted
        ``EngineStopped``, failover-eligible); some → admitted, terminal
        ``RpcTransportError``."""
        rid = request.request_id
        streamed = 0
        # generous per-frame bound: the engine's own deadline/watchdog
        # machinery bounds real decode gaps far tighter; this only keeps
        # a vanished-but-unclosed peer from wedging the reader forever
        frame_s = request.deadline_s + 5.0 \
            if request.deadline_s is not None else 600.0
        try:
            sock.settimeout(frame_s)
            while True:
                frame = pickle.loads(recv_msg(sock, self.secret))
                kind = frame[0]
                if kind == "tok":
                    streamed += 1
                    if request.stream is not None:
                        request.stream(rid, frame[2])
                elif kind == "done":
                    fut.set_result(frame[1])
                    return
                elif kind == "err":
                    fut.set_exception(frame[1])
                    return
                else:
                    fut.set_exception(RpcTransportError(
                        f"fleet stream for request {rid}: unexpected "
                        f"frame {kind!r}"))
                    return
        except (ConnectionError, OSError, EOFError) as e:
            if streamed == 0:
                fut.set_exception(EngineStopped(
                    f"worker {self.name} died before request {rid} was "
                    f"admitted (zero tokens streamed): {e}"))
            else:
                fut.set_exception(RpcTransportError(
                    f"worker {self.name} died mid-stream for request "
                    f"{rid} after {streamed} tokens: {e}"))
        except BaseException as e:           # never strand the Future
            fut.set_exception(e)
        finally:
            sock.close()


class ProcessReplica(Replica):
    """A :class:`Replica` whose engine lives in another process. Same
    breaker, same routing signals — but health comes from the heartbeat
    relay instead of an in-process beacon registry."""

    def __init__(self, name: str, engine: RemoteEngine, *,
                 breaker_threshold: int = 3, breaker_cooldown: float = 0.5):
        super().__init__(name, engine, breaker_threshold=breaker_threshold,
                         breaker_cooldown=breaker_cooldown)

    def stale(self) -> bool:
        return self.engine.stale()


@dataclass(eq=False)
class _Worker:
    """Supervisor-side record of one worker process."""

    spec: FleetWorkerSpec
    client: RemoteEngine
    proc: subprocess.Popen
    gen: int = 0            # incarnation counter (names the port file)
    respawns: int = 0


class FleetSupervisor:
    """Spawn, monitor, respawn; own the router over the process fleet."""

    def __init__(self, specs: Sequence[FleetWorkerSpec], *,
                 router_config: Optional[RouterConfig] = None,
                 workdir: Optional[str] = None,
                 spawn_timeout_s: Optional[float] = None,
                 poll_s: float = 0.25,
                 rpc_timeout_s: float = 5.0,
                 stale_after_s: Optional[float] = None,
                 max_respawns: Optional[int] = None):
        if not specs:
            raise ValueError("fleet needs at least one worker spec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate worker names in {names}")
        self._specs = list(specs)
        self._router_config = router_config
        self._workdir = workdir or tempfile.mkdtemp(prefix="paddle-tpu-fleet-")
        self._spawn_timeout_s = spawn_timeout_s if spawn_timeout_s \
            is not None else float(os.environ.get(
                "PADDLE_TPU_FLEET_SPAWN_S", "") or 180.0)
        self._poll_s = float(poll_s)
        self._rpc_timeout_s = float(rpc_timeout_s)
        self._stale_after_s = stale_after_s if stale_after_s is not None \
            else float(os.environ.get("PADDLE_TPU_FLEET_STALE_S", "") or 10.0)
        self.max_respawns = max_respawns if max_respawns is not None \
            else env_int("PADDLE_TPU_FLEET_MAX_RESPAWNS", 3)
        self._secret = _secrets.token_bytes(32)
        self._workers: Dict[str, _Worker] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.router: Optional[Router] = None
        #: respawn-exhausted / unspawnable workers: name -> FleetWorkerLost
        self.lost: Dict[str, FleetWorkerLost] = {}

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        """Spawn every worker, wait for readiness, build + start the
        router over :class:`ProcessReplica` adapters, start the monitor
        thread. A worker that cannot come up inside the spawn budget
        fails the start with :class:`FleetWorkerLost` (partial fleets are
        torn down — a supervisor either starts whole or not at all)."""
        procs = []
        workers = []
        try:
            for spec in self._specs:
                procs.append((spec, self._spawn_proc(spec, gen=0)))
            for spec, proc in procs:
                port = self._await_port(spec, proc, gen=0)
                client = RemoteEngine(
                    spec.name, "127.0.0.1", port, self._secret,
                    rpc_timeout_s=self._rpc_timeout_s,
                    stale_after_s=self._stale_after_s)
                client.beat(timeout=self._rpc_timeout_s)
                workers.append(_Worker(spec=spec, client=client, proc=proc))
        except BaseException:
            for _spec, proc in procs:
                self._terminate(proc, grace_s=2.0)
            raise
        cfg = self._router_config or RouterConfig()
        replicas = [ProcessReplica(
            w.spec.name, w.client,
            breaker_threshold=cfg.breaker_threshold,
            breaker_cooldown=cfg.breaker_cooldown)
            for w in workers]
        router = Router(replicas, cfg)
        router.start()
        self._stop.clear()
        monitor = threading.Thread(
            target=self._monitor_loop, name="paddle-tpu-fleet", daemon=True)
        with self._lock:
            for w in workers:
                self._workers[w.spec.name] = w
            self.router = router
            self._monitor = monitor
        monitor.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop routing (latching every replica out before any drain, the
        router's ordering), drain the workers over RPC, then SIGTERM and
        reap them (SIGKILL past the grace)."""
        self._stop.set()
        with self._lock:
            t = self._monitor
            self._monitor = None
        if t is not None:
            t.join(timeout=10.0)
        with self._lock:
            router = self.router
            workers = list(self._workers.values())
        if router is not None:
            router.stop(drain=drain, timeout=timeout)
        for w in workers:
            self._terminate(w.proc, grace_s=10.0)
        _trace.heartbeat_clear("serving.fleet")

    def submit(self, request: GenerationRequest
               ) -> "Future[GenerationResult]":
        with self._lock:
            router = self.router
        if router is None:
            raise EngineStopped("fleet supervisor is not started")
        return router.submit(request)

    # -- spawning -------------------------------------------------------
    def _port_file(self, spec: FleetWorkerSpec, gen: int) -> str:
        return os.path.join(self._workdir, f"{spec.name}.{gen}.port")

    def _spawn_proc(self, spec: FleetWorkerSpec,
                    gen: int) -> subprocess.Popen:
        # deferred import: the worker entry runs under ``python -m``, and
        # loading it as a side effect of ``import paddle_tpu_torch.serving``
        # inside the child would execute the module twice (runpy warns)
        from . import fleet_worker as _worker_mod

        _faults.fault_point("fleet.spawn")
        port_file = self._port_file(spec, gen)
        if os.path.exists(port_file):
            os.remove(port_file)
        doc = {"name": spec.name, "factory": spec.factory,
               "config": spec.config, "port_file": port_file,
               "pythonpath": spec.pythonpath, "warmup": spec.warmup}
        env = os.environ.copy()
        env.update(spec.env)
        env[_worker_mod.SPEC_ENV] = json.dumps(doc)
        env[_worker_mod.SECRET_ENV] = self._secret.hex()
        return subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.fleet_worker"],
            env=env)

    def _await_port(self, spec: FleetWorkerSpec, proc: subprocess.Popen,
                    gen: int) -> int:
        """Poll for the worker's atomically-published port file, bounded
        by the spawn budget; a child that exits first fails fast with its
        exit status instead of burning the whole budget."""
        port_file = self._port_file(spec, gen)
        deadline = time.monotonic() + self._spawn_timeout_s
        while time.monotonic() < deadline:
            rc = proc.poll()
            if rc is not None:
                raise FleetWorkerLost(
                    f"worker {spec.name} (gen {gen}) exited with status "
                    f"{rc} before publishing its port")
            if os.path.exists(port_file):
                with open(port_file, encoding="utf-8") as fh:
                    return int(json.load(fh)["port"])
            jitter_sleep(0.05)
        self._terminate(proc, grace_s=2.0)
        raise FleetWorkerLost(
            f"worker {spec.name} (gen {gen}) not ready within "
            f"{self._spawn_timeout_s:.0f}s")

    @staticmethod
    def _terminate(proc: subprocess.Popen, grace_s: float) -> None:
        if proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass   # zombie at most: the monitor no longer tracks it

    # -- monitoring -----------------------------------------------------
    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            _trace.heartbeat("serving.fleet", ttl_s=_HEARTBEAT_TTL_S)
            with self._lock:
                snapshot = list(self._workers.values())
            for w in snapshot:
                if self._stop.is_set():
                    break
                if w.spec.name in self.lost:
                    continue
                rc = w.proc.poll()
                if rc is not None:
                    self._on_death(w, rc)
                    continue
                try:
                    w.client.beat(timeout=self._rpc_timeout_s)
                except (ConnectionError, OSError):
                    # missed beat: stale() latches the replica out of
                    # rotation once beat_age crosses the threshold; a
                    # later good beat restores it — no state to keep here
                    pass
            self._publish_gauges()
            jitter_sleep(self._poll_s)

    def _publish_gauges(self) -> None:
        states = {"up": 0, "stale": 0, "lost": 0}
        with self._lock:
            snapshot = list(self._workers.values())
        for w in snapshot:
            if w.spec.name in self.lost:
                states["lost"] += 1
            elif w.client.stale():
                states["stale"] += 1
            else:
                states["up"] += 1
        for state, n in states.items():
            _obs.set_gauge("fleet.replicas", n, state=state)

    def _death_reason(self, rc: int) -> str:
        if rc < 0:
            try:
                return f"signal:{_signal.Signals(-rc).name}"
            except ValueError:
                return f"signal:{-rc}"
        return f"exit:{rc}"

    def _on_death(self, w: _Worker, rc: int) -> None:
        """The crash path: latch the replica out FIRST (no failover or
        hedge may target a dead worker), count the death, then respawn
        under the capped jittered backoff. The latch-before-anything
        ordering is the same no-new-admissions contract as
        ``drain_replica``."""
        name = w.spec.name
        reason = self._death_reason(rc)
        _obs.inc("fleet.worker_deaths_total", reason=reason)
        _trace.record("fleet_death", worker=name, reason=reason,
                      gen=w.gen)
        with self._lock:
            router = self.router
        if router is not None:
            router.latch_out(name)
        policy = get_policy("fleet.respawn", base_delay=0.2,
                            multiplier=2.0, max_delay=5.0, jitter=0.25)
        while not self._stop.is_set():
            if w.respawns >= self.max_respawns:
                exc = FleetWorkerLost(
                    f"worker {name} died ({reason}) and its respawn cap "
                    f"({self.max_respawns}) is exhausted")
                self.lost[name] = exc
                _obs.inc("fleet.respawn_giveups_total")
                return
            w.respawns += 1
            # capped exponential backoff between incarnations; jittered so
            # a correlated crash doesn't respawn the whole fleet in
            # lockstep
            delay = min(
                policy.base_delay * policy.multiplier ** (w.respawns - 1),
                policy.max_delay)
            jitter_sleep(delay, frac=policy.jitter)
            if self._stop.is_set():
                return
            w.gen += 1
            _obs.inc("fleet.respawns_total")
            spawned_at = time.time()
            try:
                proc = self._spawn_proc(w.spec, gen=w.gen)
                port = self._await_port(w.spec, proc, gen=w.gen)
            except (FleetWorkerLost, OSError) as e:
                _trace.record("fleet_respawn_failed", worker=name,
                              gen=w.gen, error=str(e))
                continue
            port_at = time.time()
            w.proc = proc
            w.client.repoint(port)
            try:
                w.client.beat(timeout=self._rpc_timeout_s)
            except (ConnectionError, OSError):
                self._terminate(proc, grace_s=2.0)
                continue
            if router is not None:
                # breaker reset + back into rotation: the old incarnation's
                # failures say nothing about the fresh process
                router.restore_replica(name)
            # wall-clock instants (the worker's own, in its beat's "boot",
            # share the clock): spawn, port file seen, first good beat
            _trace.record("fleet_respawned", worker=name, gen=w.gen,
                          spawned_at=spawned_at, port_at=port_at,
                          beat_at=time.time())
            return

    # -- introspection --------------------------------------------------
    def drain_worker(self, name: str,
                     timeout: Optional[float] = None) -> None:
        """Latch ``name`` out of rotation, THEN drain it over RPC —
        the restart-without-crash path (config rollouts). The worker
        process stays up (drained engines restart with the process);
        callers typically SIGTERM + let the monitor respawn, or call
        :meth:`FleetSupervisor.stop`."""
        with self._lock:
            router = self.router
        if router is None:
            raise EngineStopped("fleet supervisor is not started")
        router.drain_replica(name, timeout=timeout)

    def worker_pids(self) -> Dict[str, int]:
        with self._lock:
            return {n: w.proc.pid for n, w in self._workers.items()}

    def worker_stats(self, name: str) -> Dict[str, Any]:
        """The last cached heartbeat document for ``name``."""
        with self._lock:
            w = self._workers[name]
        with w.client._lock:
            return dict(w.client._stats)
