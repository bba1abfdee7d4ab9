"""``python -m paddle_tpu_torch.serving.fleet_worker``: one fleet replica
process. The port's copy of ``paddle_tpu/serving/fleet_worker.py``, with
the same spec, wire protocol and signals.

The :class:`~paddle_tpu_torch.serving.fleet.FleetSupervisor` starts this
module once per replica (a fresh interpreter, never a fork); it builds an
:class:`~paddle_tpu_torch.serving.engine.Engine` from a serialized spec and
serves the engine's surface over the ``distributed/rpc.py`` framing
(length-prefixed, HMAC'd; the fleet secret comes through the environment,
never over the wire). It imports the port and the factory's module only:
no JAX.

Spec (JSON in ``$PADDLE_TPU_FLEET_SPEC``)::

    {"name": "r0",                         # replica name (beacon identity)
     "factory": "my_models:make_engine",   # module:callable -> Engine
     "config": {...},                      # factory kwargs (name included)
     "port_file": "/run/fleet/r0.0.port",  # where to publish {port, pid}
     "pythonpath": ["/extra/dirs"],        # prepended to sys.path
     "warmup": [8, 16]}                    # optional Engine.warmup lens

The factory decides the device as the port's entry points do: without
``device`` in its config it needs a card, and without one the worker exits
non-zero before it publishes a port (the supervisor reports that as
:class:`~paddle_tpu_torch.serving.fleet.FleetWorkerLost`); the CPU is used
only when the config asks for it.

Wire protocol: one pickled tuple per MAC'd frame, one request per
connection:

* request: ``(method, payload)``; unary reply ``("ok", value)`` or
  ``("raise", exc)`` (the exception instance crosses the wire and re-raises
  on the client with its original type, so the router's typed arms,
  ``QueueFull``/``DeadlineExceeded``/``ValueError``/``EngineStopped``,
  carry over);
* ``submit`` streams: first ``("accepted", rid)`` (the queue took it) or a
  single ``("raise", exc)``; then ``("tok", rid, token)`` per token as the
  engine's loop thread emits it (through a queue: the loop thread never
  waits on the socket); then exactly one terminal ``("done",
  GenerationResult)`` or ``("err", exc)``. A client that vanishes
  mid-stream is a cancel upstream, so the request's slot and pages free.

``SIGTERM`` -> ``Engine.stop(drain=True)`` bounded by
``$PADDLE_TPU_FLEET_DRAIN_S`` (default 30 s): in-flight work finishes,
queued never-admitted work resolves with the never-admitted
``EngineStopped`` (the supervisor's router fails it over), then the process
exits 0 (3 when the drain evicted stragglers at its budget). ``SIGKILL`` is
what the supervisor's waitpid and heartbeat monitor exist for.

The worker turns observability on: the port's engine beats its
``serving.engine.<name>`` beacon only then, and the heartbeat relays that
beacon's staleness, so a loop thread wedged in a device call takes the
replica out of rotation although the process still answers. The beat also
carries the boot's split (``boot``: wall-clock instants of the worker's
start and of its published port, the factory's and the warm-up's seconds).

A respawned worker re-captures its graphs in ``Engine.warmup``: CUDA graphs
cannot cross processes, and the kernels are already built on disk, so the
JAX worker's compile-cache directory has no counterpart.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import queue
import signal
import socketserver
import sys
import threading
import time
from typing import Any, Dict, Tuple

import numpy as np

from ..distributed.rpc import recv_msg as _recv_msg, send_msg as _send_msg

SPEC_ENV = "PADDLE_TPU_FLEET_SPEC"
SECRET_ENV = "PADDLE_TPU_FLEET_SECRET"
DRAIN_ENV = "PADDLE_TPU_FLEET_DRAIN_S"

# per-wait bound on the streaming handler's token-queue poll; the loop is
# re-armed until the request's Future resolves (the engine's no-stranded-
# futures invariant is what terminates it)
_STREAM_POLL_S = 2.0


def _load_factory(spec: Dict[str, Any]):
    mod_name, _, attr = spec["factory"].partition(":")
    if not mod_name or not attr:
        raise ValueError(
            f"factory must be 'module:callable', got {spec['factory']!r}")
    module = importlib.import_module(mod_name)
    return getattr(module, attr)


# ---------------------------------------------------------------------------
# unary service handlers: a raise out of a ``_srv_*`` is sent back as a
# typed ("raise", exc) envelope by the dispatcher
# ---------------------------------------------------------------------------

def _srv_cancel(worker: "_Worker", payload: Dict[str, Any]) -> bool:
    return worker.engine.cancel(int(payload["request_id"]))


def _srv_withdraw(worker: "_Worker", payload: Dict[str, Any]) -> bool:
    """Atomically remove a QUEUED request (the supervisor-side hedge's
    never-admitted proof). The popped pending's Future resolves with the
    never-admitted ``EngineStopped`` so its streaming handler terminates —
    no stranded futures, and the hedging router discards the stale
    resolution."""
    from .engine import EngineStopped

    rid = int(payload["request_id"])
    pending = worker.engine.scheduler.withdraw(rid)
    if pending is None:
        return False
    pending.future.set_exception(EngineStopped(
        f"request {rid} withdrawn from {worker.name} by fleet hedge"))
    return True


def _srv_drain(worker: "_Worker", payload: Dict[str, Any]) -> None:
    worker.engine.stop(
        drain=bool(payload.get("drain", True)),
        timeout=payload.get("timeout"),
        on_timeout=payload.get("on_timeout", "fail"))


def _srv_prefix_summary(worker: "_Worker", payload: Dict[str, Any]):
    return worker.engine.prefix_summary()


def _srv_beat(worker: "_Worker", payload: Dict[str, Any]) -> Dict[str, Any]:
    """The heartbeat document the supervisor's monitor thread polls: the
    engine's own liveness beacon detail (a step loop wedged inside a
    device call stops beating; the supervisor must see that even though
    the process is alive), the routing signals the ProcessReplica caches
    for the router's placement, and the boot's split."""
    from ..observability import trace as _trace

    eng = worker.engine
    detail = _trace.beacon_detail(eng.beacon)
    return {
        "name": worker.name,
        "pid": os.getpid(),
        "beacon_stale": bool(detail and detail["stale"]),
        "queue_depth": eng.queue_depth,
        "estimated_wait": eng.scheduler.estimated_wait(),
        "draining": eng.draining,
        "outstanding_pages": eng.kv.outstanding_pages,
        "active_requests": eng.active_requests,
        "boot": dict(worker.boot),
    }


_UNARY = {
    "cancel": _srv_cancel,
    "withdraw": _srv_withdraw,
    "drain": _srv_drain,
    "prefix_summary": _srv_prefix_summary,
    "beat": _srv_beat,
}


def _srv_submit(worker: "_Worker", payload: Dict[str, Any], send) -> None:
    """The streaming handler: admit, ack, then pump tokens until the
    request's Future resolves. Runs on this connection's handler thread —
    the engine step thread only ever touches the in-process token queue,
    so a slow client can never stall a decode step."""
    from .scheduler import GenerationRequest

    frames: "queue.Queue[Tuple]" = queue.Queue()
    try:
        rid = int(payload["request_id"])
        request = GenerationRequest(
            prompt=np.asarray(payload["prompt"], np.int32),
            max_new_tokens=int(payload["max_new_tokens"]),
            eos_token_id=payload.get("eos_token_id"),
            deadline_s=payload.get("deadline_s"),
            ttft_budget_s=payload.get("ttft_budget_s"),
            request_id=rid,
            stream=lambda r, t: frames.put(("tok", r, int(t))))
        fut = worker.engine.submit(request)
    except Exception as exc:
        # a sync typed rejection (QueueFull, shed, ValueError,
        # EngineStopped), never admitted: shipped as ("raise", exc) and
        # re-raised on the submitting thread. Sent from here, not from the
        # dispatcher, whose transport arm would take DeadlineExceeded (a
        # TimeoutError, so an OSError) for a dead socket and hang up
        send(("raise", exc))
        return
    fut.add_done_callback(lambda f: frames.put(("fin", f)))
    send(("accepted", rid))
    try:
        while True:
            try:
                frame = frames.get(timeout=_STREAM_POLL_S)
            except queue.Empty:
                continue   # engine still decoding; futures never strand
            if frame[0] != "fin":
                send(frame)
                continue
            # the done-callback delivered this Future: both reads are
            # immediate; the timeout only bounds them
            exc = frame[1].exception(timeout=1.0)
            send(("err", exc) if exc is not None
                 else ("done", frame[1].result(timeout=1.0)))
            return
    except (ConnectionError, OSError):
        # the client vanished mid-stream: cancel upstream so the slot and
        # its pages free now instead of decoding for nobody
        worker.engine.cancel(rid)
        raise


class _Worker:
    """Process-wide state shared by the handler threads."""

    def __init__(self, name: str, engine, secret: bytes, boot: Dict):
        self.name = name
        self.engine = engine
        self.secret = secret
        self.boot = boot


class _FleetServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, handler, worker: _Worker):
        super().__init__(addr, handler)
        self.worker = worker


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        worker: _Worker = self.server.worker
        sock = self.request

        def send(frame) -> None:
            _send_msg(sock, pickle.dumps(frame), worker.secret)

        try:
            method, payload = pickle.loads(
                _recv_msg(sock, worker.secret))
            if method == "submit":
                _srv_submit(worker, payload, send)
                return
            fn = _UNARY.get(method)
            if fn is None:
                send(("raise", ValueError(f"unknown method {method!r}")))
                return
            try:
                result = ("ok", fn(worker, payload))
            except Exception as exc:
                result = ("raise", exc)
            send(result)
        except (ConnectionError, OSError):
            pass   # peer hung up: supervisor-side retry/failover owns it


def _write_port_file(path: str, port: int) -> None:
    """Publish {port, pid} atomically: the supervisor polls for this file
    and must never read a half-written document."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump({"port": port, "pid": os.getpid()}, fh)
    os.replace(tmp, path)


def main(argv=None) -> int:
    started_at = time.time()
    raw = os.environ.get(SPEC_ENV, "")
    if not raw:
        print(f"fleet_worker: ${SPEC_ENV} not set", file=sys.stderr)
        return 2
    spec = json.loads(raw)
    secret_hex = os.environ.get(SECRET_ENV, "")
    if not secret_hex:
        print(f"fleet_worker: ${SECRET_ENV} not set", file=sys.stderr)
        return 2
    secret = bytes.fromhex(secret_hex)
    for extra in reversed(spec.get("pythonpath", []) or []):
        if extra not in sys.path:
            sys.path.insert(0, extra)

    # the engine beats its beacon only with observability on, and the beat
    # relays that beacon
    from .. import observability as _obs
    _obs.enable()

    t0 = time.monotonic()
    factory = _load_factory(spec)
    engine = factory(**(spec.get("config") or {}))
    t1 = time.monotonic()
    warmup = spec.get("warmup")
    if warmup:
        engine.warmup(tuple(int(n) for n in warmup))
    boot = {"started_at": started_at, "factory_s": t1 - t0,
            "warmup_s": time.monotonic() - t1}
    engine.start()

    worker = _Worker(str(spec["name"]), engine, secret, boot)
    server = _FleetServer((spec.get("host", "127.0.0.1"), 0), _Handler,
                          worker)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever,
                              name="paddle-tpu-fleet-server", daemon=True)
    thread.start()
    boot["port_at"] = time.time()
    _write_port_file(spec["port_file"], port)

    term = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: term.set())
    while not term.is_set():
        term.wait(timeout=1.0)

    # graceful drain: finish in-flight work inside the budget; queued
    # never-admitted work resolves EngineStopped (the supervisor-side
    # router fails it over to a surviving replica)
    drain_raw = os.environ.get(DRAIN_ENV, "").strip()
    drain_s = float(drain_raw) if drain_raw else 30.0
    from .engine import DrainTimeout
    code = 0
    try:
        engine.stop(drain=True, timeout=drain_s, on_timeout="fail")
    except DrainTimeout:
        code = 3   # stragglers were evicted at the budget — visible exit
    server.shutdown()
    server.server_close()
    return code


if __name__ == "__main__":
    sys.exit(main())
