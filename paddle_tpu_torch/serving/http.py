"""The streaming HTTP front door over ``submit``: the port's copy of
``paddle_tpu/serving/http.py``, with the same routes, documents, headers,
status table, fault site and metrics.

One stdlib ``ThreadingHTTPServer`` (the scaffolding shared with the
``observability.http`` scrape endpoint: :class:`ServerHost` and
:class:`QuietJSONHandler`) turning the engine's and router's typed
failures into HTTP statuses:

* ``POST /v1/generate``: body ``{"prompt": [ints], "max_new_tokens": N,
  "eos_token_id": id?, "stream": bool}``; per-request budgets ride the
  ``X-Deadline-S`` / ``X-TTFT-Budget-S`` headers (float seconds, end to end
  from submit; they become ``GenerationRequest.deadline_s`` /
  ``ttft_budget_s``). ``stream: true`` answers SSE-style: one ``data:
  {"token": t, "index": i}`` event per token as the engine emits it, then
  exactly one typed terminal event, ``event: done`` with the full result
  or ``event: error`` with the mapped status. A drain resolves every
  in-flight Future, so every live stream ends with its terminal event.
  Tokens reach the handler thread through a queue: the engine's loop
  thread only puts, so a slow client never stalls a decode step.
* ``GET /healthz``: the beacon detail (:func:`observability.trace.health`),
  plus the router's rotation when the backend is a
  :class:`~paddle_tpu_torch.serving.router.Router`.
* ``GET /metrics``: Prometheus text.

The exception -> status table:

==============================  =====  ==================================
:class:`QueueFull`              429    queue at capacity; ``Retry-After``
:class:`DeadlineExceeded`       429    shed on arrival (the exception
(shed: carries the estimate)           carries the EWMA estimate)
:class:`DeadlineExceeded`       504    deadline/TTFT budget expired
:class:`EngineStopped`          503    draining/stopped (DrainTimeout
(and subclasses)                       included: evicted at drain budget)
:class:`NoHealthyReplica`,      503    nothing to place on / transport
:class:`BreakerOpen`,                  failure before admission
:class:`WatchdogTimeout`,
``ConnectionError``
:class:`RpcTransportError`      503    fleet worker died after admitting
                                       (tokens already streamed): at most
                                       once forbids a silent re-send;
                                       ``Retry-After`` tells the client
                                       to resubmit
``ValueError``                  400    malformed request
anything else                   500    a bug, never overload
==============================  =====  ==================================

``Retry-After`` (429/503): the scheduler's EWMA drain interval per queued
request, ``estimated_wait_s / depth`` from the detail the rejection
carries ("one queue slot frees in about this long"); without an estimate
(cold EWMA) 1 s. The integer header rounds up; the JSON error body carries
the float ``retry_after_s``.

``http.write`` is a fault site before every streamed write: an injected
error is retried once (the bytes never left: the same payload is resent,
``serving.http.write_retries_total``), a second consecutive fault or a
real ``BrokenPipeError`` is a client disconnect, and the request is
cancelled upstream so its slot and pages free
(``serving.http.disconnects_total``).
"""

from __future__ import annotations

import json
import logging
import math
import queue
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import observability as _obs
from ..observability import trace as _trace
from ..observability.http import QuietJSONHandler, ServerHost
from ..resilience import DeadlineExceeded, faults as _faults
from ..resilience.breaker import BreakerOpen
from ..distributed.rpc import RpcTransportError
from .engine import EngineStopped
from .router import NoHealthyReplica, Router
from .scheduler import GenerationRequest, QueueFull
from .watchdog import WatchdogTimeout

__all__ = ["FrontDoor", "status_for", "retry_after_s"]

_log = logging.getLogger(__name__)

# extra seconds past a request's own deadline the stream reader waits for
# the terminal Future resolution before declaring the backend wedged
_TERMINAL_GRACE_S = 5.0


#: the typed failure surface, as data: first ``isinstance`` match wins, so
#: subclasses that answer differently from their base sit earlier in the
#: table (``NoHealthyReplica`` before ``ConnectionError``;
#: ``DeadlineExceeded``, a ``TimeoutError``, is special-cased in
#: :func:`status_for` above its ``FutureTimeout`` alias). The JAX
#: package's table, entry for entry.
_STATUS_MAP: Tuple[Tuple[type, int], ...] = (
    (QueueFull, 429),
    (FutureTimeout, 504),
    (EngineStopped, 503),
    (NoHealthyReplica, 503),
    (BreakerOpen, 503),
    (WatchdogTimeout, 503),
    # a fleet worker that died AFTER admitting (tokens streamed): the
    # at-most-once contract forbids a silent re-send, so the client gets
    # an honest 503 + Retry-After and decides. Sits above its
    # ConnectionError base only for documentation — both answer 503.
    (RpcTransportError, 503),
    (ConnectionError, 503),
    (ValueError, 400),
)


def status_for(exc: BaseException) -> int:
    """The typed failure surface → HTTP status (``_STATUS_MAP``).
    Overload is 429, expiry 504, unavailability 503 — a 500 can only
    mean a bug, never backpressure."""
    if isinstance(exc, DeadlineExceeded):
        # shed-on-arrival carries the backpressure detail: overload (429,
        # retry later), not an expired budget (504, the request is dead)
        return 429 if getattr(exc, "estimated_wait_s", None) is not None \
            else 504
    for typ, status in _STATUS_MAP:
        if isinstance(exc, typ):
            return status
    return 500


def retry_after_s(exc: BaseException, backend: Any = None
                  ) -> Optional[float]:
    """Seconds a 429/503 client should wait: the EWMA drain interval per
    queued request from the rejection's own detail, the backend's live
    estimate as fallback, 1 s when the EWMA is cold. None for statuses
    where retrying cannot help (400/404/500/504)."""
    if status_for(exc) not in (429, 503):
        return None
    est = getattr(exc, "estimated_wait_s", None)
    depth = getattr(exc, "depth", 0) or 0
    if est is None and backend is not None:
        est = _backend_wait(backend)
        depth = 0
    if not est or est <= 0:
        return 1.0
    return est / depth if depth else est


def _backend_wait(backend: Any) -> float:
    if isinstance(backend, Router):
        return backend.estimated_wait()
    sched = getattr(backend, "scheduler", None)
    return sched.estimated_wait() if sched is not None else 0.0


def _error_doc(exc: BaseException, backend: Any = None) -> Tuple[int, Dict]:
    status = status_for(exc)
    doc: Dict[str, Any] = {"error": type(exc).__name__,
                           "message": str(exc), "status": status}
    ra = retry_after_s(exc, backend)
    if ra is not None:
        doc["retry_after_s"] = round(ra, 4)
    return status, doc


def _header_seconds(headers, name: str) -> Optional[float]:
    raw = (headers.get(name) or "").strip()
    if not raw:
        return None
    val = float(raw)       # ValueError -> 400 via the handler's catch
    # `not (val > 0)` rather than `val <= 0`: NaN fails BOTH comparisons,
    # and a NaN deadline would make every scheduler expiry check False
    # (an unexpirable request) while feeding NaN into timeout math
    if not (val > 0) or val == float("inf"):
        raise ValueError(f"{name} must be finite > 0 seconds, got {raw!r}")
    return val


class _FrontDoorHTTPServer(ThreadingHTTPServer):
    """Carries the front-door object so per-request handler threads reach
    the backend without shared class-level state. Its listen backlog takes
    a burst of clients: at socketserver's default of 5, connections past
    the queue are dropped and their clients retry after a second."""

    request_queue_size = 128

    def __init__(self, addr, handler, front: "FrontDoor"):
        super().__init__(addr, handler)
        self.front = front


class _Handler(QuietJSONHandler):
    server_version = "paddle-tpu-serving/1"

    # -- plumbing -------------------------------------------------------
    @property
    def _front(self) -> "FrontDoor":
        return self.server.front

    def _send_error_doc(self, exc: BaseException) -> None:
        status, doc = _error_doc(exc, self._front.backend)
        headers = {}
        if "retry_after_s" in doc:
            headers["Retry-After"] = int(math.ceil(doc["retry_after_s"]))
        _obs.inc("serving.http.requests_total", status=str(status))
        self._send_json(status, doc, headers)

    # -- routes ---------------------------------------------------------
    def do_GET(self):   # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/healthz":
                doc = _trace.health()
                backend = self._front.backend
                if isinstance(backend, Router):
                    doc["router"] = {
                        "in_rotation": backend.in_rotation(),
                        "replicas": [r.name for r in backend.replicas]}
                self._send_json(200 if doc["status"] == "ok" else 503, doc)
            elif path == "/metrics":
                self._send(200, _obs.prometheus_text().encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._send_json(404, {"error": "not found", "routes": [
                    "/healthz", "/metrics", "POST /v1/generate"]})
        except (BrokenPipeError, ConnectionResetError):
            pass  # why: the client hung up mid-response; nothing to serve
        except Exception:
            _log.exception("front door: GET handler failed for %s",
                           self.path)
            try:
                self._send_json(500, {"error": "internal"})
            except OSError:
                pass  # why: the response socket is already gone

    def do_POST(self):   # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path != "/v1/generate":
            self._send_json(404, {"error": "not found", "routes": [
                "/healthz", "/metrics", "POST /v1/generate"]})
            return
        try:
            self._generate()
        except (BrokenPipeError, ConnectionResetError):
            pass  # why: the client hung up mid-response; nothing to serve
        except Exception:
            _log.exception("front door: POST /v1/generate failed")
            try:
                self._send_json(500, {"error": "internal"})
            except OSError:
                pass  # why: the response socket is already gone

    # -- the generate flow ----------------------------------------------
    def _parse_request(self) -> Tuple[GenerationRequest, bool]:
        length = int(self.headers.get("Content-Length") or 0)
        doc = json.loads(self.rfile.read(length) or b"{}")
        if not isinstance(doc, dict) or "prompt" not in doc:
            raise ValueError('body must be a JSON object with "prompt"')
        req = GenerationRequest(
            prompt=np.asarray(doc["prompt"], np.int32),
            max_new_tokens=int(doc.get("max_new_tokens", 64)),
            eos_token_id=doc.get("eos_token_id"),
            deadline_s=_header_seconds(self.headers, "X-Deadline-S"),
            ttft_budget_s=_header_seconds(self.headers, "X-TTFT-Budget-S"))
        return req, bool(doc.get("stream", False))

    def _generate(self) -> None:
        t0 = time.monotonic()
        try:
            req, stream = self._parse_request()
        except Exception as exc:
            # PARSE-time failures are the client's fault by construction
            # (bad JSON/ints/headers raise assorted ValueError/TypeError/
            # KeyError): force 400 here rather than widening status_for —
            # the same types raised later by backend code are server bugs
            # and must keep reading 500
            _obs.inc("serving.http.requests_total", status="400")
            self._send_json(400, {"error": type(exc).__name__,
                                  "message": str(exc), "status": 400})
            return
        front = self._front
        events: "queue.Queue" = queue.Queue()
        if stream:
            req.stream = lambda rid, tok: events.put(("token", tok))
        try:
            fut = front.backend.submit(req)
        except Exception as exc:
            # the typed submit-time surface: QueueFull/shed -> 429 with
            # Retry-After, draining -> 503, bad request -> 400
            self._send_error_doc(exc)
            return
        fut.add_done_callback(lambda f: events.put(("end", f)))
        budget = (req.deadline_s + _TERMINAL_GRACE_S) if req.deadline_s \
            else front.default_timeout_s
        if stream:
            self._stream_response(req, events, budget, t0)
        else:
            self._unary_response(req, fut, budget, t0)

    def _unary_response(self, req: GenerationRequest, fut, budget: float,
                        t0: float) -> None:
        try:
            res = fut.result(timeout=budget)
        except FutureTimeout as exc:
            # the backend broke its always-resolves contract (a paused
            # engine): tell the truth with a 504 and free the slot
            self._front.backend.cancel(req.request_id)
            self._send_error_doc(exc)
            return
        except Exception as exc:
            self._send_error_doc(exc)
            return
        _obs.inc("serving.http.requests_total", status="200")
        _obs.observe("serving.http.request_seconds",
                     time.monotonic() - t0)
        self._send_json(200, {
            "request_id": res.request_id, "tokens": res.tokens,
            "finish_reason": res.finish_reason, "ttft_s": res.ttft_s,
            "tpot_s": res.tpot_s})

    # -- SSE streaming ---------------------------------------------------
    def _write_frame(self, payload: bytes) -> bool:
        """One streamed write through the ``http.write`` fault seam: an
        injected fault is retried once (the bytes never left the
        process — the SAME payload is resent, so a single fault is
        invisible to the client), a second fault or a real broken pipe
        reports the client gone."""
        for attempt in (0, 1):
            try:
                _faults.fault_point("http.write")
                self.wfile.write(payload)
                self.wfile.flush()
                return True
            except (BrokenPipeError, ConnectionResetError):
                return False       # the client actually hung up
            except Exception:
                if attempt:
                    return False
                _obs.inc("serving.http.write_retries_total")
        return False

    def _stream_response(self, req: GenerationRequest,
                         events: "queue.Queue", budget: float,
                         t0: float) -> None:
        _obs.inc("serving.http.streams_total")
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-store")
        self.send_header("Connection", "close")
        self.end_headers()
        deadline = time.monotonic() + budget
        index = 0
        while True:
            try:
                kind, val = events.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                # the terminal-resolution grace expired: typed terminal
                # error, slot freed upstream — never a silently hung socket
                self._front.backend.cancel(req.request_id)
                exc = FutureTimeout(
                    f"request {req.request_id}: no terminal event within "
                    f"{budget:.1f}s")
                status, doc = _error_doc(exc, self._front.backend)
                _obs.inc("serving.http.requests_total", status=str(status))
                self._write_frame(
                    b"event: error\ndata: " +
                    json.dumps(doc).encode("utf-8") + b"\n\n")
                return
            if kind == "token":
                ok = self._write_frame(
                    b"data: " + json.dumps(
                        {"token": int(val), "index": index}
                    ).encode("utf-8") + b"\n\n")
                index += 1
                if not ok:
                    # client gone (real or double-injected): cancel so the
                    # slot and its pages free instead of decoding to a
                    # dead socket
                    _obs.inc("serving.http.disconnects_total")
                    self._front.backend.cancel(req.request_id)
                    self._drain_terminal(events)
                    return
                continue
            fut = val
            exc = fut.exception()
            if exc is None:
                res = fut.result()
                _obs.inc("serving.http.requests_total", status="200")
                _obs.observe("serving.http.request_seconds",
                             time.monotonic() - t0)
                self._write_frame(
                    b"event: done\ndata: " + json.dumps({
                        "request_id": res.request_id,
                        "tokens": res.tokens,
                        "finish_reason": res.finish_reason,
                        "ttft_s": res.ttft_s, "tpot_s": res.tpot_s,
                    }).encode("utf-8") + b"\n\n")
            else:
                status, doc = _error_doc(exc, self._front.backend)
                _obs.inc("serving.http.requests_total", status=str(status))
                self._write_frame(
                    b"event: error\ndata: " +
                    json.dumps(doc).encode("utf-8") + b"\n\n")
            return

    def _drain_terminal(self, events: "queue.Queue") -> None:
        """The client is gone but the terminal event is still owed (the
        cancel above resolves the Future): consume it so the done
        callback never blocks, without writing to the dead socket."""
        try:
            while True:
                kind, _val = events.get(timeout=_TERMINAL_GRACE_S)
                if kind == "end":
                    return
        except queue.Empty:
            return   # cancel raced a terminal already consumed: nothing owed


class FrontDoor(ServerHost):
    """The serving tier's HTTP listener. ``backend`` is anything with the
    ``submit``/``cancel`` surface — one :class:`Engine` or a
    :class:`Router` over K replicas. ``port=0`` binds ephemeral (read
    ``.port``/``.url`` back); ``close()`` stops the listener (drain the
    backend FIRST — its resolving Futures are what end live streams with
    their typed terminal events)."""

    def __init__(self, backend, port: int = 0, host: str = "127.0.0.1",
                 default_timeout_s: float = 300.0):
        self.backend = backend
        self.default_timeout_s = default_timeout_s
        super().__init__(_FrontDoorHTTPServer((host, port), _Handler, self),
                         thread_name="paddle-tpu-front-door")
