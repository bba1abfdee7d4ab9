"""The scrape endpoint: ``/metrics``, ``/healthz`` and ``/debug``. The
port's copy of ``paddle_tpu/observability/http.py`` (same routes, same
documents, same ``PADDLE_TPU_OBS_HTTP_PORT`` opt-in), on a stdlib
``ThreadingHTTPServer``:

* ``GET /metrics``: ``observability.prometheus_text()``;
* ``GET /healthz``: liveness from the :func:`trace.heartbeat` beacons the
  engine's step loop and the watchdog's poll thread ping: 200 while every
  beacon is fresh, 503 once one goes stale (a loop thread wedged in a
  device call stops beating); each component carries ``stale`` and
  ``ok``;
* ``GET /debug/flight``: the flight recorder's last-N-events snapshot;
* ``GET /debug/trace``: the trace buffer as Chrome trace-event JSON;
* ``GET /debug/cost``: the program cost registry's document (one record
  per live program, the HBM ledger, the utilization join, the device
  model; :func:`cost.debug_doc`).

The serving engine calls :func:`maybe_serve_from_env` at construction:
with ``PADDLE_TPU_OBS_HTTP_PORT`` set the process-global server starts
once (port 0 = ephemeral, read back from ``server.port`` or ``.url``);
unset, it costs one environment read.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import trace as _trace

__all__ = ["QuietJSONHandler", "ServerHost", "ObsHTTPServer",
           "start_http_server", "maybe_serve_from_env"]

_log = logging.getLogger(__name__)


class QuietJSONHandler(BaseHTTPRequestHandler):
    """Handler base: quiet request logging (scrapers poll: per-request
    stderr lines would drown the process log) plus byte/JSON response
    helpers."""

    server_version = "paddle-tpu/1"

    def log_message(self, fmt, *args):
        _log.debug("http: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str,
              headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, doc,
                   headers: Optional[dict] = None) -> None:
        self._send(code, json.dumps(doc, default=str).encode("utf-8"),
                   "application/json", headers)


class ServerHost:
    """One bound stdlib HTTP server on a daemon ``serve_forever`` thread.

    Owns the scaffolding every endpoint repeats: ``daemon_threads`` (a
    wedged handler must not block process exit), the ephemeral-port
    read-back (``port=0`` is the test/fleet-local pattern — read the real
    port from ``.port``), and a bounded ``close()`` (shutdown + join).
    The caller constructs the ``ThreadingHTTPServer`` and hands it here
    to run."""

    def __init__(self, httpd: ThreadingHTTPServer, thread_name: str):
        httpd.daemon_threads = True
        self._httpd = httpd
        self.host, self.port = httpd.server_address[:2]
        self._thread = threading.Thread(
            target=httpd.serve_forever, name=thread_name, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


class _Handler(QuietJSONHandler):
    server_version = "paddle-tpu-obs/1"

    def do_GET(self):   # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                from . import prometheus_text
                self._send(200, prometheus_text().encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                doc = _trace.health()
                self._send_json(200 if doc["status"] == "ok" else 503, doc)
            elif path == "/debug/flight":
                self._send_json(200, {
                    "pid": os.getpid(),
                    "capacity": _trace.flight_recorder().capacity,
                    "events": _trace.flight_recorder().snapshot()})
            elif path == "/debug/trace":
                self._send_json(200, _trace.export_chrome())
            elif path == "/debug/cost":
                from . import cost as _cost
                self._send_json(200, _cost.debug_doc())
            else:
                self._send_json(404, {"error": "not found", "routes": [
                    "/metrics", "/healthz", "/debug/flight",
                    "/debug/trace", "/debug/cost"]})
        except (BrokenPipeError, ConnectionResetError):
            pass  # why: the scraper hung up mid-response; nothing to serve
        except Exception:
            _log.exception("obs http: handler failed for %s", self.path)
            try:
                self._send_json(500, {"error": "internal"})
            except OSError:
                pass  # why: the response socket is already gone


class ObsHTTPServer(ServerHost):
    """One scrape endpoint on a daemon thread. ``port=0`` binds an
    ephemeral port (read it back from ``.port`` — the test/fleet-local
    pattern); ``close()`` shuts the listener down."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        super().__init__(ThreadingHTTPServer((host, port), _Handler),
                         thread_name="paddle-tpu-obs-http")


def start_http_server(port: int = 0,
                      host: str = "127.0.0.1") -> ObsHTTPServer:
    """Start a scrape endpoint explicitly (tests, embedders)."""
    return ObsHTTPServer(port=port, host=host)


_GLOBAL: Optional[ObsHTTPServer] = None
_DISABLED = False        # a failed opt-in latches off: warn once, not per
_GLOBAL_LOCK = threading.Lock()   # engine construction


def maybe_serve_from_env() -> Optional[ObsHTTPServer]:
    """The opt-in seam the engine calls at construction:
    with ``PADDLE_TPU_OBS_HTTP_PORT`` set, start the process-global
    endpoint exactly once and hand it back; unset, return None at the
    cost of one env read. A bind failure (or unparsable port) logs ONCE
    and latches the opt-in off — a metrics port collision must never
    take serving down or spam a retry per engine."""
    global _GLOBAL, _DISABLED
    raw = os.environ.get("PADDLE_TPU_OBS_HTTP_PORT", "").strip()
    if not raw:
        return None
    with _GLOBAL_LOCK:
        if _GLOBAL is not None or _DISABLED:
            return _GLOBAL
        try:
            port = int(raw)
        except ValueError:
            _DISABLED = True
            _log.warning("obs http: PADDLE_TPU_OBS_HTTP_PORT=%r is not an "
                         "integer; scrape endpoint disabled", raw)
            return None
        try:
            _GLOBAL = ObsHTTPServer(port=port)
        except OSError as e:
            _DISABLED = True
            _log.warning("obs http: cannot bind port %s (%s); scrape "
                         "endpoint disabled", raw, e)
            return None
        _log.info("obs http: serving /metrics /healthz /debug on %s",
                  _GLOBAL.url)
        return _GLOBAL
