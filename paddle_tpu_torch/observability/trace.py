"""End-to-end tracing and the crash flight recorder. The port's copy of
``paddle_tpu/observability/trace.py``: the same event envelope, span and
event names, Chrome export, flight-dump file names and ``/healthz``
document, under the same environment variables (``PADDLE_TPU_TRACE``,
``PADDLE_TPU_TRACE_DIR``, ``PADDLE_TPU_FLIGHT_EVENTS``).

Three layers, one event envelope (``{"ts", "kind", "name", "attrs"}``;
span events also carry ``trace``/``span``/``parent`` ids):

* **Spans**: ``with trace.span("serving.prefill", parent=ctx, rid=7):``
  opens one node of a span tree. Context propagates thread-locally (a
  nested ``span()`` on the same thread becomes a child) and across threads
  explicitly: ``new_trace(label)`` mints a :class:`SpanContext` root that
  travels with the work item (the serving scheduler carries one per
  request, from ``submit()`` on the caller's thread to the engine's step
  thread), and ``span(..., parent=ctx)`` attaches to it. ``instant(...)``
  records a point event into the same tree. Spans exist only as context
  managers, so every begin has exactly one end on every exit path.
* **The trace buffer**: with ``PADDLE_TPU_TRACE=on`` every span and
  instant lands in an in-process buffer; :func:`export_chrome` converts it
  to Chrome trace-event JSON (``chrome://tracing`` / Perfetto; one track
  per trace, spans nested by time containment).
* **The flight recorder**: an always-on lock-free ring of the last N
  events (``PADDLE_TPU_FLIGHT_EVENTS``, default 512): lifecycle instants,
  fault events, watchdog trips. On an abort path (a watchdog trip, the
  engine's crash recovery) :func:`flight_dump` writes the ring to a JSON
  file under ``PADDLE_TPU_TRACE_DIR``.

Left out of the port: the JAX package's per-op dispatch events
(``_op_event_hook``/``_sync_op_hook``), which hook its eager dispatcher
(``core.tensor._op_trace_hook``); the port has no such dispatcher, so
``on`` records spans and instants only. A flight dump's ``cost`` key is
the program cost registry's snapshot (:func:`cost.flight_snapshot`), and
``/healthz`` carries its ``hbm`` component, which never flips the status.

Overhead: with tracing off (the default) ``span()`` is one global read
returning a shared no-op context manager, and only explicit
``instant``/``record`` calls (request- and step-rate sites, never per
kernel) pay one dict build and one ring-slot write for the recorder.

Health beacons ride along (``heartbeat(name)`` from the engine's step loop
and the watchdog's poll thread); ``observability.http`` serves them at
``/healthz`` next to ``/metrics`` and ``/debug/flight``.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

__all__ = [
    "SpanContext", "FlightRecorder",
    "span", "instant", "record", "new_trace", "current",
    "mode", "enabled", "set_mode", "tracing",
    "events", "clear", "dropped", "make_event", "span_problems",
    "export_chrome", "trace_dir",
    "flight_recorder", "flight_dump",
    "heartbeat", "heartbeat_clear", "health", "beacon_detail",
]

_log = logging.getLogger(__name__)

_VALID_MODES = ("off", "on", "flight")

# soft cap on the "on"-mode buffer: tracing a runaway loop must degrade to
# dropped-event accounting, not an OOM
_BUFFER_CAP = 500_000
# cap on remembered track labels (export metadata only): a long-running
# engine mints one trace per request, and the label map must not become
# the leak the buffer cap exists to prevent
_TRACKS_CAP = 50_000

_DEFAULT_FLIGHT_EVENTS = 512
_DEFAULT_HEARTBEAT_TTL_S = 60.0


def _env_mode() -> str:
    raw = os.environ.get("PADDLE_TPU_TRACE", "").strip().lower()
    if raw in ("", "0", "false", "no", "off", "disable", "disabled"):
        return "off"
    if raw == "flight":
        return "flight"
    if raw in ("1", "true", "yes", "on"):
        return "on"
    # an unrecognized value must not silently enable the most expensive
    # tier (a typo of "flight" would start buffering up to 500k events)
    _log.warning("PADDLE_TPU_TRACE=%r is not off|on|flight — tracing "
                 "stays OFF", raw)
    return "off"


_MODE = _env_mode()

_IDS = itertools.count(1)      # span + trace ids, one process-global space
_TLS = threading.local()


class SpanContext(NamedTuple):
    """Immutable handle for explicit cross-thread handoff: ``trace`` names
    the tree (one Chrome track), ``span`` the parent node (0 = root)."""

    trace: int
    span: int


class _TraceState:
    """The "on"-mode event buffer + track labels. Mutation is CPython-
    atomic (list.append / dict store), so the hot path takes no lock."""

    __slots__ = ("buffer", "tracks", "dropped")

    def __init__(self):
        self.buffer: List[Dict[str, Any]] = []
        self.tracks: Dict[int, str] = {}
        self.dropped = 0


_STATE = _TraceState()


def mode() -> str:
    return _MODE


def enabled() -> bool:
    """True when spans are being recorded (``on`` or ``flight``)."""
    return _MODE != "off"


def set_mode(m: str) -> None:
    """Switch tracing mode at runtime (``PADDLE_TPU_TRACE`` seeds the
    initial value at import)."""
    global _MODE
    if m not in _VALID_MODES:
        raise ValueError(f"trace mode must be one of {_VALID_MODES}, "
                         f"got {m!r}")
    _MODE = m


class tracing:
    """``with tracing("on"): ...`` — scoped mode switch for tests."""

    def __init__(self, m: str = "on"):
        self._mode = m
        self._prev = ""

    def __enter__(self):
        self._prev = _MODE
        set_mode(self._mode)
        return self

    def __exit__(self, *exc):
        set_mode(self._prev)


def make_event(kind: str, name: str, ts: Optional[float] = None,
               attrs: Optional[Dict[str, Any]] = None,
               **fields: Any) -> Dict[str, Any]:
    """The one event envelope every sink shares (the Chrome exporter, the
    flight recorder, and the JSONL step-telemetry stream): ``ts`` (a
    ``perf_counter`` instant), ``kind``, ``name``, ``attrs`` — plus
    optional span-tree fields (``trace``/``span``/``parent``)."""
    ev: Dict[str, Any] = {
        "ts": time.perf_counter() if ts is None else float(ts),
        "kind": kind, "name": name, "attrs": dict(attrs or {})}
    if fields:
        ev.update(fields)
    return ev


def _emit(ev: Dict[str, Any], ring: bool = True) -> None:
    if _MODE == "on":
        buf = _STATE.buffer
        if len(buf) < _BUFFER_CAP:
            buf.append(ev)
        else:
            _STATE.dropped += 1
    if ring:
        _FLIGHT.record(ev)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _set_track(tid: int, label: str) -> None:
    """Remember a track label for the Chrome export. Labels only matter in
    "on" mode (the exporter reads them) and the map is capped — in
    "flight" mode a long-running engine mints one trace per request, and
    an unbounded label dict would be exactly the leak the buffer cap
    exists to prevent."""
    if _MODE == "on" and len(_STATE.tracks) < _TRACKS_CAP:
        _STATE.tracks.setdefault(tid, label)


def _stack() -> List[SpanContext]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current() -> Optional[SpanContext]:
    """The innermost open span on THIS thread (for implicit parenting)."""
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


class _NoopSpan:
    """Shared disabled-mode span: one global read, nothing else."""

    __slots__ = ()
    ctx: Optional[SpanContext] = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    """One live span. Only :func:`span` constructs these, and only as a
    context manager — begin/end pairing is structural, which is what lets
    the chaos suites assert every trace is balanced."""

    __slots__ = ("_name", "_attrs", "_parent", "ctx")

    def __init__(self, name: str, parent: Optional[SpanContext],
                 attrs: Dict[str, Any]):
        self._name = name
        self._attrs = attrs
        self._parent = parent
        self.ctx: Optional[SpanContext] = None

    def __enter__(self) -> "_Span":
        stack = _stack()
        if self._parent is not None:
            tr, par = self._parent.trace, self._parent.span
        elif stack:
            top = stack[-1]
            tr, par = top.trace, top.span
        else:
            tr, par = next(_IDS), 0
            _set_track(tr, self._name)
        sid = next(_IDS)
        self.ctx = SpanContext(tr, sid)
        stack.append(self.ctx)
        _emit({"ts": time.perf_counter(), "kind": "B", "name": self._name,
               "attrs": self._attrs, "trace": tr, "span": sid,
               "parent": par, "thread": threading.get_ident()})
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = _stack()
        if stack and stack[-1] == self.ctx:
            stack.pop()
        elif self.ctx in stack:          # defensive: interleaved exit
            stack.remove(self.ctx)
        attrs = {"error": exc_type.__name__} if exc_type is not None else {}
        _emit({"ts": time.perf_counter(), "kind": "E", "name": self._name,
               "attrs": attrs, "trace": self.ctx.trace,
               "span": self.ctx.span})
        return False


def span(name: str, parent: Optional[SpanContext] = None, **attrs):
    """Open one span of the trace tree (context manager — the ONLY way to
    create a span). ``parent`` is an explicit :class:`SpanContext` for
    cross-thread handoff; omitted, the innermost open span on this thread
    (or a fresh root) parents it. Near-free when tracing is off."""
    if _MODE == "off":
        return _NOOP
    return _Span(name, parent, attrs)


def new_trace(label: str, **attrs) -> Optional[SpanContext]:
    """Mint a root context for a logical unit of work (one Chrome track):
    the cross-thread handle a serving request or training run carries.
    Returns None when tracing is off — every consumer treats the context
    as optional."""
    if _MODE == "off":
        return None
    tid = next(_IDS)
    _set_track(tid, label)
    _emit(make_event("ev", label, attrs=attrs, trace=tid, span=0, parent=0))
    return SpanContext(tid, 0)


def instant(name: str, parent: Optional[SpanContext] = None,
            **attrs) -> None:
    """A point event. Attached to ``parent`` (or the current span) in the
    trace tree when tracing is on; ALWAYS appended to the flight ring —
    instants are the coarse lifecycle/fault record the post-mortem needs,
    and they fire at request/step rate, never per op."""
    if parent is not None:
        tr, par = parent.trace, parent.span
    else:
        cur = current()
        tr, par = (cur.trace, cur.span) if cur is not None else (0, 0)
    _emit(make_event("i", name, attrs=attrs, trace=tr, parent=par))


def record(name: str, **attrs) -> None:
    """An un-parented lifecycle event (always in the flight ring; in the
    trace buffer too when tracing is on). The seam the fault injector and
    the watchdog use."""
    _emit(make_event("ev", name, attrs=attrs, trace=0, parent=0))


def events() -> List[Dict[str, Any]]:
    """Copy of the "on"-mode trace buffer."""
    return list(_STATE.buffer)


def dropped() -> int:
    return _STATE.dropped


def clear() -> None:
    """Reset the trace buffer + track names (test isolation seam; the
    flight ring has its own ``flight_recorder().clear()``)."""
    _STATE.buffer = []
    _STATE.tracks = {}
    _STATE.dropped = 0


def span_problems(evs: Optional[List[Dict[str, Any]]] = None) -> List[str]:
    """Structural validation the chaos suites assert on: every span begin
    has exactly one end (same id), no end without a begin, and every
    non-root parent id exists as a span in the same trace. Returns a list
    of human-readable problems ([] = the trace is a well-formed forest)."""
    evs = events() if evs is None else evs
    begins: Dict[int, Dict[str, Any]] = {}
    ended: Dict[int, int] = {}
    problems: List[str] = []
    for e in evs:
        if e["kind"] == "B":
            if e["span"] in begins:
                problems.append(f"span {e['span']} ({e['name']}) began twice")
            begins[e["span"]] = e
        elif e["kind"] == "E":
            if e["span"] not in begins:
                problems.append(f"span {e['span']} ({e['name']}) ended "
                                f"without a begin")
            ended[e["span"]] = ended.get(e["span"], 0) + 1
    for sid, b in begins.items():
        n = ended.get(sid, 0)
        if n != 1:
            problems.append(f"span {sid} ({b['name']}) has {n} ends")
        par = b.get("parent", 0)
        if par and par not in begins:
            # parent may be a new_trace root (span id 0 handled above) or
            # another span; a dangling nonzero parent is a broken handoff
            problems.append(f"span {sid} ({b['name']}) parent {par} is not "
                            f"a span in the buffer")
        elif par and begins[par].get("trace") != b.get("trace"):
            problems.append(f"span {sid} ({b['name']}) crosses traces "
                            f"{begins[par].get('trace')} -> {b.get('trace')}")
    return problems


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

def trace_dir() -> str:
    """Where exports and flight dumps land: ``PADDLE_TPU_TRACE_DIR``, or a
    stable per-tmpdir default."""
    d = os.environ.get("PADDLE_TPU_TRACE_DIR", "").strip()
    return d or os.path.join(tempfile.gettempdir(), "paddle_tpu_obs")


def export_chrome(path: Optional[str] = None,
                  evs: Optional[List[Dict[str, Any]]] = None):
    """Convert the trace buffer to the Chrome trace-event format
    (``chrome://tracing`` / Perfetto-loadable). Spans become complete
    ("X") events on one track per trace id (nesting falls out of time
    containment), instants "i" events; a span left open by a crash
    exports as a bare "B" (Perfetto
    renders it to the end of the trace). Returns the document dict, or
    writes it to ``path`` and returns the path."""
    evs = events() if evs is None else list(evs)
    pid = os.getpid()
    base = min((e["ts"] for e in evs), default=0.0)

    def us(ts: float) -> float:
        return (ts - base) * 1e6

    out: List[Dict[str, Any]] = []
    open_b: Dict[int, Dict[str, Any]] = {}
    for e in evs:
        kind = e["kind"]
        tid = e.get("trace", 0)
        if kind == "B":
            open_b[e["span"]] = e
        elif kind == "E":
            b = open_b.pop(e.get("span", 0), None)
            if b is None:
                continue
            args = dict(b.get("attrs") or {})
            args.update(e.get("attrs") or {})
            args["span"] = b["span"]
            if b.get("parent"):
                args["parent"] = b["parent"]
            out.append({"name": b["name"], "cat": "paddle_tpu", "ph": "X",
                        "ts": us(b["ts"]), "dur": max(0.0, us(e["ts"]) -
                                                      us(b["ts"])),
                        "pid": pid, "tid": b.get("trace", 0), "args": args})
        else:   # "i" instants + "ev" lifecycle/step events
            out.append({"name": e["name"], "cat": "paddle_tpu",
                        "ph": "i", "s": "t" if tid else "g",
                        "ts": us(e["ts"]), "pid": pid, "tid": tid,
                        "args": dict(e.get("attrs") or {})})
    for b in open_b.values():   # crash-open spans: begin-only is loadable
        out.append({"name": b["name"], "cat": "paddle_tpu", "ph": "B",
                    "ts": us(b["ts"]), "pid": pid,
                    "tid": b.get("trace", 0),
                    "args": dict(b.get("attrs") or {})})
    out.append({"name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": f"paddle_tpu[{pid}]"}})
    for tid, label in list(_STATE.tracks.items()):
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": label}})
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if path is None:
        return doc
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return path


def maybe_export_chrome(label: str) -> Optional[str]:
    """Operator-facing auto-export: when tracing is fully on AND the
    operator pointed ``PADDLE_TPU_TRACE_DIR`` somewhere, drop a Chrome
    trace there (the engine calls this at shutdown). Never
    raises; returns the path or None."""
    if _MODE != "on" or not os.environ.get("PADDLE_TPU_TRACE_DIR",
                                           "").strip():
        return None
    path = os.path.join(trace_dir(), f"trace-{label}-{os.getpid()}.json")
    try:
        return export_chrome(path)
    except OSError as e:
        _log.error("trace: chrome export to %s failed: %s", path, e)
        return None


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Lock-free ring of the last N envelope events.

    Writers pay one C-level counter bump (``itertools.count``) and one
    list-slot store — no lock, safe from any thread including the
    watchdog's. ``snapshot()`` reorders by sequence number; a dump taken
    while writers race may miss the very newest slot, which is the right
    trade for a recorder that must never stall the path it observes.
    """

    __slots__ = ("capacity", "_slots", "_seq")

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            raw = os.environ.get("PADDLE_TPU_FLIGHT_EVENTS", "").strip()
            try:
                capacity = int(raw) if raw else _DEFAULT_FLIGHT_EVENTS
            except ValueError:
                capacity = _DEFAULT_FLIGHT_EVENTS
        self.capacity = max(8, int(capacity))
        self._slots: List[Optional[Any]] = [None] * self.capacity
        self._seq = itertools.count()

    def record(self, ev: Dict[str, Any]) -> None:
        i = next(self._seq)
        self._slots[i % self.capacity] = (i, ev)

    def snapshot(self) -> List[Dict[str, Any]]:
        entries = [s for s in list(self._slots) if s is not None]
        entries.sort(key=lambda p: p[0])
        return [ev for _, ev in entries]

    def clear(self) -> None:
        self._slots = [None] * self.capacity

    def dump(self, reason: str, path: Optional[str] = None,
             **info: Any) -> Optional[str]:
        """Write the ring's last-N snapshot to a JSON file (atomic
        replace; one file per (pid, reason) so repeated aborts keep the
        LATEST post-mortem). Never raises — a failing dump must not turn
        an abort into a second crash. Returns the path or None."""
        evs = self.snapshot()
        doc = {"schema": 1, "reason": reason, "pid": os.getpid(),
               "dumped_at": time.time(),
               "dumped_perf_ts": time.perf_counter(),
               "info": dict(info), "events": evs}
        try:
            # the post-mortem names the programs that were live and what
            # they should have cost (records + HBM ledger); flight_snapshot
            # itself never raises, the guard covers the import
            from . import cost as _cost
            doc["cost"] = _cost.flight_snapshot()
        except Exception:
            doc["cost"] = None
        if path is None:
            slug = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in reason)
            path = os.path.join(trace_dir(),
                                f"flight-{os.getpid()}-{slug}.json")
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
        except OSError as e:
            _log.error("flight recorder: dump to %s failed: %s", path, e)
            return None
        from . import inc as _inc   # deferred: trace is imported by the
        _inc("trace.flight_dumps_total", reason=reason)  # package __init__
        _log.warning("flight recorder: %d events -> %s (reason=%s)",
                     len(evs), path, reason)
        return path


_FLIGHT = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _FLIGHT


def flight_dump(reason: str, **info: Any) -> Optional[str]:
    """Dump the process-global flight ring (see
    :meth:`FlightRecorder.dump`)."""
    return _FLIGHT.dump(reason, **info)


# ---------------------------------------------------------------------------
# health beacons (the /healthz surface)
# ---------------------------------------------------------------------------

class _Heartbeats:
    __slots__ = ("beats",)

    def __init__(self):
        self.beats: Dict[str, Dict[str, Any]] = {}


_HEALTH = _Heartbeats()


def heartbeat(name: str, ttl_s: float = _DEFAULT_HEARTBEAT_TTL_S,
              ok: bool = True) -> None:
    """Liveness beacon: the engine's step loop (and the watchdog
    poll threads) ping one per iteration; ``/healthz`` reports a component
    unhealthy once its beacon goes stale past ``ttl_s`` (a loop thread
    wedged inside a device call stops beating — exactly the failure an
    external prober needs to see) or it last reported ``ok=False``."""
    _HEALTH.beats[name] = {"at": time.monotonic(), "ttl_s": float(ttl_s),
                           "ok": bool(ok)}


def heartbeat_clear(name: str) -> None:
    """Retire a beacon (clean shutdown is not a liveness failure)."""
    _HEALTH.beats.pop(name, None)


def health() -> Dict[str, Any]:
    """The /healthz document: per-component age vs ttl; overall ``ok``
    only when every registered beacon is fresh and ok.

    Each component carries the per-beacon detail (an engine named in its
    ``ServingConfig`` beats ``serving.engine.<name>``): ``age_s`` since the
    last beat, the beacon's ``ttl_s``, a ``stale`` bit (age past ttl: a
    loop thread wedged in a device call stops beating), and ``ok`` (fresh
    and the last beat reported healthy)."""
    now = time.monotonic()
    comps: Dict[str, Any] = {}
    healthy = True
    # copy first: heartbeat() inserts new keys lock-free from other
    # threads (an engine's first beat racing a scrape), and iterating the
    # live dict would raise mid-/healthz
    for name, b in sorted(dict(_HEALTH.beats).items()):
        comps[name] = c = _beacon_component(b, now)
        healthy = healthy and c["ok"]
    # the HBM ledger's detail rides along independently of the 503: low
    # headroom warns (once, in the cost module) but never flips the
    # routing status; the component's ok is always True
    try:
        from . import cost as _cost
        hbm = _cost.healthz_component()
        if hbm is not None:
            comps["hbm"] = hbm
    except Exception:
        # why silent: the hbm component is advisory detail; a ledger walk
        # failing mid-scrape must not turn /healthz into a 500
        _log.debug("healthz: hbm component unavailable", exc_info=True)
    return {"status": "ok" if healthy else "unhealthy",
            "components": comps, "pid": os.getpid()}


def _beacon_component(b: Dict[str, Any], now: float) -> Dict[str, Any]:
    """One beacon's component document — the single definition of the
    stale/ok semantics both :func:`health` and :func:`beacon_detail`
    report (they must never drift: the router's rotation signal IS the
    /healthz document)."""
    age = now - b["at"]
    stale = age > b["ttl_s"]
    return {"age_s": round(age, 3), "ttl_s": b["ttl_s"], "stale": stale,
            "ok": b["ok"] and not stale}


def beacon_detail(name: str) -> Optional[Dict[str, Any]]:
    """One beacon's /healthz component (or None when it never beat):
    the router's per-replica liveness probe — a replica whose engine
    beacon is ``stale`` leaves the rotation without an HTTP scrape."""
    b = dict(_HEALTH.beats).get(name)
    if b is None:
        return None
    return _beacon_component(b, time.monotonic())

