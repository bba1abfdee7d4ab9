"""Step watchdog: a monotonic-clock guard around one device step. The
port's copy of ``paddle_tpu/resilience/watchdog.py`` (same verdicts,
metric, flight dumps and ``/healthz`` beacon).

A loop that issues one device step and one host sync per step has one
failure an in-process observer can still see: the step never comes back.
The watchdog is the observer that cannot be wedged:

* the step thread ``arm()``s the watchdog just before the step and
  ``disarm()``s after: two lock-guarded scalar writes on the hot path;
* a daemon thread polls the armed window (cadence via
  :func:`resilience.jitter_sleep`) and, when the window exceeds
  ``timeout_s``, classifies the step:

  - ``"hung"``: armed past ``timeout_s``; one trip per window,
    ``<metric>{kind="hung"}``;
  - ``"zombie"``: the same window still armed past ``2 * timeout_s``;
    logged and counted (``kind="zombie"``): an in-process observer cannot
    preempt a thread blocked in a device call, so past this point recovery
    is external.

* ``disarm()`` returns the window's verdict (or None). What the caller does
  with a tripped step that returned is its own contract: the serving
  engine abandons the step's outputs and replays the affected slots.

On a card the serving engine's wait is the token read-back after a CUDA
graph replay, which releases the GIL, so this thread runs while the loop
thread waits there.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from .. import observability as _obs
from ..observability import trace as _trace
from . import policy as _policy

__all__ = ["StepWatchdog", "WatchdogTimeout"]

_log = logging.getLogger(__name__)


class WatchdogTimeout(RuntimeError):
    """A device step exceeded the watchdog budget and its outputs were
    abandoned. Requests that exhaust their replay budget recovering from
    this see it as their terminal error."""


class StepWatchdog:
    """Arm/disarm guard around one in-flight device step.

    ``arm()`` opens a window and returns its generation token; ``disarm``
    closes it and returns the classification the poll thread assigned
    (``"hung"`` / ``"zombie"``) or None if the step came back in time.
    The poll thread is started lazily on first arm and is restartable
    after :meth:`stop` (owners stop it on shutdown).
    Thread-safe; one window at a time (its caller is single-consumer).
    """

    def __init__(self, timeout_s: float, name: str = "paddle-tpu-watchdog",
                 *, metric: str = "serving.watchdog_trips_total",
                 label: str = "serving"):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self._name = name
        self._metric = metric
        self._label = label
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._gen = 0
        self._verdicts = {}          # gen -> "hung" | "zombie"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # poll a few times per window; jitter_sleep decorrelates engines
        self._poll_s = max(0.002, self.timeout_s / 4.0)

    # -- hot path (step thread) ---------------------------------------------
    def arm(self) -> int:
        with self._lock:
            self._gen += 1
            self._armed_at = time.monotonic()
            gen = self._gen
            need_thread = self._thread is None or not self._thread.is_alive()
        if need_thread:
            self._start_thread()
        return gen

    def disarm(self, gen: int) -> Optional[str]:
        with self._lock:
            if self._gen == gen:
                self._armed_at = None
            return self._verdicts.pop(gen, None)

    # -- lifecycle ----------------------------------------------------------
    def _start_thread(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=self._name, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Stop the poll thread (idempotent; a later arm() restarts it)."""
        self._stop.set()
        # read under the lock: a concurrent arm() may be mid-restart in
        # _start_thread, and the unlocked read could join a thread object
        # already replaced
        with self._lock:
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0 * self._poll_s + 1.0)
        _trace.heartbeat_clear(f"{self._label}.watchdog")

    # -- poll loop (watchdog thread) ----------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                armed_at, gen = self._armed_at, self._gen
                verdict = self._verdicts.get(gen)
            # the /healthz beacon: the watchdog thread itself cannot be
            # wedged by a device call, so its beat going stale means the
            # process is in trouble; ok=False while a window is tripped
            _trace.heartbeat(f"{self._label}.watchdog",
                             ttl_s=max(1.0, 8.0 * self._poll_s),
                             ok=verdict is None)
            if armed_at is not None:
                waited = time.monotonic() - armed_at
                if verdict is None and waited > self.timeout_s:
                    self._trip(gen, armed_at, "hung", waited)
                elif verdict == "hung" and waited > 2.0 * self.timeout_s:
                    self._trip(gen, armed_at, "zombie", waited)
            _policy.jitter_sleep(self._poll_s)

    def _trip(self, gen: int, armed_at: float, kind: str,
              waited: float) -> None:
        with self._lock:
            # the window may have closed between the unlocked read and now
            if self._gen != gen or self._armed_at != armed_at:
                return
            self._verdicts[gen] = kind
        _obs.inc(self._metric, kind=kind)
        # a trip is a post-mortem moment: put the event in the flight ring
        # and snapshot it to disk while the process still can
        _trace.record("watchdog_trip", label=self._label, kind=kind,
                      waited_s=round(waited, 3),
                      budget_s=self.timeout_s)
        _trace.flight_dump(f"watchdog_{kind}", label=self._label,
                           waited_s=round(waited, 3))
        if kind == "hung":
            _log.warning(
                "%s watchdog: compiled step armed %.3fs > budget %.3fs "
                "— step classified hung; the owner's recovery path "
                "(abandon-and-replay) takes over",
                self._label, waited, self.timeout_s)
        else:
            _log.warning(
                "%s watchdog: compiled step still running after %.3fs "
                "(> 2x budget %.3fs) — step classified ZOMBIE; in-process "
                "recovery is impossible if it never returns (restart the "
                "process)",
                self._label, waited, self.timeout_s)
