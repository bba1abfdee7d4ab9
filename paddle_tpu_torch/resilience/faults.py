"""Deterministic fault injection: scripted or seeded failures at named
sites. The port's copy of ``paddle_tpu/resilience/faults.py``: the same
schedule semantics, so the same seed and the same sequence of
``fault_point`` calls give the same ``trace`` in both packages.

Each seam is a ``fault_point("<site>")`` call: a module-global ``None``
probe when no schedule is installed (the production state), and a test or
harness installs a :class:`FaultSchedule` that decides, per site and per
call index, whether to delay, raise, or "kill".

Determinism: a schedule is driven only by (a) the per-site call counter
and (b) its own seeded RNG for probabilistic specs, so re-running a
workload against an identical schedule gives the same ``trace``.

The port's serving engine threads four sites (exact-match tags):

====================  =====================================================
``serving.admit``     an admission attempt, before the prefill runs
                      (retried once; a second fault fails the request and
                      frees its pages)
``serving.step``      once per (decode step, included slot), in admission
                      order: call index N targets one slot; a faulted slot
                      sits the step out, a second fault fails it alone
``serving.watchdog``  once per batched-decode attempt, inside the armed
                      watchdog window, before the step launches: a
                      ``delay`` here is a hung step (the watchdog trips and
                      the step's outputs are abandoned), an ``error`` a
                      whole-batch fault; either way the slots recover by
                      bounded prefill replay (``max_replays``)
``serving.drain``     ``Engine.stop(drain=True)`` entry: an injected error
                      degrades the graceful drain to an immediate stop
====================  =====================================================

The tiers above the engine thread six more: ``router.pick`` and
``router.forward`` (``serving.router``), ``http.write`` (``serving.http``),
and ``fleet.spawn``, ``fleet.heartbeat`` and ``fleet.rpc``
(``serving.fleet``); their modules say what each means.

Kinds: ``delay`` sleeps; ``error`` raises a fresh instance of the
configured exception type; ``kill`` raises :class:`KillPoint`, a
``BaseException``, so ordinary ``except Exception`` recovery code cannot
swallow the simulated process death.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Type

from .. import observability as _obs
from ..observability import trace as _trace

__all__ = ["FaultInjected", "KillPoint", "FaultSchedule", "fault_point",
           "install", "uninstall", "installed"]


class FaultInjected(ConnectionError):
    """Default exception for injected ``error``/``drop`` faults."""


class KillPoint(BaseException):
    """Simulated process death at a fault point. Deliberately NOT an
    ``Exception``: recovery code that catches ``Exception`` must behave as
    if the process vanished, exactly like a real SIGKILL."""


class _Spec:
    __slots__ = ("kind", "on", "prob", "times", "error", "message",
                 "seconds", "fired")

    def __init__(self, kind: str, on, prob, times, error, message, seconds):
        self.kind = kind
        self.on = frozenset(int(i) for i in on) if on else None
        self.prob = None if prob is None else float(prob)
        self.times = None if times is None else int(times)
        self.error = error
        self.message = message
        self.seconds = float(seconds)
        self.fired = 0

    def make_error(self, site: str, call_index: int) -> BaseException:
        if isinstance(self.error, BaseException):
            return self.error  # caller supplied an instance: use as-is
        msg = self.message or f"injected {self.kind} at {site} " \
                              f"(call {call_index})"
        return self.error(msg)


class FaultSchedule:
    """A set of per-site fault specs plus the trace of what fired.

    ``seed`` drives the probabilistic specs; scripted specs (``on=``) need
    no RNG at all. ``trace`` is the ordered list of
    ``(site, call_index, kind)`` tuples of every fired fault — compare two
    runs' traces to prove determinism.
    """

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)
        self._specs: Dict[str, List[_Spec]] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.trace: List[Tuple[str, int, str]] = []

    # -- authoring ----------------------------------------------------------
    def inject(self, site: str, kind: str, *, on=None,
               prob: Optional[float] = None, times: Optional[int] = None,
               error: Any = FaultInjected, message: Optional[str] = None,
               seconds: float = 0.0) -> "FaultSchedule":
        """Add one spec for ``site``.

        ``on`` — 1-based call indices that fire (scripted); ``prob`` —
        seeded per-call probability (ignored when ``on`` given); ``times``
        — cap on total fires; ``error`` — exception type (or instance) for
        ``error`` kind; ``seconds`` — sleep for ``delay`` kind.
        """
        if kind not in ("delay", "error", "kill"):
            raise ValueError(f"unknown fault kind {kind!r}")
        with self._lock:
            self._specs.setdefault(site, []).append(
                _Spec(kind, on, prob, times, error, message, seconds))
        return self

    def error(self, site: str, **kw) -> "FaultSchedule":
        return self.inject(site, "error", **kw)

    # "drop" reads better at transport seams; the mechanics are identical
    # (raise a transport-shaped error the caller's retry loop handles)
    drop = error

    def delay(self, site: str, *, seconds: float, **kw) -> "FaultSchedule":
        return self.inject(site, "delay", seconds=seconds, **kw)

    def kill(self, site: str, **kw) -> "FaultSchedule":
        return self.inject(site, "kill", **kw)

    # -- execution ----------------------------------------------------------
    def calls(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def sites(self) -> frozenset:
        """Sites this schedule has specs for."""
        with self._lock:
            return frozenset(self._specs)

    def check(self, site: str) -> None:
        """One pass through ``site``: bump the counter, fire at most one
        matching spec (first match wins, in authoring order)."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            hit: Optional[_Spec] = None
            for spec in self._specs.get(site, ()):
                if spec.times is not None and spec.fired >= spec.times:
                    continue
                if spec.on is not None:
                    fire = n in spec.on
                elif spec.prob is not None:
                    fire = self._rng.random() < spec.prob
                else:
                    fire = True
                if fire:
                    spec.fired += 1
                    hit = spec
                    break
            if hit is not None:
                self.trace.append((site, n, hit.kind))
        if hit is None:
            return
        _obs.inc("resilience.injected_faults_total", site=site, kind=hit.kind)
        # the flight recorder's post-mortem tail names the fault site: a
        # killed/aborted run's dump ends at the seam that took it down
        _trace.record("fault", site=site, injected=hit.kind, call=n)
        if hit.kind == "delay":
            time.sleep(hit.seconds)
            return
        if hit.kind == "kill":
            raise KillPoint(f"injected kill at {site} (call {n})")
        raise hit.make_error(site, n)


# ---------------------------------------------------------------------------
# global install seam
# ---------------------------------------------------------------------------

_SCHEDULE: Optional[FaultSchedule] = None


def install(schedule: FaultSchedule) -> FaultSchedule:
    """Make ``schedule`` the process-wide active schedule (test/harness
    only; there is deliberately no way to enable this per-call on a hot
    path)."""
    global _SCHEDULE
    _SCHEDULE = schedule
    return schedule


def uninstall() -> None:
    global _SCHEDULE
    _SCHEDULE = None


class installed:
    """``with installed(schedule): ...`` — scoped install for tests."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule

    def __enter__(self) -> FaultSchedule:
        install(self.schedule)
        return self.schedule

    def __exit__(self, *exc) -> None:
        uninstall()


def fault_point(site: str) -> None:
    """Zero-overhead when no schedule is installed: one global load and a
    ``None`` test."""
    s = _SCHEDULE
    if s is not None:
        s.check(site)
