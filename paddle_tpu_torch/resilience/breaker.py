"""Per-endpoint circuit breakers: closed -> open -> half-open -> closed. The
port's copy of ``paddle_tpu/resilience/breaker.py``: the same states,
transitions, metrics and environment variables.

A breaker sits in front of one endpoint (here a serving replica) and turns
a run of consecutive failures into a fast local failure
(:class:`BreakerOpen`) instead of yet another attempt against a dead peer.
After ``cooldown`` seconds open it admits exactly one half-open probe; the
probe's outcome decides between closing and re-opening for another
cooldown. A breaker never changes whether a call ultimately succeeds, only
how much time is spent dialing a dead peer.

States export as ``resilience.breaker_state{endpoint=...}`` gauge values
(0 closed, 1 half-open, 2 open); every transition bumps
``resilience.breaker_transitions_total{endpoint=...,to=...}`` and every
fast-failed call ``resilience.breaker_short_circuits_total{endpoint=...}``.

Accounting is explicit (``before_call`` / ``record_success`` /
``record_failure``) rather than a context manager: a replica that answered
with a typed rejection (a full queue, a malformed request) is healthy and
must not trip its breaker, and only the caller can classify that.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from .. import observability as _obs

__all__ = ["BreakerOpen", "CircuitBreaker", "breaker_for", "reset_breakers",
           "CLOSED", "HALF_OPEN", "OPEN"]

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpen(ConnectionError):
    """Fast local failure: the endpoint's breaker is open (cooling down)
    or its single half-open probe slot is already taken."""


class CircuitBreaker:
    def __init__(self, endpoint: str, *, failure_threshold: int = 5,
                 cooldown: float = 1.0, clock=time.monotonic):
        self.endpoint = endpoint
        self.failure_threshold = int(failure_threshold)
        self.cooldown = float(cooldown)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive, closed-state only
        self._opened_at = 0.0
        self._probe_inflight = False

    # -- state machine (transitions computed under the lock, metrics
    #    emitted after release, so the breaker lock never nests inside the
    #    registry's metric locks) ----------------------------------------
    def _transition_locked(self, to: str) -> str:
        self._state = to
        if to == CLOSED:
            self._failures = 0
        if to == OPEN:
            self._opened_at = self._clock()
        self._probe_inflight = False
        return to

    def _emit(self, transition: Optional[str]) -> None:
        if transition is not None:
            _obs.inc("resilience.breaker_transitions_total",
                     endpoint=self.endpoint, to=transition)
        _obs.set_gauge("resilience.breaker_state",
                       _STATE_GAUGE[self._state], endpoint=self.endpoint)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def before_call(self) -> None:
        """Gate one call attempt. Raises :class:`BreakerOpen` while open
        (cooldown not elapsed) or while another half-open probe is out."""
        short_circuit = False
        transition = None
        with self._lock:
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown:
                    transition = self._transition_locked(HALF_OPEN)
                    self._probe_inflight = True
                else:
                    short_circuit = True
            elif self._state == HALF_OPEN:
                if self._probe_inflight:
                    short_circuit = True
                else:
                    self._probe_inflight = True
        if transition is not None:
            self._emit(transition)
        if short_circuit:
            _obs.inc("resilience.breaker_short_circuits_total",
                     endpoint=self.endpoint)
            raise BreakerOpen(
                f"circuit breaker for {self.endpoint} is {self._state}")

    def record_success(self) -> None:
        transition = None
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                transition = self._transition_locked(CLOSED)
        self._emit(transition)

    def record_failure(self) -> None:
        transition = None
        with self._lock:
            if self._state == HALF_OPEN:
                transition = self._transition_locked(OPEN)  # probe failed
            elif self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    transition = self._transition_locked(OPEN)
        self._emit(transition)

    def reset(self) -> None:
        """Force-close (a restarted endpoint: the old run of failures says
        nothing about it)."""
        transition = None
        with self._lock:
            if self._state != CLOSED:
                transition = self._transition_locked(CLOSED)
            self._failures = 0
        self._emit(transition)


# ---------------------------------------------------------------------------
# per-endpoint registry
# ---------------------------------------------------------------------------

_BREAKERS: Dict[str, CircuitBreaker] = {}
_LOCK = threading.Lock()


def breaker_for(endpoint: str, **defaults) -> CircuitBreaker:
    """Get-or-create the breaker guarding ``endpoint``. Global environment
    overrides: ``PADDLE_TPU_RETRY_BREAKER_THRESHOLD`` and
    ``PADDLE_TPU_RETRY_BREAKER_COOLDOWN`` (read at creation)."""
    with _LOCK:
        br = _BREAKERS.get(endpoint)
        if br is None:
            raw = os.environ.get("PADDLE_TPU_RETRY_BREAKER_THRESHOLD")
            if raw is not None:
                defaults["failure_threshold"] = int(raw)
            raw = os.environ.get("PADDLE_TPU_RETRY_BREAKER_COOLDOWN")
            if raw is not None:
                defaults["cooldown"] = float(raw)
            br = CircuitBreaker(endpoint, **defaults)
            _BREAKERS[endpoint] = br
        return br


def reset_breakers() -> None:
    """Drop every cached breaker (tests)."""
    with _LOCK:
        _BREAKERS.clear()
