"""Retry policies: jittered exponential backoff, caps, deadlines. The
port's copy of ``paddle_tpu/resilience/policy.py``: the same policy
registry, the same ``PADDLE_TPU_RETRY_<NAME>_<KNOB>`` overrides and the
same metrics.

One policy object describes how a subsystem retries (base delay, growth,
jitter, attempt cap); the budget of one call comes from three clamping
sources: the policy's own default deadline, the per-call ``deadline=``
argument, and the ambient thread-local deadline installed by
:class:`deadline_scope`. The tightest wins, so a deadline propagates
through nested calls instead of compounding.

Policies are named and registered (:func:`get_policy`); every knob has an
environment override, ``PADDLE_TPU_RETRY_<NAME>_<KNOB>``, ``<NAME>`` the
policy name upper-cased with ``.``/``-`` mapped to ``_`` and ``<KNOB>``
one of ``BASE_DELAY``, ``MAX_DELAY``, ``MULTIPLIER``, ``JITTER``,
``MAX_ATTEMPTS``, ``DEADLINE``.

Call-site shape (the loop owns the verb, the policy the schedule)::

    for attempt in get_policy("kv.fetch").start(deadline=60.0):
        try:
            return fetch()
        except ConnectionError as e:
            attempt.fail(e)        # backoff-sleeps, or re-raises e when
                                   # the attempt/deadline budget is spent

Every backoff is counted (``resilience.retries_total{policy=...}``), and
every exhausted budget (``resilience.giveups_total{policy=...}``).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Optional

from .. import observability as _obs

__all__ = ["RetryPolicy", "DeadlineExceeded", "deadline_scope",
           "current_deadline", "get_policy", "register_policy",
           "reset_policies", "jitter_sleep", "env_float", "env_int"]


def env_float(name: str) -> Optional[float]:
    """Float env knob; unset/blank/non-numeric -> None (logged)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        import logging
        logging.getLogger(__name__).warning(
            "ignoring non-numeric %s=%r", name, raw)
        return None


def env_int(name: str, default: int) -> int:
    """Int env knob; unset/blank/non-numeric -> ``default`` (logged)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        import logging
        logging.getLogger(__name__).warning(
            "ignoring non-numeric %s=%r", name, raw)
        return default


class DeadlineExceeded(TimeoutError):
    """A deadline budget expired before the guarded work could run.

    The typed surface for deadline-driven shedding: callers that gate work
    on a per-request or ambient deadline (``deadline_scope``, the serving
    admission boundary) resolve the work's future, or raise, with this
    type, so "too late" is told apart from "failed"."""

_TLS = threading.local()
# module RNG for jitter: desynchronization noise, not reproducibility
# surface (fault determinism lives in FaultSchedule's own seeded RNG)
_RNG = random.Random()


def current_deadline() -> Optional[float]:
    """Innermost ambient MONOTONIC deadline (None = unbounded)."""
    return getattr(_TLS, "deadline", None)


class deadline_scope:
    """Install an ambient monotonic deadline for the current thread.

    ``with deadline_scope(30.0): ...`` bounds every policy-driven retry
    loop entered inside the block (however deeply nested) to
    ``time.monotonic() + 30``. Nested scopes clamp to the TIGHTER
    deadline; they can never extend an outer budget.
    """

    def __init__(self, seconds: Optional[float] = None, *,
                 until: Optional[float] = None):
        if seconds is not None and until is not None:
            raise ValueError("pass seconds or until, not both")
        self._until = until if seconds is None \
            else time.monotonic() + float(seconds)
        self._outer: Optional[float] = None

    def __enter__(self) -> Optional[float]:
        outer = current_deadline()
        self._outer = outer
        eff = self._until
        if outer is not None:
            eff = outer if eff is None else min(eff, outer)
        _TLS.deadline = eff
        return eff

    def __exit__(self, *exc) -> None:
        _TLS.deadline = self._outer


class _Attempts:
    """Iterator/handle hybrid: yields itself once per attempt; ``fail``
    either backoff-sleeps (budget remains) or re-raises (budget spent)."""

    __slots__ = ("policy", "deadline", "attempt", "_delay")

    def __init__(self, policy: "RetryPolicy", deadline: Optional[float]):
        self.policy = policy
        self.deadline = deadline
        self.attempt = 0
        self._delay = policy.base_delay

    def __iter__(self) -> "_Attempts":
        return self

    def __next__(self) -> "_Attempts":
        self.attempt += 1
        return self

    def remaining(self) -> Optional[float]:
        """Seconds left in the deadline budget (None = unbounded)."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def fail(self, exc: BaseException) -> None:
        """Record a failed attempt.

        Re-raises ``exc`` when the attempt cap or deadline is spent;
        otherwise sleeps the next (jittered, deadline-clamped) backoff and
        returns so the loop may try again.
        """
        pol = self.policy
        left = self.remaining()
        if (pol.max_attempts is not None and self.attempt >= pol.max_attempts) \
                or (left is not None and left <= 0):
            _obs.inc("resilience.giveups_total", policy=pol.name)
            raise exc
        delay = self._delay
        if pol.jitter:
            delay *= 1.0 + pol.jitter * (2.0 * pol._rng.random() - 1.0)
        if left is not None:
            delay = min(delay, max(0.0, left))
        _obs.inc("resilience.retries_total", policy=pol.name)
        pol._sleep(delay)
        self._delay = min(self._delay * pol.multiplier, pol.max_delay)


class RetryPolicy:
    """Jittered exponential backoff schedule with attempt/deadline caps.

    ``jitter`` is a symmetric fraction: each sleep is drawn uniformly from
    ``delay * [1 - jitter, 1 + jitter]`` so simultaneously-failing workers
    decorrelate instead of re-dialing a respawned server in lockstep.
    ``sleep``/``rng`` are injection seams for tests.
    """

    def __init__(self, name: str, *, base_delay: float = 0.2,
                 multiplier: float = 2.0, max_delay: float = 2.0,
                 jitter: float = 0.25, max_attempts: Optional[int] = None,
                 deadline: Optional[float] = None,
                 sleep=time.sleep, rng: Optional[random.Random] = None):
        if base_delay < 0 or multiplier < 1.0:
            raise ValueError("base_delay >= 0 and multiplier >= 1 required")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.name = name
        self.base_delay = float(base_delay)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.max_attempts = None if max_attempts is None else int(max_attempts)
        self.deadline = None if deadline is None else float(deadline)
        self._sleep = sleep
        self._rng = rng if rng is not None else _RNG

    def start(self, deadline: Optional[float] = None) -> _Attempts:
        """Open one retry budget: the tightest of the policy default, the
        per-call ``deadline`` (seconds from now), and the ambient
        :class:`deadline_scope` governs."""
        now = time.monotonic()
        candidates = [now + d for d in (self.deadline, deadline)
                      if d is not None]
        ambient = current_deadline()
        if ambient is not None:
            candidates.append(ambient)
        return _Attempts(self, min(candidates) if candidates else None)

    def __repr__(self) -> str:
        return (f"RetryPolicy({self.name!r}, base_delay={self.base_delay}, "
                f"multiplier={self.multiplier}, max_delay={self.max_delay}, "
                f"jitter={self.jitter}, max_attempts={self.max_attempts}, "
                f"deadline={self.deadline})")


# ---------------------------------------------------------------------------
# named registry with env overrides
# ---------------------------------------------------------------------------

_POLICIES: Dict[str, RetryPolicy] = {}
_LOCK = threading.Lock()

_ENV_PREFIX = "PADDLE_TPU_RETRY_"
_FLOAT_KNOBS = ("base_delay", "max_delay", "multiplier", "jitter", "deadline")


def _env_name(policy_name: str) -> str:
    return policy_name.upper().replace(".", "_").replace("-", "_")


def _apply_env_overrides(name: str, kw: Dict) -> Dict:
    prefix = _ENV_PREFIX + _env_name(name) + "_"
    for knob in _FLOAT_KNOBS:
        raw = os.environ.get(prefix + knob.upper())
        if raw is not None:
            kw[knob] = float(raw)
    raw = os.environ.get(prefix + "MAX_ATTEMPTS")
    if raw is not None:
        kw["max_attempts"] = int(raw) if int(raw) > 0 else None
    return kw


def register_policy(policy: RetryPolicy) -> RetryPolicy:
    """Install (or replace) a policy under its name."""
    with _LOCK:
        _POLICIES[policy.name] = policy
    return policy


def get_policy(name: str, **defaults) -> RetryPolicy:
    """Get-or-create the named policy.

    ``defaults`` seed the knobs on first creation; env overrides
    (``PADDLE_TPU_RETRY_<NAME>_<KNOB>``) are applied on top, once, at
    creation time. Subsequent calls return the cached instance (call-site
    defaults of later callers do NOT reconfigure it).
    """
    with _LOCK:
        pol = _POLICIES.get(name)
        if pol is None:
            pol = RetryPolicy(name, **_apply_env_overrides(name, defaults))
            _POLICIES[name] = pol
        return pol


def reset_policies() -> None:
    """Drop every cached policy (tests: re-read env overrides)."""
    with _LOCK:
        _POLICIES.clear()


def jitter_sleep(seconds: float, *, frac: float = 0.25,
                 rng: Optional[random.Random] = None,
                 sleep=time.sleep) -> float:
    """Sleep ``seconds`` scaled by a uniform ``1 ± frac`` draw.

    The poll-loop primitive: pollers started at the same instant would
    otherwise stay in phase forever. Returns the duration actually slept
    (test seam).
    """
    r = (rng if rng is not None else _RNG).random()
    d = max(0.0, float(seconds) * (1.0 + float(frac) * (2.0 * r - 1.0)))
    sleep(d)
    return d
