"""Failure handling of the port: the counterpart of
``paddle_tpu.resilience``, with the same exception types, fault-site
names, metrics and environment variables.

* :mod:`~paddle_tpu_torch.resilience.policy`: named :class:`RetryPolicy`
  objects (jittered exponential backoff, attempt caps, monotonic deadlines
  that propagate through nested calls via :class:`deadline_scope`), the
  registry with ``PADDLE_TPU_RETRY_*`` overrides, and
  :func:`jitter_sleep` for poll loops;
* :mod:`~paddle_tpu_torch.resilience.breaker`: the per-endpoint
  :class:`CircuitBreaker` (closed -> open -> half-open with a cooldown) the
  serving router keeps for each replica, so a dead replica costs one fast
  :class:`BreakerOpen` instead of an attempt per request;
* :mod:`~paddle_tpu_torch.resilience.faults`: deterministic
  :class:`FaultSchedule` injection (delay/error/kill, by site tag, seeded
  or scripted), a no-op global probe when not installed;
* :mod:`~paddle_tpu_torch.resilience.watchdog`: the monotonic-clock
  :class:`StepWatchdog` that classifies a hung or zombie device step from
  a thread that cannot be wedged.

The JAX package's training supervisor (``resilience.trainer``) is not
ported yet.
"""

from __future__ import annotations

from .policy import (DeadlineExceeded, RetryPolicy, current_deadline,
                     deadline_scope, env_float, env_int, get_policy,
                     jitter_sleep, register_policy, reset_policies)
from .breaker import (BreakerOpen, CircuitBreaker, breaker_for,
                      reset_breakers)
from .faults import (FaultInjected, FaultSchedule, KillPoint, fault_point,
                     install, installed, uninstall)
from .watchdog import StepWatchdog, WatchdogTimeout

__all__ = [
    "RetryPolicy", "DeadlineExceeded", "deadline_scope", "current_deadline",
    "get_policy", "register_policy", "reset_policies", "jitter_sleep",
    "env_float", "env_int",
    "BreakerOpen", "CircuitBreaker", "breaker_for", "reset_breakers",
    "FaultInjected", "FaultSchedule", "KillPoint", "fault_point",
    "install", "installed", "uninstall",
    "StepWatchdog", "WatchdogTimeout",
]
