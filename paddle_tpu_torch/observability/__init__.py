"""Metrics and telemetry of the port: the counterpart of
``paddle_tpu.observability``, with the same metric names, label sets,
histogram buckets, span and event names and environment variables, so a
dashboard, a scrape config or a runbook written for the JAX package reads
this one unchanged.

Usage::

    from paddle_tpu_torch import observability as obs

    obs.enable()
    ... serve ...
    snap = obs.snapshot()             # {"serving.tokens_total": 1234, ...}
    print(obs.prometheus_text())      # scrape document
    obs.reset(); obs.disable()

Naming convention: ``<subsystem>.<noun>_<unit>``, counters suffixed
``_total``, histograms ``_seconds``, gauges plain nouns.

The package also holds ``trace`` (span trees, the Chrome trace-event
export and the always-on flight recorder), ``http`` (the ``/metrics``,
``/healthz`` and ``/debug`` endpoint behind ``PADDLE_TPU_OBS_HTTP_PORT``)
and ``cost`` (the program cost registry: flops and bytes of each captured
program, the HBM ledger, MFU and bandwidth shares; ``/debug/cost``), which
``enable()`` installs and ``disable()`` uninstalls.

Disabled (the default), the helpers ``inc``/``observe``/``set_gauge``/
``scoped_timer`` return on one global bool. Left out of the port: the JAX
package's per-op dispatch and eager-cache hooks (``_dispatch_hook``,
``_cache_hook`` and their installation in ``enable``/``disable``), which
hook its eager dispatcher.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence

from .registry import (Counter, Gauge, Histogram, LogThrottle, Registry,
                       ScopedTimer, DEFAULT_LATENCY_BUCKETS)
from . import trace  # noqa: F401  (before export, which shares its envelope)
from .export import (StepTelemetryWriter, parse_prometheus_text,
                     prometheus_text as _prom_text, read_jsonl)

__all__ = [
    "Counter", "Gauge", "Histogram", "LogThrottle", "Registry",
    "StepTelemetryWriter",
    "DEFAULT_LATENCY_BUCKETS",
    "enable", "disable", "enabled", "default_registry",
    "counter", "gauge", "histogram",
    "inc", "set_gauge", "observe", "scoped_timer",
    "snapshot", "reset", "prometheus_text", "parse_prometheus_text",
    "read_jsonl",
    "trace",
]

_REGISTRY = Registry()
_ENABLED = False
_LOCK = threading.Lock()


def default_registry() -> Registry:
    return _REGISTRY


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    """Turn metrics collection on and install the program cost registry
    (a no-op under ``PADDLE_TPU_COST=off``)."""
    global _ENABLED
    with _LOCK:
        _ENABLED = True
    from . import cost
    cost.install()


def disable() -> None:
    """Stop collecting; collected values remain readable."""
    global _ENABLED
    with _LOCK:
        _ENABLED = False
    from . import cost
    cost.uninstall()


# -- family accessors (get-or-create on the default registry) ----------------
def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _REGISTRY.histogram(name, help, labelnames, buckets)


# -- cheap instrumentation helpers (no-ops while disabled) -------------------
def _check_labels(labels) -> None:
    # ``value`` is positional-only on the helpers: obs.inc("m", value=5)
    # would otherwise land here as a bogus {value="5"} label on an
    # increment of 1
    if "value" in labels:
        raise TypeError(
            "'value' is positional-only — obs.inc(name, amount, **labels); "
            "pass the amount positionally, not as a label")


def inc(name: str, value: float = 1.0, /, **labels) -> None:
    if not _ENABLED:
        return
    _check_labels(labels)
    _REGISTRY.counter(name, labelnames=tuple(sorted(labels))).inc(value, **labels)


def set_gauge(name: str, value: float, /, **labels) -> None:
    if not _ENABLED:
        return
    _check_labels(labels)
    _REGISTRY.gauge(name, labelnames=tuple(sorted(labels))).set(value, **labels)


def observe(name: str, value: float, /, **labels) -> None:
    if not _ENABLED:
        return
    _check_labels(labels)
    _REGISTRY.histogram(name, labelnames=tuple(sorted(labels))).observe(value,
                                                               **labels)


def scoped_timer(name: str, /, **labels) -> ScopedTimer:
    """``with obs.scoped_timer("serving.step_seconds"): ...`` observes a
    latency sample when enabled and is free when disabled."""
    if not _ENABLED:
        return ScopedTimer(None, {})
    return ScopedTimer(_REGISTRY.histogram(name, labelnames=tuple(sorted(labels))),
                       labels)


# -- read-out ----------------------------------------------------------------
def snapshot() -> Dict[str, Any]:
    """Plain-data view of every collected series (works while disabled)."""
    return _REGISTRY.snapshot()


def reset() -> None:
    """Zero every series (metric families survive) and drop cost
    records; test isolation seam."""
    _REGISTRY.reset()
    from . import cost
    cost.clear()


def prometheus_text(registry: Optional[Registry] = None) -> str:
    return _prom_text(registry if registry is not None else _REGISTRY)
