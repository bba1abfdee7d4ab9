"""Process-global metrics registry: counters, gauges, histograms. The
port's copy of ``paddle_tpu/observability/registry.py``, with the same
family names, label sets, bucket layout and snapshot shape, so a dashboard
or a scrape config reads either package unchanged.

* metric families are created lazily (``counter()``/``gauge()``/
  ``histogram()`` are get-or-create), so instrumented modules never have
  to coordinate declaration order;
* labeled series live inside the family, keyed by the tuple of label
  values (the Prometheus data model, so the text exposition falls out);
* histograms use fixed bucket boundaries captured at family creation:
  cumulative bucket counts + sum + count, the Prometheus shape;
* locking is per family (each metric carries its own lock; the registry
  lock guards family creation only), so ``snapshot()`` is consistent per
  series but not atomic across families. When observability is disabled
  the module-level helpers in ``observability/__init__.py`` return
  before reaching a family, so the cold path takes no lock.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "LogThrottle", "Registry",
           "DEFAULT_LATENCY_BUCKETS"]

# Seconds-scale latency boundaries: 10us .. 10s, roughly x3 per step.
DEFAULT_LATENCY_BUCKETS = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0,
)


def _label_key(labelnames: Tuple[str, ...], labels: Dict[str, Any]
               ) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"metric labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    """One metric FAMILY: a name plus its labeled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (), lock: Optional[Any] = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock if lock is not None else threading.Lock()
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _zero(self):
        return 0.0

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def series(self) -> Dict[Tuple[str, ...], Any]:
        """Snapshot of {label-values tuple: value} (values are copies)."""
        with self._lock:
            return {k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in self._series.items()}


class Counter(_Metric):
    """Monotonically increasing count (reference: monitor Int stats)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)


class Gauge(_Metric):
    """Point-in-time level (queue depth, node age, bubble fraction)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = float(value)

    def add(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(value)

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram with fixed boundaries.

    Reads (``series``/``stats``) return
    ``{"buckets": [c_0..c_{B}], "sum": s, "count": n}`` where
    ``buckets[i]`` counts observations <= ``boundaries[i]`` and the final
    slot is the +Inf bucket (== count), the Prometheus layout. Storage is
    per-bucket raw counts; cumulation happens at read time so the write
    path stays one bisect + one increment.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None,
                 lock: Optional[Any] = None):
        super().__init__(name, help, labelnames, lock=lock)
        b = tuple(sorted(float(x) for x in
                         (DEFAULT_LATENCY_BUCKETS if buckets is None
                          else buckets)))
        if not b:
            raise ValueError("histogram needs at least one bucket boundary")
        self.boundaries = b

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        value = float(value)
        # one bisect + one slot increment under the lock; raw per-bucket
        # counts are cumulated into the Prometheus shape at read time
        idx = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = {"buckets": [0] * (len(self.boundaries) + 1),
                      "sum": 0.0, "count": 0}
                self._series[key] = st
            st["buckets"][idx] += 1
            st["sum"] += value
            st["count"] += 1

    @staticmethod
    def _cumulate(st: Dict[str, Any]) -> Dict[str, Any]:
        cum, acc = [], 0
        for c in st["buckets"]:
            acc += c
            cum.append(acc)
        return {"buckets": cum, "sum": st["sum"], "count": st["count"]}

    def series(self) -> Dict[Tuple[str, ...], Any]:
        with self._lock:
            return {k: self._cumulate(st) for k, st in self._series.items()}

    def stats(self, **labels) -> Dict[str, Any]:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                return {"buckets": [0] * (len(self.boundaries) + 1),
                        "sum": 0.0, "count": 0}
            return self._cumulate(st)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Thread-safe collection of metric families, keyed by name.

    ``snapshot()`` returns plain data (no live objects): unlabeled series
    flatten to their scalar (or histogram dict) under the family name;
    labeled series nest under ``{"k=v,...": value}``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {m.kind}")
                if tuple(labelnames) != m.labelnames:
                    raise ValueError(
                        f"metric {name!r} label mismatch: "
                        f"{tuple(labelnames)} vs {m.labelnames}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._get_or_create(Histogram, name, help, labelnames,
                                buckets=buckets)
        if buckets is not None:
            want = tuple(sorted(float(x) for x in buckets))
            if want != h.boundaries:
                # boundaries are FIXED at family creation; silently keeping
                # the old ones would drop every sample into +Inf
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{h.boundaries}, requested {want}")
        return h

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def families(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- read-out -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for m in self.families():
            series = m.series()
            if not m.labelnames:
                if () in series:
                    out[m.name] = series[()]
                continue
            labeled = {}
            for key, val in series.items():
                label_str = ",".join(f"{n}={v}"
                                     for n, v in zip(m.labelnames, key))
                labeled[label_str] = val
            if labeled:
                out[m.name] = labeled
        return out

    def reset(self) -> None:
        """Zero every series; families (names, buckets, labels) survive."""
        for m in self.families():
            m.clear()


class LogThrottle:
    """At-most-one log line per ``interval`` seconds, on a monotonic
    clock that never rewinds. The instrumented subsystems share one
    policy through this class: a failure that repeats every tick keeps
    its COUNTER accurate while the log stays readable — call ``ready()``
    and only emit when it returns True. The first occurrence always
    logs (the initial window is open)."""

    __slots__ = ("interval", "_last")

    def __init__(self, interval: float = 10.0):
        self.interval = float(interval)
        self._last = 0.0

    def ready(self) -> bool:
        now = time.monotonic()
        if now - self._last >= self.interval:
            self._last = now
            return True
        return False


class ScopedTimer:
    """RAII latency sample into a histogram — the metrics analogue of
    ``profiler.RecordEvent``::

        with obs.scoped_timer("train.step_seconds", phase="fwd"):
            ...

    Cheap when observability is disabled: the ``enabled`` probe is taken at
    ``__enter__`` and the exit path short-circuits.
    """

    __slots__ = ("_hist", "_labels", "_t0")

    def __init__(self, hist: Optional[Histogram], labels: Dict[str, Any]):
        self._hist = hist
        self._labels = labels
        self._t0 = 0.0

    def __enter__(self) -> "ScopedTimer":
        if self._hist is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._hist is not None:
            self._hist.observe(time.perf_counter() - self._t0,
                               **self._labels)
