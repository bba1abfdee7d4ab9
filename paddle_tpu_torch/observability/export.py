"""Exporters: Prometheus text exposition and JSONL step telemetry. The
port's copy of ``paddle_tpu/observability/export.py`` (the same text, the
same record shape).

* ``prometheus_text``: the scrape surface, one text document of every
  family in the registry in the Prometheus exposition format (``# TYPE``
  headers, dots mapped to underscores, cumulative ``_bucket{le=...}``
  histogram lines). ``parse_prometheus_text`` is its inverse.
* ``StepTelemetryWriter``: the stream surface, one JSON record per step
  with counter deltas since the previous record plus absolute gauges.
  Each record is the trace event envelope (``trace.make_event``: kind
  ``"step"``, the step number, counters and gauges inside ``attrs``) and
  is mirrored into the flight recorder, so a crash dump's tail carries
  the last steps' telemetry next to the fault events.
"""

from __future__ import annotations

import json
from typing import Any, Dict, IO, List, Optional, Union

from . import trace as _trace
from .registry import Counter, Gauge, Histogram, Registry

__all__ = ["prometheus_text", "parse_prometheus_text",
           "StepTelemetryWriter", "read_jsonl"]


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _escape_label_value(v: str) -> str:
    # exposition format: label values must escape \, " and newline
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _prom_labels(labelnames, key, extra: str = "") -> str:
    parts = [f'{_prom_name(n)}="{_escape_label_value(v)}"'
             for n, v in zip(labelnames, key)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"  # exposition format spells non-finite values out
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) else repr(f)


def prometheus_text(registry: Registry) -> str:
    lines: List[str] = []
    for m in registry.families():
        pname = _prom_name(m.name)
        series = m.series()
        if not series:
            continue
        if m.help:
            lines.append(f"# HELP {pname} {m.help}")
        lines.append(f"# TYPE {pname} {m.kind}")
        if isinstance(m, Histogram):
            for key, st in sorted(series.items()):
                for bound, c in zip(m.boundaries, st["buckets"]):
                    le = 'le="%r"' % (bound,)
                    labels = _prom_labels(m.labelnames, key, le)
                    lines.append(f"{pname}_bucket{labels} {c}")
                labels = _prom_labels(m.labelnames, key, 'le="+Inf"')
                lines.append(f"{pname}_bucket{labels} {st['buckets'][-1]}")
                lines.append(f"{pname}_sum{_prom_labels(m.labelnames, key)}"
                             f" {_fmt(st['sum'])}")
                lines.append(f"{pname}_count{_prom_labels(m.labelnames, key)}"
                             f" {st['count']}")
        else:
            for key, val in sorted(series.items()):
                lines.append(f"{pname}{_prom_labels(m.labelnames, key)}"
                             f" {_fmt(val)}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, float]]:
    """Inverse of ``prometheus_text`` for round-trip tests.

    Returns ``{sample_name: {label_string: value}}`` where ``label_string``
    is the raw ``{...}`` section ("" when unlabeled). Histogram samples
    appear under their ``_bucket``/``_sum``/``_count`` expansions, exactly
    as a scraper sees them.
    """
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            labels = "{" + rest
        else:
            name, labels = name_part, ""
        out.setdefault(name, {})[labels] = float(value_part)
    return out


def _flat_counters(registry: Registry) -> Dict[str, float]:
    """Counters (and histogram counts) as a flat {sample_name: value} map —
    the delta basis for step telemetry."""
    flat: Dict[str, float] = {}
    for m in registry.families():
        series = m.series()
        for key, val in series.items():
            suffix = "" if not key else \
                "{" + ",".join(f"{n}={v}"
                               for n, v in zip(m.labelnames, key)) + "}"
            if isinstance(m, Counter):
                flat[m.name + suffix] = float(val)
            elif isinstance(m, Histogram):
                flat[m.name + suffix + ".count"] = float(val["count"])
                flat[m.name + suffix + ".sum"] = float(val["sum"])
    return flat


def _flat_gauges(registry: Registry) -> Dict[str, float]:
    flat: Dict[str, float] = {}
    for m in registry.families():
        if not isinstance(m, Gauge):
            continue
        for key, val in m.series().items():
            suffix = "" if not key else \
                "{" + ",".join(f"{n}={v}"
                               for n, v in zip(m.labelnames, key)) + "}"
            flat[m.name + suffix] = float(val)
    return flat


class StepTelemetryWriter:
    """JSONL sink: one envelope event per step.

    Record shape (the trace envelope)::

        {"ts": perf_counter_s, "kind": "step", "name": "telemetry",
         "attrs": {"step": N,
                   "counters": {name: delta_since_last_record},
                   "gauges": {name: value}, ...extra}}

    Counter deltas (not absolutes) are recorded so a consumer can plot
    per-step rates without diffing, and so concatenated runs don't need a
    monotonic epoch. The first record's deltas are measured from writer
    construction (``baseline="now"``, default) or from zero
    (``baseline="zero"``). Every record is also appended to the flight
    recorder ring, so a post-mortem dump ends with the last steps'
    telemetry.
    """

    def __init__(self, path_or_file: Union[str, IO[str]],
                 registry: Optional[Registry] = None,
                 baseline: str = "now"):
        from . import default_registry
        self._registry = registry if registry is not None else \
            default_registry()
        if isinstance(path_or_file, str):
            self._fh: IO[str] = open(path_or_file, "a")
            self._owns = True
        else:
            self._fh = path_or_file
            self._owns = False
        self._prev = _flat_counters(self._registry) \
            if baseline == "now" else {}

    def write(self, step: int, **extra: Any) -> Dict[str, Any]:
        cur = _flat_counters(self._registry)
        deltas = {k: v - self._prev.get(k, 0.0)
                  for k, v in cur.items()
                  if v != self._prev.get(k, 0.0)}
        self._prev = cur
        attrs: Dict[str, Any] = {"step": int(step), "counters": deltas,
                                 "gauges": _flat_gauges(self._registry)}
        attrs.update(extra)
        rec = _trace.make_event("step", "telemetry", attrs=attrs)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        _trace.flight_recorder().record(rec)
        return rec

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self) -> "StepTelemetryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
