"""The port's observability (``paddle_tpu_torch.observability``) against
``paddle_tpu.observability``: the same calls give the same scrape document
and snapshot, span trees stay well-formed through exceptions, the flight
recorder honours its environment variable and dumps a parseable file, and
the scrape endpoint answers over loopback. The port's package imports
nothing of the JAX one."""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving import scheduler as jscheduler
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.observability import http as thttp
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.serving import scheduler as tscheduler

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def registries(monkeypatch):
    """A fresh, enabled default registry in each package for one test."""
    for mod in (jobs, tobs):
        monkeypatch.setattr(mod, "_REGISTRY", mod.Registry())
        monkeypatch.setattr(mod, "_ENABLED", True)
    yield jobs, tobs


@pytest.fixture
def port_tracing(tmp_path, monkeypatch):
    """The port's tracing fully on, a clean buffer and ring, dumps routed
    to ``tmp_path``."""
    monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(tmp_path))
    ttrace.set_mode("on")
    ttrace.clear()
    ttrace.flight_recorder().clear()
    yield ttrace
    ttrace.set_mode("off")
    ttrace.clear()
    ttrace.flight_recorder().clear()


def _serving_slo(obs, engine_mod, scheduler_mod):
    obs.histogram("serving.ttft_seconds", "submit -> first token",
                  buckets=engine_mod.TTFT_BUCKETS)
    obs.histogram("serving.tpot_seconds", "inter-token time",
                  buckets=engine_mod.TPOT_BUCKETS)
    obs.histogram("serving.queue_wait_seconds", "queue wait",
                  buckets=scheduler_mod.QUEUE_WAIT_BUCKETS)
    for v in (0.0004, 0.004, 0.0041, 0.02, 3.0):
        obs.observe("serving.tpot_seconds", v)
    for v in (0.003, 0.1, 0.75, 40.0):
        obs.observe("serving.ttft_seconds", v)
    obs.observe("serving.queue_wait_seconds", 0.0025)


def _counters(obs):
    for status in ("completed", "failed", "completed", "shed"):
        obs.inc("serving.requests_total", status=status)
    obs.inc("serving.tokens_total", 17)
    obs.inc("serving.replays_total")
    obs.inc("serving.rejected_total", reason="queue_full")
    obs.inc("resilience.injected_faults_total", site="serving.step",
            kind="error")


def _gauges(obs):
    obs.set_gauge("serving.queue_depth", 3)
    obs.set_gauge("serving.batch_utilization", 0.75)
    obs.set_gauge("serving.kv.pages_shared_ratio", 1 / 3)
    g = obs.gauge("serving.custom_level", "a level", labelnames=("slot",))
    g.set(2.5, slot="a")
    g.add(-1.0, slot="a")
    g.set(float("inf"), slot='b"\n')


def _custom_histogram(obs):
    h = obs.histogram("serving.step_seconds", "one step",
                      labelnames=("bucket",), buckets=(0.001, 0.01, 0.1))
    for b, v in (("1", 0.0005), ("16", 0.011), ("16", 0.5), ("1", 0.01)):
        h.observe(v, bucket=b)
    with obs.scoped_timer("serving.default_grid_seconds"):
        pass


SEQUENCES = {"counters": [_counters], "gauges": [_gauges],
             "histograms": [_custom_histogram],
             "all": [_counters, _gauges, _custom_histogram]}


@pytest.mark.parametrize("seq", sorted(SEQUENCES) + ["slo_buckets"])
def test_same_calls_same_scrape_and_snapshot(registries, seq):
    jo, to = registries
    for obs in (jo, to):
        if seq == "slo_buckets":
            mods = ((jengine, jscheduler) if obs is jo
                    else (tengine, tscheduler))
            _serving_slo(obs, *mods)
        else:
            for fn in SEQUENCES[seq]:
                fn(obs)
    snap_j, snap_t = jo.snapshot(), to.snapshot()
    if seq in ("histograms", "all"):
        # the scoped timer's sample is a wall time: equal total counts, any
        # sum, and any bucket (an empty block's time falls on either side
        # of the first edge, 1e-5 s, on a loaded host)
        for s in (snap_j, snap_t):
            timer = s["serving.default_grid_seconds"]
            assert timer["buckets"][-1] == timer["count"] == 1
            timer["sum"] = 0.0
            del timer["buckets"]
            jo.default_registry().get(
                "serving.default_grid_seconds").clear()
            to.default_registry().get(
                "serving.default_grid_seconds").clear()
    assert snap_t == snap_j
    assert to.prometheus_text() == jo.prometheus_text()
    if seq == "slo_buckets":
        assert 'serving_tpot_seconds_bucket{le="0.004"} 2' \
            in to.prometheus_text()


def test_prometheus_round_trip(registries):
    _, to = registries
    _counters(to)
    _gauges(to)
    _serving_slo(to, tengine, tscheduler)
    parsed = to.parse_prometheus_text(to.prometheus_text())
    snap = to.snapshot()
    assert parsed["serving_tokens_total"][""] == snap["serving.tokens_total"]
    assert parsed["serving_requests_total"]['{status="completed"}'] == 2.0
    assert parsed["serving_batch_utilization"][""] == 0.75
    ttft = snap["serving.ttft_seconds"]
    assert parsed["serving_ttft_seconds_count"][""] == ttft["count"]
    assert parsed["serving_ttft_seconds_sum"][""] == ttft["sum"]
    buckets = parsed["serving_ttft_seconds_bucket"]
    assert [buckets['{le="%r"}' % b] for b in tengine.TTFT_BUCKETS] \
        == ttft["buckets"][:-1]
    assert buckets['{le="+Inf"}'] == ttft["count"]


def test_disabled_helpers_record_nothing(monkeypatch):
    monkeypatch.setattr(tobs, "_REGISTRY", tobs.Registry())
    monkeypatch.setattr(tobs, "_ENABLED", False)
    tobs.inc("serving.tokens_total")
    tobs.observe("serving.tpot_seconds", 0.1)
    tobs.set_gauge("serving.queue_depth", 1)
    with tobs.scoped_timer("serving.x_seconds"):
        pass
    assert tobs.snapshot() == {}
    with pytest.raises(TypeError, match="positional-only"):
        monkeypatch.setattr(tobs, "_ENABLED", True)
        tobs.inc("serving.tokens_total", value=5)


def test_span_tree_survives_an_exception_and_exports(port_tracing):
    tr = port_tracing
    assert tr.span("off-check") is not None
    ctx = tr.new_trace("request-7", rid=7)
    with pytest.raises(RuntimeError, match="boom"):
        with tr.span("serving.submit", parent=ctx, rid=7):
            with tr.span("serving.prefill", rid=7):
                tr.instant("serving.fault", rid=7, site="serving.admit")
                raise RuntimeError("boom")
    ctx2 = tr.new_trace("request-8", rid=8)
    with tr.span("serving.prefill", parent=ctx2, rid=8):
        pass
    evs = tr.events()
    assert tr.span_problems(evs) == []
    ends = [e for e in evs if e["kind"] == "E"]
    assert [e["attrs"].get("error") for e in ends] == [
        "RuntimeError", "RuntimeError", None]
    doc = tr.export_chrome()
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"]
    assert sorted(n for n in names if n.startswith("request-")) \
        == ["request-7", "request-8"]
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == 3
    # a dangling begin is a problem
    assert tr.span_problems(evs[:-1]) != []


def test_span_trees_match_the_jax_package(port_tracing, monkeypatch,
                                          tmp_path):
    def drive(tr):
        ctx = tr.new_trace("request-1", rid=1)
        with tr.span("serving.submit", parent=ctx, rid=1):
            tr.instant("serving.queued", parent=ctx, rid=1, depth=1)
        with tr.span("serving.prefill", parent=ctx, rid=1, prompt=9):
            pass
        tr.record("fault", site="serving.step", injected="error", call=3)
        return [(e["kind"], e["name"], e["attrs"]) for e in tr.events()]

    jtrace.set_mode("on")
    jtrace.clear()
    try:
        want = drive(jtrace)
    finally:
        jtrace.set_mode("off")
        jtrace.clear()
    assert drive(port_tracing) == want


def test_flight_recorder_capacity_and_dump(port_tracing, monkeypatch,
                                           tmp_path):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_EVENTS", "16")
    ring = ttrace.FlightRecorder()
    assert ring.capacity == 16
    for i in range(40):
        ring.record(ttrace.make_event("ev", f"e{i}", attrs={"i": i}))
    assert [e["name"] for e in ring.snapshot()] == \
        [f"e{i}" for i in range(24, 40)]
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_EVENTS", "nonsense")
    assert ttrace.FlightRecorder().capacity == 512
    ttrace.record("fault", site="serving.watchdog", injected="delay", call=2)
    path = ttrace.flight_dump("serving_recover", error="WatchdogTimeout")
    assert path == os.path.join(str(tmp_path),
                                f"flight-{os.getpid()}-serving_recover.json")
    doc = json.load(open(path))
    assert doc["reason"] == "serving_recover" and doc["schema"] == 1
    assert doc["info"] == {"error": "WatchdogTimeout"}
    assert doc["events"][-1]["attrs"]["site"] == "serving.watchdog"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_scrape_endpoint_over_loopback(registries, port_tracing):
    _, to = registries
    _serving_slo(to, tengine, tscheduler)
    srv = thttp.start_http_server(0)
    try:
        assert srv.port > 0
        code, body = _get(srv.url + "/metrics")
        assert code == 200
        assert 'serving_tpot_seconds_bucket{le="0.004"} 2' in body
        assert to.parse_prometheus_text(body) == \
            to.parse_prometheus_text(to.prometheus_text())
        ttrace.heartbeat("serving.engine", ttl_s=60)
        code, body = _get(srv.url + "/healthz")
        assert code == 200
        doc = json.loads(body)
        assert doc["status"] == "ok"
        assert doc["components"]["serving.engine"]["stale"] is False
        ttrace.heartbeat("serving.engine.stale", ttl_s=-1)
        code, body = _get(srv.url + "/healthz")
        assert code == 503
        ttrace.heartbeat_clear("serving.engine.stale")
        ttrace.heartbeat_clear("serving.engine")
        ttrace.record("fault", site="serving.admit", injected="error",
                      call=1)
        code, body = _get(srv.url + "/debug/flight")
        assert code == 200
        flight = json.loads(body)
        assert flight["events"][-1]["name"] == "fault"
        assert flight["capacity"] == ttrace.flight_recorder().capacity
        code, body = _get(srv.url + "/debug/trace")
        assert code == 200 and "traceEvents" in json.loads(body)
        assert _get(srv.url + "/nope")[0] == 404
    finally:
        srv.close()


def test_scrape_endpoint_from_the_environment(monkeypatch):
    monkeypatch.setattr(thttp, "_GLOBAL", None)
    monkeypatch.setattr(thttp, "_DISABLED", False)
    monkeypatch.delenv("PADDLE_TPU_OBS_HTTP_PORT", raising=False)
    assert thttp.maybe_serve_from_env() is None
    monkeypatch.setenv("PADDLE_TPU_OBS_HTTP_PORT", "0")
    srv = thttp.maybe_serve_from_env()
    try:
        assert srv is not None and thttp.maybe_serve_from_env() is srv
        assert _get(srv.url + "/metrics")[0] == 200
    finally:
        srv.close()
    monkeypatch.setattr(thttp, "_GLOBAL", None)
    monkeypatch.setenv("PADDLE_TPU_OBS_HTTP_PORT", "not-a-port")
    assert thttp.maybe_serve_from_env() is None


_IMPORT = """
import sys
import paddle_tpu_torch.observability
import paddle_tpu_torch.observability.http
import paddle_tpu_torch.resilience
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_observability_imports_nothing_of_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _IMPORT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
