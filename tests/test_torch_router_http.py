"""The port's serving front door against ``paddle_tpu.serving``'s: the
circuit breaker, the pick-2 router with at-most-once failover and the
streaming HTTP front door, over the tiny Llama with carried weights (the
JAX engine on its paged tier, the Pallas decode kernel under the
interpreter; the port's engine on the CPU).

* status table: ``status_for`` and ``retry_after_s`` over every exception
  of the typed surface equal the JAX package's;
* breaker: one scripted sequence of calls, successes, failures and clock
  steps gives the same states and gauge values in both packages;
* placement: pick-2 with one seed over replicas with the same queue states
  gives the same ``Router.trace``, prefix-affine placement included;
* end to end: a ``FrontDoor`` over a ``Router`` of two engines in each
  package, fed the same prompts one at a time: tokens exact (fp32), SSE
  and unary bodies byte-equal apart from request ids and timing fields,
  the same ``/healthz`` keys;
* seeded faults: one ``FaultSchedule`` over ``router.pick``,
  ``router.forward`` and ``http.write`` gives the same status and outcome
  per request, the same fault trace and the same router trace;
* two engines' loop threads share the kernels' launch counters: no
  increment is lost, and a capture records the wrappers' launches while
  other graphs' replays go on counting;
* the cases of ``tests/test_serving_http.py`` on the port: the status
  mapping over HTTP (400, 429 + Retry-After, 503, 504), SSE parity with one
  terminal event, per-replica ``/healthz``, pick-2 spreading, no failover
  after a token, a hedge that reroutes only by ``withdraw``, a drained
  replica leaving the rotation before its drain, breakers, budgets, and a
  drain that ends every stream with a typed event.

Tolerance: tokens equal; statuses, traces and frames equal.
"""

import http.client
import json
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.distributed.rpc import RpcTransportError as JRpcTransportError
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.resilience import DeadlineExceeded as JDeadlineExceeded
from paddle_tpu.resilience import breaker as jbreaker
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import http as jhttp
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import serving
from paddle_tpu_torch._native import LaunchCounter, recorded_launches
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.distributed.rpc import RpcTransportError
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.resilience import DeadlineExceeded, breaker, faults
from paddle_tpu_torch.serving import http as thttp

torch.set_num_threads(2)

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=48,
            max_pos=128)
MAX_LEN, PS = 96, 16


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 64, (n,), dtype=np.int32)
            for n in (8, 8, 21, 5, 11, 30)]


PROMPTS = _prompts()


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    jm = JLlama(JConfig.tiny(**TINY))
    jm.eval()
    np_state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(np_state), strict=True)
    yield jm, tm
    import gc
    del jm
    gc.collect()


def _cfg(mod, name, **kw):
    base = dict(num_layers=2, num_heads=2, head_dim=8, max_len=MAX_LEN,
                max_batch=4, buckets=(1, 2, 4), page_size=PS,
                kv_dtype="native", watchdog_s=0, max_queue=16, name=name,
                prefix_sharing="off")
    base.update(kw)
    return mod.ServingConfig(**base)


def _engine(pair, mod, name, **kw):
    jm, tm = pair
    if mod is jserving:
        return jserving.Engine(*jm.serving_callables(MAX_LEN),
                               _cfg(jserving, name, paged_attention="on",
                                    **kw))
    return serving.Engine(*tm.serving_callables(MAX_LEN),
                          _cfg(serving, name, device="cpu", **kw))


def _router(pair, mod, k=2, seed=0, hedge_s=0, poll_s=0.02, router_kw=None,
            **eng_kw):
    names = [chr(ord("a") + i) for i in range(k)]
    engines = [(n, _engine(pair, mod, n, **eng_kw)) for n in names]
    cfg = mod.RouterConfig(seed=seed, hedge_s=hedge_s, poll_s=poll_s,
                           **(router_kw or {}))
    return mod.Router(engines, cfg), dict(engines)


@pytest.fixture
def metrics(monkeypatch):
    """A fresh, enabled default registry in each package for one test."""
    for mod in (jobs, tobs):
        monkeypatch.setattr(mod, "_REGISTRY", mod.Registry())
        monkeypatch.setattr(mod, "_ENABLED", True)
    yield jobs, tobs


@pytest.fixture(scope="module")
def reference(pair):
    """The port engine's transcript of each prompt decoded alone, 40 new
    tokens (a shorter request's tokens are its prefix)."""
    out = []
    for p in PROMPTS:
        eng = _engine(pair, serving, "ref")
        fut = eng.submit(serving.GenerationRequest(p, max_new_tokens=40))
        eng.run()
        out.append(fut.result(timeout=0).tokens)
    return out


def _ref(reference, i, n):
    return reference[i][:n]


# ---------------------------------------------------------------------------
# HTTP helpers (tests/test_serving_http.py's)
# ---------------------------------------------------------------------------

def post_generate(fd, prompt, *, max_new_tokens=4, stream=False,
                  headers=None, timeout=30.0, raw_body=None):
    """One POST /v1/generate over a real socket; returns (status, headers,
    parsed JSON or None, raw bytes)."""
    conn = http.client.HTTPConnection(fd.host, fd.port, timeout=timeout)
    try:
        body = raw_body if raw_body is not None else json.dumps({
            "prompt": np.asarray(prompt).tolist(),
            "max_new_tokens": max_new_tokens, "stream": stream}).encode()
        conn.request("POST", "/v1/generate", body=body,
                     headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        doc = None
        if resp.headers.get("Content-Type", "").startswith(
                "application/json"):
            doc = json.loads(raw)
        return resp.status, dict(resp.headers), doc, raw
    finally:
        conn.close()


def read_sse(raw: bytes):
    """(tokens, terminals), each terminal ("done"|"error", doc); a stream
    cut without a terminal gives ``terminals == []``."""
    tokens, terminals = [], []
    event = "message"
    for line in raw.decode("utf-8").splitlines():
        if line.startswith("event: "):
            event = line[len("event: "):]
        elif line.startswith("data: "):
            doc = json.loads(line[len("data: "):])
            if event in ("done", "error"):
                terminals.append((event, doc))
            else:
                tokens.append(doc["token"])
        elif not line:
            event = "message"
    return tokens, terminals


def stream_generate(fd, prompt, *, max_new_tokens=4, headers=None,
                    timeout=30.0):
    status, _hdrs, _doc, raw = post_generate(
        fd, prompt, max_new_tokens=max_new_tokens, stream=True,
        headers=headers, timeout=timeout)
    assert status == 200   # stream errors arrive as the terminal event
    return read_sse(raw)


def get_json(fd, path):
    conn = http.client.HTTPConnection(fd.host, fd.port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


# the fields that differ between two runs of the same request: request ids
# (each package numbers its own) and measured times
_VOLATILE = re.compile(rb'"(request_id|ttft_s|tpot_s)": [^,}]+')


def _stable(raw: bytes) -> bytes:
    return _VOLATILE.sub(rb'"\1": 0', raw)


def _normal_trace(trace, rids):
    """A router trace with each request id replaced by its submission
    index (the packages number requests apart)."""
    index = {rid: i for i, rid in enumerate(rids)}
    out = []
    for entry in trace:
        if entry[0] in ("out", "in"):
            out.append(entry)
        else:
            out.append((entry[0], index.get(entry[1], entry[1]))
                       + tuple(entry[2:]))
    return out


def _wait_beacons(trace_mod, names, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if set(names) <= set(trace_mod.health()["components"]):
            return
        time.sleep(0.005)
    raise AssertionError(f"beacons {names} never beat")


# ---------------------------------------------------------------------------
# the status table
# ---------------------------------------------------------------------------

def _shed(mod_exc, est, depth):
    exc = mod_exc("shed on arrival")
    exc.estimated_wait_s, exc.depth, exc.capacity = est, depth, 8
    return exc


SURFACE = {
    "queue_full": lambda m: m.QueueFull("full", depth=8, capacity=8,
                                        estimated_wait_s=2.0),
    "queue_full_cold": lambda m: m.QueueFull("full", depth=8, capacity=8,
                                             estimated_wait_s=0.0),
    "queue_full_no_depth": lambda m: m.QueueFull("full",
                                                 estimated_wait_s=0.6),
    "shed": lambda m: _shed(m.DeadlineExceeded, 0.75, 3),
    "deadline": lambda m: m.DeadlineExceeded("expired"),
    "engine_stopped": lambda m: m.EngineStopped("draining"),
    "drain_timeout": lambda m: m.DrainTimeout("evicted"),
    "no_healthy_replica": lambda m: m.NoHealthyReplica("none"),
    "breaker_open": lambda m: m.BreakerOpen("open"),
    "watchdog": lambda m: m.WatchdogTimeout("hung"),
    "fault_injected": lambda m: m.FaultInjected("boom"),
    "rpc_transport": lambda m: m.RpcTransportError("died mid-stream"),
    "connection": lambda m: ConnectionError("reset"),
    "future_timeout": lambda m: m.FutureTimeout("no terminal"),
    "value": lambda m: ValueError("bad"),
    "runtime": lambda m: RuntimeError("bug"),
}


class _Surface:
    """One package's typed surface under common names."""

    def __init__(self, serving_mod, breaker_mod, faults_mod, rpc_exc,
                 deadline_exc):
        from concurrent.futures import TimeoutError as FutureTimeout
        for name in ("QueueFull", "EngineStopped", "DrainTimeout",
                     "NoHealthyReplica", "WatchdogTimeout"):
            setattr(self, name, getattr(serving_mod, name))
        self.BreakerOpen = breaker_mod.BreakerOpen
        self.FaultInjected = faults_mod.FaultInjected
        self.RpcTransportError = rpc_exc
        self.DeadlineExceeded = deadline_exc
        self.FutureTimeout = FutureTimeout


@pytest.mark.parametrize("case", sorted(SURFACE))
def test_status_table_matches_the_jax_front_door(case):
    jexc = SURFACE[case](_Surface(jserving, jbreaker, jfaults,
                                  JRpcTransportError, JDeadlineExceeded))
    texc = SURFACE[case](_Surface(serving, breaker, faults,
                                  RpcTransportError, DeadlineExceeded))
    assert thttp.status_for(texc) == jhttp.status_for(jexc)
    assert thttp.retry_after_s(texc) == jhttp.retry_after_s(jexc)
    assert thttp._error_doc(texc) == jhttp._error_doc(jexc)


def test_status_table_entries_and_values():
    # the port's table names the port's types, in the JAX table's order
    assert [(t.__name__, s) for t, s in thttp._STATUS_MAP] == \
        [(t.__name__, s) for t, s in jhttp._STATUS_MAP]
    assert thttp.status_for(serving.QueueFull("full")) == 429
    assert thttp.status_for(DeadlineExceeded("expired")) == 504
    assert thttp.status_for(RpcTransportError("dead")) == 503
    assert thttp.status_for(ValueError("bad")) == 400
    assert thttp.status_for(RuntimeError("bug")) == 500


# ---------------------------------------------------------------------------
# the breaker
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


BREAKER_SCRIPT = (
    "call", "fail", "call", "ok", "call", "fail", "call", "fail", "call",
    "fail", "call", "tick:0.3", "call", "tick:0.8", "call", "call", "fail",
    "call", "tick:1.0", "call", "ok", "call", "fail", "reset", "call",
    "fail", "fail", "fail", "call", "tick:2.0", "call", "ok", "ok",
)


def _drive_breaker(mod, obs_mod):
    clock = _Clock()
    br = mod.CircuitBreaker("serving.replica.x", failure_threshold=3,
                            cooldown=1.0, clock=clock)
    seen = []
    for op in BREAKER_SCRIPT:
        outcome = None
        if op == "call":
            try:
                br.before_call()
                outcome = "pass"
            except mod.BreakerOpen:
                outcome = "short"
        elif op == "ok":
            br.record_success()
        elif op == "fail":
            br.record_failure()
        elif op == "reset":
            br.reset()
        else:
            clock.t += float(op.split(":")[1])
        snap = obs_mod.snapshot()
        seen.append((op, outcome, br.state,
                     snap.get("resilience.breaker_state", {}).get(
                         "endpoint=serving.replica.x")))
    snap = obs_mod.snapshot()
    return seen, {k: snap.get(k) for k in (
        "resilience.breaker_transitions_total",
        "resilience.breaker_short_circuits_total")}


def test_breaker_states_and_gauges_match_the_jax_breaker(metrics):
    jo, to = metrics
    want = _drive_breaker(jbreaker, jo)
    got = _drive_breaker(breaker, to)
    assert got == want
    states = {s for _, _, s, _ in got[0]}
    assert states == {"closed", "open", "half_open"}


def test_breaker_registry_reads_the_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RETRY_BREAKER_THRESHOLD", "7")
    monkeypatch.setenv("PADDLE_TPU_RETRY_BREAKER_COOLDOWN", "2.5")
    for mod in (jbreaker, breaker):
        mod.reset_breakers()
        br = mod.breaker_for("store:1")
        assert (br.failure_threshold, br.cooldown) == (7, 2.5)
        assert mod.breaker_for("store:1") is br
        mod.reset_breakers()


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _placement_run(pair, mod, seed):
    """Paused engines (no loop thread): queue depths are the only live
    signal (every EWMA is cold), so picks follow the seeded pair sampling
    and the depth and name tie-breaks. Then a prefix made resident on
    replica ``c`` pulls its followers there (affinity)."""
    router, engines = _router(pair, mod, k=4, seed=seed,
                              prefix_sharing="on")
    rids = []
    futs = []
    # uneven starting queues, placed on the engines directly
    for name, n in (("a", 2), ("b", 0), ("c", 1), ("d", 3)):
        for i in range(n):
            engines[name].submit(mod.GenerationRequest(
                PROMPTS[i], max_new_tokens=2))
    for i in range(10):
        req = mod.GenerationRequest(PROMPTS[i % len(PROMPTS)],
                                    max_new_tokens=2)
        rids.append(req.request_id)
        futs.append(router.submit(req))
    for eng in engines.values():
        eng.run()
    for f in futs:
        f.result(timeout=60)
    # a 2-page prefix resident on "c" only
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 64, (2 * PS,), dtype=np.int32)
    seed_req = mod.GenerationRequest(
        np.concatenate([shared, PROMPTS[3]]), max_new_tokens=2)
    engines["c"].submit(seed_req)
    engines["c"].run()
    for i, tail in enumerate((5, 9, 13, 2)):
        req = mod.GenerationRequest(
            np.concatenate([shared, rng.integers(0, 64, (tail,),
                                                 dtype=np.int32)]),
            max_new_tokens=2)
        rids.append(req.request_id)
        futs.append(router.submit(req))
        if i == 1:
            for eng in engines.values():
                eng.run()
    for eng in engines.values():
        eng.run()
    tokens = [f.result(timeout=60).tokens for f in futs]
    router.stop(drain=True, timeout=5)
    for eng in engines.values():
        assert eng.kv.outstanding_pages == 0
    return _normal_trace(router.trace, rids), tokens


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_pick2_and_affinity_traces_match_the_jax_router(pair, metrics, seed):
    want_trace, want_tokens = _placement_run(pair, jserving, seed)
    got_trace, got_tokens = _placement_run(pair, serving, seed)
    assert got_trace == want_trace
    assert got_tokens == want_tokens
    picks = [e for e in got_trace if e[0] == "pick"]
    assert len({e[2] for e in picks}) >= 3
    affine = [e for e in got_trace if e[0] == "affinity"]
    # the first follower finds the prefix on "c" only; once others ran
    # followers the chain is resident there too
    assert affine and affine[0][2] == "c"
    assert all(e[3] == 2 for e in affine)


def test_prefix_depth_walks_the_same_chain(pair):
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 64, (3 * PS,), dtype=np.int32)
    depths = []
    for mod in (jserving, serving):
        eng = _engine(pair, mod, "p", prefix_sharing="on")
        eng.submit(mod.GenerationRequest(shared.copy(), max_new_tokens=2))
        eng.run()
        rep = mod.Replica("p", eng)
        depths.append([rep.prefix_depth(mod.GenerationRequest(
            np.concatenate([shared[:n], PROMPTS[0]]), max_new_tokens=1))
            for n in (0, PS - 1, PS, 2 * PS, 3 * PS)])
        eng.stop(drain=True, timeout=5)
    assert depths[0] == depths[1]
    assert depths[1][:4] == [0, 0, 1, 2]


# ---------------------------------------------------------------------------
# end to end through the front door, both packages
# ---------------------------------------------------------------------------

def _front_door_run(pair, mod, http_mod, trace_mod, n_new=6):
    router, engines = _router(pair, mod, k=2)
    fd = http_mod.FrontDoor(router)
    router.start()
    out = []
    try:
        _wait_beacons(trace_mod, ["serving.engine.a", "serving.engine.b",
                                  "serving.router"])
        for i, p in enumerate(PROMPTS[:4]):
            status, hdrs, _doc, raw = post_generate(
                fd, p, max_new_tokens=n_new, stream=bool(i % 2))
            out.append((status, hdrs.get("Content-Type"), _stable(raw)))
        code, health = get_json(fd, "/healthz")
        shape = {"status": health["status"], "code": code,
                 "keys": sorted(health),
                 "components": {k: sorted(v) for k, v in
                                health["components"].items()
                                if k in ("serving.engine.a",
                                         "serving.engine.b",
                                         "serving.router")},
                 "router": health["router"]}
    finally:
        router.stop(drain=True, timeout=10)
        fd.close()
    for eng in engines.values():
        assert eng.kv.outstanding_pages == 0
    return out, shape


def test_front_door_end_to_end_matches_the_jax_front_door(pair, metrics,
                                                          reference):
    want, want_health = _front_door_run(pair, jserving, jhttp, jtrace)
    got, got_health = _front_door_run(pair, serving, thttp, ttrace)
    assert got == want
    assert got_health == want_health
    assert got_health["router"]["in_rotation"] == ["a", "b"]
    for i, (status, ctype, raw) in enumerate(got):
        assert status == 200
        if i % 2:
            assert ctype == "text/event-stream"
            tokens, terminals = read_sse(raw)
            assert len(terminals) == 1 and terminals[0][0] == "done"
            assert tokens == terminals[0][1]["tokens"]
        else:
            tokens = json.loads(raw)["tokens"]
        assert tokens == _ref(reference, i, 6)


def _fault_schedule(mod, seed):
    s = mod.FaultSchedule(seed)
    s.error("router.pick", prob=0.25)
    s.error("router.forward", prob=0.3)
    s.error("http.write", prob=0.3)
    return s


def _faulted_run(pair, mod, http_mod, faults_mod, seed):
    # a breaker that opens on two failures and stays open for the run: its
    # state depends on the schedule only, never on the clock
    router, engines = _router(pair, mod, k=2, router_kw={
        "breaker_threshold": 2, "breaker_cooldown": 600.0})
    fd = http_mod.FrontDoor(router)
    router.start()
    outcomes, rids = [], []
    sched = _fault_schedule(faults_mod, seed)
    try:
        with faults_mod.installed(sched):
            for i in range(8):
                status, _h, doc, raw = post_generate(
                    fd, PROMPTS[i % len(PROMPTS)], max_new_tokens=5,
                    stream=bool(i % 2))
                if i % 2 and status == 200:
                    tokens, terminals = read_sse(raw)
                    outcomes.append((status, tokens, [
                        (k, d.get("error"), d.get("status"),
                         d.get("tokens")) for k, d in terminals]))
                else:
                    outcomes.append((status, doc.get("error"),
                                     doc.get("tokens")))
                rids.append(next(e[1] for e in reversed(router.trace)
                                 if e[0] not in ("out", "in")))
    finally:
        router.stop(drain=True, timeout=10)
        fd.close()
    for eng in engines.values():
        assert eng.kv.outstanding_pages == 0
    return outcomes, sched.trace, _normal_trace(router.trace, rids)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_faults_give_the_jax_outcomes(pair, metrics, seed):
    want = _faulted_run(pair, jserving, jhttp, jfaults, seed)
    got = _faulted_run(pair, serving, thttp, faults, seed)
    assert got[1] == want[1] and len(got[1]) >= 2
    assert got[0] == want[0]
    assert got[2] == want[2]


# ---------------------------------------------------------------------------
# the front door over one port engine (tests/test_serving_http.py's cases)
# ---------------------------------------------------------------------------

class TestFrontDoor:
    def test_unary_parity_and_metrics(self, pair, metrics, reference):
        eng = _engine(pair, serving, "").warmup()
        fd = serving.FrontDoor(eng)
        eng.start()
        try:
            status, _h, doc, _raw = post_generate(fd, PROMPTS[0],
                                                  max_new_tokens=5)
            assert status == 200
            assert doc["tokens"] == _ref(reference, 0, 5)
            assert doc["finish_reason"] == "length"
            assert doc["ttft_s"] is not None
        finally:
            eng.stop(drain=True, timeout=10)
            fd.close()
        snap = metrics[1].snapshot()
        assert snap["serving.http.requests_total"].get("status=200") == 1
        assert snap["serving.http.request_seconds"]["count"] == 1

    def test_stream_parity_single_terminal(self, pair, metrics, reference):
        eng = _engine(pair, serving, "").warmup()
        fd = serving.FrontDoor(eng)
        eng.start()
        try:
            tokens, terminals = stream_generate(fd, PROMPTS[1],
                                                max_new_tokens=6)
        finally:
            eng.stop(drain=True, timeout=10)
            fd.close()
        ref = _ref(reference, 1, 6)
        assert tokens == ref
        assert len(terminals) == 1
        kind, doc = terminals[0]
        assert kind == "done" and doc["tokens"] == ref
        assert metrics[1].snapshot()["serving.http.streams_total"] == 1

    def test_bad_request_maps_400(self, pair, metrics):
        eng = _engine(pair, serving, "")
        fd = serving.FrontDoor(eng)
        try:
            status, _h, _doc, _raw = post_generate(
                fd, PROMPTS[0], raw_body=b"{not json")
            assert status == 400
            status, _h, doc, _raw = post_generate(
                fd, PROMPTS[0], raw_body=b'{"nope": 1}')
            assert status == 400 and doc["error"] == "ValueError"
            for bad in ("banana", "-1", "nan", "inf"):
                status, _h, _doc, _raw = post_generate(
                    fd, PROMPTS[0], headers={"X-Deadline-S": bad})
                assert status == 400, bad
                status, _h, _doc, _raw = post_generate(
                    fd, PROMPTS[0], headers={"X-TTFT-Budget-S": bad})
                assert status == 400, bad
            # a request the engine can never fit: the engine's ValueError
            status, _h, doc, _raw = post_generate(
                fd, np.zeros(MAX_LEN, np.int32), max_new_tokens=4)
            assert status == 400 and "max_len" in doc["message"]
            status, _h, doc, _raw = post_generate(fd, PROMPTS[0],
                                                  raw_body=b"{}")
            assert status == 400
            conn = http.client.HTTPConnection(fd.host, fd.port, timeout=10)
            conn.request("POST", "/v1/other", body=b"{}")
            assert conn.getresponse().status == 404
            conn.close()
        finally:
            fd.close()

    def test_queue_full_maps_429_with_retry_after(self, pair, metrics):
        # a paused engine (no step loop) with a 1-deep queue: the second
        # request is refused with the structured QueueFull
        eng = _engine(pair, serving, "", max_queue=1)
        fd = serving.FrontDoor(eng)
        try:
            first = threading.Thread(
                target=post_generate, args=(fd, PROMPTS[0]),
                kwargs={"timeout": 20.0}, daemon=True)
            first.start()
            deadline = time.monotonic() + 5.0
            while eng.queue_depth < 1 and time.monotonic() < deadline:
                time.sleep(0.002)
            status, hdrs, doc, _raw = post_generate(fd, PROMPTS[1])
            assert status == 429
            assert doc["error"] == "QueueFull"
            assert doc["retry_after_s"] > 0
            assert int(hdrs["Retry-After"]) >= 1
        finally:
            eng.run()
            first.join(timeout=10)
            eng.stop(drain=True, timeout=5)
            fd.close()

    def test_draining_maps_503(self, pair, metrics):
        eng = _engine(pair, serving, "")
        eng.stop(drain=True, timeout=1)
        assert eng.draining
        fd = serving.FrontDoor(eng)
        try:
            status, hdrs, doc, _raw = post_generate(fd, PROMPTS[0])
            assert status == 503 and doc["error"] == "EngineStopped"
            assert doc["retry_after_s"] == 1.0      # a cold EWMA
            assert hdrs["Retry-After"] == "1"
        finally:
            fd.close()

    def test_deadline_header_expiry_maps_504(self, pair, metrics):
        # one busy slot; the probe's X-Deadline-S expires in the queue ->
        # the admission-boundary sweep sheds it -> 504, no Retry-After
        eng = _engine(pair, serving, "", max_batch=1).warmup()
        fd = serving.FrontDoor(eng)
        eng.start()
        try:
            blocker = eng.submit(serving.GenerationRequest(
                PROMPTS[0], max_new_tokens=60,
                stream=lambda rid, tok: time.sleep(0.01)))
            status, _h, doc, _raw = post_generate(
                fd, PROMPTS[1], max_new_tokens=4,
                headers={"X-Deadline-S": "0.05"}, timeout=30.0)
            assert status == 504
            assert doc["error"] == "DeadlineExceeded"
            assert "retry_after_s" not in doc
            blocker.result(timeout=30)
        finally:
            eng.stop(drain=True, timeout=10)
            fd.close()

    def test_healthz_and_metrics_through_the_front_door(self, pair,
                                                        metrics):
        router, _engines = _router(pair, serving, k=2)
        fd = serving.FrontDoor(router)
        router.start()
        try:
            _wait_beacons(ttrace, ["serving.engine.a", "serving.engine.b",
                                   "serving.router"])
            code, doc = get_json(fd, "/healthz")
            assert code == 200 and doc["status"] == "ok"
            for name in ("serving.engine.a", "serving.engine.b",
                         "serving.router"):
                comp = doc["components"][name]
                assert comp["ok"] and not comp["stale"]
                assert "age_s" in comp and "ttl_s" in comp
            assert doc["router"] == {"in_rotation": ["a", "b"],
                                     "replicas": ["a", "b"]}
            post_generate(fd, PROMPTS[0], max_new_tokens=3)
            conn = http.client.HTTPConnection(fd.host, fd.port, timeout=10)
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            text = resp.read().decode()
            conn.close()
            assert resp.status == 200
            assert 'serving_http_requests_total{status="200"} 1' in text
            assert "serving_router_picks_total" in text
            code, doc = get_json(fd, "/nowhere")
            assert code == 404
        finally:
            router.stop(drain=True, timeout=10)
            fd.close()


# ---------------------------------------------------------------------------
# the router over port engines (tests/test_serving_http.py's cases)
# ---------------------------------------------------------------------------

class TestRouter:
    def test_pick2_spreads_by_queue_depth(self, pair, metrics, reference):
        # paused engines: depth is the tie-breaker, so sequential submits
        # alternate replicas instead of piling onto one
        router, engines = _router(pair, serving, k=2)
        futs = [router.submit(serving.GenerationRequest(
            PROMPTS[i], max_new_tokens=3)) for i in range(4)]
        assert engines["a"].queue_depth == 2
        assert engines["b"].queue_depth == 2
        assert router.queue_depth == 4
        assert router.estimated_wait() == 0.0       # cold EWMAs
        for eng in engines.values():
            eng.run()
        for i, f in enumerate(futs):
            assert f.result(timeout=10).tokens == _ref(reference, i, 3)
        snap = metrics[1].snapshot()
        assert snap["serving.router.picks_total"] == {"replica=a": 2.0,
                                                      "replica=b": 2.0}
        router.stop(drain=True, timeout=5)

    def test_hedging_defaults_off(self, monkeypatch):
        assert serving.RouterConfig().hedge_s is None
        assert serving.RouterConfig(hedge_s=0).hedge_s is None
        monkeypatch.setenv("PADDLE_TPU_ROUTER_HEDGE_S", "0.5")
        monkeypatch.setenv("PADDLE_TPU_ROUTER_PREFIX_AFFINITY", "0.25")
        cfg = serving.RouterConfig()
        assert (cfg.hedge_s, cfg.prefix_affinity_bias) == (0.5, 0.25)
        monkeypatch.setenv("PADDLE_TPU_ROUTER_PREFIX_AFFINITY", "2")
        with pytest.raises(ValueError, match="PREFIX_AFFINITY"):
            serving.RouterConfig()
        with pytest.raises(ValueError, match="poll_s"):
            serving.RouterConfig(poll_s=0)

    def test_drain_replica_leaves_rotation_before_drain(self, pair, metrics,
                                                        reference):
        router, engines = _router(pair, serving, k=2)
        # park work on both (paused engines), then drain 'a': its queued,
        # never-admitted work fails over to 'b'
        futs = [router.submit(serving.GenerationRequest(
            PROMPTS[i], max_new_tokens=3)) for i in range(4)]
        assert engines["a"].queue_depth == 2
        router.drain_replica("a", timeout=0.0, on_timeout="fail")
        assert router.in_rotation() == ["b"]
        out_at = router.trace.index(("out", "a"))
        fails = [i for i, t in enumerate(router.trace)
                 if t[0] == "failover"]
        assert fails and all(i > out_at for i in fails)
        futs.append(router.submit(serving.GenerationRequest(
            PROMPTS[4], max_new_tokens=3)))
        assert engines["a"].queue_depth == 0
        engines["b"].run()
        for i, f in enumerate(futs):
            assert f.result(timeout=10).tokens == _ref(reference, i, 3)
        snap = metrics[1].snapshot()
        assert snap.get("serving.router.failovers_total", 0) == 2
        for eng in engines.values():
            assert eng.kv.outstanding_pages == 0
        # restore puts 'a' back: the next request may land there again
        router.restore_replica("a")
        assert router.in_rotation() == ["a", "b"]
        assert router.trace[-1] == ("in", "a")
        router.stop(drain=True, timeout=5)

    def test_no_failover_after_token_emitted(self, pair, metrics,
                                             reference):
        # at most once: an admitted request (it streamed tokens) on a
        # drained replica resolves with the typed DrainTimeout, never
        # re-sent though a healthy replica is free
        router, engines = _router(pair, serving, k=2, max_batch=1)
        for eng in engines.values():
            eng.warmup()
        got = []
        first_token = threading.Event()

        def stream(rid, tok):
            got.append(tok)
            first_token.set()
            time.sleep(0.01)    # the drain lands while the stream is live

        router.start()
        try:
            fut = router.submit(serving.GenerationRequest(
                PROMPTS[0], max_new_tokens=40, stream=stream))
            assert first_token.wait(timeout=20)
            victim = router.trace[0][2]
            router.drain_replica(victim, timeout=0.0, on_timeout="fail")
            with pytest.raises(serving.DrainTimeout):
                fut.result(timeout=10)
            assert not any(t[0] == "failover" for t in router.trace)
            assert metrics[1].snapshot().get(
                "serving.router.failovers_total", 0) == 0
            assert got == _ref(reference, 0, 40)[:len(got)]
            assert 0 < len(got) < 40
            assert engines[victim].kv.outstanding_pages == 0
        finally:
            router.stop(drain=True, timeout=10)

    def test_hedge_reroutes_queued_request_by_withdraw(self, pair, metrics,
                                                       reference):
        # 'a' is busy with a long request; the probe sits queued (never
        # admitted) past hedge_s -> withdrawn, re-routed to 'b' once, no
        # token duplicated
        router, engines = _router(pair, serving, k=2, max_batch=1,
                                  hedge_s=0.05, poll_s=0.01)
        for eng in engines.values():
            eng.warmup()
        got = []
        withdrawn = []
        real = engines["a"].scheduler.withdraw

        def withdraw(rid):
            p = real(rid)
            withdrawn.append((rid, p is not None))
            return p

        engines["a"].scheduler.withdraw = withdraw
        router.start()
        try:
            long_fut = router.submit(serving.GenerationRequest(
                PROMPTS[0], max_new_tokens=40,
                stream=lambda rid, tok: time.sleep(0.01)))
            deadline = time.monotonic() + 10.0
            while engines["a"].active_requests < 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.002)
            assert engines["a"].active_requests == 1
            probe = serving.GenerationRequest(
                PROMPTS[1], max_new_tokens=4,
                stream=lambda rid, tok: got.append(tok))
            fut = router.submit(probe)
            res = fut.result(timeout=20)
            assert res.tokens == _ref(reference, 1, 4)
            assert got == res.tokens
            long_fut.result(timeout=20)
        finally:
            router.stop(drain=True, timeout=10)
        assert metrics[1].snapshot().get("serving.router.hedges_total",
                                         0) == 1
        hedges = [t for t in router.trace if t[0] == "hedge"]
        assert hedges == [("hedge", probe.request_id, "a")]
        # the reroute happened only through a successful withdraw
        assert (probe.request_id, True) in withdrawn
        picks = [t for t in router.trace
                 if t[0] == "pick" and t[1] == probe.request_id]
        assert [p[2] for p in picks] == ["a", "b"]

    def test_hedge_never_reroutes_an_admitted_request(self, pair, metrics,
                                                      reference):
        # every request admitted at once (free slots): the hedge finds
        # nothing queued to withdraw, so nothing is re-routed
        router, engines = _router(pair, serving, k=2, hedge_s=0.02,
                                  poll_s=0.01)
        router.start()
        try:
            futs = [router.submit(serving.GenerationRequest(
                PROMPTS[i], max_new_tokens=20,
                stream=lambda rid, tok: time.sleep(0.005)))
                for i in range(2)]
            for i, f in enumerate(futs):
                assert f.result(timeout=30).tokens == _ref(reference, i, 20)
        finally:
            router.stop(drain=True, timeout=10)
        assert not any(t[0] == "hedge" for t in router.trace)

    def test_breaker_opens_on_forward_faults(self, pair, metrics, reference):
        router, engines = _router(pair, serving, k=2, router_kw={
            "breaker_threshold": 1, "breaker_cooldown": 60.0})
        sched = faults.FaultSchedule()
        sched.error("router.forward", on=[1])
        with faults.installed(sched):
            f1 = router.submit(serving.GenerationRequest(
                PROMPTS[0], max_new_tokens=3))
            f2 = router.submit(serving.GenerationRequest(
                PROMPTS[1], max_new_tokens=3))
        rep_a = next(r for r in router.replicas if r.name == "a")
        assert rep_a.breaker.state == "open"
        assert any(t[0] == "forward_fault" and t[2] == "a"
                   for t in router.trace)
        assert any(t[0] == "breaker_open" and t[2] == "a"
                   for t in router.trace)
        assert engines["a"].queue_depth == 0
        assert engines["b"].queue_depth == 2
        engines["b"].run()
        assert f1.result(timeout=10).tokens == _ref(reference, 0, 3)
        assert f2.result(timeout=10).tokens == _ref(reference, 1, 3)
        snap = metrics[1].snapshot()
        assert snap.get("serving.router.retries_total", 0) >= 1
        assert snap["resilience.breaker_state"][
            "endpoint=serving.replica.a"] == 2
        router.stop(drain=True, timeout=5)

    def test_router_stopped_rejects_typed(self, pair, metrics):
        router, _engines = _router(pair, serving, k=2)
        router.stop(drain=True, timeout=1)
        with pytest.raises(serving.EngineStopped):
            router.submit(serving.GenerationRequest(
                PROMPTS[0], max_new_tokens=2))

    def test_no_replica_in_rotation_is_typed(self, pair, metrics):
        router, _engines = _router(pair, serving, k=2)
        router.latch_out("a")
        router.latch_out("b")
        with pytest.raises(serving.NoHealthyReplica):
            router.submit(serving.GenerationRequest(
                PROMPTS[0], max_new_tokens=2))
        assert router.trace[-1][0] == "reject" and \
            router.trace[-1][2] == "no_replica"
        assert metrics[1].snapshot()["serving.router.rejected_total"] == {
            "reason=no_replica": 1.0}
        with pytest.raises(KeyError):
            router.latch_out("zz")
        router.stop(drain=True, timeout=5)

    def test_start_after_stop_restores_rotation(self, pair, metrics,
                                                reference):
        router, _engines = _router(pair, serving, k=2)
        router.stop(drain=True, timeout=1)
        assert router.in_rotation() == []
        router.start()
        try:
            assert router.in_rotation() == ["a", "b"]
            fut = router.submit(serving.GenerationRequest(
                PROMPTS[0], max_new_tokens=3))
            assert fut.result(timeout=20).tokens == _ref(reference, 0, 3)
        finally:
            router.stop(drain=True, timeout=10)

    def test_expired_budget_is_504_not_failover(self, pair, metrics):
        router, engines = _router(pair, serving, k=2)
        fut = router.submit(serving.GenerationRequest(
            PROMPTS[0], max_new_tokens=3, ttft_budget_s=0.02))
        picked = router.trace[0][2]
        time.sleep(0.05)
        router.drain_replica(picked, timeout=0.0, on_timeout="fail")
        with pytest.raises(DeadlineExceeded) as ei:
            fut.result(timeout=10)
        assert thttp.status_for(ei.value) == 504
        assert thttp.retry_after_s(ei.value) is None
        assert not any(t[0] == "failover" for t in router.trace)
        other = next(n for n in ("a", "b") if n != picked)
        assert engines[other].queue_depth == 0
        router.stop(drain=True, timeout=5)

    def test_malformed_request_returns_half_open_probe(self, pair, metrics,
                                                       reference):
        router, _engines = _router(pair, serving, k=1, router_kw={
            "breaker_threshold": 1, "breaker_cooldown": 0.0})
        br = router._replicas["a"].breaker
        br.before_call()
        br.record_failure()
        assert br.state == "open"
        with pytest.raises(ValueError, match="max_len"):
            router.submit(serving.GenerationRequest(
                np.zeros(MAX_LEN, np.int32), max_new_tokens=1))
        assert br.state == "closed"
        fut = router.submit(serving.GenerationRequest(
            PROMPTS[0], max_new_tokens=3))
        router.start()
        try:
            assert fut.result(timeout=20).tokens == _ref(reference, 0, 3)
        finally:
            router.stop(drain=True, timeout=10)

    def test_duplicate_beacons_rejected(self, pair):
        with pytest.raises(ValueError, match="beacon"):
            serving.Router([("a", _engine(pair, serving, "")),
                            ("b", _engine(pair, serving, ""))])
        with pytest.raises(ValueError, match="duplicate"):
            serving.Router([("a", _engine(pair, serving, "x")),
                            ("a", _engine(pair, serving, "y"))])
        with pytest.raises(ValueError):
            serving.Router([])

    def test_stale_beacon_leaves_rotation(self, pair, metrics):
        router, engines = _router(pair, serving, k=2)
        ttrace.heartbeat("serving.engine.a", ttl_s=0.01)
        ttrace.heartbeat("serving.engine.b", ttl_s=60.0)
        time.sleep(0.03)
        try:
            assert router.in_rotation() == ["b"]
            router.submit(serving.GenerationRequest(PROMPTS[0],
                                                    max_new_tokens=2))
            assert engines["b"].queue_depth == 1
            assert engines["a"].queue_depth == 0
        finally:
            ttrace.heartbeat_clear("serving.engine.a")
            ttrace.heartbeat_clear("serving.engine.b")
            router.stop(drain=True, timeout=5)


# ---------------------------------------------------------------------------
# shutdown under load
# ---------------------------------------------------------------------------

class TestShutdownUnderLoad:
    def _stream_worker(self, fd, prompt, n_new, out, first_token_evt):
        conn = http.client.HTTPConnection(fd.host, fd.port, timeout=60)
        try:
            conn.request("POST", "/v1/generate", body=json.dumps({
                "prompt": np.asarray(prompt).tolist(),
                "max_new_tokens": n_new, "stream": True}).encode())
            resp = conn.getresponse()
            first = resp.readline()       # the stream is live
            first_token_evt.set()
            raw = first + resp.read()
            out.append((resp.status, read_sse(raw)))
        finally:
            conn.close()

    @pytest.mark.parametrize("graceful", [True, False])
    def test_drain_ends_every_stream_typed(self, pair, graceful, metrics,
                                           reference):
        router, engines = _router(pair, serving, k=2, max_batch=4)
        for eng in engines.values():
            eng.warmup()
        fd = serving.FrontDoor(router)
        router.start()
        outs = [[] for _ in range(4)]
        evts = [threading.Event() for _ in range(4)]
        threads = [threading.Thread(
            target=self._stream_worker,
            args=(fd, PROMPTS[i], 40, outs[i], evts[i]), daemon=True)
            for i in range(4)]
        sched = faults.FaultSchedule()
        sched.delay("serving.step", seconds=0.005)
        try:
            with faults.installed(sched):
                for t in threads:
                    t.start()
                for e in evts:
                    assert e.wait(timeout=30)
                router.stop(drain=True,
                            timeout=(30.0 if graceful else 0.0),
                            on_timeout="fail")
                for t in threads:
                    t.join(timeout=30)
                    assert not t.is_alive(), "stream never terminated"
        finally:
            fd.close()
        statuses = []
        for i, out in enumerate(outs):
            assert out, "client thread died without a response"
            status, (tokens, terminals) = out[0]
            assert status == 200
            assert len(terminals) == 1, "a stream must end exactly once"
            kind, doc = terminals[0]
            if kind == "done":
                assert tokens == doc["tokens"] == _ref(reference, i, 40)
                statuses.append(200)
            else:
                assert doc["status"] in (503, 504)
                assert doc["error"] in ("DrainTimeout", "EngineStopped")
                assert tokens == _ref(reference, i, 40)[:len(tokens)]
                statuses.append(doc["status"])
        if graceful:
            assert statuses == [200, 200, 200, 200]
        else:
            assert 503 in statuses
        for eng in engines.values():
            assert eng.kv.outstanding_pages == 0
            assert eng.active_requests == 0 and eng.queue_depth == 0

    def test_wedged_admission_during_zero_budget_drain_resolves_typed(
            self, pair, metrics):
        # the loop thread is wedged mid-admission (popped, prefill not
        # landed: a delay fault longer than the join grace) when a
        # zero-budget drain sweeps stragglers; the late admission resolves
        # the Future typed instead of stranding it
        eng = _engine(pair, serving, "", max_batch=1).warmup()
        sched = faults.FaultSchedule()
        sched.delay("serving.admit", on=[1], seconds=1.6)
        with faults.installed(sched):
            eng.start()
            fut = eng.submit(serving.GenerationRequest(
                PROMPTS[0], max_new_tokens=4))
            deadline = time.monotonic() + 5.0
            while eng.queue_depth > 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            eng.stop(drain=True, timeout=0.0, on_timeout="fail")
        with pytest.raises(serving.DrainTimeout):
            fut.result(timeout=10)
        deadline = time.monotonic() + 5.0
        while eng.kv.outstanding_pages and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.kv.outstanding_pages == 0
        assert eng.active_requests == 0 and eng.queue_depth == 0

    def test_slow_client_never_stalls_the_other_streams(self, pair, metrics,
                                                        reference):
        # the SSE writer reads tokens from a queue: a client that stops
        # reading holds up its own handler thread only, while the loop
        # thread decodes on and the other request finishes
        router, engines = _router(pair, serving, k=1, max_batch=4)
        fd = serving.FrontDoor(router)
        router.start()
        slow = socket_post(fd, PROMPTS[0], 40)
        try:
            t0 = time.monotonic()
            status, _h, doc, _raw = post_generate(fd, PROMPTS[1],
                                                  max_new_tokens=30)
            assert status == 200 and doc["tokens"] == _ref(reference, 1, 30)
            assert time.monotonic() - t0 < 20
        finally:
            slow.close()
            router.stop(drain=True, timeout=10)
            fd.close()
        for eng in engines.values():
            assert eng.kv.outstanding_pages == 0


def socket_post(fd, prompt, n_new):
    """A streaming request whose client never reads its response."""
    import socket
    body = json.dumps({"prompt": np.asarray(prompt).tolist(),
                       "max_new_tokens": n_new, "stream": True}).encode()
    sock = socket.create_connection((fd.host, fd.port), timeout=10)
    sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Length: " + str(len(body)).encode()
                 + b"\r\n\r\n" + body)
    return sock


# ---------------------------------------------------------------------------
# two engines' loop threads and the launch counters
# ---------------------------------------------------------------------------

def test_launch_counts_lose_no_increment_under_threads():
    counter = LaunchCounter("stress")
    n_threads, n_adds = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counter.add(1) for _ in range(n_adds)],
            daemon=True) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counter.count == n_threads * n_adds


def test_a_capture_records_launches_while_replays_go_on_counting():
    # one engine's loop thread captures a graph while the other's replays
    # count theirs: the capture's record holds the wrappers' launches,
    # made on any thread (a captured backward runs on autograd's), and the
    # replays stay counted
    counter = LaunchCounter("capture_vs_replay")
    recording = threading.Event()
    replayed = threading.Event()

    def replays():
        assert recording.wait(timeout=30)
        for _ in range(100):
            counter.add(3)
        replayed.set()

    def backward():
        counter.launched()

    other = threading.Thread(target=replays, daemon=True)
    other.start()
    with recorded_launches() as rec:
        counter.launched()
        recording.set()
        assert replayed.wait(timeout=30)
        autograd = threading.Thread(target=backward, daemon=True)
        autograd.start()
        autograd.join(timeout=30)
        counter.launched()
    other.join(timeout=30)
    assert not other.is_alive() and not autograd.is_alive()
    assert rec == {counter: 3}
    assert counter.count == 300
    counter.launched(2)
    assert counter.count == 302
