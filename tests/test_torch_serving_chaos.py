"""Serving under failure in the port: the same seeded fault schedules
through the port's engine and ``paddle_tpu.serving.Engine`` (paged tier,
the Pallas decode kernel under the interpreter) on the same tiny Llama
with carried weights, native and int8 pools, give the same per-request
outcomes, the same fault trace and the same terminal counters; and the
liveness invariants of ``tests/test_serving_chaos.py`` hold on the port
with watchdog delays included (every Future resolves typed, no page
leaks, accounting exact, survivors decode the no-fault tokens, replays
bounded).

The port updates its pool in place, so its recovery argument differs from
the JAX engine's and is tested here: a retried step leaves the pool
bit-equal to one step (native, bf16, int8; a repeated token write is a
no-op), a replay under prefix sharing re-acquires the prefix and leaves
the shared pages unchanged, a drain that requeues resumes to the
undisturbed transcripts after ``start()``, and a loop thread wedged past
the drain budget is abandoned: ``stop()`` returns, every Future resolves,
and no late token reaches a settled one. Plus: a replayed request that met
its TTFT budget is not shed, and ``train.capture_*`` counters move with
``capture_info()``. Watchdog budgets are 0.2 s, as the JAX chaos suite's.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import jit, observability as tobs, serving
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.core import step_capture as sc
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.resilience import DeadlineExceeded, faults
from paddle_tpu_torch.serving import kv_cache as tkv

torch.set_num_threads(2)

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=48,
            max_pos=128)
MAX_LEN, PS = 96, 16
N_NEW = [4, 3, 5, 4, 3]
TERMINAL = ("completed", "failed", "shed", "cancelled")
EXPECTED = (faults.FaultInjected, serving.WatchdogTimeout, DeadlineExceeded,
            serving.DrainTimeout, serving.EngineStopped)
COUNTERS = ("serving.requests_total", "serving.tokens_total",
            "serving.step_retries_total", "serving.admit_retries_total",
            "serving.replays_total", "serving.rejected_total")


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 64, (n,), dtype=np.int32)
            for n in (8, 8, 21, 5, 11)]


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


def _cfg(mod, kv_dtype, **kw):
    base = dict(num_layers=2, num_heads=2, head_dim=8, max_len=MAX_LEN,
                max_batch=4, buckets=(1, 2, 4), page_size=PS,
                kv_dtype=kv_dtype, watchdog_s=0, max_queue=16)
    base.update(kw)
    return mod.ServingConfig(**base)


def _port(tm, kv_dtype="native", **kw):
    return serving.Engine(*tm.serving_callables(MAX_LEN),
                          _cfg(serving, kv_dtype, device="cpu", **kw))


@pytest.fixture
def metrics(monkeypatch):
    """A fresh, enabled default registry in each package for one test."""
    for mod in (jobs, tobs):
        monkeypatch.setattr(mod, "_REGISTRY", mod.Registry())
        monkeypatch.setattr(mod, "_ENABLED", True)
    yield jobs, tobs


@pytest.fixture
def tracing(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(tmp_path))
    ttrace.set_mode("on")
    ttrace.clear()
    ttrace.flight_recorder().clear()
    yield ttrace
    ttrace.set_mode("off")
    ttrace.clear()
    ttrace.flight_recorder().clear()


@pytest.fixture(scope="module")
def reference(pair):
    """The port engine's no-fault transcripts, per kv leg."""
    _, tm = pair
    out = {}
    for leg in ("native", "int8"):
        eng = _port(tm, leg)
        futs = [eng.submit(serving.GenerationRequest(p, max_new_tokens=n))
                for p, n in zip(_prompts(), N_NEW)]
        eng.run()
        out[leg] = [f.result(timeout=0).tokens for f in futs]
    return out


def _outcomes(futs):
    out = []
    for f in futs:
        assert f.done(), "stranded future"
        exc = f.exception(timeout=0)
        out.append(("err", type(exc).__name__) if exc is not None
                   else ("ok", tuple(f.result(timeout=0).tokens)))
    return out


def _counters(snap):
    return {k: snap[k] for k in COUNTERS if k in snap}


# ---------------------------------------------------------------------------
# cross-package parity under deterministic schedules
# ---------------------------------------------------------------------------

def _parity_schedule(mod, seed):
    s = mod.FaultSchedule(seed)
    s.error("serving.admit", prob=0.3)
    s.error("serving.step", prob=0.15)
    s.error("serving.watchdog", prob=0.3)
    s.error("serving.drain", prob=0.5)
    return s


def _chaos_run(eng, mod, faults_mod, sched, prompts):
    eng.run()             # a reused engine: clears the last drain's latch
    with faults_mod.installed(sched):
        futs = [eng.submit(mod.GenerationRequest(p, max_new_tokens=n + 4))
                for p, n in zip(prompts, N_NEW)]
        eng.run()
        eng.stop(drain=True, timeout=10)
    return _outcomes(futs)


@pytest.fixture(scope="module")
def parity_engines(pair):
    jm, tm = pair
    engines = {}
    for leg in ("native", "bf16", "int8"):
        engines[leg] = (
            jserving.Engine(*jm.serving_callables(MAX_LEN), _cfg(
                jserving, leg, paged_attention="on", max_replays=1)),
            _port(tm, leg, max_replays=1))
    return engines


@pytest.mark.parametrize("kv_dtype", ["native", "bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chaos_matches_the_jax_engine(parity_engines, metrics, kv_dtype,
                                      seed):
    jeng, teng = parity_engines[kv_dtype]
    jo, to = metrics
    prompts = _prompts()
    js, ts = (_parity_schedule(jfaults, seed),
              _parity_schedule(faults, seed))
    want = _chaos_run(jeng, jserving, jfaults, js, prompts)
    got = _chaos_run(teng, serving, faults, ts, prompts)
    assert got == want
    assert ts.trace == js.trace and len(ts.trace) >= 2
    assert _counters(to.snapshot()) == _counters(jo.snapshot())
    for eng in (jeng, teng):
        assert eng.kv.outstanding_pages == 0
        assert eng.active_requests == 0 and eng.queue_depth == 0


# ---------------------------------------------------------------------------
# the invariants sweep, watchdog delays included
# ---------------------------------------------------------------------------

def _chaos_schedule(seed):
    sched = faults.FaultSchedule(seed)
    sched.error("serving.admit", prob=0.15)
    sched.error("serving.step", prob=0.06)
    sched.delay("serving.watchdog", prob=0.04, times=1, seconds=0.8)
    sched.error("serving.watchdog", prob=0.05)
    sched.error("serving.drain", prob=0.5)
    return sched


def _sweep(tm, seed, kv_dtype="native"):
    eng = _port(tm, kv_dtype, watchdog_s=0.2, max_replays=2).warmup()
    futs = []
    with faults.installed(_chaos_schedule(seed)) as sched:
        for i, (p, n) in enumerate(zip(_prompts(), N_NEW)):
            kw = {"deadline_s": 30.0} if i % 2 else {}
            futs.append(eng.submit(serving.GenerationRequest(
                p, max_new_tokens=n, **kw)))
        eng.run()
        eng.stop(drain=True, timeout=10)
    eng.stop(drain=True, timeout=1)          # idempotent under fire
    return eng, futs, sched


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chaos_sweep_invariants(pair, reference, metrics, seed):
    _, to = metrics
    eng, futs, _ = _sweep(pair[1], seed)
    completed = 0
    for f, want in zip(futs, reference["native"]):
        assert f.done(), "stranded future after drain"
        try:
            res = f.result(timeout=0)
        except EXPECTED:
            continue
        completed += 1
        assert res.tokens == want
        assert res.finish_reason in ("length", "eos")
    assert eng.kv.outstanding_pages == 0
    assert eng.kv.free_pages == eng.kv.config.num_pages - 1
    assert eng.active_requests == 0 and eng.queue_depth == 0
    snap = to.snapshot()
    statuses = snap.get("serving.requests_total", {})
    assert sum(statuses.get(f"status={s}", 0) for s in TERMINAL) == len(futs)
    assert statuses.get("status=completed", 0) == completed
    assert snap.get("serving.tokens_total", 0) >= completed * min(N_NEW)
    assert snap.get("serving.replays_total", 0) <= 2 * len(futs)


@pytest.mark.parametrize("seed", [0, 2])
def test_chaos_sweep_trace_invariants(pair, metrics, tracing, tmp_path, seed):
    eng, futs, _ = _sweep(pair[1], seed)
    evs = tracing.events()
    assert tracing.span_problems(evs) == []
    for f in futs:
        exc = f.exception(timeout=0)
        if isinstance(exc, (faults.FaultInjected, serving.WatchdogTimeout)):
            rid = [e for e in evs if e["name"] == "serving.fault"
                   and e["attrs"].get("error") == type(exc).__name__]
            assert rid, "a faulted request's trace has no fault event"
    recovered = any(e["name"] == "serving.recover" for e in evs)
    dump = tmp_path / f"flight-{os.getpid()}-serving_recover.json"
    assert recovered == dump.exists()
    if recovered:
        doc = json.load(open(dump))
        sites = [e["attrs"].get("site") for e in doc["events"]
                 if e["name"] == "fault"]
        assert sites and sites[-1].startswith("serving.")
    doc = tracing.export_chrome()
    labels = [e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"]
    assert sum(x.startswith("request-") for x in labels) == len(futs)


def test_watchdog_trip_replays_both_slots(pair, reference, metrics):
    _, to = metrics
    eng = _port(pair[1], watchdog_s=0.2, max_replays=1).warmup()
    sched = faults.FaultSchedule().delay("serving.watchdog", on=(2,),
                                         seconds=0.7)
    with faults.installed(sched):
        futs = [eng.submit(serving.GenerationRequest(p, max_new_tokens=n))
                for p, n in zip(_prompts()[:2], N_NEW[:2])]
        eng.run()
    assert [f.result(timeout=0).tokens for f in futs] == \
        reference["native"][:2]
    snap = to.snapshot()
    assert snap["serving.watchdog_trips_total"]["kind=hung"] >= 1
    assert snap["serving.replays_total"] == 2
    assert eng.kv.outstanding_pages == 0
    eng.stop()


# ---------------------------------------------------------------------------
# the in-place pool's recovery argument
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leg", ["native", "bf16", "int8"])
def test_a_repeated_token_write_changes_nothing(leg):
    gen = torch.Generator().manual_seed(4)
    P, L, H, D, B = 7, 2, 2, 8, 3
    x = torch.randn((P, L, 2, H, PS, D), generator=gen) * 2
    pool, scales = (tkv.quantize_pages(x) if leg == "int8" else
                    (x.to(torch.bfloat16 if leg == "bf16" else x.dtype),
                     None))
    tables = torch.tensor([[1, 2, 0], [3, 4, 0], [5, 6, 0]],
                          dtype=torch.int32)
    for trial in range(20):
        t = torch.randint(0, 2 * PS, (B,), generator=gen).int()
        k = torch.randn((B, H, D), generator=gen) * (1 + trial % 3)
        v = torch.randn((B, H, D), generator=gen)
        for layer in range(L):
            tpa.scatter_token_inplace(pool, scales, tables, t, layer, k, v,
                                      PS)
            once = (pool.clone(), None if scales is None else scales.clone())
            tpa.scatter_token_inplace(pool, scales, tables, t, layer, k, v,
                                      PS)
            assert torch.equal(pool, once[0])
            assert scales is None or torch.equal(scales, once[1])


def _steps(eng, prompts, n_steps, fail_read_at=None, fail_site=None):
    """Admit ``prompts``, then ``n_steps`` steps; with ``fail_read_at`` the
    token read-back of that decode step raises once after the launch."""
    futs = [eng.submit(serving.GenerationRequest(p, max_new_tokens=8))
            for p in prompts]
    calls = {"n": 0}
    real = eng._read

    def flaky(out):
        calls["n"] += 1
        if calls["n"] == fail_read_at:
            raise RuntimeError("read-back failed after the launch")
        return real(out)

    eng._read = flaky
    sched = faults.FaultSchedule()
    if fail_site:
        sched.error("serving.watchdog", on=(fail_site,))
    with faults.installed(sched):
        for _ in range(n_steps):
            eng.step()
    return futs, [list(s.tokens) for s in eng._slots]


@pytest.mark.parametrize("leg", ["native", "bf16", "int8"])
def test_retried_step_leaves_the_pool_bit_equal(pair, metrics, leg):
    _, to = metrics
    prompts = _prompts()[:3]
    one = _port(pair[1], leg)
    _, want_tokens = _steps(one, prompts, 4)
    for kw in (dict(fail_read_at=2), dict(fail_site=3)):
        to.reset()
        again = _port(pair[1], leg)
        _, tokens = _steps(again, prompts, 4, **kw)
        assert tokens == want_tokens
        assert torch.equal(again.kv.pool, one.kv.pool)
        if leg == "int8":
            assert torch.equal(again.kv.scales, one.kv.scales)
        snap = to.snapshot()
        assert snap["serving.step_retries_total"] == 1
        assert "serving.replays_total" not in snap
    # finishing both leaves nothing behind
    for eng in (one, again):
        eng.run()
        assert eng.kv.outstanding_pages == 0


def test_replay_under_prefix_sharing_keeps_shared_pages(pair, metrics):
    _, to = metrics
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 64, (2 * PS,), dtype=np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 64, (n,), np.int32)])
               for n in (5, 9)]
    plain = _port(pair[1], prefix_sharing="on")
    futs = [plain.submit(serving.GenerationRequest(p, max_new_tokens=6))
            for p in prompts]
    plain.run()
    want = [f.result(timeout=0).tokens for f in futs]

    eng = _port(pair[1], prefix_sharing="on", max_replays=1)
    futs = [eng.submit(serving.GenerationRequest(p, max_new_tokens=6))
            for p in prompts]
    eng.step()                                   # both admitted, 1 step
    slot = eng._slots[1]
    assert slot.shared_pages == 2
    shared_ids = slot.page_ids[:2]
    before = eng.kv.pool[shared_ids].clone()
    stats0 = eng.kv.prefix_stats()["prefix_pages_shared_total"]
    # a whole-batch fault twice in one step: both slots replay
    sched = faults.FaultSchedule().error("serving.watchdog", on=(1, 2))
    with faults.installed(sched):
        eng.step()
        assert eng.active_requests == 0 and eng.queue_depth == 2
        assert torch.equal(eng.kv.pool[shared_ids], before)
        eng.run()
    assert [f.result(timeout=0).tokens for f in futs] == want
    assert eng.kv.prefix_stats()["prefix_pages_shared_total"] \
        >= stats0 + 2 * 2
    assert torch.equal(eng.kv.pool[shared_ids], before)
    assert to.snapshot()["serving.replays_total"] == 2
    assert eng.kv.outstanding_pages == 0


def test_drain_requeue_then_start_resumes(pair, reference):
    eng = _port(pair[1])
    first = threading.Event()

    def slow(rid, tok):
        first.set()
        time.sleep(0.02)

    futs = [eng.submit(serving.GenerationRequest(p, max_new_tokens=n,
                                                 stream=slow))
            for p, n in zip(_prompts(), N_NEW)]
    eng.start()
    assert first.wait(30)
    eng.stop(drain=True, timeout=0.0, on_timeout="requeue")
    assert not all(f.done() for f in futs)
    assert eng.active_requests == 0 and eng.queue_depth > 0
    with pytest.raises(serving.EngineStopped):
        eng.submit(serving.GenerationRequest(_prompts()[0]))
    eng.start()
    got = [f.result(timeout=60).tokens for f in futs]
    eng.stop(drain=True, timeout=30)
    assert got == reference["native"]
    assert eng.kv.outstanding_pages == 0


def test_wedged_loop_thread_is_abandoned(pair, reference, metrics,
                                         monkeypatch):
    monkeypatch.setattr(serving.engine, "_JOIN_GRACE_S", 0.3)
    eng = _port(pair[1])
    late = []
    stopped = threading.Event()

    def record(rid, tok):
        if stopped.is_set():
            late.append((rid, tok))

    sched = faults.FaultSchedule().delay("serving.watchdog", on=(2,),
                                         seconds=1.5)
    with faults.installed(sched):
        futs = [eng.submit(serving.GenerationRequest(
            p, max_new_tokens=6, stream=record)) for p in _prompts()[:2]]
        eng.start()
        zombie = eng._thread
        deadline = time.monotonic() + 30
        while sched.calls("serving.watchdog") < 2:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        t0 = time.monotonic()
        eng.stop(drain=True, timeout=0.1)        # returns, does not raise
        stopped.set()
        assert time.monotonic() - t0 < 1.4
        assert zombie.is_alive()
        for f in futs:
            with pytest.raises(serving.DrainTimeout):
                f.result(timeout=0)
        assert eng.kv.outstanding_pages == 0
        # a restarted engine serves while the zombie still sleeps
        eng.start()
        fresh = eng.submit(serving.GenerationRequest(
            _prompts()[0], max_new_tokens=N_NEW[0]))
        assert fresh.result(timeout=30).tokens == reference["native"][0]
        zombie.join(timeout=10)
        assert not zombie.is_alive()
    assert late == []
    eng.stop(drain=True, timeout=10)
    assert eng.kv.outstanding_pages == 0


def test_replayed_request_is_not_shed_for_a_met_ttft_budget(pair, reference,
                                                            metrics):
    _, to = metrics
    eng = _port(pair[1], max_replays=1)
    fut = eng.submit(serving.GenerationRequest(
        _prompts()[0], max_new_tokens=N_NEW[0], ttft_budget_s=0.2))
    eng.step()                              # admitted: first token, 1 step
    time.sleep(0.25)                        # older than its TTFT budget
    with faults.installed(faults.FaultSchedule().error(
            "serving.watchdog", on=(1, 2))):
        eng.step()                          # recovered, requeued
        assert eng.queue_depth == 1
        eng.run()                           # swept, re-admitted, finished
    assert fut.result(timeout=0).tokens == reference["native"][0]
    snap = to.snapshot()
    assert snap["serving.replays_total"] == 1
    assert "serving.rejected_total" not in snap
    assert snap["serving.ttft_seconds"]["count"] == 1


def test_capture_counters_follow_capture_info(monkeypatch, metrics):
    _, to = metrics
    sc.stats_clear()
    x = torch.ones(3)
    monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", "auto")
    cap = jit.capture_step(lambda a: a * 2)
    for _ in range(3):
        cap(x)
    monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", "off")
    jit.capture_step(lambda a: a + 1)(x)
    sc._count("hits")            # the card's kinds, which no CPU call makes
    sc._count("retraces")
    info = sc.capture_info()
    assert info == {"hits": 1, "retraces": 1,
                    "bypasses": {"cpu": 3, "off": 1}}
    snap = to.snapshot()
    assert snap["train.capture_hits_total"] == info["hits"]
    assert snap["train.capture_retraces_total"] == info["retraces"]
    assert snap["train.capture_bypasses_total"] == {
        f"reason={k}": float(v) for k, v in info["bypasses"].items()}
    sc.stats_clear()
