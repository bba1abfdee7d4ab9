"""The port's failure handling (``paddle_tpu_torch.resilience``) against
``paddle_tpu.resilience``: the same seeded fault schedule driven by the
same calls fires the same faults, deadlines nest to the tighter one, retry
policies sleep the same schedule under the same overrides, and the step
watchdog classifies hung then zombie and counts its trips."""

import random
import threading
import time

import pytest

from paddle_tpu import resilience as jres
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import policy as jpolicy
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.resilience import policy as tpolicy
from paddle_tpu_torch.serving import StepWatchdog as ServingWatchdog

SITES = ("serving.admit", "serving.step", "serving.watchdog",
         "serving.drain")


@pytest.fixture
def port_metrics(monkeypatch):
    """A fresh, enabled default registry of the port for one test."""
    monkeypatch.setattr(tobs, "_REGISTRY", tobs.Registry())
    monkeypatch.setattr(tobs, "_ENABLED", True)
    yield tobs


def _schedule(mod, seed):
    s = mod.FaultSchedule(seed)
    s.error("serving.admit", prob=0.3)
    s.error("serving.step", prob=0.2, times=4)
    s.delay("serving.watchdog", on=(3, 7), seconds=0.0)
    s.error("serving.watchdog", prob=0.1, error=TimeoutError,
            message="device fault")
    s.kill("serving.drain", on=(2,))
    s.error("serving.drain", prob=0.5)
    return s


def _drive(mod, faults_mod, seed, calls):
    sched = _schedule(mod, seed)
    outcomes = []
    with faults_mod.installed(sched):
        for site in calls:
            try:
                faults_mod.fault_point(site)
                outcomes.append(None)
            except BaseException as exc:       # KillPoint included
                outcomes.append((type(exc).__name__, str(exc)))
    assert faults_mod._SCHEDULE is None
    return list(sched.trace), outcomes, {s: sched.calls(s) for s in SITES}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_schedule_same_trace_and_exceptions(seed):
    rng = random.Random(100 + seed)
    calls = [rng.choice(SITES) for _ in range(300)]
    want = _drive(jres, jfaults, seed, calls)
    got = _drive(tres, tfaults, seed, calls)
    assert got == want
    assert len(got[0]) > 10
    # and the same seed twice in the port
    assert _drive(tres, tfaults, seed, calls) == got


def test_kinds_and_scripted_indices():
    sched = tfaults.FaultSchedule()
    sched.error("a", on=(2,))
    sched.kill("b", on=(1,))
    sched.error("c", error=ValueError("given instance"))
    with tfaults.installed(sched):
        tfaults.fault_point("a")
        with pytest.raises(tfaults.FaultInjected, match=r"a \(call 2\)"):
            tfaults.fault_point("a")
        with pytest.raises(tfaults.KillPoint):
            try:
                tfaults.fault_point("b")
            except Exception:                      # must not catch a kill
                pytest.fail("KillPoint caught as an Exception")
        with pytest.raises(ValueError, match="given instance"):
            tfaults.fault_point("c")
        tfaults.fault_point("unscheduled")
    assert sched.trace == [("a", 2, "error"), ("b", 1, "kill"),
                           ("c", 1, "error")]
    assert sched.sites() == frozenset("abc")
    with pytest.raises(ValueError, match="unknown fault kind"):
        sched.inject("a", "explode")


def test_fault_events_reach_metrics_and_the_flight_ring(port_metrics):
    from paddle_tpu_torch.observability import trace as ttrace
    ttrace.flight_recorder().clear()
    sched = tfaults.FaultSchedule(0).error("serving.step", on=(1,))
    with tfaults.installed(sched), pytest.raises(tfaults.FaultInjected):
        tfaults.fault_point("serving.step")
    snap = port_metrics.snapshot()
    assert snap["resilience.injected_faults_total"] == {
        "kind=error,site=serving.step": 1.0}
    last = ttrace.flight_recorder().snapshot()[-1]
    assert last["name"] == "fault" and last["attrs"] == {
        "site": "serving.step", "injected": "error", "call": 1}


@pytest.mark.parametrize("mod", [jpolicy, tpolicy], ids=["jax", "port"])
def test_deadline_scopes_nest_to_the_tighter(mod):
    assert mod.current_deadline() is None
    with mod.deadline_scope(10.0) as outer:
        assert outer == mod.current_deadline()
        with mod.deadline_scope(100.0) as inner:
            assert inner == outer                  # cannot extend
        with mod.deadline_scope(until=outer - 5.0) as tight:
            assert tight == outer - 5.0
            with mod.deadline_scope(None) as same:
                assert same == tight
        assert mod.current_deadline() == outer
    assert mod.current_deadline() is None
    with pytest.raises(ValueError):
        mod.deadline_scope(1.0, until=2.0)


def _policy_sleeps(mod, monkeypatch, env, **kw):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mod.reset_policies()
    sleeps = []
    rng = random.Random(7)
    pol = mod.get_policy("kv.fetch", **kw)
    pol._sleep = sleeps.append
    pol._rng = rng
    attempts = 0
    with pytest.raises(ConnectionError):
        for att in pol.start():
            attempts += 1
            if attempts > 50:
                break
            att.fail(ConnectionError(f"attempt {att.attempt}"))
    mod.reset_policies()
    return attempts, sleeps, repr(pol)


@pytest.mark.parametrize("case", ["defaults", "env", "no_jitter"])
def test_retry_policy_matches_the_jax_package(case, monkeypatch):
    env, kw = {}, dict(max_attempts=6)
    if case == "env":
        env = {"PADDLE_TPU_RETRY_KV_FETCH_MAX_DELAY": "0.5",
               "PADDLE_TPU_RETRY_KV_FETCH_MAX_ATTEMPTS": "4",
               "PADDLE_TPU_RETRY_KV_FETCH_BASE_DELAY": "0.1"}
    if case == "no_jitter":
        kw.update(jitter=0.0, multiplier=3.0, max_delay=1.0)
    want = _policy_sleeps(jpolicy, monkeypatch, env, **kw)
    got = _policy_sleeps(tpolicy, monkeypatch, env, **kw)
    assert got == want
    attempts, sleeps, _ = got
    cap = 0.5 if case == "env" else (1.0 if case == "no_jitter" else 2.0)
    jitter = 0.0 if case == "no_jitter" else 0.25
    assert attempts == (4 if case == "env" else 6)
    assert len(sleeps) == attempts - 1
    assert all(s <= cap * (1 + jitter) for s in sleeps)
    if case == "no_jitter":
        assert sleeps == [0.2, 0.2 * 3.0, 1.0, 1.0, 1.0]


def test_retry_budget_follows_the_ambient_deadline(monkeypatch):
    tpolicy.reset_policies()
    pol = tpolicy.RetryPolicy("t", base_delay=5.0, jitter=0.0,
                              sleep=lambda s: None)
    with tpolicy.deadline_scope(0.05):
        att = pol.start(deadline=60.0)
        assert att.remaining() <= 0.05
        time.sleep(0.06)
        next(att)
        with pytest.raises(KeyError):
            att.fail(KeyError("late"))
    with pytest.raises(ValueError):
        tpolicy.RetryPolicy("bad", jitter=1.0)


def test_jitter_sleep_and_env_knobs(monkeypatch):
    for mod in (jpolicy, tpolicy):
        slept = []
        d = mod.jitter_sleep(0.4, rng=random.Random(3), sleep=slept.append)
        assert slept == [d] and 0.3 <= d <= 0.5
    assert tpolicy.jitter_sleep(0.4, rng=random.Random(3),
                                sleep=lambda s: None) == \
        jpolicy.jitter_sleep(0.4, rng=random.Random(3), sleep=lambda s: None)
    monkeypatch.setenv("X_F", "2.5")
    monkeypatch.setenv("X_I", "oops")
    assert tpolicy.env_float("X_F") == 2.5
    assert tpolicy.env_float("X_MISSING") is None
    assert tpolicy.env_int("X_I", 4) == 4
    assert issubclass(tres.DeadlineExceeded, TimeoutError)


def test_step_watchdog_hung_then_zombie(port_metrics, tmp_path,
                                        monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(tmp_path))
    assert ServingWatchdog is tres.StepWatchdog
    wd = tres.StepWatchdog(0.05)
    try:
        gen = wd.arm()
        assert wd.disarm(gen) is None              # back in time
        gen = wd.arm()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and port_metrics.snapshot().get(
                "serving.watchdog_trips_total", {}).get("kind=zombie") \
                is None:
            time.sleep(0.01)
        verdict = wd.disarm(gen)
        assert verdict == "zombie"
        trips = port_metrics.snapshot()["serving.watchdog_trips_total"]
        assert trips == {"kind=hung": 1.0, "kind=zombie": 1.0}
        # a stale window's late disarm changes nothing
        assert wd.disarm(gen) is None
        assert (tmp_path / f"flight-{__import__('os').getpid()}-"
                           f"watchdog_hung.json").exists()
    finally:
        wd.stop()
    assert not any(t.name == "paddle-tpu-watchdog" and t.is_alive()
                   for t in threading.enumerate())
    with pytest.raises(ValueError):
        tres.StepWatchdog(0)
