"""The port's fleet tier on the CPU: the RPC framing against
``paddle_tpu.distributed.rpc``'s, and worker processes of the port
(``python -m paddle_tpu_torch.serving.fleet_worker``, ``device="cpu"`` in
the spec) behind the router, against the JAX engine.

* framing: the same payload and secret give byte-equal frames in both
  packages, each reads the other's frames, and both refuse a tampered MAC;
* typed rejections cross the wire with their type and detail, so the
  router's arms and the front door's statuses carry over;
* two workers over the tiny Llama with weights carried from the JAX model
  (saved to a file: a worker imports no JAX) give the JAX engine's tokens;
* the cases of ``tests/test_fleet.py`` on the port: a transport fault
  before admission fails over; stale heartbeats latch both replicas out
  and good ones bring them back; a SIGKILL after a streamed token is a
  typed ``RpcTransportError`` while the dead worker's queued request fails
  over and completes, no token is delivered twice, and the worker is
  respawned once and serves again; SIGTERM drains and exits 0, and with
  no respawns left the death is a typed ``FleetWorkerLost``; a spawn
  failure is typed.

Every wait on a worker has its own timeout; one 2-worker fleet carries the
rotation cases.
"""

import os
import pickle
import signal
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.distributed import rpc as jrpc
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import serving
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.resilience import DeadlineExceeded, faults
from paddle_tpu_torch.serving import fleet_worker
from paddle_tpu_torch.serving import http as thttp
from paddle_tpu_torch.serving.fleet import (FleetSupervisor, FleetWorkerLost,
                                            FleetWorkerSpec, RemoteEngine)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(ROOT, "tests", "workers")
sys.path.insert(0, WORKERS)

from torch_fleet_factory import MAX_LEN, PS, TINY  # noqa: E402

N_NEW = 6
SECRET = bytes(range(32))


def _prompts():
    rng = np.random.default_rng(13)
    return [rng.integers(0, 64, (n,), dtype=np.int32)
            for n in (8, 8, 21, 5, 11)]


PROMPTS = _prompts()


# ---------------------------------------------------------------------------
# the framing
# ---------------------------------------------------------------------------

def _frame(send, payload, secret):
    """The bytes ``send`` puts on the wire for ``payload``."""
    a, b = socket.socketpair()

    def write():
        try:
            send(a, payload, secret)
        finally:
            a.shutdown(socket.SHUT_WR)

    writer = threading.Thread(target=write, daemon=True)
    try:
        writer.start()
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            chunks.append(chunk)
        writer.join(timeout=10)
        return b"".join(chunks)
    finally:
        a.close()
        b.close()


def _read(recv, frame, secret):
    """What ``recv`` makes of ``frame`` followed by the peer's close."""
    a, b = socket.socketpair()

    def write():
        try:
            a.sendall(frame)
            a.shutdown(socket.SHUT_WR)
        except OSError:
            pass  # the reader refused the frame early and closed

    try:
        writer = threading.Thread(target=write, daemon=True)
        writer.start()
        got = recv(b, secret)
        writer.join(timeout=10)
        return got
    finally:
        a.close()
        b.close()


PAYLOADS = {
    "empty": b"",
    "pickle": pickle.dumps(("submit", {"prompt": [1, 2, 3],
                                       "max_new_tokens": 4})),
    "two_mib": bytes(range(256)) * 8192,
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_frames_are_byte_equal_and_cross_read(name):
    payload = PAYLOADS[name]
    mine = _frame(rpc.send_msg, payload, SECRET)
    theirs = _frame(jrpc.send_msg, payload, SECRET)
    assert mine == theirs
    assert len(mine) == 8 + 32 + len(payload)
    assert _read(rpc.recv_msg, theirs, SECRET) == payload
    assert _read(jrpc.recv_msg, mine, SECRET) == payload


@pytest.mark.parametrize("where", ["mac", "payload", "secret"])
def test_a_tampered_frame_is_refused_by_both(where):
    frame = bytearray(_frame(rpc.send_msg, PAYLOADS["pickle"], SECRET))
    secret = SECRET
    if where == "mac":
        frame[8] ^= 1
    elif where == "payload":
        frame[-1] ^= 1
    else:
        secret = bytes(32)
    for recv in (rpc.recv_msg, jrpc.recv_msg):
        with pytest.raises(ConnectionError, match="authentication"):
            _read(recv, bytes(frame), secret)


def test_a_short_or_cut_frame_is_a_connection_error():
    full = _frame(rpc.send_msg, b"abcdef", SECRET)
    for cut in (4, 8 + 10):
        with pytest.raises(ConnectionError):
            _read(rpc.recv_msg, full[:cut], SECRET)
    short = (8).to_bytes(8, "little") + b"x" * 8
    with pytest.raises(ConnectionError, match="too short"):
        _read(rpc.recv_msg, short, SECRET)
    a, b = socket.socketpair()
    with a, b, pytest.raises(RuntimeError, match="secret"):
        rpc.send_msg(a, b"x", None)


# ---------------------------------------------------------------------------
# typed rejections across the wire (no worker process: the worker's server
# over a stand-in engine in this process)
# ---------------------------------------------------------------------------

class _Refusing:
    """An engine whose submit raises ``exc``: what the worker's handler
    ships back as ("raise", exc)."""

    def __init__(self, exc):
        self.exc = exc

    def submit(self, request):
        raise self.exc


def _shed():
    exc = DeadlineExceeded("shed on arrival")
    exc.estimated_wait_s, exc.depth, exc.capacity = 0.9, 3, 16
    return exc


REFUSALS = {
    "queue_full": lambda: serving.QueueFull(
        "full", depth=16, capacity=16, estimated_wait_s=3.2),
    "shed": _shed,
    "value": lambda: ValueError("prompt exceeds max_len"),
    "engine_stopped": lambda: serving.EngineStopped("draining"),
    "deadline": lambda: DeadlineExceeded("expired"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_typed_rejections_cross_the_wire(case):
    exc = REFUSALS[case]()
    server = fleet_worker._FleetServer(
        ("127.0.0.1", 0), fleet_worker._Handler,
        fleet_worker._Worker("w", _Refusing(exc), SECRET, {}))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = RemoteEngine("w", "127.0.0.1", server.server_address[1],
                              SECRET, rpc_timeout_s=10.0)
        with pytest.raises(type(exc)) as ei:
            client.submit(serving.GenerationRequest(PROMPTS[0],
                                                    max_new_tokens=2))
        got = ei.value
        assert type(got) is type(exc) and str(got) == str(exc)
        for key in ("depth", "capacity", "estimated_wait_s"):
            assert getattr(got, key, None) == getattr(exc, key, None)
        assert thttp.status_for(got) == thttp.status_for(exc)
        assert thttp.retry_after_s(got) == thttp.retry_after_s(exc)
        # an unknown method comes back typed too
        with pytest.raises(ValueError, match="unknown method"):
            client._unary("nope", {}, timeout=10.0)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_a_dead_address_is_a_transport_error_before_admission():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    port = lsock.getsockname()[1]
    lsock.close()
    client = RemoteEngine("w", "127.0.0.1", port, SECRET, rpc_timeout_s=1.0)
    # the refused dial itself (a ConnectionError, as the JAX client's)
    with pytest.raises(ConnectionError):
        client.submit(serving.GenerationRequest(PROMPTS[0],
                                                max_new_tokens=2))
    assert client.cancel(1) is False
    assert client.scheduler.withdraw(1) is None
    assert client.stale()                   # never beat
    client.stop(drain=True, timeout=0.1)    # a dead worker: a done stop


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The JAX tiny Llama, and its weights converted and saved for the
    workers."""
    paddle.seed(11)
    jm = JLlama(JConfig.tiny(**TINY))
    jm.eval()
    np_state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    path = tmp_path_factory.mktemp("fleet") / "tiny_llama.pt"
    torch.save(state_dict_from_paddle_tpu(np_state), path)
    yield jm, str(path)
    import gc
    del jm
    gc.collect()


@pytest.fixture(scope="module")
def jax_tokens(carried):
    """The JAX engine's transcript of each prompt decoded alone (paged
    tier, the Pallas decode kernel under the interpreter), 40 new tokens."""
    jm, _ = carried
    out = []
    for p in PROMPTS:
        eng = jserving.Engine(*jm.serving_callables(MAX_LEN),
                              jserving.ServingConfig(
                                  num_layers=2, num_heads=2, head_dim=8,
                                  max_len=MAX_LEN, max_batch=1, buckets=(1,),
                                  page_size=PS, paged_attention="on"))
        fut = eng.submit(jserving.GenerationRequest(p, max_new_tokens=40))
        eng.run()
        out.append(list(fut.result(timeout=0).tokens))
    return out


def _specs(names, weights, **config):
    return [FleetWorkerSpec(
        name=n, factory="torch_fleet_factory:make_engine",
        config={"name": n, "weights": weights, "device": "cpu", **config},
        pythonpath=[WORKERS, ROOT], env={"PYTHONPATH": ROOT})
        for n in names]


def _submit(sup, prompt, n_new=N_NEW, stream=None):
    toks = []

    def record(rid, tok):
        toks.append(int(tok))
        if stream is not None:
            stream(rid, tok)

    req = serving.GenerationRequest(prompt=prompt, max_new_tokens=n_new,
                                    stream=record)
    return sup.submit(req), toks, req


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def fleet2(carried):
    # one slot a worker (a second request queues behind the first) and a
    # decode step slowed to 10 ms, so a kill lands mid-stream
    sup = FleetSupervisor(_specs(["r0", "r1"], carried[1], max_batch=1,
                                 step_sleep_s=0.01),
                          poll_s=0.05, stale_after_s=2.0, max_respawns=3,
                          spawn_timeout_s=120)
    sup.start()
    yield sup
    faults.uninstall()
    sup.stop(drain=True, timeout=60)


@pytest.fixture
def metrics(monkeypatch):
    monkeypatch.setattr(tobs, "_REGISTRY", tobs.Registry())
    monkeypatch.setattr(tobs, "_ENABLED", True)
    yield tobs


class TestFleetRotation:
    """Ordered over the shared 2-worker fleet: the SIGKILL case runs last
    (the respawned worker rejoins before the module's teardown drains)."""

    def test_workers_give_the_jax_engine_tokens(self, fleet2, jax_tokens):
        for i, p in enumerate(PROMPTS):
            fut, toks, _ = _submit(fleet2, p)
            res = fut.result(timeout=120)
            assert list(res.tokens) == jax_tokens[i][:N_NEW]
            assert toks == list(res.tokens)     # streamed once each
            assert res.finish_reason == "length"
        picked = {e[2] for e in fleet2.router.trace if e[0] == "pick"}
        assert picked and picked <= {"r0", "r1"}
        # the heartbeat-cached stats catch up with the drained worker
        _wait(lambda: fleet2.worker_stats("r0")["outstanding_pages"] == 0
              and fleet2.worker_stats("r1")["outstanding_pages"] == 0,
              30.0, "every page back on both workers")
        stats = fleet2.worker_stats("r0")
        assert stats["name"] == "r0" and stats["queue_depth"] == 0
        assert not stats["beacon_stale"] and not stats["draining"]
        assert set(stats["boot"]) == {"started_at", "factory_s",
                                      "warmup_s", "port_at"}
        pids = fleet2.worker_pids()
        assert set(pids) == {"r0", "r1"} and os.getpid() not in \
            pids.values()

    def test_transport_fault_before_admission_fails_over(self, fleet2,
                                                         jax_tokens):
        sched = faults.FaultSchedule(seed=0).error("fleet.rpc", on=[1])
        faults.install(sched)
        try:
            fut, toks, _ = _submit(fleet2, PROMPTS[0])
            res = fut.result(timeout=120)
        finally:
            faults.uninstall()
        assert list(res.tokens) == jax_tokens[0][:N_NEW] == toks
        assert sched.trace == [("fleet.rpc", 1, "error")]
        kinds = [e[0] for e in fleet2.router.trace if e[1] == res.request_id]
        assert "forward_fault" in kinds
        assert "pick" in kinds[kinds.index("forward_fault"):]

    def test_heartbeat_stale_latches_out_and_rejoins(self, fleet2,
                                                     jax_tokens):
        faults.install(faults.FaultSchedule(seed=0).error("fleet.heartbeat"))
        try:
            _wait(lambda: not fleet2.router.in_rotation(), 30.0,
                  "both replicas to leave the rotation")
            with pytest.raises(serving.NoHealthyReplica):
                _submit(fleet2, PROMPTS[0])
        finally:
            faults.uninstall()
        _wait(lambda: fleet2.router.in_rotation() == ["r0", "r1"], 30.0,
              "both replicas to rejoin")
        fut, _, _ = _submit(fleet2, PROMPTS[1])
        assert list(fut.result(timeout=120).tokens) == \
            jax_tokens[1][:N_NEW]

    def test_sigkill_mid_stream_then_respawn_rejoins(self, fleet2, metrics,
                                                     jax_tokens):
        """A real SIGKILL of the worker that streamed a token for request
        A while request B waits in its queue: A ends with the typed
        ``RpcTransportError`` (503 + Retry-After at the front door, never
        re-sent), B, never admitted, fails over to the other worker and
        completes; no token is delivered twice; the supervisor respawns
        the worker once and it serves again."""
        first = threading.Event()
        fut_a, toks_a, req_a = _submit(
            fleet2, PROMPTS[0], n_new=60,
            stream=lambda rid, tok: first.set())
        assert first.wait(timeout=60)
        victim = [e for e in fleet2.router.trace
                  if e[0] == "pick" and e[1] == req_a.request_id][-1][2]
        # B placed on the victim (the other latched out for the placement:
        # the router places on heartbeat-cached queue depths, which may
        # lag), then the other back in the rotation to take the failover
        other = next(n for n in ("r0", "r1") if n != victim)
        fleet2.router.latch_out(other)
        try:
            fut_b, toks_b, req_b = _submit(fleet2, PROMPTS[2], n_new=N_NEW)
        finally:
            fleet2.router.restore_replica(other)
        picks_b = [e[2] for e in fleet2.router.trace
                   if e[0] == "pick" and e[1] == req_b.request_id]
        assert picks_b == [victim], "B must queue behind A on one worker"
        old_pid = fleet2.worker_pids()[victim]
        os.kill(old_pid, signal.SIGKILL)
        with pytest.raises(rpc.RpcTransportError) as ei:
            fut_a.result(timeout=60)
        assert "mid-stream" in str(ei.value)
        assert thttp.status_for(ei.value) == 503
        assert thttp.retry_after_s(ei.value) == 1.0
        res_b = fut_b.result(timeout=120)
        assert list(res_b.tokens) == jax_tokens[2][:N_NEW] == toks_b
        assert 0 < len(toks_a) < 60
        assert toks_a == jax_tokens[0][:len(toks_a)]   # each token once
        trace_b = [e for e in fleet2.router.trace if e[1] == req_b.request_id]
        assert ("failover", req_b.request_id, victim) in trace_b
        assert [e[2] for e in trace_b if e[0] == "pick"][-1] != victim
        assert not any(e[0] == "failover" and e[1] == req_a.request_id
                       for e in fleet2.router.trace)
        # the respawn: a new process, back in the rotation, serving
        _wait(lambda: fleet2.worker_pids()[victim] != old_pid
              and fleet2.router.in_rotation() == ["r0", "r1"], 120.0,
              "the respawned worker to rejoin")
        snap = metrics.snapshot()
        assert snap["fleet.respawns_total"] == 1
        assert snap["fleet.worker_deaths_total"] == {
            "reason=signal:SIGKILL": 1.0}
        assert not fleet2.lost
        fleet2.router.latch_out(other)
        try:
            fut, toks, req = _submit(fleet2, PROMPTS[3])
        finally:
            fleet2.router.restore_replica(other)
        assert list(fut.result(timeout=120).tokens) == \
            jax_tokens[3][:N_NEW] == toks
        assert [e[2] for e in fleet2.router.trace
                if e[0] == "pick" and e[1] == req.request_id] == [victim]


class TestFleetLifecycle:
    def test_sigterm_drains_then_typed_giveup(self, carried, metrics,
                                              jax_tokens, tmp_path):
        sup = FleetSupervisor(_specs(["s0"], carried[1], step_sleep_s=0.01),
                              workdir=str(tmp_path), poll_s=0.05,
                              stale_after_s=2.0, max_respawns=0,
                              spawn_timeout_s=120)
        sup.start()
        try:
            first = threading.Event()
            fut, toks, _ = _submit(sup, PROMPTS[0], n_new=20,
                                   stream=lambda r, t: first.set())
            assert first.wait(timeout=60)
            proc = sup._workers["s0"].proc
            proc.send_signal(signal.SIGTERM)
            res = fut.result(timeout=120)
            assert list(res.tokens) == jax_tokens[0][:20] == toks
            assert proc.wait(timeout=60) == 0
            _wait(lambda: "s0" in sup.lost, 30.0, "the typed giveup")
            assert isinstance(sup.lost["s0"], FleetWorkerLost)
            assert "s0" not in sup.router.in_rotation()
            with pytest.raises((serving.NoHealthyReplica,
                                serving.EngineStopped)):
                _submit(sup, PROMPTS[1])[0].result(timeout=30)
            snap = metrics.snapshot()
            assert snap["fleet.worker_deaths_total"]["reason=exit:0"] >= 1
            assert snap["fleet.respawn_giveups_total"] >= 1
            _wait(lambda: metrics.snapshot()["fleet.replicas"].get(
                "state=lost") == 1, 30.0, "the lost gauge")
        finally:
            sup.stop(drain=False, timeout=10)

    def test_spawn_failure_is_typed(self, tmp_path):
        spec = FleetWorkerSpec(name="bad", factory="no_such_module:nope",
                               pythonpath=[WORKERS],
                               env={"PYTHONPATH": ROOT})
        sup = FleetSupervisor([spec], workdir=str(tmp_path),
                              spawn_timeout_s=120, poll_s=0.05)
        with pytest.raises(FleetWorkerLost, match="exited with status"):
            sup.start()
        assert sup.router is None

    def test_spec_and_supervisor_validate(self):
        with pytest.raises(ValueError, match="module:callable"):
            FleetWorkerSpec(name="x", factory="nocolon")
        with pytest.raises(ValueError, match="non-empty"):
            FleetWorkerSpec(name="", factory="a:b")
        with pytest.raises(ValueError, match="duplicate"):
            FleetSupervisor([FleetWorkerSpec("x", "a:b"),
                             FleetWorkerSpec("x", "a:b")])
        with pytest.raises(ValueError, match="at least one"):
            FleetSupervisor([])
        with pytest.raises(serving.EngineStopped):
            FleetSupervisor([FleetWorkerSpec("x", "a:b")]).submit(
                serving.GenerationRequest(PROMPTS[0]))
