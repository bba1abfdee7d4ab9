"""``paddle_tpu_torch.jit.capture_step`` on the CPU, where a step runs on
the eager tier (bypass ``cpu``: a CPU has no graphs; the graphs
themselves are held on the card by ``chip_smoke.py``'s ``capture_check``):

* the capture key: a shape change, a mutated closure scalar and the LRU of
  8 graphs each make a new key, and an unchanged call keeps its key;
* bypasses are counted by reason (``cpu``, ``off``) in ``stats`` and
  ``capture_info()``; ``HostStateWriteError`` fires where carried state
  (``_lr_t`` through ``_sync_lr_tensor``, ``_step_t``) is written from
  the host inside the capture context;
* the attention-dropout seed counter advances one per attention call, the
  same state draws the same seeds twice, and a NaN-gated step (the
  device-side gate a graph runs, and the eager tier's host gate) leaves
  parameters, masters, moments, ``_step_t`` and the counter bitwise
  unchanged; the gate and a graph touch only the RNGs the step draws from
  (another model's is neither saved nor written);
* ``PADDLE_TPU_STEP_CAPTURE`` takes ``auto`` or ``off`` and nothing else,
  and only CUDA's capture errors demote a step to the eager tier;
* ``iters_per_call`` runs K steps over K-stacked inputs;
* a tiny ERNIE (dropout 0) trained 3 steps through ``capture_step`` with
  the fine-tune recipe (multi-tensor AdamW, ``LinearWarmup`` over
  ``PolynomialDecay``, ``ClipGradByGlobalNorm(1.0)``) against the JAX
  package's ERNIE and AdamW on its eager tier: losses rtol 1e-5; each
  parameter within 2 x the summed LR of the JAX one (an Adam step moves an
  element by at most about lr, and an element whose exact gradient is 0,
  as the k biases', moves by noise of either sign) and most elements far
  closer (median relative difference below 1e-4).
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.ernie import ErnieConfig as JConfig
from paddle_tpu.models.ernie import ErnieForSequenceClassification as JErnie
from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.core import step_capture as sc
from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                           ErnieForSequenceClassification)
from paddle_tpu_torch.nn import Dropout, DropoutRNG
from paddle_tpu_torch.nn.common import recording_draws
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(2)

TINY = dict(vocab=96, hidden=32, layers=2, heads=2, inter=64, max_pos=64)
SEQ = 32


@pytest.fixture(autouse=True)
def _auto(monkeypatch):
    # the suite pins PADDLE_TPU_STEP_CAPTURE=off; these tests need auto
    monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", "auto")
    sc.stats_clear()


def _cfg(mod, attn_dropout=0.0):
    c = mod.tiny(**TINY)
    c.hidden_dropout_prob = 0.0
    c.attention_probs_dropout_prob = attn_dropout
    return c


def _torch_model(attn_dropout=0.0, seed=0):
    return ErnieForSequenceClassification(_cfg(ErnieConfig, attn_dropout),
                                          num_classes=2, device="cpu",
                                          seed=seed)


def _batch(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, TINY["vocab"], (batch, SEQ)),
            rng.integers(0, 2, (batch,)))


def _recipe(model, peak=1e-3, steps=4):
    sched = tlr.LinearWarmup(tlr.PolynomialDecay(peak, steps, end_lr=0.0),
                             warmup_steps=2, start_lr=0.0, end_lr=peak)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                weight_decay=0.01, use_multi_tensor=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    return sched, opt


def _captured(model, opt, **kw):
    def step(ids, labels):
        loss, _ = model(ids, labels=labels)
        loss.backward()
        return loss

    def update():
        opt.step()
        opt.clear_grad()
    return jit.capture_step(step, update_fn=update, clear_fn=opt.clear_grad,
                            **kw)


# -- the key ------------------------------------------------------------------

def test_shape_change_and_mutated_closure_scalar_make_new_keys():
    scale = 2.0

    def step(x):
        return (x * scale).sum()
    cap = jit.CapturedStep(step)
    x = torch.zeros(4, 8)
    k0 = cap._key((x,), {})
    assert cap._key((torch.ones(4, 8),), {}) == k0   # values do not key
    assert cap._key((torch.zeros(4, 9),), {}) != k0
    assert cap._key((torch.zeros(4, 8, dtype=torch.float64),), {}) != k0
    assert cap._key((x,), {"k": 3}) != cap._key((x,), {"k": 4})
    scale = 3.0   # noqa: F841 - the closure cell the key reads
    assert cap._key((x,), {}) != k0
    # an identity-keyed closure value (a tensor) keys by object, not content
    w = torch.zeros(2)

    def step2(x):
        return (x * w).sum()
    cap2 = jit.CapturedStep(step2)
    k2 = cap2._key((x,), {})
    w.add_(1.0)
    assert cap2._key((x,), {}) == k2


def test_at_most_eight_graphs_in_lru_order():
    cap = jit.CapturedStep(lambda x: x.sum())
    for i in range(8):
        cap._store(("k", i), f"graph{i}")
    assert cap._lookup(("k", 0)) == "graph0"   # now the most recent
    cap._store(("k", 8), "graph8")
    assert cap.num_graphs == 8
    assert cap._lookup(("k", 1)) is None       # the least recent went
    assert cap._lookup(("k", 0)) == "graph0"
    assert cap._lookup(("k", 8)) == "graph8"


# -- bypasses and the host-write trap ---------------------------------------

def test_cpu_and_off_bypasses_are_counted(monkeypatch):
    model = _torch_model()
    _, opt = _recipe(model)
    ids, labels = (torch.from_numpy(x) for x in _batch())
    cap = _captured(model, opt, nan_gate=True)
    cap(ids, labels)
    cap(ids, labels)
    assert cap.stats["bypasses"] == {"cpu": 2}
    monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", "off")
    off = _captured(model, opt)
    off(ids, labels)
    assert off.stats["bypasses"] == {"off": 1}
    assert sc.capture_info() == {"hits": 0, "retraces": 0,
                                 "bypasses": {"cpu": 2, "off": 1}}
    assert opt.t == 3 and cap.applies_update


def test_host_state_writes_inside_the_capture_context_raise():
    model = _torch_model()
    sched, opt = _recipe(model)
    with sc.capture_context():
        assert sc.capturing()
        with pytest.raises(jit.HostStateWriteError, match="_lr_t"):
            sched.step()               # -> opt._sync_lr_tensor()
        with pytest.raises(jit.HostStateWriteError):
            opt._sync_lr_tensor()
        with pytest.raises(jit.HostStateWriteError, match="_step_t"):
            opt.t = 5
        with pytest.raises(jit.HostStateWriteError, match="_lr_t"):
            opt._write_lr(0.5)
    assert not sc.capturing()
    sched.step()
    opt.t = 5
    assert opt.t == 5 and float(opt._lr_t) == np.float32(sched())


def test_argument_checks_follow_the_reference():
    with pytest.raises(ValueError, match="update_fn"):
        jit.capture_step(lambda: None, nan_gate=True)
    with pytest.raises(ValueError, match="iters_per_call"):
        jit.capture_step(lambda: None, update_fn=lambda: None, nan_gate=True,
                         iters_per_call=2)


# -- dropout seeds ------------------------------------------------------------

def test_next_seed_is_derived_on_the_device_and_advances_the_counter():
    r = DropoutRNG("cpu", seed=5)
    seeds = [int(r.next_seed()) for _ in range(4)]
    assert seeds == [(5 + i * 0x9E3779B1) % 2 ** 32 for i in range(4)]
    assert int(r.counter) == 4
    again = DropoutRNG("cpu", seed=5)
    assert [int(again.next_seed()) for _ in range(4)] == seeds


def test_counter_advances_per_attention_call_and_replays_the_same_seeds():
    model = _torch_model(attn_dropout=0.1)
    rng = model.ernie.rng
    _, opt = _recipe(model)
    ids, labels = (torch.from_numpy(x) for x in _batch())
    cap = _captured(model, opt, nan_gate=True)
    l1 = cap(ids, labels)
    assert int(rng.counter) == TINY["layers"]
    cap(ids, labels)
    assert int(rng.counter) == 2 * TINY["layers"]
    # the same state draws the same seeds: a fresh model, same seed
    again = _torch_model(attn_dropout=0.1)
    _, opt2 = _recipe(again)
    assert torch.equal(_captured(again, opt2, nan_gate=True)(ids, labels), l1)


def test_recording_draws_names_each_rng_once_with_its_counter_before():
    a, b = DropoutRNG("cpu", seed=1), DropoutRNG("cpu", seed=2)
    a.next_seed()
    drop = Dropout(0.5, rng=b).eval()
    with recording_draws(keep_counters=True) as log:
        a.next_seed()
        a.next_seed()
        drop(torch.ones(4))            # eval: draws nothing
    assert list(log) == [a] and int(log[a]) == 1 and int(a.counter) == 3
    with recording_draws() as log:
        drop.train()(torch.ones(4))
    assert log == {b: None}
    b.next_seed()                      # no region open: nothing recorded
    assert log == {b: None}


def test_gate_touches_only_the_rngs_the_step_draws_from():
    model = _torch_model(attn_dropout=0.1)
    other = _torch_model(attn_dropout=0.1, seed=1)   # alive, unrelated
    _, opt = _recipe(model)
    ids, labels = (torch.from_numpy(x) for x in _batch())
    cap = _captured(model, opt, nan_gate=True)
    version = other.ernie.rng.counter._version
    drawn = set()
    cap._once_gated((ids, labels), {}, drawn)          # the device gate
    assert drawn == {model.ernie.rng}
    cap(ids, labels)                                   # the eager tier
    assert other.ernie.rng.counter._version == version
    assert int(other.ernie.rng.counter) == 0
    assert int(model.ernie.rng.counter) == 2 * TINY["layers"]


def test_capture_mode_takes_auto_or_off_only(monkeypatch):
    for m in ("auto", "off", " OFF "):
        monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", m)
        assert sc.mode() == m.strip().lower()
    for m in ("0", "disabled", "on"):
        monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", m)
        with pytest.raises(ValueError, match="PADDLE_TPU_STEP_CAPTURE"):
            jit.capture_step(lambda: None)


def test_only_cuda_capture_errors_count_as_untraceable():
    sync = RuntimeError("CUDA error: operation not permitted when stream is "
                        "capturing\nSearch for "
                        "`cudaErrorStreamCaptureUnsupported'")
    assert sc._is_capture_failure(sync)
    try:                  # ending the capture a host read broke
        try:
            raise sync
        except RuntimeError:
            raise RuntimeError("CUDA error: operation failed due to a "
                               "previous error during capture")
    except RuntimeError as ended:
        assert sc._is_capture_failure(ended)
    for other in (RuntimeError("flash kernel launch while capturing: "
                               "cudaError_t 700"),
                  ValueError("operation not permitted when stream is "
                             "capturing")):
        assert not sc._is_capture_failure(other)


def _state(model, opt):
    fs = opt._flat
    return ([p.detach().clone() for p in model.parameters()]
            + [fs.master.clone(), fs.m.clone(), fs.v.clone(),
               opt._step_t.clone(), model.ernie.rng.counter.clone()])


@pytest.mark.parametrize("tier", ["device_gate", "eager_tier"])
def test_nan_gated_step_leaves_every_state_tensor_unchanged(tier):
    model = _torch_model(attn_dropout=0.1)
    _, opt = _recipe(model)
    ids, labels = (torch.from_numpy(x) for x in _batch())
    poison = {"on": False}

    def step(ids, labels):
        loss, _ = model(ids, labels=labels)
        loss.backward()
        return loss * float("nan") if poison["on"] else loss

    def update():
        opt.step()
        opt.clear_grad()
    cap = jit.capture_step(step, update_fn=update, clear_fn=opt.clear_grad,
                           nan_gate=True)
    cap(ids, labels)                   # one real step: moments carry state
    before = _state(model, opt)
    poison["on"] = True
    if tier == "device_gate":          # the body a graph captures
        out = cap._once_gated((ids, labels), {}, set())
    else:
        out = cap(ids, labels)
    assert not math.isfinite(float(out.detach()))
    assert all(p.grad is None for p in model.parameters())
    for a, b in zip(_state(model, opt), before):
        assert torch.equal(a, b)
    poison["on"] = False
    cap(ids, labels)
    assert opt.t == 2 and int(model.ernie.rng.counter) == 2 * TINY["layers"]


def test_iters_per_call_runs_k_steps_over_stacked_inputs():
    model = _torch_model()
    sched, opt = _recipe(model)
    batches = [_batch(seed=s) for s in range(3)]
    ids = torch.stack([torch.from_numpy(b[0]) for b in batches])
    labels = torch.stack([torch.from_numpy(b[1]) for b in batches])
    cap = _captured(model, opt, iters_per_call=3)
    losses = cap(ids, labels)
    assert losses.shape == (3,) and opt.t == 3
    # the same three steps one at a time
    model2 = _torch_model()
    _, opt2 = _recipe(model2)
    one = _captured(model2, opt2)
    want = torch.stack([one(ids[i], labels[i]) for i in range(3)])
    assert torch.equal(losses, want)


# -- the fine-tune recipe against the JAX package -----------------------------

def _jax_pair(seed=3):
    paddle.seed(seed)
    jm = JErnie(_cfg(JConfig), num_classes=2)
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = _torch_model()
    tm.load_state_dict(state_dict_from_paddle_tpu(state), strict=True)
    return jm, tm


def test_tiny_ernie_recipe_tracks_jax_over_3_steps():
    jm, tm = _jax_pair()
    peak, steps = 1e-3, 3
    js = jopt.lr.LinearWarmup(jopt.lr.PolynomialDecay(peak, 4, end_lr=0.0),
                              warmup_steps=2, start_lr=0.0, end_lr=peak)
    jo = jopt.AdamW(learning_rate=js, parameters=jm.parameters(),
                    weight_decay=0.01, use_multi_tensor=True,
                    grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    ts, to = _recipe(tm, peak=peak)
    cap = _captured(tm, to, nan_gate=True)
    jl, tl, lrs = [], [], []
    for s in range(steps):
        ids, labels = _batch(seed=s)
        loss, _ = jm(paddle.to_tensor(ids.astype(np.int32)),
                     labels=paddle.to_tensor(labels))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss.numpy()))
        tl.append(float(cap(torch.from_numpy(ids), torch.from_numpy(labels))))
        lrs.append(ts())
        js.step()
        ts.step()
    assert cap.stats["bypasses"] == {"cpu": steps}
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    tol = 2 * sum(lrs)
    jp = dict(jm.named_parameters())
    rel = []
    for name, p in tm.named_parameters():
        want = np.asarray(jp[name]._data)
        got = p.detach().numpy()
        assert np.abs(got - want).max() <= tol, name
        rel.append(np.abs(got - want) / np.maximum(np.abs(want), 1e-3))
    assert float(np.median(np.concatenate([r.ravel() for r in rel]))) < 1e-4
