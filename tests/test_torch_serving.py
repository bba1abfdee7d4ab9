"""The port's serving engine against ``paddle_tpu.serving.Engine`` with the
paged-attention kernel tier on (``paged_attention="on"``: the Pallas decode
kernel under the interpreter), on the same tiny Llama and the same prompts,
on the float and int8 kv legs. Greedy transcripts must be identical and
every page must be back after the drain.

One prompt is 128 tokens long and the JAX SDPA routing seam is opened for
the reference engine, so its prefill reaches the Pallas flash kernel
(interpret mode) as it would on an accelerator. Also the port engine's own
request lifecycle: eos, cancel, drained stop, queue limits.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.ops import flash_attention as jflash
from paddle_tpu.ops import nn_ops as jnn_ops
from paddle_tpu_torch import serving
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(2)

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=48,
            max_pos=256)
MAX_LEN, PS, NEW = 160, 16, 6
PROMPT_LENS = (128, 9, 23)


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


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 64, (n,), dtype=np.int32) for n in PROMPT_LENS]


def _cfg(mod, kv_dtype, **kw):
    return mod.ServingConfig(num_layers=2, num_heads=2, head_dim=8,
                             max_len=MAX_LEN, max_batch=2, buckets=(1, 2),
                             page_size=PS, kv_dtype=kv_dtype, **kw)


def _drain(eng, mod, prompts):
    futs = [eng.submit(mod.GenerationRequest(p, max_new_tokens=NEW))
            for p in prompts]
    eng.run()
    return [f.result(timeout=60).tokens for f in futs]


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_engine_transcripts_match_paddle_tpu(pair, kv_dtype, monkeypatch):
    jm, tm = pair
    prompts = _prompts()
    monkeypatch.setattr(jnn_ops, "_sdpa_flash_backend_ok", lambda: True)
    flash_calls = []
    real = jflash._pallas_flash

    def counted(*a, **k):
        flash_calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(jflash, "_pallas_flash", counted)
    jeng = jserving.Engine(*jm.serving_callables(MAX_LEN),
                           _cfg(jserving, kv_dtype, paged_attention="on"))
    want = _drain(jeng, jserving, prompts)
    assert any(s[2] == 128 for s in flash_calls), flash_calls
    teng = serving.Engine(*tm.serving_callables(MAX_LEN),
                          _cfg(serving, kv_dtype, device="cpu"))
    got = _drain(teng, serving, prompts)
    assert got == want
    assert all(len(t) == NEW for t in got)
    for eng in (jeng, teng):
        assert eng.kv.free_pages == eng.kv.config.num_pages - 1
        assert eng.kv.outstanding_pages == 0


@pytest.fixture(scope="module")
def port_callables():
    m = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    return m.serving_callables(MAX_LEN)


def test_eos_cancel_and_free(port_callables):
    eng = serving.Engine(*port_callables,
                         _cfg(serving, "native", device="cpu"))
    p = _prompts()[1]
    first = _drain(eng, serving, [p])[0]
    # eos on the third token evicts early
    f_eos = eng.submit(serving.GenerationRequest(
        p, max_new_tokens=NEW, eos_token_id=first[2]))
    # a queued request cancelled before any step resolves "cancelled"
    queued = serving.GenerationRequest(p, max_new_tokens=NEW)
    f_cancel = eng.submit(queued)
    eng.cancel(queued.request_id)
    eng.run()
    r = f_eos.result(timeout=10)
    assert r.finish_reason == "eos" and r.tokens == first[:3]
    assert f_cancel.result(timeout=10).finish_reason == "cancelled"
    assert eng.kv.free_pages == eng.kv.config.num_pages - 1


def test_cancel_active_slot_frees_pages(port_callables):
    eng = serving.Engine(*port_callables,
                         _cfg(serving, "native", device="cpu"))
    req = serving.GenerationRequest(_prompts()[2], max_new_tokens=NEW)
    fut = eng.submit(req)
    eng.step()                       # admitted and one token decoded
    assert eng.active_requests == 1
    eng.cancel(req.request_id)
    eng.step()
    assert fut.result(timeout=10).finish_reason == "cancelled"
    assert eng.kv.outstanding_pages == 0


def test_threaded_drain_resolves_every_future(port_callables):
    eng = serving.Engine(*port_callables,
                         _cfg(serving, "int8", device="cpu"))
    seen = threading.Event()
    prompts = _prompts()[1:]
    futs = [eng.submit(serving.GenerationRequest(
        p, max_new_tokens=NEW, stream=lambda rid, tok: seen.set()))
        for p in prompts]
    eng.start()
    assert seen.wait(30)
    eng.stop(drain=True, timeout=30)
    for f in futs:
        assert len(f.result(timeout=10).tokens) == NEW
    with pytest.raises(serving.EngineStopped):
        eng.submit(serving.GenerationRequest(prompts[0]))
    assert eng.kv.outstanding_pages == 0


def test_queued_request_past_its_budget_is_shed(port_callables):
    eng = serving.Engine(*port_callables,
                         _cfg(serving, "native", device="cpu"))
    fut = eng.submit(serving.GenerationRequest(_prompts()[1],
                                               ttft_budget_s=1e-4))
    time.sleep(0.01)
    eng.step()
    with pytest.raises(serving.DeadlineExceeded):
        fut.result(timeout=10)
    assert eng.kv.outstanding_pages == 0


def test_submit_limits(port_callables):
    eng = serving.Engine(*port_callables, _cfg(
        serving, "native", device="cpu", max_queue=1))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(serving.GenerationRequest(np.zeros(MAX_LEN, np.int32)))
    eng.submit(serving.GenerationRequest(_prompts()[1]))
    with pytest.raises(serving.QueueFull):
        eng.submit(serving.GenerationRequest(_prompts()[1]))
    eng.run()
    assert eng.kv.outstanding_pages == 0
