"""Engine factory the port's fleet worker processes load in the tests
(``torch_fleet_factory:make_engine``): the tiny Llama of
``tests/test_torch_router_http.py`` and ``tests/test_torch_fleet.py`` with
the weights the test carried over from the JAX model and saved to
``weights`` (``torch.save`` of the port's state dict). ``step_sleep_s``
slows each decode step (the tokens stay the same), so a test's signal
lands while a request is still streaming.

The worker process imports the port and this module only, never JAX, so
the weights travel as a file. ``device`` is passed through to the model and
the engine as the port's entry points take it: without it they need a
card.
"""

import time

import torch

from paddle_tpu_torch import serving
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=48,
            max_pos=128)
MAX_LEN, PS = 96, 16


def make_engine(name, weights=None, device=None, max_batch=4, max_queue=16,
                step_sleep_s=0.0, **kw):
    torch.set_num_threads(1)
    model = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device=device)
    if weights is not None:
        model.load_state_dict(torch.load(weights, map_location="cpu"),
                              strict=True)
    model.eval()
    prefill_fn, step_fn = model.serving_callables(MAX_LEN)
    if step_sleep_s:
        def slow_step(tok, cache, t, _step=step_fn):
            time.sleep(step_sleep_s)
            return _step(tok, cache, t)
        step_fn = slow_step
    return serving.Engine(prefill_fn, step_fn,
                          serving.ServingConfig(
                              num_layers=2, num_heads=2, head_dim=8,
                              max_len=MAX_LEN, max_batch=max_batch,
                              buckets=(1, 2, 4), page_size=PS,
                              max_queue=max_queue, name=name, device=device,
                              **kw))
