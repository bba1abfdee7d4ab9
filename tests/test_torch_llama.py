"""The port's Llama against ``paddle_tpu.models.llama`` from one state dict
carried across by ``paddle_tpu_torch.convert``: logits (fp32, atol 1e-4)
and greedy ``generate`` tokens (identical)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(2)

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=48,
            max_pos=256)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(7)
    jm = JLlama(JConfig.tiny(**TINY))
    jm.eval()
    np_state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(np_state), strict=True)
    yield jm, tm
    import gc
    del jm
    gc.collect()


@pytest.mark.parametrize("shape", [(2, 24), (1, 128)])
def test_logits_match(pair, shape):
    jm, tm = pair
    ids = np.random.default_rng(shape[1]).integers(0, 64, shape)
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.shape == (*shape, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_generate_tokens_identical(pair):
    jm, tm = pair
    prompt = np.random.default_rng(5).integers(0, 64, (2, 11))
    want = np.asarray(jm.generate(paddle.to_tensor(prompt.astype(np.int32)),
                                  max_new_tokens=6, do_sample=False)._data)
    got = tm.generate(torch.from_numpy(prompt), max_new_tokens=6)
    assert got.tolist() == want.tolist()


def test_state_dict_keys_and_layouts_match(pair):
    jm, tm = pair
    jsd = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    tsd = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert tsd == jsd


def test_convert_copies_bf16():
    import ml_dtypes
    a = np.arange(6, dtype=np.float32).reshape(2, 3).astype(ml_dtypes.bfloat16)
    t = state_dict_from_paddle_tpu({"w": a})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    a[0, 0] = 5                       # a copy, not a view
    assert t[0, 0].item() == 0.0


def test_seeded_init_is_reproducible():
    cfg = LlamaConfig.tiny(**TINY)
    a = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    b = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
