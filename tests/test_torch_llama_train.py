"""The port's Llama training path (plain kernel versions on the CPU) against
``paddle_tpu.models.llama`` from one state dict carried across.

The JAX side's attention is opened to its flash path
(``_sdpa_flash_backend_ok``), so its forward and backward run the Pallas
forward-with-lse, dq and dk/dv kernels under the interpreter at seq 128.

* fp32: the loss and every parameter gradient (atol 1e-5), then 3 AdamW
  steps on each side (losses rtol 1e-5; parameters atol 1e-5 against a
  step of lr = 1e-3 per element, see ``test_three_adamw_steps_match``);
* ``recompute`` on and off give identical losses and gradients;
* a ``scan_layers=True`` JAX model loads through
  ``convert.scan_to_layered_state_dict`` and gives the same logits;
* AMP O2 bf16: the port mirrors the JAX package's O2 casts (``rms_norm``
  and ``cross_entropy`` in fp32, RoPE with bf16 cos/sin); what remains
  differs only in where bf16 rounds inside ops (the rotation, matmul and
  attention accumulations), bounded here: loss rtol 2e-4 (4.1e-5 seen;
  7.4e-5 with fp32 cos/sin), each gradient within 5% of its largest
  element (3.2% seen, a few bf16 ulps) (ROADMAP Queue C).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.ops import nn_ops as jnn_ops
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import (layered_to_scan_state_dict,
                                      scan_to_layered_state_dict,
                                      state_dict_from_paddle_tpu)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=48,
            max_pos=256)
SEQ = 128


@pytest.fixture(autouse=True)
def _jax_flash_path(monkeypatch):
    monkeypatch.setattr(jnn_ops, "_sdpa_flash_backend_ok", lambda: True)


def _ids(seed=0, batch=2):
    return np.random.default_rng(seed).integers(0, TINY["vocab"],
                                                (batch, SEQ))


def _pair(seed=7, **cfg):
    paddle.seed(seed)
    jcfg = JConfig.tiny(**TINY)
    tcfg = LlamaConfig.tiny(**TINY)
    for k, v in cfg.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    jm = JLlama(jcfg)
    np_state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(np_state), strict=True)
    return jm, tm


def _jax_step(jm, ids):
    loss, _ = jm(paddle.to_tensor(ids.astype(np.int32)),
                 labels=paddle.to_tensor(ids.astype(np.int32)))
    loss.backward()
    return loss


def _torch_step(tm, ids):
    x = torch.from_numpy(ids)
    loss, _ = tm(x, labels=x)
    loss.backward()
    return loss


def test_loss_and_gradients_match():
    jm, tm = _pair()
    ids = _ids()
    lj = _jax_step(jm, ids)
    lt = _torch_step(tm, ids)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=0, atol=1e-5)
    jgrads = {k: np.asarray(p.grad._data) for k, p in jm.named_parameters()}
    tgrads = dict(tm.named_parameters())
    assert set(jgrads) == set(tgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(tgrads[k].grad.numpy(), g, rtol=0,
                                   atol=1e-5, err_msg=k)


def test_three_adamw_steps_match():
    # Adam moves an element by about lr whatever its gradient's size, so
    # parameters agree to the gradients' agreement (1e-6 relative) times
    # lr: atol 1e-5 holds with room wherever no gradient sits at 0 +- 1e-9
    jm, tm = _pair()
    jo = paddle.optimizer.AdamW(learning_rate=1e-3,
                                parameters=jm.parameters())
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    lj, lt = [], []
    for s in range(3):
        ids = _ids(seed=s)
        lj.append(float(_jax_step(jm, ids)))
        jo.step()
        jo.clear_grad()
        lt.append(_torch_step(tm, ids).item())
        to.step()
        to.clear_grad()
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert lt[-1] < lt[0]
    jstate = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jstate[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_recompute_gives_identical_losses_and_grads():
    ids = torch.from_numpy(_ids(seed=3))
    out = []
    for recompute in (False, True):
        cfg = LlamaConfig.tiny(**TINY)
        cfg.recompute = recompute
        m = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(1))
        loss, _ = m(ids, labels=ids)
        loss.backward()
        out.append((loss.item(), [p.grad.clone() for p in m.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_recompute_carries_the_autocast_state():
    # the layer is recomputed in the backward, outside auto_cast: it must
    # rebuild the forward's fp32 norm outputs, or checkpoint's metadata
    # check fails
    cfg = LlamaConfig.tiny(**TINY)
    cfg.recompute = True
    m = LlamaForCausalLM(cfg, device="cpu")
    amp.decorate(m, level="O2", dtype="bfloat16")
    ids = torch.from_numpy(_ids(seed=4))
    with amp.auto_cast(level="O2"):
        loss, _ = m(ids, labels=ids)
    loss.backward()
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.grad is not None and p.grad.dtype == torch.bfloat16
               for p in m.parameters())


def test_scan_layers_checkpoint_loads_through_convert():
    paddle.seed(11)
    jcfg = JConfig.tiny(**TINY)
    jcfg.scan_layers = True
    jm = JLlama(jcfg)
    jm.eval()
    scan_state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert any(".scan_" in k for k in scan_state)
    layered = scan_to_layered_state_dict(scan_state)
    tcfg = LlamaConfig.tiny(**TINY)
    tcfg.scan_layers = True
    tm = LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(layered), strict=True)
    ids = _ids(seed=5)
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    back = layered_to_scan_state_dict(layered, TINY["layers"])
    assert set(back) == set(scan_state)
    for k, v in scan_state.items():
        np.testing.assert_array_equal(back[k], v)


def test_amp_o2_bf16_step_tracks_jax():
    jm, tm = _pair()
    paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    amp.decorate(tm, level="O2", dtype="bfloat16")
    ids = _ids(seed=6)
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        lj, _ = jm(paddle.to_tensor(ids.astype(np.int32)),
                   labels=paddle.to_tensor(ids.astype(np.int32)))
    lj.backward()
    x = torch.from_numpy(ids)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        lt, _ = tm(x, labels=x)
    lt.backward()
    assert lt.dtype == torch.float32
    # the loss is fp32 log-softmax of bf16 logits on both sides
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-4)
    jgrads = {k: np.asarray(p.grad._data, np.float32)
              for k, p in jm.named_parameters()}
    for k, p in tm.named_parameters():
        assert p.grad.dtype == torch.bfloat16, k
        g, want = p.grad.float().numpy(), jgrads[k]
        rel = np.abs(g - want).max() / np.abs(want).max()
        assert rel < 5e-2, (k, rel)
