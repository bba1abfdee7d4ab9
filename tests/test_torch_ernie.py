"""The port's ERNIE (plain kernel versions on the CPU) against
``paddle_tpu.models.ernie`` from one state dict carried across.

The JAX side's attention is opened to its flash path
(``_sdpa_flash_backend_ok``), so a mask-free forward and backward run the
Pallas forward-with-lse, dq and dk/dv kernels under the interpreter at seq
128, as ERNIE's attention does on the JAX package's accelerator. Dropout is
0 wherever the two are compared: JAX draws its hidden dropout from
``jax.random``, which no torch generator reproduces (the attention dropout
mask B0 is held bit for bit in ``test_torch_flash_segs_dropout.py``).

* the converted state dict loads key for key (``strict``);
* fp32: loss (rtol 1e-5), logits and every parameter gradient (atol 1e-4)
  of ``ErnieForSequenceClassification``, mask-free and with the additive
  (B, L) padding mask, which both packages send to the plain masked
  softmax. The two agree to 7.5e-7 (logits) and 3.6e-7 (gradients) on
  most runs, but the same command has given 1.5e-5 on the logits once in
  five, so the limit is 1e-4;
* AMP O2 bf16, one AdamW step (fp32 masters) on each side: the port mirrors
  the JAX O2 casts (``layer_norm`` and ``cross_entropy`` fp32, every other
  op of the model, adds and dropout included, bf16); what remains differs
  in where bf16 rounds inside ops (JAX rounds GELU's erf form after each
  primitive, torch once). At this tiny model that noise is large: each
  side's loss lies 0.3% from its fp32 value and its gradients up to 16%
  (JAX) and 21% (port) of their largest element from fp32 ones. Bounds:
  loss rtol 1.5e-2 (7e-3 seen), each gradient within 15% of its largest
  element (9.7% seen; the k biases, whose exact gradient is 0, below
  1e-3), each parameter after the step within 2 lr plus one bf16 ulp of
  the JAX one (a step moves an element by at most about lr, whatever the
  size of its gradient);
* per module: ``LayerNorm`` (atol 1e-5), ``gelu`` erf and tanh forms (atol
  1e-6), ``TransformerEncoderLayer`` forward and input gradient (atol
  1e-5);
* ``Dropout`` and ``Embedding(padding_idx)`` behave as paddle's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models.ernie import ErnieConfig as JConfig
from paddle_tpu.models.ernie import ErnieForSequenceClassification as JErnie
from paddle_tpu.nn import functional as PF
from paddle_tpu.ops import nn_ops as jnn_ops
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                           ErnieForSequenceClassification)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

TINY = dict(vocab=128, hidden=64, layers=2, heads=2, inter=96, max_pos=128)
SEQ = 128


@pytest.fixture(autouse=True)
def _jax_flash_path(monkeypatch):
    monkeypatch.setattr(jnn_ops, "_sdpa_flash_backend_ok", lambda: True)


def _no_dropout(cfg):
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _pair(seed=3):
    paddle.seed(seed)
    jm = JErnie(_no_dropout(JConfig.tiny(**TINY)), num_classes=3)
    np_state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = ErnieForSequenceClassification(_no_dropout(ErnieConfig.tiny(**TINY)),
                                        num_classes=3, device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(np_state), strict=True)
    return jm, tm


def _batch(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY["vocab"], (batch, SEQ))
    mask = np.ones((batch, SEQ), np.int64)
    mask[1, 100:] = 0
    return ids, rng.integers(0, 3, (batch,)), mask


def _jax_run(jm, ids, labels, mask=None):
    kw = {} if mask is None else {"attention_mask": paddle.to_tensor(mask)}
    loss, logits = jm(paddle.to_tensor(ids.astype(np.int32)),
                      labels=paddle.to_tensor(labels), **kw)
    loss.backward()
    return float(loss.numpy()), logits.numpy(), {
        n: np.asarray(p.grad._data) for n, p in jm.named_parameters()
        if p.grad is not None}


def _torch_run(tm, ids, labels, mask=None):
    kw = {} if mask is None else {"attention_mask": torch.from_numpy(mask)}
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                      **kw)
    loss.backward()
    return float(loss), logits.detach().numpy(), {
        n: p.grad.numpy() for n, p in tm.named_parameters()}


def test_state_dict_converts_key_for_key():
    jm, tm = _pair()
    jkeys = set(jm.state_dict())
    assert jkeys == set(tm.state_dict())
    assert "ernie.encoder.layers.1.self_attn.q_proj.weight" in jkeys
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(),
                                      np.asarray(v._data))


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask",
                                                       "additive_mask"])
def test_loss_logits_and_grads_match_jax(masked):
    jm, tm = _pair()
    ids, labels, mask = _batch()
    m = mask if masked else None
    jl, jlog, jg = _jax_run(jm, ids, labels, m)
    tl, tlog, tg = _torch_run(tm, ids, labels, m)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-4)
    assert set(tg) == set(jg)
    for name, g in jg.items():
        np.testing.assert_allclose(tg[name], g, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_amp_o2_bf16_step_tracks_jax():
    jm, tm = _pair(seed=4)
    ids, labels, _ = _batch(seed=1)
    lr = 1e-3
    jopt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=jm.parameters())
    jm, jopt = paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    topt = AdamW(learning_rate=lr, weight_decay=0.01,
                 parameters=tm.parameters())
    tm, topt = amp.decorate(tm, topt, level="O2", dtype="bfloat16")
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        jl, _ = jm(paddle.to_tensor(ids.astype(np.int32)),
                   labels=paddle.to_tensor(labels))
    jl.backward()
    jg = {n: np.asarray(p.grad._data, np.float32)
          for n, p in jm.named_parameters()}
    jopt.step()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        tl, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert tl.dtype == torch.float32
    tl.backward()
    tg = {n: p.grad.float().numpy() for n, p in tm.named_parameters()}
    topt.step()
    np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1.5e-2)
    jp = {n: np.asarray(p._data, np.float32) for n, p in jm.named_parameters()}
    for name, g in jg.items():
        if name.endswith("k_proj.bias"):
            # exactly 0 (softmax ignores a shift common to every key):
            # both sides hold rounding noise
            assert np.abs(tg[name]).max() < 1e-3, name
            continue
        scale = max(float(np.abs(g).max()), 1e-12)
        assert np.abs(tg[name] - g).max() <= 0.15 * scale, name
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        # an Adam step moves an element by at most about lr whatever the
        # size of its gradient, so a noise-level gradient of the other sign
        # puts the two 2 lr apart; the bf16 parameters round from the fp32
        # masters, so one bf16 ulp more
        got = p.float().detach().numpy()
        tol = 2 * lr + np.maximum(np.abs(got), np.abs(jp[n])) * 2.0 ** -7
        assert (np.abs(got - jp[n]) <= tol).all(), n


def test_layer_norm_and_gelu_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32) * 3 + 1
    paddle.seed(0)
    jln = jnn.LayerNorm(48, epsilon=1e-12)
    tln = nn.LayerNorm(48, epsilon=1e-12, device="cpu")
    w, b = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    jln.weight._set_data(paddle.to_tensor(w)._data)
    jln.bias._set_data(paddle.to_tensor(b)._data)
    tln.load_state_dict({"weight": torch.from_numpy(w),
                         "bias": torch.from_numpy(b)})
    np.testing.assert_allclose(tln(torch.from_numpy(x)).detach().numpy(),
                               jln(paddle.to_tensor(x)).numpy(), rtol=0,
                               atol=1e-5)
    for approximate in (False, True):
        np.testing.assert_allclose(
            TF.gelu(torch.from_numpy(x), approximate).numpy(),
            PF.gelu(paddle.to_tensor(x), approximate).numpy(), rtol=0,
            atol=1e-6)
    np.testing.assert_allclose(TF.tanh(torch.from_numpy(x)).numpy(),
                               np.tanh(x), rtol=0, atol=1e-6)


def test_layer_norm_is_fp32_under_o2():
    x = torch.randn(2, 4, 8, dtype=torch.bfloat16)
    ln = nn.LayerNorm(8, device="cpu")
    amp.decorate(ln, level="O2", dtype="bfloat16")
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        assert ln(x).dtype == torch.float32
        assert TF.gelu(ln(x)).dtype == torch.bfloat16


def test_transformer_encoder_layer_matches_jax():
    paddle.seed(6)
    jl = jnn.TransformerEncoderLayer(64, 2, 96, dropout=0.0,
                                     activation="gelu", attn_dropout=0.0,
                                     act_dropout=0.0, layer_norm_eps=1e-12)
    tl = nn.TransformerEncoderLayer(64, 2, 96, dropout=0.0,
                                    activation="gelu", attn_dropout=0.0,
                                    act_dropout=0.0, layer_norm_eps=1e-12,
                                    device="cpu")
    tl.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v._data) for k, v in jl.state_dict().items()}),
        strict=True)
    x = np.random.default_rng(7).standard_normal((2, SEQ, 64)).astype(
        np.float32)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jl(jx)
    (jout * jout).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tl(tx)
    (tout * tout).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=0,
                               atol=1e-4)


def test_dropout_is_paddles_and_draws_from_the_rng():
    rng = nn.DropoutRNG("cpu", seed=1)
    d = nn.Dropout(0.25, rng=rng)
    x = torch.ones(200, 200)
    y = d(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    again = nn.Dropout(0.25, rng=nn.DropoutRNG("cpu", seed=1))(x)
    assert torch.equal(y, again)
    d.eval()
    assert torch.equal(d(x), x)
    with pytest.raises(ValueError, match="generator"):
        TF.dropout(x, 0.5)


def test_embedding_padding_row_is_zero_and_takes_no_gradient():
    e = nn.Embedding(10, 4, padding_idx=0, device="cpu")
    e.reset_parameters(torch.Generator().manual_seed(0))
    assert not e.weight[0].any()
    with torch.no_grad():
        e.weight[0] = 1.0
    out = e(torch.tensor([[0, 3, 0]]))
    assert not out[0, 0].any() and out[0, 1].any()
    out.sum().backward()
    assert not e.weight.grad[0].any()


def test_ernie3_base_config_and_size():
    cfg = ErnieConfig.ernie3_base()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.intermediate_size) == (
        40000, 768, 12, 12, 3072)
    assert ErnieConfig.ernie3_medium().num_hidden_layers == 6
    # the parameter count from the shapes alone (no model is built)
    h, i, v, L = 768, 3072, 40000, 12
    layer = 4 * (h * h + h) + (h * i + i) + (i * h + h) + 4 * h
    emb = (v + 2048 + 4 + 3) * h + 2 * h
    assert emb + L * layer + (h * h + h) + (h * 2 + 2) == 117_946_370
