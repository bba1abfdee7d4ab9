"""The decoder side of the port's ``nn.transformer`` against
``paddle_tpu.nn`` on the CPU, weights carried across by
``convert.state_dict_from_paddle_tpu``, inputs from a seeded numpy
generator, dropout 0 (JAX draws it from ``jax.random``, which no torch
generator reproduces; the attention dropout mask is held bit for bit in
``test_torch_flash_segs_dropout.py``):

* ``MultiHeadAttention`` with a cache (and ``gen_cache``'s empty one): out
  and the concatenated K/V, fp32 atol 1e-5;
* ``TransformerEncoderLayer`` with a cache, atol 1e-5;
* ``TransformerDecoderLayer`` pre-norm and post-norm, with a causal float
  ``tgt_mask`` and a key-padding bool ``memory_mask``: output and the
  gradients of ``tgt`` and ``memory``, atol 1e-5 / 1e-4;
* a 2 + 2 layer ``Transformer``: the state dict key for key, the forward
  (atol 1e-5), and one AMP O2 bf16 AdamW step of a sequence-to-sequence
  loss with label smoothing 0.1 and ``ignore_index=0``: loss rtol 1.5e-2
  of the JAX O2 loss, each gradient within 15% of its largest element of
  the JAX fp32 gradient, each parameter after the step within 2 lr plus
  one bf16 ulp of the JAX O2 step (the bounds of ``test_torch_ernie.py``'s
  O2 step, for the same reasons);
* ``need_weights`` is stored and no weights are returned, and the decoder
  layer's ``cache`` is ignored, as in the JAX package;
* ``flops`` counts the JAX package's linears and norms plus the port's
  attention products.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flops as jflops
from paddle_tpu import nn as jnn
from paddle_tpu.ops import loss_ops as jloss
from paddle_tpu_torch import amp, flops, nn
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.ops.loss_ops import cross_entropy
from paddle_tpu_torch.optimizer import AdamW

E, H, FF = 32, 2, 48
LS, LT, B = 9, 7, 2


def _carry(jm, tm):
    tm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()}),
        strict=True)
    return tm


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want), rtol=0, atol=atol)


def _masks():
    """The causal float mask of the target and a key-padding bool mask of
    the source (row 1 sees its first 6 keys)."""
    keep = np.ones((B, 1, 1, LS), bool)
    keep[1, ..., 6:] = False
    causal = np.triu(np.full((LT, LT), -np.inf, np.float32), k=1)
    return causal, keep


def test_mha_cache_and_gen_cache():
    paddle.seed(1)
    jm = jnn.MultiHeadAttention(E, H)
    tm = _carry(jm, nn.MultiHeadAttention(E, H, device="cpu"))
    q, past = _x((B, 3, E), 2), _x((B, 5, H, E // H), 3)
    jc = (paddle.to_tensor(past), paddle.to_tensor(past * 0.5))
    tc = (torch.from_numpy(past), torch.from_numpy(past * 0.5))
    jout, (jk, jv) = jm(paddle.to_tensor(q), cache=jc)
    tout, (tk, tv) = tm(torch.from_numpy(q), cache=tc)
    _close(tout, jout.numpy())
    _close(tk, jk.numpy())
    _close(tv, jv.numpy())
    assert tk.shape == (B, 8, H, E // H)
    empty = tm.gen_cache(torch.from_numpy(q), type=nn.MultiHeadAttention.Cache)
    jempty = jm.gen_cache(paddle.to_tensor(q))
    assert [tuple(t.shape) for t in empty] == \
        [tuple(t.shape) for t in jempty] == [(B, 0, H, E // H)] * 2
    jout, _ = jm(paddle.to_tensor(q), cache=jempty)
    tout, (tk, _) = tm(torch.from_numpy(q), cache=empty)
    _close(tout, jout.numpy())
    _close(tout, tm(torch.from_numpy(q)).detach())
    assert tk.shape == (B, 3, H, E // H)


def test_mha_need_weights_is_stored_and_returns_no_weights():
    tm = nn.MultiHeadAttention(E, H, need_weights=True, device="cpu")
    for lin in (tm.q_proj, tm.k_proj, tm.v_proj, tm.out_proj):
        lin.reset_parameters(torch.Generator().manual_seed(0))
    assert tm.need_weights is True
    assert jnn.MultiHeadAttention(E, H, need_weights=True).need_weights
    out = tm(torch.from_numpy(_x((B, 4, E), 4)))
    assert isinstance(out, torch.Tensor) and out.shape == (B, 4, E)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_with_cache(normalize_before):
    paddle.seed(5)
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    jl = jnn.TransformerEncoderLayer(E, H, FF, **kw)
    tl = _carry(jl, nn.TransformerEncoderLayer(E, H, FF, device="cpu", **kw))
    src, past = _x((B, 3, E), 6), _x((B, 4, H, E // H), 7)
    jout, (jk, _) = jl(paddle.to_tensor(src),
                       cache=(paddle.to_tensor(past), paddle.to_tensor(past)))
    tout, (tk, _) = tl(torch.from_numpy(src),
                       cache=(torch.from_numpy(past), torch.from_numpy(past)))
    _close(tout, jout.numpy())
    _close(tk, jk.numpy())


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer(normalize_before):
    paddle.seed(8)
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    jl = jnn.TransformerDecoderLayer(E, H, FF, **kw)
    tl = _carry(jl, nn.TransformerDecoderLayer(E, H, FF, device="cpu", **kw))
    assert sorted(tl.state_dict()) == sorted(jl.state_dict())
    tgt, mem = _x((B, LT, E), 9), _x((B, LS, E), 10)
    causal, keep = _masks()
    jt, jmem = paddle.to_tensor(tgt), paddle.to_tensor(mem)
    jt.stop_gradient = jmem.stop_gradient = False
    jout = jl(jt, jmem, paddle.to_tensor(causal), paddle.to_tensor(keep))
    (jout * jout).sum().backward()
    tt = torch.from_numpy(tgt).requires_grad_()
    tmem = torch.from_numpy(mem).requires_grad_()
    tout = tl(tt, tmem, torch.from_numpy(causal), torch.from_numpy(keep))
    (tout * tout).sum().backward()
    _close(tout, jout.numpy())
    _close(tt.grad, jt.grad.numpy(), 1e-4)
    _close(tmem.grad, jmem.grad.numpy(), 1e-4)


def test_decoder_layer_ignores_its_cache():
    tl = nn.TransformerDecoderLayer(E, H, FF, dropout=0.0, device="cpu")
    for m in tl.modules():
        if isinstance(m, nn.Linear):
            m.reset_parameters(torch.Generator().manual_seed(1))
    tgt, mem = torch.from_numpy(_x((B, LT, E), 11)), \
        torch.from_numpy(_x((B, LS, E), 12))
    cache = tl.self_attn.gen_cache(tgt)
    with_cache = tl(tgt, mem, cache=cache)
    assert isinstance(with_cache, torch.Tensor)
    assert torch.equal(with_cache, tl(tgt, mem))


def test_square_subsequent_mask():
    tm = nn.Transformer(E, H, 1, 1, FF, device="cpu")
    got = tm.generate_square_subsequent_mask(5)
    want = jnn.Transformer(E, H, 1, 1, FF).generate_square_subsequent_mask(5)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want.numpy())


def _pair(seed, **kw):
    paddle.seed(seed)
    cfg = dict(d_model=E, nhead=H, num_encoder_layers=2,
               num_decoder_layers=2, dim_feedforward=FF, dropout=0.0, **kw)
    jm = jnn.Transformer(**cfg)
    tm = _carry(jm, nn.Transformer(device="cpu", **cfg))
    return jm, tm


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_state_dict_and_forward(normalize_before):
    jm, tm = _pair(13, normalize_before=normalize_before)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    assert ("encoder.norm.weight" in tm.state_dict()) == normalize_before
    src, tgt = _x((B, LS, E), 14), _x((B, LT, E), 15)
    causal, keep = _masks()
    jout = jm(paddle.to_tensor(src), paddle.to_tensor(tgt),
              paddle.to_tensor(keep), paddle.to_tensor(causal),
              paddle.to_tensor(keep))
    tout = tm(torch.from_numpy(src), torch.from_numpy(tgt),
              torch.from_numpy(keep), torch.from_numpy(causal),
              torch.from_numpy(keep))
    _close(tout, jout.numpy())


def test_transformer_custom_stacks():
    enc = nn.TransformerEncoder(
        nn.TransformerEncoderLayer(E, H, FF, device="cpu"), 1)
    dec = nn.TransformerDecoder(
        nn.TransformerDecoderLayer(E, H, FF, device="cpu"), 3)
    tm = nn.Transformer(E, H, custom_encoder=enc, custom_decoder=dec,
                        device="cpu")
    assert tm.encoder is enc and tm.decoder is dec
    assert len(tm.decoder.layers) == 3
    # copies own their parameters and share the prototype's DropoutRNG
    a, b = dec.layers[0], dec.layers[1]
    assert a.linear1.weight is not b.linear1.weight
    assert a.self_attn.rng is b.cross_attn.rng is b.dropout3.rng


def _seq2seq_step(v=23):
    """The sequence-to-sequence loss's inputs: source and target
    embeddings, labels with padding (0) in row 1, the masks."""
    src, tgt = _x((B, LS, E), 18), _x((B, LT, E), 19)
    labels = np.random.default_rng(20).integers(1, v, (B, LT))
    labels[1, 5:] = 0
    return src, tgt, labels, *_masks()


def _jax_loss(jm, jhead, src, tgt, labels, causal, keep):
    out = jm(paddle.to_tensor(src), paddle.to_tensor(tgt),
             paddle.to_tensor(keep), paddle.to_tensor(causal),
             paddle.to_tensor(keep))
    return jloss.cross_entropy(jhead(out), paddle.to_tensor(labels),
                               ignore_index=0, label_smoothing=0.1)


def _jax_pair_with_head(v=23):
    jm, tm = _pair(16)
    paddle.seed(17)
    jhead = jnn.Linear(E, v, bias_attr=False)
    thead = _carry(jhead, nn.Linear(E, v, bias_attr=False, device="cpu"))
    return jm, tm, jhead, thead


def test_transformer_o2_step_with_label_smoothing_tracks_jax():
    """The port's O2 gradients are held against the JAX fp32 gradients
    (bf16 rounding moves the JAX package's own O2 gradients by up to 26%
    of an element here, and differently from one process to another); the
    loss and the parameters after the step against the JAX O2 step. Adam's
    first update is about -lr sign(g) on every element, so where the JAX
    fp32 gradient is past both O2 gradients' error the two steps must move
    each parameter the same way, by the same bf16 value."""
    lr = 1e-3
    inputs = _seq2seq_step()
    jm, _, jhead, _ = _jax_pair_with_head()
    _jax_loss(jm, jhead, *inputs).backward()
    jg = {n: np.asarray(p.grad._data, np.float32)
          for n, p in jm.named_parameters()}
    jm, tm, jhead, thead = _jax_pair_with_head()
    jopt = paddle.optimizer.AdamW(
        learning_rate=lr, parameters=jm.parameters() + jhead.parameters(),
        beta2=0.98, epsilon=1e-9)
    (jm, jhead), jopt = paddle.amp.decorate([jm, jhead], jopt, level="O2",
                                            dtype="bfloat16")
    jp0 = {n: np.asarray(p._data, np.float32)
           for n, p in jm.named_parameters()}
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        jl = _jax_loss(jm, jhead, *inputs)
    jl.backward()
    jopt.step()
    topt = AdamW(learning_rate=lr, parameters=list(tm.parameters())
                 + list(thead.parameters()), beta2=0.98, epsilon=1e-9)
    (tm, thead), topt = amp.decorate([tm, thead], topt, level="O2",
                                     dtype="bfloat16")
    tp0 = {n: p.float().detach().numpy().copy()
           for n, p in tm.named_parameters()}
    src, tgt, labels, causal, keep = inputs
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        out = tm(torch.from_numpy(src), torch.from_numpy(tgt),
                 torch.from_numpy(keep), torch.from_numpy(causal),
                 torch.from_numpy(keep))
        tl = cross_entropy(thead(out), torch.from_numpy(labels),
                           ignore_index=0, label_smoothing=0.1)
    assert tl.dtype == torch.float32
    tl.backward()
    tg = {n: p.grad.float().numpy() for n, p in tm.named_parameters()}
    topt.step()
    np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                               rtol=1.5e-2)
    for name, g in jg.items():
        if name.endswith("k_proj.bias"):
            # exactly 0 (softmax ignores a shift common to every key)
            assert np.abs(tg[name]).max() < 1e-3, name
            continue
        scale = max(float(np.abs(g).max()), 1e-12)
        assert np.abs(tg[name] - g).max() <= 0.15 * scale, name
    jp = {n: np.asarray(p._data, np.float32) for n, p in jm.named_parameters()}
    strong = moved = 0
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        got = p.float().detach().numpy()
        np.testing.assert_array_equal(tp0[n], jp0[n], err_msg=n)
        tol = 2 * lr + np.maximum(np.abs(got), np.abs(jp[n])) * 2.0 ** -7
        assert (np.abs(got - jp[n]) <= tol).all(), n
        g = jg[n]
        sure = np.abs(g) > 0.3 * max(float(np.abs(g).max()), 1e-12)
        if n.endswith("k_proj.bias"):
            sure[...] = False
        step_t, step_j = np.sign(got - tp0[n]), np.sign(jp[n] - jp0[n])
        np.testing.assert_array_equal(step_t[sure], step_j[sure],
                                      err_msg=n)
        assert (step_j[sure] != np.sign(g[sure])).all(), n
        ulp = np.maximum(np.abs(got), np.abs(jp[n])) * 2.0 ** -7
        assert (np.abs(got - jp[n])[sure] <= ulp[sure]).all(), n
        strong += int(sure.sum())
        moved += int((step_j[sure] != 0).sum())
    assert strong > 500 and moved > 0.5 * strong, (strong, moved)


def test_flops_counts_linears_norms_and_attention():
    paddle.seed(21)
    jl = jnn.TransformerEncoderLayer(E, H, FF, dropout=0.0)
    tl = _carry(jl, nn.TransformerEncoderLayer(E, H, FF, dropout=0.0,
                                               device="cpu"))
    want = jflops(jl, [B, LS, E])
    attention = 2 * B * LS * LS * E      # QK^T and PV, H heads of E / H
    assert flops(tl, [B, LS, E]) == want + attention
    jm, tm = _pair(22)
    per_layer = flops(tl, [B, LS, E])
    cross = 4 * B * LS * E * (E + 1) + attention + 2 * B * LS * E
    assert flops(tm, [B, LS, E]) == 2 * per_layer + 2 * (per_layer + cross)
