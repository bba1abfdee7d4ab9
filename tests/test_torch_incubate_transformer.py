"""The rest of the port's ``incubate`` fused transformer surface against
``paddle_tpu.incubate`` on the CPU (where the port's wrappers run their
kernels' plain versions), the same seeded numpy inputs and parameters on
both sides (layers' parameters carried by ``convert``):

* ``fused_linear``, ``fused_matmul_bias``, ``fused_linear_activation``,
  ``fused_feedforward``, ``fused_multi_head_attention`` (with ``cache_kv``
  and an additive mask), ``memory_efficient_attention``,
  ``variable_length_memory_efficient_attention`` (both of its routes),
  ``softmax_mask_fuse``, ``softmax_mask_fuse_upper_triangle``,
  ``identity_loss`` and ``blha_get_max_len``; the layers
  ``FusedLinear``, ``FusedFeedForward``, ``FusedMultiHeadAttention`` and
  ``FusedTransformerEncoderLayer``.
* fp32: outputs within atol 1e-5 of JAX's and gradients (JAX's own
  autograd) within 1e-4: the two differ by summation order only.
* AMP O2 bf16, both sides casting by the same op names: outputs within
  2^-6 of |ref| plus 2^-6 of the largest output (two bf16 roundings apart
  where GELU or the softmax rounds in another place: torch rounds each op
  once, the JAX package after each primitive), gradients within 2^-4 of
  the largest element of JAX's.
* dropout only where no mask is drawn (p = 0 or eval mode): the port's
  masks are its kernels' hash, the JAX package's ``jax.random``'s.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import nn as jinn
from paddle_tpu.incubate import nn_functional as JF
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.incubate import nn_functional as TF

torch.set_num_threads(2)

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _jt(a):
    t = paddle.to_tensor(a)
    t.stop_gradient = False
    return t


def _tt(a):
    return torch.from_numpy(np.array(a)).requires_grad_()


def _jnp(t):
    return np.asarray(t._data, np.float32)


def _run(jfn, tfn, arrays: dict, o2=False, consts=None, seed=99):
    """Both sides on the same arrays (leaves with gradients; ``consts``
    without): outputs and the gradients of a seeded weighted sum of them,
    as numpy fp32."""
    consts = consts or {}
    jl = {k: _jt(v) for k, v in arrays.items()}
    tl = {k: _tt(v) for k, v in arrays.items()}
    jc = {k: paddle.to_tensor(v) for k, v in consts.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in consts.items()}
    if o2:
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            jout = jfn(**jl, **jc)
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            tout = tfn(**tl, **tc)
    else:
        jout, tout = jfn(**jl, **jc), tfn(**tl, **tc)
    jout = list(jout) if isinstance(jout, (tuple, list)) else [jout]
    tout = list(tout) if isinstance(tout, (tuple, list)) else [tout]
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(tuple(o.shape)).astype(np.float32)
          for o in tout]
    jobj = None
    for o, w in zip(jout, ws):
        term = (o.astype("float32") * paddle.to_tensor(w)).sum()
        jobj = term if jobj is None else jobj + term
    jobj.backward()
    sum((o.float() * torch.from_numpy(w)).sum()
        for o, w in zip(tout, ws)).backward()
    return ([_jnp(o) for o in jout], [o.detach().float().numpy()
                                      for o in tout],
            {k: np.asarray(t.grad._data, np.float32) for k, t in jl.items()
             if t.grad is not None},
            {k: t.grad.float().numpy() for k, t in tl.items()
             if t.grad is not None})


def _check(res, o2=False):
    jouts, touts, jg, tg = res
    for j, t in zip(jouts, touts):
        assert j.shape == t.shape
        if o2:
            lim = 2.0 ** -6 * (np.abs(j) + np.abs(j).max())
            assert (np.abs(t - j) <= lim).all()
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=OUT_ATOL)
    assert set(tg) == set(jg)
    for k, g in jg.items():
        if o2:
            assert np.abs(tg[k] - g).max() <= 2.0 ** -4 * max(
                float(np.abs(g).max()), 1e-12), k
        else:
            np.testing.assert_allclose(tg[k], g, rtol=0, atol=GRAD_ATOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the fused linears
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("o2", [False, True])
def test_fused_linear_matches_jax(bias, transpose, o2):
    arrays = {"x": _np(1, 3, 5, 16), "weight": _np(2, *((24, 16) if transpose
                                                        else (16, 24)),
                                                   scale=0.3)}
    if bias:
        arrays["bias"] = _np(3, 24, scale=0.5)
    _check(_run(lambda **a: JF.fused_linear(**a, transpose_weight=transpose),
                lambda **a: TF.fused_linear(**a, transpose_weight=transpose),
                arrays, o2), o2)


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_matmul_bias_matches_jax(tx, ty, bias):
    arrays = {"x": _np(4, 2, *((16, 6) if tx else (6, 16))),
              "y": _np(5, *((20, 16) if ty else (16, 20)), scale=0.3)}
    if bias:
        arrays["bias"] = _np(6, 20)
    _check(_run(lambda **a: JF.fused_matmul_bias(**a, transpose_x=tx,
                                                 transpose_y=ty),
                lambda **a: TF.fused_matmul_bias(**a, transpose_x=tx,
                                                 transpose_y=ty), arrays))


@pytest.mark.parametrize("activation", ["gelu", "relu", "none", ""])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("o2", [False, True])
def test_fused_linear_activation_matches_jax(activation, bias, o2):
    # "gelu" is jax.nn.gelu's default, the tanh form, on both sides
    arrays = {"x": _np(7, 4, 16), "y": _np(8, 16, 32, scale=0.4)}
    if bias:
        arrays["bias"] = _np(9, 32, scale=0.5)
    _check(_run(lambda **a: JF.fused_linear_activation(
        **a, activation=activation),
        lambda **a: TF.fused_linear_activation(**a, activation=activation),
        arrays, o2), o2)


def test_fused_linear_activation_transposes_and_rejects_unknown():
    arrays = {"x": _np(10, 16, 4), "y": _np(11, 32, 16, scale=0.4),
              "bias": _np(12, 32)}
    _check(_run(lambda **a: JF.fused_linear_activation(
        **a, trans_x=True, trans_y=True, activation="relu"),
        lambda **a: TF.fused_linear_activation(
            **a, trans_x=True, trans_y=True, activation="relu"), arrays))
    with pytest.raises(KeyError):
        TF.fused_linear_activation(torch.ones(2, 2), torch.ones(2, 2),
                                   activation="swish")


# ---------------------------------------------------------------------------
# fused_feedforward and fused_multi_head_attention
# ---------------------------------------------------------------------------

FFN_CASES = [(False, True, "relu"), (True, True, "gelu"),
             (False, False, "gelu"), (True, False, "relu")]


def _ffn_arrays(h=16, inter=32):
    return {"x": _np(20, 2, 7, h), "linear1_weight": _np(21, h, inter,
                                                         scale=0.3),
            "linear2_weight": _np(22, inter, h, scale=0.3),
            "linear1_bias": _np(23, inter, scale=0.2),
            "linear2_bias": _np(24, h, scale=0.2),
            "ln1_scale": _np(25, h, scale=0.2, shift=1.0),
            "ln1_bias": _np(26, h, scale=0.2),
            "ln2_scale": _np(27, h, scale=0.2, shift=1.0),
            "ln2_bias": _np(28, h, scale=0.2)}


@pytest.mark.parametrize("pre,add_residual,activation", FFN_CASES)
@pytest.mark.parametrize("training", [True, False])
def test_fused_feedforward_matches_jax(pre, add_residual, activation,
                                       training):
    kw = dict(dropout1_rate=0.0 if training else 0.5,
              dropout2_rate=0.0 if training else 0.3, activation=activation,
              pre_layer_norm=pre, add_residual=add_residual,
              training=training, ln1_epsilon=1e-5, ln2_epsilon=1e-6)
    _check(_run(lambda **a: JF.fused_feedforward(**a, **kw),
                lambda **a: TF.fused_feedforward(**a, **kw), _ffn_arrays()))


def test_fused_feedforward_o2_tracks_jax():
    kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation="gelu")
    _check(_run(lambda **a: JF.fused_feedforward(**a, **kw),
                lambda **a: TF.fused_feedforward(**a, **kw), _ffn_arrays(),
                o2=True), o2=True)


def _mha_arrays(h=16, heads=2, bias=True, pre=False):
    d = h // heads
    a = {"x": _np(30, 2, 8, h), "qkv_weight": _np(31, 3, heads, d, h,
                                                  scale=0.3),
         "linear_weight": _np(32, h, h, scale=0.3)}
    if bias:
        a.update(qkv_bias=_np(33, 3, heads, d, scale=0.2),
                 linear_bias=_np(34, h, scale=0.2))
    if pre:
        a.update(pre_ln_scale=_np(35, h, scale=0.2, shift=1.0),
                 pre_ln_bias=_np(36, h, scale=0.2))
    else:
        a.update(ln_scale=_np(37, h, scale=0.2, shift=1.0),
                 ln_bias=_np(38, h, scale=0.2))
    return a


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mask", [False, True])
def test_fused_multi_head_attention_matches_jax(pre, bias, mask):
    consts = {}
    if mask:
        m = np.zeros((2, 1, 8, 8), np.float32)
        m[1, :, :, 6:] = -1e4
        consts["attn_mask"] = m
    kw = dict(pre_layer_norm=pre, dropout_rate=0.0, attn_dropout_rate=0.0)
    _check(_run(lambda **a: JF.fused_multi_head_attention(**a, **kw),
                lambda **a: TF.fused_multi_head_attention(**a, **kw),
                _mha_arrays(bias=bias, pre=pre), consts=consts))


def test_fused_multi_head_attention_with_cache_kv_matches_jax():
    arrays = _mha_arrays()
    arrays["cache_kv"] = _np(39, 2, 2, 2, 5, 8)
    res = _run(lambda **a: JF.fused_multi_head_attention(
        **a, dropout_rate=0.0, attn_dropout_rate=0.0, add_residual=False),
        lambda **a: TF.fused_multi_head_attention(
            **a, dropout_rate=0.0, attn_dropout_rate=0.0,
            add_residual=False), arrays)
    assert [o.shape for o in res[1]] == [(2, 8, 16), (2, 2, 2, 13, 8)]
    _check(res)


def test_fused_multi_head_attention_o2_tracks_jax():
    kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0)
    _check(_run(lambda **a: JF.fused_multi_head_attention(**a, **kw),
                lambda **a: TF.fused_multi_head_attention(**a, **kw),
                _mha_arrays(), o2=True), o2=True)


def test_fused_blocks_draw_dropout_from_the_generator():
    from paddle_tpu_torch.nn import DropoutRNG
    a = {k: torch.from_numpy(v) for k, v in _ffn_arrays().items()}
    outs = [TF.fused_feedforward(**a, dropout1_rate=0.2, dropout2_rate=0.2,
                                 generator=DropoutRNG("cpu", seed=s))
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    with pytest.raises(ValueError, match="generator"):
        TF.fused_feedforward(**a, dropout1_rate=0.2)
    m = {k: torch.from_numpy(v) for k, v in _mha_arrays().items()}
    rng = DropoutRNG("cpu", seed=3)
    TF.fused_multi_head_attention(**m, dropout_rate=0.1,
                                  attn_dropout_rate=0.1, generator=rng)
    assert int(rng.counter) == 2   # the attention's seed and the output's


# ---------------------------------------------------------------------------
# the memory-efficient attentions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [None, 0.2])
@pytest.mark.parametrize("bias", [False, True])
def test_memory_efficient_attention_matches_jax(scale, bias):
    arrays = {"query": _np(40, 2, 16, 2, 8), "key": _np(41, 2, 16, 2, 8),
              "value": _np(42, 2, 16, 2, 8)}
    consts = {"attn_bias": _np(43, 2, 1, 16, 16)} if bias else {}
    _check(_run(lambda **a: JF.memory_efficient_attention(**a, scale=scale),
                lambda **a: TF.memory_efficient_attention(**a, scale=scale),
                arrays, consts=consts))


@pytest.mark.parametrize("d,mask", [(64, False), (32, False), (64, True)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(16, 16), (8, 20)])
def test_varlen_memory_efficient_attention_matches_jax(d, mask, causal, sq,
                                                       sk):
    # D = 64 without a mask takes the flash kernels' segment-id variant,
    # the rest the plain composition; every query row sees a key
    arrays = {"query": _np(44, 2, 2, sq, d), "key": _np(45, 2, 2, sk, d),
              "value": _np(46, 2, 2, sk, d)}
    consts = {"seq_lens": np.array([sq, sq - 3], np.int32),
              "kv_seq_lens": np.array([[sk], [sk - 5]], np.int32)}
    if mask:
        consts["mask"] = _np(47, 2, 1, sq, sk)
    _check(_run(lambda **a: JF.variable_length_memory_efficient_attention(
        **a, causal=causal, scale=0.11),
        lambda **a: TF.variable_length_memory_efficient_attention(
            **a, causal=causal, scale=0.11), arrays, consts=consts))


# ---------------------------------------------------------------------------
# the masked softmaxes and the small functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("o2", [False, True])
@pytest.mark.parametrize("mshape", [(2, 1, 8, 12), (2, 3, 8, 12)])
def test_softmax_mask_fuse_matches_jax(o2, mshape):
    consts = {"mask": np.where(_np(51, *mshape) > 1.0, -1e4, 0.0)
              .astype(np.float32)}
    _check(_run(JF.softmax_mask_fuse, TF.softmax_mask_fuse,
                {"x": _np(50, 2, 3, 8, 12, scale=3.0)}, o2, consts), o2)


@pytest.mark.parametrize("o2", [False, True])
@pytest.mark.parametrize("lq,lk", [(8, 8), (6, 10)])
def test_softmax_mask_fuse_upper_triangle_matches_jax(o2, lq, lk):
    _check(_run(JF.softmax_mask_fuse_upper_triangle,
                TF.softmax_mask_fuse_upper_triangle,
                {"x": _np(52, 2, 3, lq, lk, scale=3.0)}, o2), o2)


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", 0, 1, 2])
def test_identity_loss_matches_jax(reduction):
    _check(_run(lambda **a: JF.identity_loss(**a, reduction=reduction),
                lambda **a: TF.identity_loss(**a, reduction=reduction),
                {"x": _np(53, 4, 5)}))


def test_blha_get_max_len_matches_jax():
    enc, dec = np.array([3, 9, 4], np.int32), np.array([0, 2, 7], np.int32)
    jm = JF.blha_get_max_len(paddle.to_tensor(enc), paddle.to_tensor(dec))
    tm = TF.blha_get_max_len(torch.from_numpy(enc), torch.from_numpy(dec))
    assert [int(np.asarray(v._data)) for v in jm] == [int(v) for v in tm] \
        == [9, 7]


# ---------------------------------------------------------------------------
# the layers, parameters carried by convert
# ---------------------------------------------------------------------------

def _layer_pair(jl, tl, seed):
    """Random values into the JAX layer, carried into the port's by
    ``convert.state_dict_from_paddle_tpu``; both in eval mode."""
    assert list(tl.state_dict()) == list(jl.state_dict())
    state = {}
    for i, (k, v) in enumerate(jl.state_dict().items()):
        a = _np(seed + i, *v.shape, scale=0.2,
                shift=1.0 if k.endswith(("ln.weight", "norm1.weight",
                                         "norm2.weight")) else 0.0)
        v._set_data(paddle.to_tensor(a)._data)
        state[k] = np.asarray(v._data)
    tl.load_state_dict(state_dict_from_paddle_tpu(state))
    jl.eval()
    tl.eval()
    return jl, tl


def _layer_check(jl, tl, x, mask=None):
    jx, tx = _jt(x), _tt(x)
    jargs, targs = [jx], [tx]
    if mask is not None:
        jargs.append(paddle.to_tensor(mask))
        targs.append(torch.from_numpy(mask))
    jout, tout = jl(*jargs), tl(*targs)
    w = _np(60, *tout.shape)
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), _jnp(jout), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(jx.grad._data, np.float32),
                               rtol=0, atol=GRAD_ATOL)
    jp = dict(jl.named_parameters())
    for k, p in tl.named_parameters():
        # a parameter the forward does not use (pre_ln without
        # normalize_before) has no gradient on either side
        jgrad = jp[k].grad
        if p.grad is None or jgrad is None:
            assert p.grad is None and (jgrad is None or not np.asarray(
                jgrad._data).any()), k
            continue
        np.testing.assert_allclose(
            p.grad.numpy(), np.asarray(jgrad._data, np.float32),
            rtol=0, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("bias", [True, False])
def test_fused_linear_layer_matches_jax(bias):
    paddle.seed(0)
    jl = jinn.FusedLinear(16, 24, bias_attr=None if bias else False)
    tl = tinn.FusedLinear(16, 24, bias_attr=None if bias else False,
                          device="cpu")
    _layer_check(*_layer_pair(jl, tl, 70), _np(61, 3, 16))


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_fused_feedforward_layer_matches_jax(pre, activation):
    paddle.seed(1)
    jl = jinn.FusedFeedForward(16, 32, dropout_rate=0.1,
                               activation=activation, normalize_before=pre)
    tl = tinn.FusedFeedForward(16, 32, dropout_rate=0.1,
                               activation=activation, normalize_before=pre,
                               device="cpu")
    _layer_check(*_layer_pair(jl, tl, 80), _np(62, 2, 6, 16))


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("mask", [False, True])
def test_fused_multi_head_attention_layer_matches_jax(pre, mask):
    paddle.seed(2)
    jl = jinn.FusedMultiHeadAttention(16, 2, dropout_rate=0.1,
                                      attn_dropout_rate=0.1,
                                      normalize_before=pre)
    tl = tinn.FusedMultiHeadAttention(16, 2, dropout_rate=0.1,
                                      attn_dropout_rate=0.1,
                                      normalize_before=pre, device="cpu")
    m = None
    if mask:
        m = np.zeros((2, 1, 1, 6), np.float32)
        m[0, ..., 4:] = -1e4
    _layer_check(*_layer_pair(jl, tl, 90), _np(63, 2, 6, 16), m)
    with pytest.raises(NotImplementedError):
        tl(torch.zeros(1, 2, 16), cache=object())


@pytest.mark.parametrize("pre", [False, True])
def test_fused_transformer_encoder_layer_matches_jax(pre):
    paddle.seed(3)
    jl = jinn.FusedTransformerEncoderLayer(16, 2, 32, dropout_rate=0.1,
                                           activation="gelu",
                                           normalize_before=pre)
    tl = tinn.FusedTransformerEncoderLayer(16, 2, 32, dropout_rate=0.1,
                                           activation="gelu",
                                           normalize_before=pre,
                                           device="cpu")
    _layer_check(*_layer_pair(jl, tl, 100), _np(64, 2, 6, 16))


def test_layers_train_with_dropout_from_their_rng():
    from paddle_tpu_torch.nn import DropoutRNG
    rng = DropoutRNG("cpu", seed=7)
    layers = [tinn.FusedMultiHeadAttention(16, 2, 0.1, 0.1, rng=rng,
                                           device="cpu"),
              tinn.FusedFeedForward(16, 32, 0.1, rng=rng, device="cpu"),
              tinn.FusedTransformerEncoderLayer(16, 2, 32, 0.1, rng=rng,
                                                device="cpu")]
    x = torch.randn(2, 6, 16, requires_grad=True)
    out = x
    for layer in layers:
        out = layer(out)
    out.square().mean().backward()
    # MHA: attention, output; FFN: two; encoder: attention and three
    assert int(rng.counter) == 2 + 2 + 4
    assert torch.isfinite(x.grad).all()
