"""The port's ``nn`` for training against ``paddle_tpu.nn`` on the CPU:

* the ``Layer`` surface: ``create_parameter`` with ``ParamAttr`` (an
  initializer, a learning-rate scale, ``trainable``, ``need_clip``;
  ``bias_attr=False`` makes none), ``set_global_initializer``'s
  precedence, buffers in the state dict by ``persistable``,
  ``set_state_dict`` (numpy in, dtype kept, shape errors, missing and
  unexpected keys), ``parameters()``, ``sublayers()``, ``train()`` /
  ``eval()``, post hooks, ``build_scope``'s device and seed;
* the initializers' distributions: bounds, mean and standard deviation
  within 5 standard errors of the JAX package's formulas, fans of linear
  and convolution weights, ``Orthogonal``'s orthonormal rows or columns,
  ``Dirac``'s identity convolution, ``calculate_gain`` equal to JAX's;
* the containers' keys, equal to the JAX package's state dict keys;
* every activation function and layer, every manipulation function and
  the loss classes against the JAX package's, fp32 (outputs and gradients
  of ``sum(out * cot)`` within 1e-5 of each plus 1e-6 of the largest).
"""

import collections
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.ops import activation as JA
from paddle_tpu.ops import manipulation as JM
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.ops import activation as TA
from paddle_tpu_torch.ops import manipulation as TM


def _arr(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, rtol=1e-5, atol_frac=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want._data) if hasattr(want, "_data") else want
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_frac * max(float(np.abs(want).max(initial=0.0)), 1e-30))


def _cpu():
    return nn.build_scope("cpu", seed=0)


# -- the Layer surface -------------------------------------------------------

class _Net(nn.Layer):
    def __init__(self):
        super().__init__()
        self.w = self.create_parameter(
            (3, 4), attr=nn.ParamAttr(initializer=init.Constant(3.0),
                                      learning_rate=0.5, need_clip=False))
        self.frozen = self.create_parameter(
            (2,), attr=nn.ParamAttr(trainable=False), is_bias=True)
        self.none = self.create_parameter((2,), attr=False)
        self.register_buffer("kept", torch.zeros(2))
        self.register_buffer("scratch", torch.ones(2), persistable=False)
        self.sub = nn.Conv2D(2, 3, 3, bias_attr=False)


def test_create_parameter_and_param_attr():
    with _cpu():
        m = _Net()
    assert torch.equal(m.w, torch.full((3, 4), 3.0))
    assert m.w.optimize_attr == {"learning_rate": 0.5}
    assert m.w.need_clip is False and m.w.requires_grad
    assert not m.frozen.requires_grad and torch.equal(m.frozen,
                                                      torch.zeros(2))
    assert m.none is None and m.sub.bias is None
    assert set(m.state_dict()) == {"w", "frozen", "kept", "sub.weight"}
    assert [n for n, _ in m.named_parameters()] == ["w", "frozen",
                                                    "sub.weight"]
    assert len(m.parameters()) == 3
    assert len(m.parameters(include_sublayers=False)) == 2
    assert m.sublayers() == [m.sub] and m.full_name() == "_net"


def test_default_initializers_and_global_precedence():
    with _cpu():
        lin = nn.Conv2D(4, 8, 3)
    fan_in = 4 * 9
    assert float(lin.weight.detach().abs().max()) <= math.sqrt(6.0 / fan_in)
    assert torch.equal(lin.bias, torch.zeros(8))
    init.set_global_initializer(init.Constant(0.5), init.Constant(0.25))
    try:
        with _cpu():
            a = nn.Conv2D(2, 2, 1)
            b = nn.Conv2D(2, 2, 1, weight_attr=nn.ParamAttr(
                initializer=init.Constant(7.0)))
    finally:
        init.set_global_initializer(None)
    assert torch.equal(a.weight, torch.full_like(a.weight, 0.5))
    assert torch.equal(a.bias, torch.full_like(a.bias, 0.25))
    assert torch.equal(b.weight, torch.full_like(b.weight, 7.0))


def test_set_state_dict_numpy_shapes_and_keys():
    with _cpu():
        m = nn.Sequential(nn.Conv2D(2, 3, 1), nn.BatchNorm2D(3))
    sd = {k: np.full(tuple(v.shape), 2.0, np.float64)
          for k, v in m.state_dict().items()}
    sd["ghost"] = np.zeros(1)
    del sd["1.bias"]
    missing, unexpected = m.set_state_dict(sd)
    assert missing == ["1.bias"] and unexpected == ["ghost"]
    assert m[1]._mean.dtype == torch.float32
    assert torch.equal(m[1]._mean, torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="shape mismatch for 0.weight"):
        m.set_state_dict({"0.weight": np.zeros((3, 2, 2, 2))})


def test_train_eval_hooks_and_build_scope():
    with _cpu():
        m = nn.Sequential(nn.Conv2D(1, 1, 1), nn.BatchNorm2D(1))
    m.eval()
    assert not any(s.training for s in m.sublayers(include_self=True))
    m.train()
    seen = []
    h = m[0].register_forward_post_hook(
        lambda layer, inputs, out: seen.append(tuple(out.shape)))
    m(torch.zeros(2, 1, 3, 3))
    h.remove()
    m(torch.zeros(2, 1, 3, 3))
    assert seen == [(2, 1, 3, 3)]
    with nn.build_scope("cpu", seed=3):
        a = nn.Conv2D(2, 2, 3)
    with nn.build_scope("cpu", seed=3):
        b = nn.Conv2D(2, 2, 3)
    assert a.weight.device.type == "cpu" and torch.equal(a.weight, b.weight)


# -- initializers ------------------------------------------------------------

def _draw(initializer, shape):
    return initializer(shape, torch.float32, "cpu",
                       torch.Generator().manual_seed(1)).double()


def _moments_ok(t, mean, std):
    n = t.numel()
    assert abs(float(t.mean()) - mean) <= 5 * std / math.sqrt(n) + 1e-12
    assert abs(float(t.std()) - std) <= 5 * std / math.sqrt(2 * n)


UNIFORM_CASES = {
    # name: port initializer, JAX initializer, shape, limit of |x|
    "uniform": (init.Uniform(-0.3, 0.7), jinit.Uniform(-0.3, 0.7),
                (200, 300), None),
    "xavier_uniform_linear": (init.XavierUniform(), jinit.XavierUniform(),
                              (200, 300), math.sqrt(6 / 500)),
    "xavier_uniform_conv": (init.XavierUniform(), jinit.XavierUniform(),
                            (64, 32, 3, 3), math.sqrt(6 / (9 * 96))),
    "kaiming_uniform_conv": (init.KaimingUniform(), jinit.KaimingUniform(),
                             (64, 32, 3, 3),
                             math.sqrt(2) * math.sqrt(3 / (32 * 9))),
    "kaiming_uniform_fan_in": (init.KaimingUniform(fan_in=50),
                               jinit.KaimingUniform(fan_in=50), (64, 32),
                               math.sqrt(2) * math.sqrt(3 / 50)),
}


@pytest.mark.parametrize("case", sorted(UNIFORM_CASES))
def test_uniform_initializers_bounds_and_moments(case):
    ti, ji, shape, limit = UNIFORM_CASES[case]
    t = _draw(ti, shape)
    j = np.asarray(ji(shape, "float32"), np.float64)
    lo, hi = (ti.low, ti.high) if limit is None else (-limit, limit)
    for v in (t.numpy(), j):
        assert v.min() >= lo and v.max() <= hi
        assert v.min() < lo + 0.01 * (hi - lo) and \
            v.max() > hi - 0.01 * (hi - lo)
    _moments_ok(t, (lo + hi) / 2, (hi - lo) / math.sqrt(12))


NORMAL_CASES = {
    "normal": (init.Normal(0.5, 2.0), (300, 300), 0.5, 2.0),
    "xavier_normal": (init.XavierNormal(), (200, 300), 0.0,
                      math.sqrt(2 / 500)),
    "kaiming_normal_conv": (init.KaimingNormal(), (64, 32, 3, 3), 0.0,
                            math.sqrt(2 / (32 * 9))),
    "kaiming_normal_leaky": (init.KaimingNormal(negative_slope=0.2,
                                                nonlinearity="leaky_relu"),
                             (128, 256), 0.0,
                             math.sqrt(2 / 1.04) / math.sqrt(128)),
}


@pytest.mark.parametrize("case", sorted(NORMAL_CASES))
def test_normal_initializers_moments(case):
    ti, shape, mean, std = NORMAL_CASES[case]
    _moments_ok(_draw(ti, shape), mean, std)


def test_truncated_normal_bounds_and_moments():
    t = _draw(init.TruncatedNormal(1.0, 0.5, -2.0, 2.0), (400, 400))
    assert float(t.min()) >= 0.0 and float(t.max()) <= 2.0
    # the standard normal truncated to [-2, 2] has std 0.8796
    _moments_ok(t, 1.0, 0.5 * 0.87963)
    j = np.asarray(jinit.TruncatedNormal(1.0, 0.5)((100, 100), "float32"))
    assert j.min() >= 0.0 and j.max() <= 2.0


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 2, 3, 3)])
def test_orthogonal_dirac_constant_assign(shape):
    q = _draw(init.Orthogonal(gain=2.0), shape).reshape(shape[0], -1)
    small = min(q.shape)
    gram = q @ q.T if q.shape[0] == small else q.T @ q
    assert torch.allclose(gram, 4.0 * torch.eye(small, dtype=gram.dtype),
                          atol=1e-5)
    d = _draw(init.Dirac(), (3, 3, 3, 3)).float()
    x = torch.randn(1, 3, 5, 5)
    assert torch.allclose(torch.nn.functional.conv2d(x, d, padding=1), x)
    np.testing.assert_array_equal(
        _draw(init.Dirac(), (4, 2, 3)).numpy(),
        np.asarray(jinit.Dirac()((4, 2, 3), "float32")))
    assert torch.equal(_draw(init.Constant(1.5), (2, 3)),
                       torch.full((2, 3), 1.5, dtype=torch.float64))
    v = np.arange(6, dtype=np.float32)
    assert torch.equal(_draw(init.Assign(v), (2, 3)).float(),
                       torch.from_numpy(v).reshape(2, 3))


def test_gains_and_fans_equal_jax():
    for nl in ("sigmoid", "linear", "conv2d", "tanh", "relu", "selu"):
        assert init.calculate_gain(nl) == jinit.calculate_gain(nl)
    assert init.calculate_gain("leaky_relu", 0.2) == \
        jinit.calculate_gain("leaky_relu", 0.2)
    for shape in ((7,), (3, 5), (8, 4, 3, 3), (6, 2, 5)):
        assert init._fans(shape) == jinit._fans(shape)


# -- containers --------------------------------------------------------------

def _both_keys(build):
    paddle.seed(0)
    jm = build(jnn)
    with _cpu():
        tm = build(nn)
    return list(jm.state_dict()), list(tm.state_dict())


CONTAINER_CASES = {
    "sequential": lambda m: m.Sequential(m.Conv2D(2, 3, 3),
                                         m.BatchNorm2D(3), m.ReLU(),
                                         m.PReLU(3)),
    "sequential_named": lambda m: m.Sequential(
        ("conv", m.Conv2D(2, 3, 1)), ("bn", m.BatchNorm2D(3))),
    "sequential_ordered": lambda m: m.Sequential(collections.OrderedDict(
        [("a", m.Conv1D(2, 2, 3)), ("b", m.GroupNorm(1, 2))])),
    "layer_list": lambda m: m.LayerList([m.Conv2D(1, 1, 1),
                                         m.InstanceNorm2D(1)]).append(
        m.Conv2DTranspose(1, 2, 3)),
    "layer_dict": lambda m: m.LayerDict({"x": m.Conv3D(1, 1, 1),
                                         "y": m.BatchNorm1D(4)}),
    "conv1d_transpose": lambda m: m.Sequential(m.Conv1DTranspose(2, 3, 3),
                                               m.Conv3DTranspose(2, 2, 2)),
}


@pytest.mark.parametrize("case", sorted(CONTAINER_CASES))
def test_container_state_dict_keys_equal_jax(case):
    jkeys, tkeys = _both_keys(CONTAINER_CASES[case])
    assert sorted(jkeys) == sorted(tkeys)


def test_container_access():
    with _cpu():
        seq = nn.Sequential(nn.ReLU(), nn.Sigmoid(), nn.Tanh())
        lst = nn.LayerList([nn.ReLU()])
        lst.insert(0, nn.Sigmoid())
        lst.extend([nn.Tanh()])
        d = nn.LayerDict({"a": nn.ReLU()})
        d["b"] = nn.Sigmoid()
        pl = nn.ParameterList([torch.nn.Parameter(torch.zeros(2))])
        pl.append(torch.nn.Parameter(torch.ones(1)))
    assert len(seq[1:]) == 2 and isinstance(seq[-1], nn.Tanh)
    assert [type(m).__name__ for m in lst] == ["Sigmoid", "ReLU", "Tanh"]
    assert isinstance(lst[-1], nn.Tanh) and len(lst) == 3
    assert list(d.keys()) == ["a", "b"] and "b" in d
    assert list(pl.state_dict()) == ["0", "1"] and len(pl) == 2
    x = torch.randn(3)
    assert torch.equal(seq(x), torch.tanh(torch.sigmoid(torch.relu(x))))


# -- activations -------------------------------------------------------------

ACT_CASES = [
    ("relu", {}), ("relu6", {}), ("silu", {}), ("swish", {}),
    ("softsign", {}), ("tanhshrink", {}), ("mish", {}), ("hardswish", {}),
    ("hardsigmoid", {}), ("hardsigmoid", dict(slope=0.3, offset=0.2)),
    ("log_sigmoid", {}), ("gelu", {}), ("gelu", dict(approximate=True)),
    ("softmax", dict(axis=1)), ("log_softmax", {}),
    ("softplus", dict(beta=2.0, threshold=3.0)), ("leaky_relu", {}),
    ("elu", dict(alpha=0.7)), ("selu", {}), ("celu", dict(alpha=1.3)),
    ("hardtanh", dict(min=-0.5, max=0.8)), ("hardshrink", {}),
    ("softshrink", dict(threshold=0.3)),
    ("thresholded_relu", dict(threshold=0.4)), ("glu", dict(axis=1)),
    ("maxout", dict(groups=2, axis=1)),
]


@pytest.mark.parametrize("name,kw", ACT_CASES,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(ACT_CASES)])
def test_activation_function_matches_jax(name, kw):
    x = _arr((3, 4, 5), 11, 2.0)
    cot = _arr((3, 4, 5) if name not in ("glu", "maxout") else (3, 2, 5),
               12)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = getattr(JA, name)(jx, **kw)
    (jout * paddle.to_tensor(cot)).sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    tout = getattr(TA, name)(tx, **kw)
    (tout * torch.from_numpy(cot)).sum().backward()
    _close(tout, jout)
    _close(tx.grad, jx.grad)


def test_prelu_and_sigmoid_match_jax():
    x, w = _arr((2, 3, 4), 13), np.array([0.1, 0.2, 0.3], np.float32)
    _close(TA.prelu(torch.from_numpy(x), torch.from_numpy(w)),
           JA.prelu(paddle.to_tensor(x), paddle.to_tensor(w)))
    _close(TA.sigmoid(torch.from_numpy(x)),
           jnn.functional.sigmoid(paddle.to_tensor(x)))


def test_gumbel_softmax_distribution():
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.7]])).repeat(4000, 1)
    g = torch.Generator().manual_seed(0)
    soft = TA.gumbel_softmax(logits, temperature=0.5, generator=g)
    assert torch.allclose(soft.sum(-1), torch.ones(4000))
    hard = TA.gumbel_softmax(logits, hard=True, generator=g)
    assert torch.equal(hard.sum(-1), torch.ones(4000))
    share = hard.mean(0)
    assert torch.allclose(share, torch.tensor([0.1, 0.2, 0.7]), atol=0.03)


LAYER_CASES = [
    ("ReLU", {}), ("ReLU6", {}), ("GELU", {}), ("Sigmoid", {}),
    ("Tanh", {}), ("Softmax", dict(axis=1)), ("LogSoftmax", {}),
    ("LeakyReLU", dict(negative_slope=0.2)), ("ELU", {}), ("SELU", {}),
    ("CELU", {}), ("SiLU", {}), ("Silu", {}), ("Swish", {}), ("Mish", {}),
    ("Hardswish", {}), ("Hardsigmoid", {}), ("Hardtanh", {}),
    ("Hardshrink", {}), ("Softshrink", {}), ("Softplus", {}),
    ("Softsign", {}), ("Tanhshrink", {}), ("ThresholdedReLU", {}),
    ("LogSigmoid", {}), ("Maxout", dict(groups=2)), ("PReLU", {}),
    ("GLU", dict(axis=1)), ("Softmax2D", {}),
]


@pytest.mark.parametrize("name,kw", LAYER_CASES,
                         ids=[n for n, _ in LAYER_CASES])
def test_activation_layer_matches_jax(name, kw):
    x = _arr((2, 4, 3, 3), 14, 2.0)
    jl = getattr(jnn, name)(**kw)
    with _cpu():
        tl = getattr(nn, name)(**kw)
    assert list(jl.state_dict()) == list(tl.state_dict())
    _close(tl(torch.from_numpy(x)), jl(paddle.to_tensor(x)))


# -- manipulation ------------------------------------------------------------

MANIP_CASES = [
    ("reshape", [(2, 3, 4)], dict(shape=[0, -1, 2])),
    ("flatten", [(2, 3, 4, 5)], dict(start_axis=1, stop_axis=2)),
    ("transpose", [(2, 3, 4)], dict(perm=[2, 0, 1])),
    ("t", [(3, 4)], {}),
    ("squeeze", [(2, 1, 3, 1)], dict(axis=[1, 2])),
    ("unsqueeze", [(2, 3)], dict(axis=[0, -1])),
    ("tile", [(2, 3)], dict(repeat_times=[2, 1, 2])),
    ("expand", [(3, 1)], dict(shape=[2, -1, 4])),
    ("broadcast_to", [(1, 3)], dict(shape=[4, 3])),
    ("roll", [(3, 4)], dict(shifts=[1, -2], axis=[0, 1])),
    ("roll", [(3, 4)], dict(shifts=5)),
    ("flip", [(3, 4, 2)], dict(axis=[0, 2])),
    ("fliplr", [(3, 4)], {}), ("flipud", [(3, 4)], {}),
    ("rot90", [(3, 4, 2)], dict(k=3, axes=(0, 1))),
    ("repeat_interleave", [(3, 4)], dict(repeats=2, axis=1)),
    ("pad", [(2, 3, 4, 5)], dict(pad=[1, 2, 0, 1], value=0.5)),
    ("pad", [(2, 3, 4, 5)], dict(pad=[1, 2, 2, 1], mode="reflect")),
    ("pad", [(2, 3, 4, 5)], dict(pad=[1, 2, 3, 1], mode="replicate")),
    ("pad", [(2, 3, 4, 5)], dict(pad=[2, 1, 1, 3], mode="circular")),
    ("pad", [(2, 4, 5, 3)], dict(pad=[1, 0, 2, 1], data_format="NHWC")),
    ("pad", [(2, 3)], dict(pad=[1, 0, 0, 2])),
    ("tril", [(4, 5)], dict(diagonal=1)), ("triu", [(4, 5)], {}),
    ("diag", [(4,)], dict(offset=1)), ("diag", [(4, 5)], dict(offset=-1)),
    ("diagonal", [(3, 4, 5)], dict(offset=1, axis1=1, axis2=2)),
    ("diag_embed", [(2, 3)], dict(offset=1)),
    ("slice", [(4, 6, 5)], dict(axes=[0, 2], starts=[1, -3],
                                ends=[10, -1])),
    ("strided_slice", [(6, 7)], dict(axes=[0, 1], starts=[1, 6],
                                     ends=[6, 0], strides=[2, -2])),
    ("moveaxis", [(2, 3, 4)], dict(source=0, destination=2)),
    ("swapaxes", [(2, 3, 4)], dict(axis1=0, axis2=2)),
    ("crop", [(4, 5, 6)], dict(shape=[2, -1, 3], offsets=[1, 2, 3])),
]


@pytest.mark.parametrize("name,shapes,kw", MANIP_CASES,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(MANIP_CASES)])
def test_manipulation_matches_jax(name, shapes, kw):
    arrays = [_arr(s, 20 + i) for i, s in enumerate(shapes)]
    js = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    jout, tout = getattr(JM, name)(*js, **kw), getattr(TM, name)(*ts, **kw)
    cot = _arr(tuple(tout.shape), 30)
    (jout * paddle.to_tensor(cot)).sum().backward()
    (tout * torch.from_numpy(cot)).sum().backward()
    _close(tout, jout)
    for t, j in zip(ts, js):
        _close(t.grad, j.grad)


def test_multi_tensor_manipulation_matches_jax():
    a, b = _arr((2, 3), 40), _arr((2, 3), 41)
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(TM.concat([ta, tb], axis=1), JM.concat([ja, jb], axis=1))
    _close(TM.stack([ta, tb], axis=2), JM.stack([ja, jb], axis=2))
    for t, j in zip(TM.split(ta, [1, -1], axis=1),
                    JM.split(ja, [1, -1], axis=1)):
        _close(t, j)
    for t, j in zip(TM.chunk(tb, 3, axis=1), JM.chunk(jb, 3, axis=1)):
        _close(t, j)
    for t, j in zip(TM.unbind(ta, 1), JM.unbind(ja, 1)):
        _close(t, j)
    _close(TM.expand_as(ta[:1], tb), JM.expand_as(ja[:1], jb))
    for t, j in zip(TM.broadcast_tensors([ta[:1], tb]),
                    JM.broadcast_tensors([ja[:1], jb])):
        _close(t, j)
    for t, j in zip(TM.meshgrid(ta[0], tb[1]), JM.meshgrid(ja[0], jb[1])):
        _close(t, j)
    assert TM.cast(ta, "bfloat16").dtype == torch.bfloat16
    c = TM.as_complex(TM.stack([ta, tb], -1))
    _close(TM.as_real(c), JM.as_real(JM.as_complex(JM.stack([ja, jb], -1))))
    with pytest.raises(ValueError, match="crop out of bounds"):
        TM.crop(ta, shape=[3, 3])


# -- loss classes ------------------------------------------------------------

def _loss_inputs(name):
    r = np.random.default_rng(50)
    x = r.standard_normal((6, 5)).astype(np.float32)
    p = 1 / (1 + np.exp(-x))
    y01 = (r.random((6, 5)) > 0.5).astype(np.float32)
    return {
        "CrossEntropyLoss": ([x, r.integers(0, 5, 6)], dict(
            label_smoothing=0.1)),
        "MSELoss": ([x, y01], {}), "L1Loss": ([x, y01], {}),
        "NLLLoss": ([np.log(np.exp(x) / np.exp(x).sum(1, keepdims=True)),
                     r.integers(0, 5, 6)], dict(reduction="sum")),
        "BCELoss": ([p, y01], {}),
        "BCEWithLogitsLoss": ([x, y01], dict(pos_weight=None)),
        "KLDivLoss": ([x, p], dict(reduction="batchmean")),
        "SmoothL1Loss": ([x, y01], dict(delta=0.5)),
        "MarginRankingLoss": ([x, x[::-1].copy(), np.sign(x)],
                              dict(margin=0.2)),
        "CosineEmbeddingLoss": ([x, x[::-1].copy(),
                                 np.array([1, -1, 1, -1, 1, -1],
                                          np.float32)], dict(margin=0.1)),
        "TripletMarginLoss": ([x, x[::-1].copy(), x * 0.5], {}),
        "HingeEmbeddingLoss": ([x, np.where(y01 > 0, 1.0, -1.0).astype(
            np.float32)], dict(margin=0.7)),
    }[name]


@pytest.mark.parametrize("name", sorted(nn.loss.__all__))
def test_loss_class_matches_jax(name):
    arrays, kw = _loss_inputs(name)
    js = [paddle.to_tensor(a, stop_gradient=not i == 0)
          for i, a in enumerate(arrays)]
    ts = [torch.tensor(a, requires_grad=i == 0)
          for i, a in enumerate(arrays)]
    jl = getattr(jnn, name)(**kw)(*js)
    with _cpu():
        tl = getattr(nn, name)(**kw)(*ts)
    jl.backward()
    tl.backward()
    _close(tl, jl)
    _close(ts[0].grad, js[0].grad)
