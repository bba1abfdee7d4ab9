"""The port's ``AdamW`` (plain versions on the CPU) against the JAX
package's ``AdamW`` over 5 steps on the same parameters and gradients:
fp32 moments, int8 moments, fp32 masters under AMP O2 (bf16 parameters),
master-free bf16 without stochastic rounding, and bf16 moments. Also
``clear_grad`` and the default decoupled weight decay of 0.01 on every
parameter.

Tolerances: fp32 parameters rtol 1e-6 (the update is the same fp32
arithmetic; XLA and PyTorch differ in the last bit of a few elementwise
results, and the bias corrections ``1 - beta^t`` by an ulp at most); the
int8 leg atol 1e-6 = lr / 1000, since an int8 code one step apart moves an
element by a fraction of its step; bf16 parameters within one bf16 ulp
(2^-7 relative), the fp32 masters rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

LR = 1e-3
SHAPES = [(64, 48), (128, 64)]   # weights of 3072 (ragged) and 8192 elements


def _models():
    """The same two Linear layers in both packages."""
    paddle.seed(3)
    jm = paddle.nn.LayerList([paddle.nn.Linear(i, o) for i, o in SHAPES])
    tm = torch.nn.ModuleList([Linear(i, o, device="cpu") for i, o in SHAPES])
    with torch.no_grad():
        for jl, tl in zip(jm, tm):
            tl.weight.copy_(torch.from_numpy(np.array(jl.weight._data)))
            tl.bias.copy_(torch.from_numpy(
                np.random.default_rng(1).normal(0, 0.1, tl.bias.shape)
                .astype(np.float32)))
            jl.bias._set_data(jnp.asarray(tl.bias.numpy().copy()))
    return jm, tm


def _grads(step):
    rng = np.random.default_rng(100 + step)
    out = []
    for i, o in SHAPES:
        out += [rng.normal(0, 0.01, (i, o)).astype(np.float32),
                rng.normal(0, 0.01, (o,)).astype(np.float32)]
    return out


def _run(moment_dtype, o2, master, sr=True, steps=5):
    jm, tm = _models()
    kw = dict(learning_rate=LR, moment_dtype=moment_dtype,
              use_master_weights=master, stochastic_rounding=sr)
    jo = paddle.optimizer.AdamW(parameters=jm.parameters(), **kw)
    to = AdamW(parameters=tm.parameters(), **kw)
    if o2:
        jm, jo = paddle.amp.decorate(jm, jo, level="O2", dtype="bfloat16",
                                     master_weight=master)
        tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16",
                              master_weight=master)
    jp, tp = list(jm.parameters()), list(tm.parameters())
    for s in range(steps):
        gs = _grads(s)
        loss = sum((p.astype("float32") * paddle.to_tensor(g)).sum()
                   for p, g in zip(jp, gs))
        loss.backward()
        jo.step()
        jo.clear_grad()
        loss = sum((p.float() * torch.from_numpy(g)).sum()
                   for p, g in zip(tp, gs))
        loss.backward()
        to.step()
        to.clear_grad()
    return jo, to, jp, tp


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_fp32_params_match_jax_adamw(moment_dtype):
    jo, to, jp, tp = _run(moment_dtype, o2=False, master=None)
    assert to.t == 5
    for pj, pt in zip(jp, tp):
        want = np.asarray(pj._data)
        if moment_dtype == "float32":
            np.testing.assert_allclose(_np(pt), want, rtol=1e-6, atol=1e-9)
        else:
            np.testing.assert_allclose(_np(pt), want, rtol=0, atol=LR * 1e-3)
    if moment_dtype == "int8":
        for pj, pt in zip(jp, tp):
            for name in ("moment1", "moment2_sqrt"):
                got = to._accumulators[name][id(pt)].numpy().astype(int)
                want = np.asarray(jo._accumulators[name][id(pj)]._data)
                assert got.shape == want.shape
                assert np.abs(got - want.astype(int)).max() <= 1


def test_o2_fp32_masters_match_jax():
    jo, to, jp, tp = _run("float32", o2=True, master=None)
    for pj, pt in zip(jp, tp):
        assert pt.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(pt), np.asarray(pj._data, np.float32),
                                   rtol=2.0 ** -7, atol=0)
        master_t = to._master_weights[id(pt)]
        master_j = np.asarray(jo._master_weights[id(pj)]._data)
        assert master_t.dtype == torch.float32
        np.testing.assert_allclose(master_t.numpy(), master_j, rtol=1e-6,
                                   atol=1e-9)


def test_master_free_bf16_without_sr_matches_jax():
    jo, to, jp, tp = _run("float32", o2=True, master=False, sr=False)
    assert not to._master_weights
    for pj, pt in zip(jp, tp):
        assert pt.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(pt), np.asarray(pj._data, np.float32),
                                   rtol=2.0 ** -7, atol=0)


def test_clear_grad_and_default_weight_decay_on_every_parameter():
    _, tm = _models()
    params = list(tm.parameters())
    before = [p.detach().clone() for p in params]
    opt = AdamW(learning_rate=LR, parameters=params)
    assert opt._wd_coeff == 0.01
    # zero gradients: the Adam step is 0, only the decay moves a parameter
    sum((p * 0.0).sum() for p in params).backward()
    assert all(p.grad is not None for p in params)
    opt.step()
    opt.clear_grad()
    assert all(p.grad is None for p in params)
    decay = np.float32(1.0 - LR * 0.01)
    for p, b in zip(params, before):
        np.testing.assert_array_equal(_np(p), b.numpy() * decay)
    # no gradients: the counter advances, the parameters stay
    after = [p.detach().clone() for p in params]
    opt.step()
    assert opt.t == 2
    for p, a in zip(params, after):
        assert torch.equal(p.detach(), a)


def test_unported_options_raise():
    # only lazy_mode (SelectedRows gradients) is not ported: bf16 and fp16
    # moments now run, and match the JAX package's (here 5 steps of bf16
    # moments on the per-parameter path: moments within one bf16 ulp, fp32
    # parameters rtol 1e-6); a moment dtype the reference does not know
    # raises its TypeError. use_multi_tensor and grad_clip are ported
    # (tests/test_torch_multi_tensor_adam.py, tests/test_torch_grad_clip.py),
    # and so are parameter groups, lr_ratio and apply_decay_param_fun
    # (tests/test_torch_optimizer_groups.py)
    p = [torch.nn.Parameter(torch.zeros(4))]
    with pytest.raises(NotImplementedError):
        AdamW(parameters=p, lazy_mode=True)
    with pytest.raises(TypeError):
        AdamW(parameters=p, moment_dtype="bfloat")
    jo, to, jp, tp = _run("bfloat16", o2=False, master=None)
    for pj, pt in zip(jp, tp):
        np.testing.assert_allclose(_np(pt), np.asarray(pj._data), rtol=1e-6,
                                   atol=1e-9)
        for name in ("moment1", "moment2"):
            got = to._accumulators[name][id(pt)]
            want = np.asarray(jo._accumulators[name][id(pj)]._data,
                              np.float32)
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(got), want, rtol=2.0 ** -7,
                                       atol=0)
    p[0].param_name = "w"
    AdamW(parameters=[{"params": p, "learning_rate": 1.0}],
          apply_decay_param_fun=lambda n: True, lr_ratio=lambda q: 1.0)
