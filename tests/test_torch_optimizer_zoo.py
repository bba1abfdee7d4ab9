"""The port's optimizers beyond ``Adam``/``AdamW`` (plain PyTorch on the
CPU) against the JAX package's, on the same parameters and gradients:
``SGD``, ``Momentum`` (with and without Nesterov), ``Adamax``,
``Adagrad``, ``Adadelta``, ``RMSProp`` (plain and centered with
momentum), ``Lamb`` (with ``exclude_from_weight_decay_fn``), ``LBFGS``
(with and without a closure), ``Rprop``, ``ASGD`` (a history of 3),
``NAdam`` and ``RAdam`` (its rectified branch reached at step 6), over 6
steps; fp32 parameters and AMP O2 bf16 ones (``SGD`` and ``Momentum`` with
fp32 masters and master-free). Also a parameter's ``regularizer``
(``L1Decay``, ``L2Decay``; over ``AdamW`` too), the optimizer-level
``weight_decay=L1Decay(c)`` quirk (the L2 form, as in the JAX package), a
parameter that does not require a gradient, ``minimize``,
``clear_gradients``, ``set_dict``, the legacy int8 checkpoint's
conversion and the exported names.

Tolerances: fp32 parameters and accumulators rtol 1e-6 (the same fp32
formulas; XLA and PyTorch differ in the last bit of a few elementwise
results, ``pow`` and the norms' sums among them); bf16 parameters within
one bf16 ulp (2^-7 relative) of the JAX package's, fp32 masters rtol 1e-6.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import amp, regularizer
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.ops import q8_adam

torch.set_num_threads(2)

SHAPES = [(64, 48), (48, 10)]
STEPS = 6
RTOL, ATOL = 1e-6, 1e-8
BF16_ULP = 2.0 ** -7

# name -> (class name, constructor arguments, learning rate)
CASES = {
    "SGD": ("SGD", {}, 0.1),
    "Momentum": ("Momentum", dict(momentum=0.9), 0.05),
    "Momentum_nesterov": ("Momentum", dict(momentum=0.9, use_nesterov=True),
                          0.05),
    "Adamax": ("Adamax", {}, 1e-2),
    "Adagrad": ("Adagrad", dict(initial_accumulator_value=0.1), 1e-2),
    "Adadelta": ("Adadelta", dict(rho=0.9), 1.0),
    "RMSProp": ("RMSProp", {}, 1e-3),
    "RMSProp_centered": ("RMSProp", dict(centered=True, momentum=0.5), 1e-3),
    "Lamb": ("Lamb", dict(exclude_from_weight_decay_fn=lambda p:
                          len(p.shape) == 1), 1e-2),
    "LBFGS": ("LBFGS", dict(max_iter=3), 0.05),
    "Rprop": ("Rprop", dict(learning_rate_range=(1e-4, 0.05)), 1e-2),
    "ASGD": ("ASGD", dict(batch_num=3), 0.05),
    "NAdam": ("NAdam", {}, 1e-2),
    "RAdam": ("RAdam", dict(beta2=0.9), 1e-2),
}
# accumulators held beside the parameters (the JAX package's names)
ACCS = {"SGD": (), "Momentum": ("velocity",), "Adamax": ("moment",
                                                         "inf_norm"),
        "Adagrad": ("moment",), "Adadelta": ("avg_squared_grad",
                                             "avg_squared_update"),
        "RMSProp": ("mean_square", "momentum"), "Lamb": ("moment1",
                                                         "moment2"),
        "LBFGS": (), "Rprop": ("prev_grad", "step_size"),
        "ASGD": ("d", "grad_hist"), "NAdam": ("moment1", "moment2",
                                              "mu_product"),
        "RAdam": ("moment1", "moment2")}


def _models(seed=3):
    paddle.seed(seed)
    jm = paddle.nn.LayerList([paddle.nn.Linear(i, o) for i, o in SHAPES])
    tm = torch.nn.ModuleList([Linear(i, o, device="cpu") for i, o in SHAPES])
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for jl, tl in zip(jm, tm):
            tl.weight.copy_(torch.from_numpy(np.array(jl.weight._data)))
            tl.bias.copy_(torch.from_numpy(
                rng.normal(0, 0.1, tl.bias.shape).astype(np.float32)))
            # a copy: jnp.asarray may alias the numpy view of the torch
            # tensor, which the port's in-place step then writes under the
            # JAX package's asynchronous dispatch
            jl.bias._set_data(jnp.asarray(tl.bias.numpy().copy()))
    return jm, tm


def _grads(step):
    rng = np.random.default_rng(100 + step)
    out = []
    for i, o in SHAPES:
        out += [rng.normal(0, 0.05, (i, o)).astype(np.float32),
                rng.normal(0, 0.05, (o,)).astype(np.float32)]
    # a sign that flips between steps (Rprop's shrinking branch)
    out[1] *= (-1) ** step
    return out


def _set_grads(jp, tp, gs):
    """Both packages' parameters get the gradients ``gs`` in their own
    dtype, as the backward of ``sum(p.float() * g)`` gives them."""
    from paddle_tpu.core.tensor import Tensor
    # each package its own copy of the gradients: a zero-copy view would
    # share the numpy memory between the two
    for pj, g in zip(jp, gs):
        pj.grad = Tensor(jnp.array(g, copy=True).astype(pj._data.dtype),
                         stop_gradient=True)
    for pt, g in zip(tp, gs):
        pt.grad = torch.from_numpy(g.copy()).to(pt.dtype)


def _np32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(getattr(t, "_data", t), np.float32)


def _build(case, o2=False, master=None, sr=True):
    cls, kw, lr = CASES[case]
    jm, tm = _models()
    jo = getattr(jopt, cls)(learning_rate=lr, parameters=jm.parameters(),
                            **kw)
    to = getattr(topt, cls)(learning_rate=lr, parameters=tm.parameters(),
                            **kw)
    if o2:
        jm, jo = paddle.amp.decorate(jm, jo, level="O2", dtype="bfloat16",
                                     master_weight=master)
        tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16",
                              master_weight=master)
    jo._stochastic_rounding = to._stochastic_rounding = sr
    return jo, to, list(jm.parameters()), list(tm.parameters())


def _run(case, o2=False, master=None, steps=STEPS):
    jo, to, jp, tp = _build(case, o2, master, sr=False)
    for s in range(steps):
        gs = _grads(s)
        if case == "LBFGS" and s % 2:   # with a closure every other step
            def closure(ps, mk):
                return lambda: _closure_loss(ps, gs, mk)
            jo.step(closure(jp, "jax"))
            to.step(closure(tp, "torch"))
        else:
            _set_grads(jp, tp, gs)
            jo.step()
            to.step()
        jo.clear_grad()
        to.clear_grad()
    return jo, to, jp, tp


def _closure_loss(ps, gs, kind):
    from paddle_tpu.core.tensor import Tensor
    for p, g in zip(ps, gs):
        if kind == "jax":
            p.grad = Tensor(jnp.array(g, copy=True).astype(p._data.dtype),
                            stop_gradient=True)
        else:
            p.grad = torch.from_numpy(g.copy()).to(p.dtype)
    return sum(float((_np32(p) * g).sum()) for p, g in zip(ps, gs))


def _check_params(jp, tp, o2):
    for pj, pt in zip(jp, tp):
        want, got = _np32(pj), _np32(pt)
        if o2:
            assert pt.dtype == torch.bfloat16
            np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-30)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _check_accs(case, jo, to, jp, tp):
    cls = CASES[case][0]
    for name in ACCS[cls]:
        for pj, pt in zip(jp, tp):
            got = to._accumulators[name][id(pt)]
            want = jo._accumulators[name][id(pj)]._data
            assert got.dtype == torch.float32 and tuple(got.shape) == \
                tuple(want.shape), name
            np.testing.assert_allclose(_np32(got), _np32(want), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_fp32(case):
    jo, to, jp, tp = _run(case)
    _check_params(jp, tp, o2=False)
    _check_accs(case, jo, to, jp, tp)
    if case != "LBFGS":
        assert to.t == STEPS == int(jo._step_t._data)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_o2_bf16(case):
    jo, to, jp, tp = _run(case, o2=True)
    _check_params(jp, tp, o2=True)
    cls = CASES[case][0]
    if cls in ("SGD", "Momentum"):   # fp32 masters, as the JAX package
        for pj, pt in zip(jp, tp):
            np.testing.assert_allclose(
                _np32(to._master_weights[id(pt)]),
                _np32(jo._master_weights[id(pj)]), rtol=RTOL, atol=ATOL)
    elif cls != "LBFGS":   # no masters: cast back to nearest
        assert not to._master_weights


@pytest.mark.parametrize("case", ["SGD", "Momentum", "Momentum_nesterov"])
def test_master_free_without_sr_matches_jax(case):
    jo, to, jp, tp = _run(case, o2=True, master=False)
    assert not to._master_weights and not jo._master_weights
    _check_params(jp, tp, o2=True)


def test_master_free_sgd_rounds_stochastically():
    # a sub-ulp SGD step on a bf16 parameter moves it only by stochastic
    # rounding: about lr * g * steps in all
    w = torch.nn.Parameter(torch.ones(4096, dtype=torch.bfloat16))
    opt = topt.SGD(learning_rate=1.0, parameters=[w])
    opt._use_master_weights = False
    for _ in range(8):
        w.grad = torch.full_like(w, 1e-4)
        opt.step()
    assert abs(float(w.float().mean()) - (1.0 - 8e-4)) < 2e-4
    opt._stochastic_rounding = False
    w.grad = torch.full_like(w, 1e-4)
    before = w.detach().clone()
    opt.step()
    assert torch.equal(w.detach(), before)


def test_exports_every_name_of_the_jax_package():
    assert set(jopt.__all__) <= set(topt.__all__)
    for name in jopt.__all__:
        assert hasattr(topt, name), name
    assert set(regularizer.__all__) == {"L1Decay", "L2Decay"}
    assert topt.L1Decay is regularizer.L1Decay


@pytest.mark.parametrize("opt,kind", [("SGD", "l1"), ("SGD", "l2"),
                                      ("AdamW", "l1"), ("Adam", "l2"),
                                      ("Momentum", "l2")])
def test_parameter_regularizer_matches_jax(opt, kind):
    # a parameter's own regularizer wins over the optimizer's weight_decay
    # and applies under AdamW too
    jm, tm = _models()
    jp, tp = list(jm.parameters()), list(tm.parameters())
    for i in (0, 3):
        cls = "L1Decay" if kind == "l1" else "L2Decay"
        jp[i].regularizer = getattr(jopt, cls)(0.05)
        tp[i].regularizer = getattr(regularizer, cls)(0.05)
    kw = dict(learning_rate=1e-2, weight_decay=1e-3)
    jo = getattr(jopt, opt)(parameters=jp, **kw)
    to = getattr(topt, opt)(parameters=tp, **kw)
    for s in range(4):
        _set_grads(jp, tp, _grads(s))
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    _check_params(jp, tp, o2=False)


def test_optimizer_level_l1decay_adds_the_l2_form():
    # the JAX package's quirk, ported as it is: weight_decay=L1Decay(c) on
    # the optimizer adds c * p, as L2Decay(c) does
    out = []
    for wd in (topt.L1Decay(0.1), topt.L2Decay(0.1), 0.1):
        _, tm = _models()
        tp = list(tm.parameters())
        to = topt.SGD(learning_rate=0.5, parameters=tp, weight_decay=wd)
        (tp[0] * 0.0).sum().backward()
        to.step()
        out.append(tp[0].detach().clone())
    assert torch.equal(out[0], out[1]) and torch.equal(out[1], out[2])
    jm, tm = _models()
    jo = jopt.SGD(learning_rate=0.5, parameters=jm.parameters(),
                  weight_decay=jopt.L1Decay(0.1))
    (list(jm.parameters())[0] * 0.0).sum().backward()
    jo.step()
    np.testing.assert_allclose(out[0].numpy(),
                               _np32(list(jm.parameters())[0]), rtol=RTOL)


def test_untrainable_parameter_is_skipped_as_in_jax():
    for cls, kw in (("SGD", {}), ("AdamW", dict(use_multi_tensor=True)),
                    ("RMSProp", {})):
        jm, tm = _models()
        jp, tp = list(jm.parameters()), list(tm.parameters())
        jo = getattr(jopt, cls)(learning_rate=1e-2, parameters=jp, **kw)
        to = getattr(topt, cls)(learning_rate=1e-2, parameters=tp, **kw)
        before = tp[1].detach().clone()
        _set_grads(jp, tp, _grads(0))
        jp[1].trainable = False
        tp[1].requires_grad_(False)
        jo.step()
        to.step()
        assert torch.equal(tp[1].detach(), before), cls
        _check_params(jp, tp, o2=False)


def test_minimize_clear_gradients_and_set_dict():
    jm, tm = _models()
    jp, tp = list(jm.parameters()), list(tm.parameters())
    for pj, pt in zip(jp, tp):   # the state's keys: the JAX names
        pt.param_name = pj.name
    jo = jopt.Momentum(learning_rate=0.05, parameters=jp)
    to = topt.Momentum(learning_rate=0.05, parameters=tp)
    gs = _grads(0)
    # the port's minimize (backward, then step) against the JAX package's
    # step on the same gradients (sum(p * g)'s gradient is g)
    tl = sum((p * torch.from_numpy(g)).sum() for p, g in zip(tp, gs))
    assert to.minimize(tl) == (None, None)
    _set_grads(jp, [], gs)
    jo.step()
    _check_params(jp, tp, o2=False)
    assert all(p.grad is not None for p in tp)
    to.clear_gradients()
    assert all(p.grad is None for p in tp)
    # set_dict is set_state_dict: a state of the JAX package loads
    fresh = topt.Momentum(learning_rate=0.05, parameters=tp)
    fresh.set_dict({k: np.asarray(v._data) for k, v in
                    jo.state_dict().items()})
    assert fresh.t == 1
    np.testing.assert_allclose(
        fresh._accumulators["velocity"][id(tp[0])].numpy(),
        _np32(jo._accumulators["velocity"][id(jp[0])]), rtol=RTOL)


def test_legacy_int8_checkpoint_converts_as_in_jax():
    # an int8 checkpoint with linear-v moment2 codes and scales loads into
    # the sqrt layout with the JAX package's warning and codes
    p = torch.nn.Parameter(torch.zeros(3000))
    to = topt.AdamW(parameters=[p], moment_dtype="int8")
    rng = np.random.default_rng(0)
    v = np.abs(rng.normal(0, 1e-4, 3000)).astype(np.float32)
    vq, vs = q8_adam.q8_quantize(torch.from_numpy(v))
    mq, ms = q8_adam.q8_quantize(torch.from_numpy(v * 0.0))
    name = to._name(0)
    state = {"step": np.asarray(3, np.int32),
             f"{name}_moment1": mq.numpy(), f"{name}_moment1_scale":
             ms.numpy(), f"{name}_moment2": vq.numpy(),
             f"{name}_moment2_scale": vs.numpy()}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        to.set_state_dict(state)
    assert any("legacy int8 moment2" in str(w.message) for w in rec)
    got_q = to._accumulators["moment2_sqrt"][id(p)]
    got_s = to._accumulators["moment2_sqrt_scale"][id(p)]
    want_q, want_s = jopt._q8_quantize(jnp.sqrt(jnp.maximum(
        jnp.asarray(vq.numpy()).astype(jnp.float32)
        * jnp.asarray(vs.numpy())[:, None], 0.0)).reshape(-1))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL)
    assert to.t == 3
    # a state in the current layout loads with no warning
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        to.set_state_dict(to.state_dict())
    assert not any("legacy" in str(w.message) for w in rec)
