"""The port's gradient clips (``ClipGradByValue``, ``ClipGradByNorm``,
``ClipGradByGlobalNorm``, also as ``paddle_tpu_torch.nn.ClipGradBy*``)
against the JAX package's on the same numpy gradients: rtol 1e-6 (the same
fp32 formulas; the norms' sums run in another order). A parameter with
``need_clip = False`` passes through, and an ``AdamW`` with
``grad_clip=`` takes the clipped gradients: 3 steps against the JAX
``AdamW`` with the same clip, rtol 1e-6."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Parameter
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt

SHAPES = [(16, 12), (12,), (7, 5, 3)]


def _grads(scale, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale, s).astype(np.float32) for s in SHAPES]


def _clip(mod, kind):
    return {"value": lambda: mod.ClipGradByValue(0.05, -0.03),
            "value_sym": lambda: mod.ClipGradByValue(0.02),
            "norm": lambda: mod.ClipGradByNorm(0.3),
            "global": lambda: mod.ClipGradByGlobalNorm(1.0)}[kind]()


@pytest.mark.parametrize("kind", ["value", "value_sym", "norm", "global"])
@pytest.mark.parametrize("scale", [0.01, 0.2])
def test_clip_matches_jax(kind, scale):
    grads = _grads(scale)
    ps = [types.SimpleNamespace() for _ in grads]
    want = _clip(jopt, kind)([(p, jnp.asarray(g)) for p, g in zip(ps, grads)])
    got = _clip(topt, kind)([(p, torch.from_numpy(g))
                             for p, g in zip(ps, grads)])
    for (pw, gw), (pg, gg) in zip(want, got):
        assert pw is pg
        np.testing.assert_allclose(gg.numpy(), np.asarray(gw), rtol=1e-6,
                                   atol=1e-9)


def test_global_norm_scale_is_clip_over_max_of_total_and_clip():
    grads = _grads(0.2)
    total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                        for g in grads))
    assert total > 1.0
    out = topt.ClipGradByGlobalNorm(1.0)(
        [(None, torch.from_numpy(g)) for g in grads])
    for (_, g), g0 in zip(out, grads):
        np.testing.assert_allclose(g.numpy(), g0 / total, rtol=1e-6)
    # under the norm nothing changes
    small = _grads(1e-4)
    out = topt.ClipGradByGlobalNorm(1.0)(
        [(None, torch.from_numpy(g)) for g in small])
    for (_, g), g0 in zip(out, small):
        np.testing.assert_array_equal(g.numpy(), g0)


def test_need_clip_false_and_missing_grads_pass_through():
    grads = _grads(0.2)
    frozen = types.SimpleNamespace(need_clip=False)
    pairs = [(frozen, torch.from_numpy(grads[0])), (None, None),
             (None, torch.from_numpy(grads[1]))]
    for kind in ("value", "norm", "global"):
        out = _clip(topt, kind)(pairs)
        assert out[0][1] is pairs[0][1] and out[1][1] is None


def test_clips_are_reexported_from_nn_and_keep_dtype():
    assert tnn.ClipGradByGlobalNorm is topt.ClipGradByGlobalNorm
    assert tnn.ClipGradByNorm is topt.ClipGradByNorm
    assert tnn.ClipGradByValue is topt.ClipGradByValue
    g = torch.from_numpy(_grads(0.5)[0]).to(torch.bfloat16)
    for kind in ("value", "norm", "global"):
        (_, out), = _clip(topt, kind)([(None, g)])
        assert out.dtype == torch.bfloat16 and out.shape == g.shape


@pytest.mark.parametrize("kind", ["value", "norm", "global"])
def test_adamw_applies_the_clip_like_jax(kind):
    init = [np.random.default_rng(5 + i).normal(0, 0.1, s).astype(np.float32)
            for i, s in enumerate(SHAPES)]
    jps = [Parameter(jnp.asarray(x)) for x in init]
    tps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    jo = jopt.AdamW(learning_rate=1e-2, parameters=jps,
                    grad_clip=_clip(jopt, kind))
    to = topt.AdamW(learning_rate=1e-2, parameters=tps,
                    grad_clip=_clip(topt, kind))
    for step in range(3):
        grads = _grads(0.2, seed=10 + step)
        for p, g in zip(jps, grads):
            p.grad = paddle.to_tensor(g)
        for p, g in zip(tps, grads):
            p.grad = torch.from_numpy(g)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    for pj, pt in zip(jps, tps):
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj._data),
                                   rtol=1e-6, atol=1e-8)
