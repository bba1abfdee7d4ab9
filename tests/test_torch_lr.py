"""The port's LR schedulers (``paddle_tpu_torch.optimizer.lr``) against the
JAX package's (``paddle_tpu.optimizer.lr``): every one of the 18 classes,
built with the same arguments, gives the same ``last_lr`` over 30 steps, to
1e-12 relative (both are the same host Python in double precision). Also:
a bound optimizer's carried LR tensor follows ``step()``, and a
``LinearWarmup`` over ``PolynomialDecay`` (the ERNIE fine-tune schedule)
drives ``_lr_t`` with no retrace of anything."""

import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30


def _args(mod):
    """Constructor arguments of each scheduler, built with ``mod``'s
    classes where one wraps another."""
    return {
        "NoamDecay": dict(d_model=64, warmup_steps=5, learning_rate=2.0),
        "PiecewiseDecay": dict(boundaries=[5, 12, 20],
                               values=[0.1, 0.05, 0.01, 0.001]),
        "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.1),
        "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.2),
        "PolynomialDecay": dict(learning_rate=0.1, decay_steps=20,
                                end_lr=0.001, power=2.0, cycle=True),
        "LinearWarmup": dict(
            learning_rate=mod.PolynomialDecay(5e-5, 25, end_lr=0.0,
                                              power=1.0),
            warmup_steps=4, start_lr=0.0, end_lr=5e-5),
        "ExponentialDecay": dict(learning_rate=0.1, gamma=0.9),
        "MultiStepDecay": dict(learning_rate=0.1, milestones=[3, 9, 17],
                               gamma=0.5),
        "StepDecay": dict(learning_rate=0.1, step_size=7, gamma=0.3),
        "LambdaDecay": dict(learning_rate=0.1,
                            lr_lambda=lambda e: 0.95 ** e),
        "ReduceOnPlateau": dict(learning_rate=0.1, factor=0.5, patience=2,
                                cooldown=1),
        "CosineAnnealingDecay": dict(learning_rate=0.1, T_max=12,
                                     eta_min=0.001),
        "MultiplicativeDecay": dict(learning_rate=0.1,
                                    lr_lambda=lambda e: 0.9),
        "OneCycleLR": dict(max_learning_rate=0.1, total_steps=25,
                           anneal_strategy="cos", three_phase=False),
        "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.1,
                         step_size_up=4, step_size_down=6,
                         mode="triangular2"),
        "LinearLR": dict(learning_rate=0.1, total_steps=15,
                         start_factor=0.25, end_factor=1.0),
        "CosineAnnealingWarmRestarts": dict(learning_rate=0.1, T_0=5,
                                            T_mult=2, eta_min=0.001),
    }


NAMES = sorted(_args(jlr))


def _metric(i):
    # falls, then plateaus: ReduceOnPlateau cuts the LR after its patience
    return max(1.0 - 0.1 * i, 0.4)


def _trajectory(mod, name):
    s = getattr(mod, name)(**_args(mod)[name])
    out = [s()]
    for i in range(STEPS):
        if name == "ReduceOnPlateau":
            s.step(_metric(i))
        else:
            s.step()
        out.append(s.last_lr)
    return out


def test_every_reference_scheduler_is_ported():
    assert sorted(jlr.__all__) == sorted(tlr.__all__)
    assert set(NAMES) == set(jlr.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("name", NAMES)
def test_last_lr_matches_jax_over_30_steps(name):
    want = _trajectory(jlr, name)
    got = _trajectory(tlr, name)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert len(set(got)) > 1, f"{name} never moved over {STEPS} steps"


def test_scheduler_pushes_into_the_bound_optimizers_lr_tensor():
    sched = tlr.LinearWarmup(tlr.PolynomialDecay(5e-5, 10, end_lr=0.0),
                             warmup_steps=3, start_lr=0.0, end_lr=5e-5)
    p = torch.nn.Parameter(torch.zeros(8))
    opt = AdamW(learning_rate=sched, parameters=[p])
    seen = []
    for _ in range(12):
        assert opt.get_lr() == sched()
        seen.append(float(opt._lr_t))
        np.testing.assert_allclose(seen[-1], np.float32(sched()), rtol=0)
        sched.step()
    # warm-up from 0, then the linear decay
    assert seen[0] == 0.0 and seen[1] < seen[2] < seen[3]
    assert seen[3] > seen[5] > seen[-1]
    # the fp32 carried value is the host float rounded once
    assert opt._lr_t.dtype == torch.float32 and opt._lr_t.dim() == 0
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)


def test_reduce_on_plateau_moves_the_carried_lr():
    sched = tlr.ReduceOnPlateau(0.1, factor=0.5, patience=0)
    opt = AdamW(learning_rate=sched,
                parameters=[torch.nn.Parameter(torch.zeros(2))])
    for m in (1.0, 1.0, 1.0):
        sched.step(m)
    assert sched.last_lr < 0.1
    assert math.isclose(float(opt._lr_t), sched.last_lr, rel_tol=1e-7)


def test_set_lr_writes_the_carried_lr():
    opt = AdamW(learning_rate=0.1,
                parameters=[torch.nn.Parameter(torch.zeros(2))])
    assert float(opt._lr_t) == np.float32(0.1)
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25 and float(opt._lr_t) == 0.25
