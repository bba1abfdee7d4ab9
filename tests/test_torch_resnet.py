"""The port's ``vision.models`` ResNets against ``paddle_tpu.vision.models``
on the CPU, weights carried across by ``convert.load_resnet_state_dict``,
inputs from a seeded numpy generator.

``resnet50(num_classes=10)`` at 2 x 3 x 64 x 64 in fp32, every block's
last BN weight scaled by 0.1 in both packages before the run (at the
default initialization a random ResNet-50 at batch 2 is chaotic: the
port's own fp32 gradients differ from its fp64 ones by up to half of a
gradient's largest element, so no tolerance could hold two correct runs;
at 32 x 32, layer 4's BNs normalise 2 elements a channel and flip signs on
rounding). Held: the 267 state-dict keys, the logits and the loss (rtol
1e-5), every gradient (1e-4 of its largest element), the BN buffers after
the training forward (rtol 1e-5), the parameters after one
``Momentum(0.1, 0.9)`` step (rtol 1e-5), the eval-mode logits on the
running buffers (1e-4 of their largest); one AMP O2 bf16 forward and
backward (loss rtol 1e-2: bf16 convolutions round at other points in XLA
and oneDNN; the BN buffers rtol 1e-2 plus 2e-2 of each buffer's largest
element, the statistics of bf16 activations; each bf16 gradient as close to the
JAX fp32 gradient as the JAX package's own O2 gradient is, see the test);
``resnet18`` (``BasicBlock``)
forward and gradients; ``paddle.flops`` equal to the JAX counter's.
"""

import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flops as jflops
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import amp, flops
from paddle_tpu_torch.convert import load_resnet_state_dict
from paddle_tpu_torch.ops.loss_ops import cross_entropy
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models

SHAPE, CLASSES, LR, MOM = (2, 3, 64, 64), 10, 0.1, 0.9


def _damped_pair(name, last_bn):
    """A JAX model and the port's with one state: the JAX model's own
    initialization, each block's ``last_bn`` weight times 0.1."""
    paddle.seed(0)
    jm = getattr(jmodels, name)(num_classes=CLASSES)
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    for k in sd:
        if re.fullmatch(rf"layer\d\.\d+\.{last_bn}\.weight", k):
            sd[k] = sd[k] * np.float32(0.1)
    jm.set_state_dict(sd)
    tm = getattr(models, name)(num_classes=CLASSES, device="cpu", seed=0)
    load_resnet_state_dict(tm, sd)
    return jm, tm, sd


def _batch(seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal(SHAPE).astype(np.float32),
            r.integers(0, CLASSES, SHAPE[0]).astype(np.int64))


def _jgrads(jm):
    return {k: np.asarray(p.grad._data, np.float32)
            for k, p in jm.named_parameters()}


def _buffers(sd):
    return {k: np.asarray(v._data if hasattr(v, "_data") else v.numpy(),
                          np.float32)
            for k, v in sd.items() if k.endswith(("_mean", "_variance"))}


@pytest.fixture(scope="module")
def r50():
    """One fp32 training forward and backward, one Momentum step and an
    eval forward in each package."""
    jm, tm, sd = _damped_pair("resnet50", "bn3")
    x, y = _batch(1)
    out = {"keys": (sorted(sd), sorted(tm.state_dict()))}
    jlogits = jm(paddle.to_tensor(x))
    jloss = paddle.nn.functional.cross_entropy(jlogits, paddle.to_tensor(y))
    jloss.backward()
    tlogits = tm(torch.from_numpy(x))
    tloss = cross_entropy(tlogits, torch.from_numpy(y))
    tloss.backward()
    out.update(
        logits=(tlogits.detach().numpy(), np.asarray(jlogits._data)),
        loss=(float(tloss.detach()), float(jloss)),
        grads=({k: p.grad.numpy() for k, p in tm.named_parameters()},
               _jgrads(jm)),
        buffers=(_buffers(tm.state_dict()), _buffers(jm.state_dict())))
    paddle.optimizer.Momentum(learning_rate=LR, momentum=MOM,
                              parameters=jm.parameters()).step()
    Momentum(learning_rate=LR, momentum=MOM,
             parameters=tm.parameters()).step()
    out["params"] = ({k: p.detach().numpy().copy()
                      for k, p in tm.named_parameters()},
                     {k: np.asarray(p._data)
                      for k, p in jm.named_parameters()})
    jm.eval()
    tm.eval()
    with torch.no_grad():
        out["eval_logits"] = (tm(torch.from_numpy(x)).numpy(),
                              np.asarray(jm(paddle.to_tensor(x))._data))
    return out


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def test_state_dict_keys_equal_jax(r50):
    got, want = r50["keys"]
    assert got == want and len(got) == 267
    assert sum(k.endswith(("_mean", "_variance")) for k in got) == 2 * 53


def test_logits_and_loss_match_jax(r50):
    got, want = r50["logits"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(
        np.abs(want).max()))
    lt, lj = r50["loss"]
    assert abs(lt - lj) <= 1e-5 * abs(lj)


def test_every_gradient_matches_jax(r50):
    got, want = r50["grads"]
    assert set(got) == set(want)
    worst = max((_rel(got[k], want[k]), k) for k in want)
    assert worst[0] < 1e-4, worst


def test_bn_buffers_after_one_training_forward(r50):
    got, want = r50["buffers"]
    assert set(got) == set(want) and len(got) == 106
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_momentum_step_matches_jax(r50):
    got, want = r50["params"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_eval_mode_uses_the_running_buffers(r50):
    got, want = r50["eval_logits"]
    assert _rel(got, want) < 1e-4


def test_o2_bf16_step_tracks_jax(r50):
    """The port's O2 gradients are as close to the JAX package's fp32 ones
    as the JAX package's own O2 gradients are. At batch 2 both O2 steps sit
    far from the fp32 gradient (bf16 through 50 layers: a median 0.34 of
    each gradient's largest element, 0.22 of the whole gradient's L2 norm;
    single elements up to 0.96 in either package), so the bounds are on
    those distances: the whole gradient's relative L2 distance at most 1.25
    times the JAX package's, the median of the per-leaf distances at most
    1.25 times its median, and every leaf's cosine with the fp32 gradient
    at least 0.85 (measured 0.93; a zeroed, negated or misplaced gradient
    falls far below)."""
    jm, tm, _ = _damped_pair("resnet50", "bn3")
    paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    amp.decorate(tm, level="O2", dtype="bfloat16")
    x, y = _batch(1)
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        lj = paddle.nn.functional.cross_entropy(jm(paddle.to_tensor(x)),
                                                paddle.to_tensor(y))
    lj.backward()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        lt = cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    lt.backward()
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-2)
    fp32, jo2 = r50["grads"][1], _jgrads(jm)
    to2 = {}
    for k, p in tm.named_parameters():
        assert p.dtype == p.grad.dtype == torch.bfloat16, k
        to2[k] = p.grad.float().numpy()

    def l2(a):
        return float(np.sqrt(sum(np.square(a[k] - fp32[k]).sum()
                                 for k in fp32)
                             / sum(np.square(v).sum() for v in fp32.values())))
    assert l2(to2) <= 1.25 * l2(jo2)
    assert np.median([_rel(to2[k], fp32[k]) for k in fp32]) <= 1.25 * \
        np.median([_rel(jo2[k], fp32[k]) for k in fp32])
    for k, g in fp32.items():
        cos = float((to2[k] * g).sum()) / float(
            np.sqrt(np.square(to2[k]).sum() * np.square(g).sum()))
        assert cos >= 0.85, (k, cos)
    bufs_t, bufs_j = _buffers(tm.state_dict()), _buffers(jm.state_dict())
    for k in bufs_j:
        assert tm.state_dict()[k].dtype == torch.float32
        np.testing.assert_allclose(bufs_t[k], bufs_j[k], rtol=1e-2,
                                   atol=2e-2 * np.abs(bufs_j[k]).max(),
                                   err_msg=k)


def test_resnet18_basic_block_matches_jax():
    jm, tm, sd = _damped_pair("resnet18", "bn2")
    assert sorted(sd) == sorted(tm.state_dict())
    x, y = _batch(3)
    jl = paddle.nn.functional.cross_entropy(jm(paddle.to_tensor(x)),
                                            paddle.to_tensor(y))
    jl.backward()
    tl = cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    want = _jgrads(jm)
    worst = max((_rel(p.grad.numpy(), want[k]), k)
                for k, p in tm.named_parameters())
    assert worst[0] < 1e-4, worst


def test_flops_equal_the_jax_counter():
    paddle.seed(0)
    jm = jmodels.resnet50(num_classes=CLASSES)
    tm = models.resnet50(num_classes=CLASSES, device="cpu", seed=0)
    size = [1, 3, 64, 64]
    assert flops(tm, size) == jflops(jm, size)
    assert tm.training


def test_constructors_and_carrier_refuse_what_they_cannot_do():
    with pytest.raises(ValueError, match="pretrained"):
        models.resnet18(pretrained=True, device="cpu")
    tm = models.resnet18(num_classes=CLASSES, device="cpu", seed=0)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    sd["extra.weight"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="extra"):
        load_resnet_state_dict(tm, sd)
    del sd["extra.weight"]
    sd["fc.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_resnet_state_dict(tm, sd)


@pytest.mark.parametrize("name", ["resnet34", "resnet101", "resnet152",
                                  "wide_resnet50_2", "wide_resnet101_2",
                                  "resnext50_32x4d", "resnext50_64x4d",
                                  "resnext101_32x4d", "resnext101_64x4d",
                                  "resnext152_32x4d", "resnext152_64x4d"])
def test_every_constructor_builds_the_jax_layout(name):
    paddle.seed(0)
    want = {k: tuple(v.shape) for k, v in
            getattr(jmodels, name)(num_classes=CLASSES).state_dict().items()}
    tm = getattr(models, name)(num_classes=CLASSES, device="cpu", seed=0)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
