"""The port's loss ops (``paddle_tpu_torch/ops/loss_ops.py``) against the JAX
package's (``paddle_tpu/ops/loss_ops.py``) on the CPU: the same numpy
inputs from a seed, the loss and the gradient of every differentiable
input, fp32 within rtol 1e-5 / atol 1e-6 (NaN where JAX gives NaN).

The CPU path of ``cross_entropy`` over hard labels on the last axis is the
plain version of the K4 kernel (``ops/softmax_cross_entropy.py``), so the
label-smoothing, class-weight and reduction forms of that plain version are
held against ``jax.grad`` here; its autograd function is driven with the
launches replaced by the plain version. Labels outside the vocabulary
(-100 under the default ``ignore_index=-100``, -1, V, V + 7) score as the
JAX package's one-hot scores them: a zero target, a row that still counts.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.ops import loss_ops as J
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import loss_ops as T
from paddle_tpu_torch.ops import softmax_cross_entropy as ce

RTOL, ATOL = 1e-5, 1e-6
V = 10


def _close(got, want):
    torch.testing.assert_close(got.detach().float(),
                               torch.as_tensor(np.array(want)).float(),
                               rtol=RTOL, atol=ATOL, equal_nan=True)


def _jax_run(fn, arrays, grads, cot=None, **kw):
    """``fn`` on JAX tensors: the result and the gradients of the inputs
    named in ``grads`` (of ``sum(result * cot)`` when the result is not a
    scalar)."""
    ts = [None if a is None else paddle.to_tensor(
        a, stop_gradient=i not in grads) for i, a in enumerate(arrays)]
    out = fn(*ts, **kw)
    red = out if cot is None else (out * paddle.to_tensor(cot)).sum()
    red.backward()
    return (np.asarray(out._data),
            [np.asarray(ts[i].grad._data) for i in grads])


def _torch_run(fn, arrays, grads, cot=None, **kw):
    ts = [None if a is None else torch.tensor(a).requires_grad_(
        i in grads) for i, a in enumerate(arrays)]
    out = fn(*ts, **kw)
    red = out if cot is None else (out * torch.tensor(cot)).sum()
    gs = torch.autograd.grad(red, [ts[i] for i in grads])
    return out, list(gs)


def _check(jfn, tfn, arrays, grads, cot_shape=None, seed=3, **kw):
    cot = None if cot_shape is None else np.random.default_rng(seed) \
        .standard_normal(cot_shape).astype(np.float32)
    want, wg = _jax_run(jfn, arrays, grads, cot, **kw)
    got, tg = _torch_run(tfn, arrays, grads, cot, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    for a, b in zip(tg, wg):
        _close(a, b)


def _logits(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 2) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# the repair: labels outside the vocabulary


def test_out_of_vocabulary_label_scores_zero_as_in_jax():
    """The case that raised on the port (``index -100 is out of bounds``):
    logits (4, 10) from default_rng(0), labels [1, -100, 3, 12]."""
    x = np.random.default_rng(0).standard_normal((4, 10)).astype(np.float32)
    lab = np.array([1, -100, 3, 12])
    _check(J.cross_entropy, T.cross_entropy, [x, lab], [0])
    got = T.cross_entropy(torch.tensor(x), torch.tensor(lab))
    assert abs(float(got) - 1.2486007) < 1e-6


@pytest.mark.parametrize("ignore_index", [-100, 0])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_labels_outside_the_vocabulary(ignore_index, smoothing, reduction):
    x = _logits((8, V), 1)
    lab = np.array([-100, -1, V, V + 7, 0, 3, 9, 0])
    _check(J.cross_entropy, T.cross_entropy, [x, lab], [0],
           cot_shape=(8,) if reduction == "none" else None,
           ignore_index=ignore_index, label_smoothing=smoothing,
           reduction=reduction)


def test_out_of_vocabulary_rows_count_in_the_mean():
    x = torch.tensor(_logits((4, V), 2))
    lab = torch.tensor([-100, 2, V + 7, 5])
    rows = ce.softmax_cross_entropy_reference(x, lab, reduction="none")
    assert rows[0] == 0 and rows[2] == 0
    mean = ce.softmax_cross_entropy_reference(x, lab)
    torch.testing.assert_close(mean, rows.sum() / 4)


# ---------------------------------------------------------------------------
# cross_entropy over its arguments


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("ignore_index", [-100, 2])
def test_cross_entropy_hard_labels(weighted, smoothing, reduction,
                                   ignore_index):
    rng = np.random.default_rng(4)
    x = _logits((3, 5, V), 4)
    lab = rng.integers(0, V, (3, 5))
    lab[0, :2] = 2
    w = rng.uniform(0.5, 2.0, (V,)).astype(np.float32) if weighted else None
    _check(lambda a, b, c, **k: J.cross_entropy(a, b, weight=c, **k),
           lambda a, b, c, **k: T.cross_entropy(a, b, weight=c, **k),
           [x, lab, w], [0] + ([2] if weighted else []),
           cot_shape=(3, 5) if reduction == "none" else None,
           ignore_index=ignore_index, label_smoothing=smoothing,
           reduction=reduction)


@pytest.mark.parametrize("ignore_index", [-100, 0])
def test_cross_entropy_weight_with_out_of_range_labels(ignore_index):
    """``jnp.take`` of the weight: -1 wraps to the last class, -100, V and
    V + 7 read NaN; the rows ignored at ``ignore_index=0`` score 0."""
    x = _logits((6, V), 5)
    lab = np.array([-1, -100, V, 0, 4, V + 7])
    w = np.linspace(0.5, 1.5, V).astype(np.float32)
    _check(lambda a, b, c, **k: J.cross_entropy(a, b, weight=c, **k),
           lambda a, b, c, **k: T.cross_entropy(a, b, weight=c, **k),
           [x, lab, w], [0], cot_shape=(6,), ignore_index=ignore_index,
           reduction="none", label_smoothing=0.1)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_cross_entropy_soft_labels(weighted, smoothing):
    rng = np.random.default_rng(6)
    x = _logits((4, 6, V), 6)
    y = rng.dirichlet(np.ones(V), (4, 6)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (V,)).astype(np.float32) if weighted else None
    _check(lambda a, b, c, **k: J.cross_entropy(a, b, weight=c, **k),
           lambda a, b, c, **k: T.cross_entropy(a, b, weight=c, **k),
           [x, y, w], [0, 1], soft_label=True, label_smoothing=smoothing)


@pytest.mark.parametrize("trailing_one", [False, True])
def test_cross_entropy_on_another_axis(trailing_one):
    rng = np.random.default_rng(7)
    x = _logits((3, V, 5), 7)
    lab = rng.integers(0, V, (3, 1, 5) if trailing_one else (3, 5))
    _check(J.cross_entropy, T.cross_entropy, [x, lab], [0], axis=1,
           ignore_index=1, label_smoothing=0.1)


def test_cross_entropy_without_softmax():
    rng = np.random.default_rng(8)
    p = rng.dirichlet(np.ones(V), (7,)).astype(np.float32)
    lab = rng.integers(0, V, (7, 1))
    _check(J.cross_entropy, T.cross_entropy, [p, lab], [0],
           use_softmax=False, reduction="sum")


def test_cross_entropy_under_o2_bf16():
    """Logits and weights cast to fp32 as the JAX op's are (black list)."""
    rng = np.random.default_rng(9)
    x = torch.tensor(_logits((6, V), 9)).bfloat16()
    lab = rng.integers(0, V, (6,))
    w = rng.uniform(0.5, 2.0, (V,)).astype(np.float32)
    xj = paddle.to_tensor(x.float().numpy()).astype("bfloat16")
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        want = J.cross_entropy(xj, paddle.to_tensor(lab),
                               weight=paddle.to_tensor(w),
                               label_smoothing=0.1)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        got = T.cross_entropy(x, torch.tensor(lab), weight=torch.tensor(w),
                              label_smoothing=0.1)
    assert got.dtype == torch.float32
    _close(got, want._data)


def test_softmax_with_cross_entropy():
    rng = np.random.default_rng(10)
    x = _logits((5, V), 10)
    lab = rng.integers(0, V, (5, 1))
    _check(J.softmax_with_cross_entropy, T.softmax_with_cross_entropy,
           [x, lab], [0], cot_shape=(5, 1))
    loss, sm = T.softmax_with_cross_entropy(torch.tensor(x),
                                            torch.tensor(lab),
                                            return_softmax=True)
    jl, js = J.softmax_with_cross_entropy(paddle.to_tensor(x),
                                          paddle.to_tensor(lab),
                                          return_softmax=True)
    _close(loss, jl._data)
    _close(sm, js._data)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ignore_index", [-100, 3])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_nll_loss(weighted, ignore_index, reduction):
    rng = np.random.default_rng(11)
    logp = np.log(rng.dirichlet(np.ones(V), (8,))).astype(np.float32)
    lab = rng.integers(0, V, (8,))
    lab[:2] = 3
    lab[2] = -1          # wraps in jnp.take_along_axis
    w = rng.uniform(0.5, 2.0, (V,)).astype(np.float32) if weighted else None
    _check(lambda a, b, c, **k: J.nll_loss(a, b, weight=c, **k),
           lambda a, b, c, **k: T.nll_loss(a, b, weight=c, **k),
           [logp, lab, w], [0], cot_shape=(8,) if reduction == "none"
           else None, ignore_index=ignore_index, reduction=reduction)


def test_nll_loss_label_outside_the_table_reads_nan():
    logp = np.log(np.full((3, V), 1.0 / V, np.float32))
    lab = np.array([1, V, -V - 1])
    _check(J.nll_loss, T.nll_loss, [logp, lab], [0], cot_shape=(3,),
           reduction="none")


# ---------------------------------------------------------------------------
# the regression and pairwise losses


def _pair(seed, shape=(4, 6)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "smooth_l1_loss"])
def test_regression_losses(name, reduction):
    a, b = _pair(12)
    _check(getattr(J, name), getattr(T, name), [a, b], [0, 1],
           cot_shape=a.shape if reduction == "none" else None,
           reduction=reduction)


def test_smooth_l1_delta():
    a, b = _pair(13)
    _check(J.smooth_l1_loss, T.smooth_l1_loss, [a, b], [0, 1], delta=0.5)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_binary_cross_entropy(weighted, reduction):
    rng = np.random.default_rng(14)
    p = rng.uniform(0.01, 0.99, (5, 3)).astype(np.float32)
    p[0, 0] = 0.0        # clipped at 1e-12
    y = (rng.uniform(size=(5, 3)) > 0.5).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (5, 3)).astype(np.float32) if weighted \
        else None
    _check(lambda a, b, c, **k: J.binary_cross_entropy(a, b, weight=c, **k),
           lambda a, b, c, **k: T.binary_cross_entropy(a, b, weight=c, **k),
           [p, y, w], [0], cot_shape=(5, 3) if reduction == "none" else None,
           reduction=reduction)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pos_weighted", [False, True])
def test_binary_cross_entropy_with_logits(weighted, pos_weighted):
    rng = np.random.default_rng(15)
    z = (rng.standard_normal((5, 3)) * 3).astype(np.float32)
    y = rng.uniform(size=(5, 3)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (5, 3)).astype(np.float32) if weighted \
        else None
    pw = rng.uniform(0.5, 3.0, (3,)).astype(np.float32) if pos_weighted \
        else None

    def run(mod):
        return lambda a, b, c, d, **k: mod.binary_cross_entropy_with_logits(
            a, b, weight=c, pos_weight=d, **k)
    _check(run(J), run(T), [z, y, w, pw], [0, 1], reduction="sum")


@pytest.mark.parametrize("log_target", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "batchmean", "sum", "none"])
def test_kl_div(log_target, reduction):
    rng = np.random.default_rng(16)
    logp = np.log(rng.dirichlet(np.ones(V), (4,))).astype(np.float32)
    y = rng.dirichlet(np.ones(V), (4,)).astype(np.float32)
    y[0, 0] = 0.0        # clipped inside the log
    if log_target:
        y = np.log(y + 1e-3).astype(np.float32)
    _check(J.kl_div, T.kl_div, [logp, y], [0, 1],
           cot_shape=(4, V) if reduction == "none" else None,
           reduction=reduction, log_target=log_target)


def test_hinge_embedding_loss():
    a, _ = _pair(17)
    y = np.where(np.random.default_rng(17).uniform(size=a.shape) > 0.5,
                 1.0, -1.0).astype(np.float32)
    _check(J.hinge_embedding_loss, T.hinge_embedding_loss, [a, y], [0],
           margin=0.7)


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_margin_ranking_loss(reduction):
    a, b = _pair(18, (9,))
    y = np.where(np.arange(9) % 2, 1.0, -1.0).astype(np.float32)
    _check(J.margin_ranking_loss, T.margin_ranking_loss, [a, b, y], [0, 1],
           cot_shape=(9,) if reduction == "none" else None, margin=0.3,
           reduction=reduction)


def test_cosine_embedding_loss():
    a, b = _pair(19, (6, 8))
    y = np.array([1, -1, 1, -1, -1, 1], np.int64)
    _check(J.cosine_embedding_loss, T.cosine_embedding_loss, [a, b, y],
           [0, 1], margin=0.1)


@pytest.mark.parametrize("p,swap", [(2.0, False), (1.0, True), (3.0, False)])
def test_triplet_margin_loss(p, swap):
    a, pos = _pair(20, (5, 7))
    neg, _ = _pair(21, (5, 7))
    _check(J.triplet_margin_loss, T.triplet_margin_loss, [a, pos, neg],
           [0, 1, 2], p=p, swap=swap, margin=0.5)


def test_square_error_cost_and_log_loss():
    a, b = _pair(22)
    _check(J.square_error_cost, T.square_error_cost, [a, b], [0, 1],
           cot_shape=a.shape)
    rng = np.random.default_rng(22)
    p = rng.uniform(0.01, 0.99, (6, 1)).astype(np.float32)
    y = (rng.uniform(size=(6, 1)) > 0.5).astype(np.float32)
    _check(J.log_loss, T.log_loss, [p, y], [0], cot_shape=(6, 1))


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_sigmoid_focal_loss(normalized, reduction):
    rng = np.random.default_rng(23)
    z = (rng.standard_normal((6, 4)) * 2).astype(np.float32)
    y = (rng.uniform(size=(6, 4)) > 0.7).astype(np.float32)
    nrm = np.array([3.0], np.float32) if normalized else None

    def run(mod):
        return lambda a, b, c, **k: mod.sigmoid_focal_loss(
            a, b, normalizer=c, **k)
    _check(run(J), run(T), [z, y, nrm], [0],
           cot_shape=(6, 4) if reduction == "none" else None,
           reduction=reduction, gamma=1.5, alpha=0.3)


def test_functional_exports_every_loss():
    names = [n for n in T.__all__]
    assert len(names) == 16
    for n in names:
        assert getattr(TF, n) is getattr(T, n)


# ---------------------------------------------------------------------------
# K4: the plain version and the autograd function with fake launches


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_k4_plain_shift_against_jax(smoothing, weighted):
    """``shift=True`` (the causal LM loss) with smoothing and weights: rows
    l < L - 1 against labels [:, 1:], as JAX's cross_entropy on the slice."""
    rng = np.random.default_rng(24)
    x = _logits((2, 7, V), 24)
    lab = rng.integers(0, V, (2, 7))
    lab[0, 3] = -100
    w = rng.uniform(0.5, 2.0, (V,)).astype(np.float32) if weighted else None
    want, (wg,) = _jax_run(
        lambda a, b, c: J.cross_entropy(a[:, :-1, :], b[:, 1:], weight=c,
                                        label_smoothing=smoothing),
        [x, lab, w], [0])
    got, (tg,) = _torch_run(
        lambda a, b, c: ce.softmax_cross_entropy(
            a, b, shift=True, weight=c, label_smoothing=smoothing),
        [x, lab, w], [0])
    _close(got, want)
    _close(tg, wg)


def _fake_fwd(x3, lab2, l_used, ignore, x_cast, fns=None, *, weight=None,
              eps=0.0, reduction="mean"):
    rows = x3[:, :l_used].reshape(-1, x3.shape[-1])
    lab = lab2.reshape(-1)
    loss = ce.softmax_cross_entropy_reference(
        rows, lab, ignore, dtype=x_cast, weight=weight, label_smoothing=eps,
        reduction=reduction)
    m = rows.float().max(-1).values
    logs = (rows.float() - m[:, None]).exp().sum(-1).log()
    valid = (lab != ignore) if ignore >= 0 else torch.ones_like(
        lab, dtype=torch.bool)
    out = loss if reduction == "none" else torch.stack(
        [loss, valid.sum().float()])
    return out, m, logs, valid.float()


def _fake_bwd(x3, lab2, l_used, ignore, x_cast, m, logs, valid, out, g,
              fns=None, *, weight=None, eps=0.0, reduction="mean"):
    leaf = x3.detach().requires_grad_()
    with torch.enable_grad():
        loss = ce.softmax_cross_entropy_reference(
            leaf[:, :l_used].reshape(-1, x3.shape[-1]), lab2.reshape(-1),
            ignore, dtype=x_cast, weight=weight, label_smoothing=eps,
            reduction=reduction)
        return torch.autograd.grad(loss, leaf, g)[0]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_k4_function_wiring_with_options(monkeypatch, reduction):
    monkeypatch.setattr(ce, "_launch_fwd", _fake_fwd)
    monkeypatch.setattr(ce, "_launch_bwd", _fake_bwd)
    monkeypatch.setattr(ce, "plain_path", lambda x: False)
    monkeypatch.setattr(ce, "_as_3d", lambda x: x if x.dim() == 3
                        else x.unsqueeze(0))
    x = torch.tensor(_logits((2, 6, V), 25), requires_grad=True)
    lab = torch.tensor(np.random.default_rng(25).integers(0, V, (2, 6)))
    lab[1, 2] = -1        # one-hots to zeros, weight wraps
    w = torch.linspace(0.5, 1.5, V)
    kw = dict(weight=w, label_smoothing=0.1, reduction=reduction)
    got = ce.softmax_cross_entropy(x, lab, 4, **kw)
    want = ce.softmax_cross_entropy_reference(x, lab, 4, **kw)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    (ga,) = torch.autograd.grad((got * cot).sum(), x)
    (gb,) = torch.autograd.grad((want * cot).sum(), x)
    torch.testing.assert_close(ga, gb)


def test_k4_cost_counts_weights_and_rows():
    x3 = torch.zeros(2, 5, V)
    lab2 = torch.zeros(2, 5, dtype=torch.int64)
    base = ce.cross_entropy_cost(x3, lab2, 5)[1]
    assert base == 10 * V * 4 + 10 * 8
    w = torch.ones(V)
    assert ce.cross_entropy_cost(x3, lab2, 5, weight=w)[1] == base + 4 * V
    assert ce.cross_entropy_cost(x3, lab2, 5, rows_out=True)[1] == \
        base + 4 * 10


def test_k4_rejects_an_unknown_reduction():
    with pytest.raises(ValueError, match="reduction"):
        ce.softmax_cross_entropy(torch.zeros(2, V),
                                 torch.zeros(2, dtype=torch.int64),
                                 reduction="batchmean")
