"""The port's PP-YOLOE (``paddle_tpu_torch.models.ppyoloe``) against
``paddle_tpu.models.ppyoloe`` on the CPU, and K10's swish tails.

``PPYOLOEConfig.tiny(4)`` at 2 x 64 x 64 x 3 (NHWC), as
``tests/test_detection.py`` builds it, 3 ground-truth boxes an image (the
last masked off), inputs and weights from seeds: the weights are drawn by
the port's initializers (``seed=0``), set into the JAX model, and carried
back from its state dict key for key by ``convert.load_ppyoloe_state_dict``.
The ground-truth boxes are 24-48 pixels wide, so that anchors are assigned
and the GIoU and DFL terms are not 0 (with test_detection's 6-20 pixel
boxes no anchor passes the assigner's 1e-12 metric floor at this
initialization). The JAX model is built with its initializers replaced by
zeros (its own draws would be overwritten; drawing them costs half a
minute), and runs its training step (the loss and its backward) and its
evaluation (the forward and ``predict``) through ``paddle.jit.to_static``,
once, in a module fixture, compiled at XLA's backend optimization level 0
(half the compile time on one core; the programs compute the same
functions). The train-mode ``cls_logits`` and ``reg_dist`` are the head's
outputs inside the loss call, in both packages.

Held, each tolerance with the figures behind it:

* the state dicts of ``tiny``, ``s`` and ``l``: the same keys and shapes;
* in train mode, fp32: ``cls_logits`` and ``reg_dist`` within 1e-3 of
  each tensor's largest element, the four losses rel 2e-4, every gradient
  within 1e-2 of its tensor's largest element and the BN buffers after the
  training forward within 2e-3 of each buffer's largest element. Widened
  from 1e-4 by what fp32 rounding does here: the deepest maps are 2 x 2,
  so the neck's train-mode BNs normalise 8 elements a channel and amplify
  rounding (seen against JAX: logits 1.1e-4 and 3.8e-4, losses 3.4e-5,
  gradients 5.2e-3, buffers 3.2e-4; the port's own fp32 gradients differ
  from its fp64 ones by 1.3e-3 of the largest element, so no tolerance
  under that could hold two correct fp32 runs);
* the eval-mode ``cls_logits`` and ``reg_dist`` after the step, on each
  package's running buffers, within 1e-3 of each tensor's largest element
  (seen 3.2e-6 and 7.7e-5: the buffers differ as above; 1.5e-6 on equal
  buffers);
* one ``Adam(1e-3)`` step: the port's optimizer stepping from the JAX
  gradients gives the JAX package's parameters (rtol 1e-6). From its own
  gradients it could not: Adam's first step moves each element by about
  lr times the sign of its gradient, and a gradient within rounding of 0
  flips;
* ``predict`` (score_threshold 0, keep_top_k 20) after that step on each
  package's own running buffers: the counts and labels equal, scores and
  boxes within 1e-3 of the largest (the buffers differ as above);
* ``flops`` counts each fused swish tail once an element;
* K10's autograd function with each launch faked by its plain version,
  both swish tails, fp32 and O2 bf16, training and eval: the forward
  bit-equal to the plain version, the running buffers within 1e-6, the
  gradients within 1e-5 (fp32) / 2^-7 (bf16) of autograd's through the
  plain version, and the launches counted on the tail's counters.
"""

import contextlib
import functools
import inspect

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
import paddle_tpu.nn.initializer as jinit
from paddle_tpu.models import ppyoloe as jppyoloe
from paddle_tpu_torch import amp, flops
from paddle_tpu_torch.convert import load_ppyoloe_state_dict
from paddle_tpu_torch.models import ppyoloe
from paddle_tpu_torch.nn import build_scope
from paddle_tpu_torch.ops import batch_norm as K10
from paddle_tpu_torch.optimizer import Adam

B, SIZE, M, C = 2, 64, 3, 4
LR = 1e-3


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    centers = rng.uniform(20, SIZE - 20, (B, M, 2))
    wh = rng.uniform(24, 48, (B, M, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2],
                           -1).astype(np.float32)
    labels = rng.integers(0, C, (B, M)).astype(np.int32)
    mask = np.ones((B, M), np.float32)
    mask[:, -1] = 0.0
    return imgs, labels, boxes, mask


def _zero_init(shape, dtype):
    return paddle.to_tensor(np.zeros(shape, np.float32))._data


def _jax_model(cfg, monkeypatch):
    """The JAX package's PPYOLOE with its initializers drawing zeros."""
    for obj in vars(jinit).values():
        if inspect.isclass(obj) and issubclass(obj, jinit.Initializer):
            monkeypatch.setattr(obj, "__call__",
                                lambda self, shape, dtype: _zero_init(
                                    shape, dtype))
    return jppyoloe.PPYOLOE(cfg)


@contextlib.contextmanager
def _recorded_head(head):
    """The head's forward records its outputs (the instance's attribute
    over the class's method)."""
    seen = []
    real = head.forward

    def forward(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
        return out
    head.forward = forward
    try:
        yield seen
    finally:
        del head.forward


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(getattr(t, "_data", t)).astype(np.float32)


def _frac(got, want):
    """max |got - want| over the largest |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def runs():
    """One training step (loss, backward), one Adam step and the
    evaluation (forward, predict) in each package."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(
            jax.jit, compiler_options={"xla_backend_optimization_level": 0}))
        out = _runs(mp)
    return out


def _runs(mp):
    tm = ppyoloe.PPYOLOE(ppyoloe.PPYOLOEConfig.tiny(C), device="cpu", seed=0)
    jm = _jax_model(jppyoloe.PPYOLOEConfig.tiny(C), mp)
    jm.set_state_dict({k: v.numpy() for k, v in tm.state_dict().items()})
    jsd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = ppyoloe.PPYOLOE(ppyoloe.PPYOLOEConfig.tiny(C), device="cpu", seed=1)
    load_ppyoloe_state_dict(tm, jsd)
    data = _batch()
    jd = [paddle.to_tensor(v) for v in data]
    td = [torch.tensor(v) for v in data]
    out = {}

    jparams = jm.parameters()
    jnames = [k for k, _ in jm.named_parameters()]

    @paddle.jit.to_static
    def jstep(img, lab, box, msk):
        with _recorded_head(jm.head) as seen:
            lo = jm.loss(img, lab, box, msk)
        lo["loss"].backward()
        c, r = seen[0]
        return (c, r, lo["loss"], lo["loss_cls"], lo["loss_iou"],
                lo["loss_dfl"], [p.grad for p in jparams])

    jm.train()
    jr = jstep(*jd)
    out["j_train"] = {"cls": _np(jr[0]), "reg": _np(jr[1]),
                      "losses": [float(v) for v in jr[2:6]],
                      "grads": dict(zip(jnames, (_np(g) for g in jr[6])))}
    out["j_bufs"] = {k: np.asarray(v._data) for k, v in
                     jm.state_dict().items()
                     if k.endswith(("_mean", "_variance"))}
    jopt = paddle.optimizer.Adam(learning_rate=LR, parameters=jparams,
                                 use_multi_tensor=True)
    jopt.step()
    out["j_params"] = {k: np.asarray(p._data)
                       for k, p in jm.named_parameters()}
    jm.eval()

    @paddle.jit.to_static
    def jinfer(img):
        c, r = jm(img)
        dets, nums = jm.predict(img, score_threshold=0.0, keep_top_k=20)
        return c, r, dets, nums

    ji = jinfer(jd[0])
    out["j_eval"] = [_np(v) for v in ji[:3]] + [np.asarray(ji[3]._data)]

    tm.train()
    with _recorded_head(tm.head) as seen:
        lo = tm.loss(*td)
    lo["loss"].backward()
    c, r = seen[0]
    out["t_train"] = {"cls": c, "reg": r,
                      "losses": [lo[k].item() for k in
                                 ("loss", "loss_cls", "loss_iou",
                                  "loss_dfl")],
                      "grads": {k: p.grad.clone()
                                for k, p in tm.named_parameters()}}
    out["t_bufs"] = {k: v.clone() for k, v in tm.state_dict().items()
                     if k.endswith(("_mean", "_variance"))}
    topt = Adam(learning_rate=LR, parameters=tm.parameters())
    with torch.no_grad():
        for k, p in tm.named_parameters():
            p.grad.copy_(torch.from_numpy(out["j_train"]["grads"][k]))
    topt.step()
    out["t_params"] = {k: p.detach().clone()
                       for k, p in tm.named_parameters()}
    tm.eval()
    with torch.no_grad():
        c, r = tm(td[0])
        dets, nums = tm.predict(td[0], score_threshold=0.0, keep_top_k=20)
    out["t_eval"] = [c, r, dets, nums]
    out["models"] = (jm, tm)
    return out


def test_state_dict_keys_and_shapes_tiny(runs):
    jm, tm = runs["models"]
    want = {k: tuple(v._data.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want and len(got) == 572
    assert all(tm.state_dict()[k].dtype == torch.float32 for k in got)


@pytest.mark.parametrize("cfg", ["s", "l"])
def test_state_dict_keys_and_shapes_published(cfg, monkeypatch):
    jm = _jax_model(getattr(jppyoloe.PPYOLOEConfig, cfg)(80), monkeypatch)
    want = {k: tuple(v._data.shape) for k, v in jm.state_dict().items()}
    tm = ppyoloe.PPYOLOE(getattr(ppyoloe.PPYOLOEConfig, cfg)(80),
                         device="cpu", seed=0)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want


def test_convert_refuses_other_keys():
    tm = ppyoloe.PPYOLOE(ppyoloe.PPYOLOEConfig.tiny(C), device="cpu", seed=0)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    extra = dict(sd, **{"head.extra": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="extra"):
        load_ppyoloe_state_dict(tm, extra)
    sd.pop("backbone.stem.0.bn._mean")
    with pytest.raises(ValueError, match="missing"):
        load_ppyoloe_state_dict(tm, sd)


def test_train_forward_and_losses(runs):
    j, t = runs["j_train"], runs["t_train"]
    assert t["cls"].shape == (B, 84, C) and t["reg"].shape == (B, 84, 68)
    assert _frac(t["cls"], j["cls"]) < 1e-3
    assert _frac(t["reg"], j["reg"]) < 1e-3
    for got, want in zip(t["losses"], j["losses"]):
        assert np.isfinite(got) and want > 0
        np.testing.assert_allclose(got, want, rtol=2e-4)


def test_every_gradient(runs):
    j, t = runs["j_train"]["grads"], runs["t_train"]["grads"]
    assert sorted(j) == sorted(t)
    for k in t:
        if np.abs(j[k]).max() == 0:
            assert float(t[k].abs().max()) == 0, k
        else:
            assert _frac(t[k], j[k]) < 1e-2, k


def test_bn_buffers_after_the_training_forward(runs):
    j, t = runs["j_bufs"], runs["t_bufs"]
    assert sorted(j) == sorted(t) and len(t) > 0
    for k in t:
        assert _frac(t[k], j[k]) < 2e-3, k


def test_one_adam_step(runs):
    j, t = runs["j_params"], runs["t_params"]
    for k in t:
        np.testing.assert_allclose(_np(t[k]), j[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_eval_forward_and_predict(runs):
    (jc, jr, jdets, jnums), (tc, tr, tdets, tnums) = \
        runs["j_eval"], runs["t_eval"]
    assert _frac(tc, jc) < 1e-3 and _frac(tr, jr) < 1e-3
    assert tdets.shape == (B, 20, 6) and tdets.dtype == torch.float32
    assert tnums.dtype == torch.int32
    np.testing.assert_array_equal(tnums.numpy(), jnums)
    d = _np(tdets)
    np.testing.assert_array_equal(d[..., 0], jdets[..., 0])
    assert _frac(d[..., 1], jdets[..., 1]) < 1e-3
    assert _frac(d[..., 2:], jdets[..., 2:]) < 1e-3


def test_flops_count_the_swish_tails():
    with build_scope("cpu"):
        layer = ppyoloe.ConvBNLayer(3, 8, 3, stride=2)
        plain = ppyoloe.ConvBNLayer(3, 8, 3, stride=2, act="none")
    n_out = 1 * 8 * 8 * 8
    conv_macs = n_out * 3 * 3 * 3
    assert flops(layer, [1, 16, 16, 3]) == conv_macs + 2 * n_out + n_out
    assert flops(plain, [1, 16, 16, 3]) == conv_macs + 2 * n_out


# ---------------------------------------------------------------------------
# K10's swish tails through its autograd function, launches faked
# ---------------------------------------------------------------------------
def _fake_stats(x, rm, rv, momentum, geo, update):
    n, s, c = geo
    x3 = x.reshape(n // s, c, s).float()
    mean = x3.mean((0, 2))
    var = (x3 - mean.view(1, c, 1)).square().mean((0, 2))
    if update:
        rm.copy_(momentum * rm + (1.0 - momentum) * mean)
        rv.copy_(momentum * rv + (1.0 - momentum) * (var * (
            n / max(n - 1, 1))))
    return mean, var


def _fake_apply(x, w, b, res, mean, var, eps, spec, geo):
    """The kernel's apply with a swish tail, rounding point by rounding
    point."""
    n, s, c = geo
    r = torch.rsqrt(var.view(1, c, 1) + eps)
    z = K10._tail_input(x.reshape(n // s, c, s).float(), mean, r, w, b,
                         None if res is None else res.reshape(n // s, c, s),
                         spec)
    return (z / (1.0 + torch.exp(-z))).to(spec.out).reshape(x.shape)


def _fake_bwd(phase, x, dy, out, w, mean, var, eps, spec, geo, part, sums,
              dw, db, dx, dres, batch_stats, bias=None, residual=None):
    r = K10.batch_norm_bwd_reference(
        x, dy, out, w, mean, var, eps, spec, geo, batch_stats,
        None if db is None else db.dtype,
        None if dres is None else dres.dtype, bias=bias, residual=residual)
    bufs = ((dw, "dw"), (db, "db")) if phase == 0 else ((dx, "dx"),
                                                       (dres, "dres"))
    for buf, k in bufs:
        if buf is not None:
            buf.copy_(r[k])


SWISH_CASES = {
    # name: shape (NHWC), dtype, tail, training
    "fp32_train_swish": ((2, 5, 5, 6), torch.float32, "swish", True),
    "fp32_train_add_swish": ((2, 5, 5, 6), torch.float32, "add_swish",
                             True),
    "fp32_eval_add_swish": ((2, 5, 5, 6), torch.float32, "add_swish",
                            False),
    "o2_train_swish": ((2, 5, 5, 6), torch.bfloat16, "swish", True),
    "o2_train_add_swish": ((2, 5, 5, 6), torch.bfloat16, "add_swish", True),
}


@pytest.mark.parametrize("case", sorted(SWISH_CASES))
def test_swish_tails_with_fake_launches(monkeypatch, case):
    monkeypatch.setattr(K10, "_launch_stats", _fake_stats)
    monkeypatch.setattr(K10, "_launch_apply", _fake_apply)
    monkeypatch.setattr(K10, "_launch_bwd", _fake_bwd)
    shape, dt, tail, training = SWISH_CASES[case]
    r = np.random.default_rng(13)
    c = shape[-1]
    arrs = [(r.standard_normal(shape) * 1.7 + 0.4), 1 + 0.3 *
            r.standard_normal(c), 0.2 * r.standard_normal(c),
            r.standard_normal(shape)]
    rm = (0.1 * r.standard_normal(c)).astype(np.float32)
    rv = (1 + 0.2 * r.random(c)).astype(np.float32)
    cot = torch.tensor(r.standard_normal(shape).astype(np.float32))
    o2 = dt == torch.bfloat16
    runs = []
    for kernel_path in (True, False):
        ins = [torch.tensor(a.astype(np.float32)).to(dt).requires_grad_()
               for a in arrs]
        res = ins[3] if tail == "add_swish" else None
        trm, trv = torch.tensor(rm), torch.tensor(rv)
        before = {t: (K10.launches_fwd[t].count, K10.launches_bwd[t].count)
                  for t in K10.TAILS}
        with (amp.auto_cast(level="O2", dtype="bfloat16") if o2
              else amp.auto_cast(enable=False)):
            if kernel_path:
                spec = K10.bn_spec(ins[0], ins[1], ins[2], res, "swish")
                assert spec.tail == tail
                out = K10.BatchNorm.apply(
                    ins[0], ins[1], ins[2], res, trm, trv, training, 0.9,
                    1e-5, spec, K10.bn_geometry(ins[0], "NHWC"))
            else:
                out = K10.batch_norm_reference(
                    ins[0], trm, trv, ins[1], ins[2], training, 0.9, 1e-5,
                    "NHWC", residual=res, act="swish")
        (out.float() * cot).sum().backward()
        counts = {t: (K10.launches_fwd[t].count - before[t][0],
                      K10.launches_bwd[t].count - before[t][1])
                  for t in K10.TAILS}
        runs.append((out, trm, trv, [t.grad for t in ins
                                     if t.grad is not None], counts))
    (a, arm, arv, ag, acount), (b, brm, brv, bg, bcount) = runs
    assert a.dtype == b.dtype == dt
    frac = 1e-5 if dt == torch.float32 else 2.0 ** -7
    # the fake apply's swish is z / (1 + exp(-z)), the plain version's
    # F.silu: equal in fp32 up to a last bit, equal after bf16 rounding
    assert _frac(a, b) <= (2e-7 if dt == torch.float32 else frac)
    torch.testing.assert_close(arm, brm, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(arv, brv, rtol=1e-6, atol=1e-7)
    assert len(ag) == len(bg) == (4 if tail == "add_swish" else 3)
    for ga, gb in zip(ag, bg):
        assert ga.dtype == gb.dtype
        np.testing.assert_allclose(_np(ga), _np(gb), rtol=frac,
                                   atol=frac * float(_np(gb).__abs__().max()))
    want = {t: ((2 if training else 1), 2) if t == tail else (0, 0)
            for t in K10.TAILS}
    assert acount == want and all(v == (0, 0) for v in bcount.values())


def test_spec_of_the_swish_tails_under_o2():
    x = torch.zeros(2, 3, 3, 4, dtype=torch.bfloat16)
    w = torch.ones(4, dtype=torch.bfloat16)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        s = K10.bn_spec(x, w, w, None, "swish")
        a = K10.bn_spec(x, w, w, x, "swish")
    assert (s.tail, s.norm, s.act, s.out) == ("swish", torch.float32,
                                              torch.bfloat16, torch.bfloat16)
    assert (a.tail, a.act) == ("add_swish", torch.bfloat16)
    with pytest.raises(ValueError, match="act must be"):
        K10.bn_spec(x, act="gelu")
