"""K10's plain version (``ops/batch_norm.py``'s ``batch_norm_reference``,
what the port's ``batch_norm`` runs on CPU tensors) against
``paddle_tpu.ops.nn_ops.batch_norm`` on the CPU, inputs from a seeded
numpy generator:

* fp32, training and eval, ``use_global_stats``, another momentum, without
  weight and bias, NCHW / NHWC / NC / NCL / NCDHW: the output (rtol 1e-5),
  the running buffers after the call (rtol 1e-5) and the gradients of x,
  the weight and the bias of ``sum(out * cot)`` (1e-5 of each gradient's
  largest element: the sums run in another order);
* O2 bf16 with bf16 parameters (``amp.decorate``'s), each tail: ``bn``,
  ``relu(bn)``, ``relu(bn + residual)``, against the JAX package's ops
  under its O2 casts (BN in fp32, the add and ReLU in bf16): outputs
  within one bf16 rounding (2^-7 of each element plus 2^-7 of the largest:
  both round fp32 results that differ in their last bits), gradients
  within 2^-7 of each and 1e-3 of the largest (x's gradient cancels in
  its sum);
* the fused tails equal the unfused sequence of the port's own ops (bit
  for bit, gradients too);
* the autograd function ``BatchNorm`` with each launch done by its plain
  version (the kernel's rounding points): the forward bit-equal to the
  plain version, gradients within 1e-5 (fp32) / 2^-7 (bf16) of autograd's,
  the running buffers, and two launches forward and two backward counted.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import nn_ops as jnn_ops
from paddle_tpu_torch import amp
from paddle_tpu_torch.ops import batch_norm as K10
from paddle_tpu_torch.ops import nn_ops


def _rng(seed):
    return np.random.default_rng(seed)


def _inputs(shape, ch_axis, seed, affine=True):
    r = _rng(seed)
    c = shape[ch_axis]
    x = (r.standard_normal(shape) * 1.7 + 0.4).astype(np.float32)
    w = (1 + 0.3 * r.standard_normal(c)).astype(np.float32) if affine \
        else None
    b = (0.2 * r.standard_normal(c)).astype(np.float32) if affine else None
    rm = (0.1 * r.standard_normal(c)).astype(np.float32)
    rv = (1 + 0.2 * r.random(c)).astype(np.float32)
    cot = r.standard_normal(shape).astype(np.float32)
    res = r.standard_normal(shape).astype(np.float32)
    return x, w, b, rm, rv, cot, res


def _jt(a, grad=False, dtype=None):
    """A JAX-package leaf of ``a`` (rounded to bf16 first with
    ``dtype="bfloat16"``, to nearest as torch rounds)."""
    if a is None:
        return None
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
    return paddle.to_tensor(a, stop_gradient=not grad)


def _tt(a, grad=False, dtype=None):
    if a is None:
        return None
    t = torch.tensor(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.requires_grad_(grad)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._data).astype(np.float32)


def _amp(o2):
    return amp.auto_cast(level="O2", dtype="bfloat16") if o2 \
        else amp.auto_cast(enable=False)


def _close(got, want, rtol, atol_frac):
    got, want = _np(got), _np(want)
    atol = atol_frac * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


FP32_CASES = {
    # name: shape, data_format, training, use_global_stats, momentum, affine
    "nchw_train": ((4, 6, 5, 7), "NCHW", True, None, 0.9, True),
    "nchw_eval": ((4, 6, 5, 7), "NCHW", False, None, 0.9, True),
    "global_stats": ((4, 6, 5, 7), "NCHW", True, True, 0.9, True),
    "momentum_0_7": ((4, 6, 5, 7), "NCHW", True, None, 0.7, True),
    "no_affine": ((4, 6, 5, 7), "NCHW", True, None, 0.9, False),
    "nhwc_train": ((4, 5, 7, 6), "NHWC", True, None, 0.9, True),
    "nc_train": ((16, 6), "NCL", True, None, 0.9, True),
    "ncl_train": ((4, 6, 9), "NCL", True, None, 0.9, True),
    "ncdhw_train": ((2, 4, 3, 5, 6), "NCDHW", True, None, 0.9, True),
}


@pytest.mark.parametrize("case", sorted(FP32_CASES))
def test_batch_norm_matches_jax_fp32(case):
    shape, fmt, training, glob, mom, affine = FP32_CASES[case]
    ch = 1 if fmt.startswith("NC") else len(shape) - 1
    x, w, b, rm, rv, cot, _ = _inputs(shape, ch, 3, affine)
    jx, jw, jb = _jt(x, True), _jt(w, True), _jt(b, True)
    jrm, jrv = _jt(rm), _jt(rv)
    jout = jnn_ops.batch_norm(jx, jrm, jrv, jw, jb, training=training,
                              momentum=mom, epsilon=1e-5, data_format=fmt,
                              use_global_stats=glob)
    (jout * paddle.to_tensor(cot)).sum().backward()
    tx, tw, tb = _tt(x, True), _tt(w, True), _tt(b, True)
    trm, trv = _tt(rm), _tt(rv)
    tout = nn_ops.batch_norm(tx, trm, trv, tw, tb, training=training,
                             momentum=mom, epsilon=1e-5, data_format=fmt,
                             use_global_stats=glob)
    (tout * torch.tensor(cot)).sum().backward()
    _close(tout, jout, 1e-5, 1e-6)
    _close(trm, jrm, 1e-5, 1e-6)
    _close(trv, jrv, 1e-5, 1e-6)
    if not training or glob:
        np.testing.assert_array_equal(trm.numpy(), rm)
        np.testing.assert_array_equal(trv.numpy(), rv)
    for t, j in ((tx, jx), (tw, jw), (tb, jb)):
        if t is not None:
            _close(t.grad, j.grad, 1e-5, 1e-5)


@pytest.mark.parametrize("tail", ["none", "relu", "add_relu"])
def test_batch_norm_o2_bf16_matches_jax(tail):
    shape = (4, 8, 6, 6)
    x, w, b, rm, rv, cot, res = _inputs(shape, 1, 5)
    jrm, jrv = _jt(rm), _jt(rv)
    jx, jw, jb = (_jt(a, True, "bfloat16") for a in (x, w, b))
    jres = _jt(res, True, "bfloat16")
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        jout = jnn_ops.batch_norm(jx, jrm, jrv, jw, jb, training=True)
        if tail == "add_relu":
            jout = jout + jres
        if tail != "none":
            jout = paddle.nn.functional.relu(jout)
    (jout.astype("float32") * paddle.to_tensor(cot)).sum().backward()
    trm, trv = _tt(rm), _tt(rv)
    tx, tw, tb = (_tt(a, True, torch.bfloat16) for a in (x, w, b))
    tres = _tt(res, True, torch.bfloat16)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        tout = nn_ops.batch_norm(
            tx, trm, trv, tw, tb, training=True,
            residual=tres if tail == "add_relu" else None,
            act=None if tail == "none" else "relu")
    (tout.float() * torch.tensor(cot)).sum().backward()
    assert str(tout.dtype).split(".")[-1] == str(jout._data.dtype)
    _close(tout, jout, 2.0 ** -7, 2.0 ** -7)
    _close(trm, jrm, 1e-5, 1e-6)
    _close(trv, jrv, 1e-5, 1e-6)
    grads = [(tx, jx), (tw, jw), (tb, jb)]
    if tail == "add_relu":
        grads.append((tres, jres))
    for t, j in grads:
        assert t.grad.dtype == torch.bfloat16
        _close(t.grad, j.grad, 2.0 ** -7, 1e-3)


@pytest.mark.parametrize("o2", [False, True])
@pytest.mark.parametrize("tail", ["relu", "add_relu"])
def test_fused_tails_equal_the_unfused_ops(o2, tail):
    x, w, b, rm, rv, cot, res = _inputs((3, 5, 4, 4), 1, 7)
    dt = torch.bfloat16 if o2 else torch.float32
    runs = []
    for fused in (True, False):
        ins = [_tt(a, True, dt) for a in (x, w, b, res)]
        trm, trv = _tt(rm), _tt(rv)
        with _amp(o2):
            r = ins[3] if tail == "add_relu" else None
            if fused:
                out = nn_ops.batch_norm(ins[0], trm, trv, ins[1], ins[2],
                                        training=True, residual=r,
                                        act="relu")
            else:
                out = nn_ops.batch_norm(ins[0], trm, trv, ins[1], ins[2],
                                        training=True)
                if r is not None:
                    out = nn_ops.add(out, r)
                out = nn_ops.relu(out)
        (out.float() * torch.tensor(cot)).sum().backward()
        runs.append((out, trm, trv, [t.grad for t in ins
                                     if t.grad is not None]))
    (a, arm, arv, ag), (c, crm, crv, cg) = runs
    assert a.dtype == c.dtype and torch.equal(a, c)
    assert torch.equal(arm, crm) and torch.equal(arv, crv)
    assert len(ag) == len(cg)
    for ga, gc in zip(ag, cg):
        assert torch.equal(ga, gc)


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
    """The kernel's apply, rounding point by rounding point."""
    n, s, c = geo

    def v(t):
        return t.reshape(n // s, c, s)

    t = ((v(x).float() - mean.view(1, c, 1))
         * torch.rsqrt(var.view(1, c, 1) + eps)).to(spec.norm).float()
    if w is not None:
        t = (t * w.float().view(1, c, 1)).to(spec.wmul).float()
    if b is not None:
        t = (t + b.float().view(1, c, 1)).to(spec.badd).float()
    if spec.tail == "add_relu":
        t = (t.to(spec.act).float() + v(res).to(spec.act).float()).to(
            spec.act).float()
    if spec.tail != "none":
        t = torch.relu(t.to(spec.act).float())
    return t.to(spec.out).reshape(x.shape)


def _fake_bwd(phase, x, dy, out, w, mean, var, eps, spec, geo, part, sums,
              dw, db, dx, dres, batch_stats, bias=None, residual=None):
    """The kernel's backward launch: the ReLU tail's mask recomputed from
    x, the statistics, w and the bias (no saved output), the residual's
    from the saved output."""
    if spec.tail == "relu":
        assert out is None and (bias is not None or db is None)
    r = K10.batch_norm_bwd_reference(
        x, dy, out, w, mean, var, eps, spec, geo, batch_stats,
        None if db is None else db.dtype,
        None if dres is None else dres.dtype, bias=bias, residual=residual)
    bufs = ((dw, "dw"), (db, "db")) if phase == 0 else ((dx, "dx"),
                                                       (dres, "dres"))
    for buf, k in bufs:
        if buf is not None:
            buf.copy_(r[k])


FN_CASES = {
    # name: shape, data_format, dtype, tail, training
    "fp32_train_relu": ((4, 6, 5, 5), "NCHW", torch.float32, "relu", True),
    "fp32_eval_none": ((4, 6, 5, 5), "NCHW", torch.float32, "none", False),
    "o2_train_add_relu": ((4, 6, 5, 5), "NCHW", torch.bfloat16, "add_relu",
                          True),
    "o2_nhwc_relu": ((4, 5, 5, 6), "NHWC", torch.bfloat16, "relu", True),
}


@pytest.mark.parametrize("case", sorted(FN_CASES))
def test_autograd_function_with_fake_launches(monkeypatch, case):
    monkeypatch.setattr(K10, "_launch_stats", _fake_stats)
    monkeypatch.setattr(K10, "_launch_apply", _fake_apply)
    monkeypatch.setattr(K10, "_launch_bwd", _fake_bwd)
    shape, fmt, dt, tail, training = FN_CASES[case]
    ch = 1 if fmt.startswith("NC") else len(shape) - 1
    x, w, b, rm, rv, cot, res = _inputs(shape, ch, 11)
    o2 = dt == torch.bfloat16
    act = None if tail == "none" else "relu"
    runs = []
    for kernel_path in (True, False):
        ins = [_tt(a, True, dt) for a in (x, w, b, res)]
        r = ins[3] if tail == "add_relu" else None
        trm, trv = _tt(rm), _tt(rv)
        before = {t: (K10.launches_fwd[t].count, K10.launches_bwd[t].count)
                  for t in K10.TAILS}
        with _amp(o2):
            if kernel_path:
                spec = K10.bn_spec(ins[0], ins[1], ins[2], r, act)
                out = K10.BatchNorm.apply(
                    ins[0], ins[1], ins[2], r, trm, trv, training, 0.9,
                    1e-5, spec, K10.bn_geometry(ins[0], fmt))
            else:
                out = K10.batch_norm_reference(
                    ins[0], trm, trv, ins[1], ins[2], training, 0.9, 1e-5,
                    fmt, residual=r, act=act)
        (out.float() * torch.tensor(cot)).sum().backward()
        counts = {t: (K10.launches_fwd[t].count - before[t][0],
                      K10.launches_bwd[t].count - before[t][1])
                  for t in K10.TAILS}
        runs.append((out, trm, trv, [t.grad for t in ins
                                     if t.grad is not None], counts))
    (a, arm, arv, ag, acount), (c, crm, crv, cg, ccount) = runs
    assert a.dtype == c.dtype and torch.equal(a, c)
    torch.testing.assert_close(arm, crm, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(arv, crv, rtol=1e-6, atol=1e-7)
    assert len(ag) == len(cg)
    frac = 1e-5 if dt == torch.float32 else 2.0 ** -7
    for ga, gc in zip(ag, cg):
        assert ga.dtype == gc.dtype
        _close(ga, gc, frac, frac)
    want = {t: ((2 if training else 1), 2) if t == tail else (0, 0)
            for t in K10.TAILS}
    assert acount == want and all(v == (0, 0) for v in ccount.values())


def test_spec_refuses_a_residual_without_relu_and_other_activations():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="only before a ReLU"):
        K10.bn_spec(x, residual=x)
    with pytest.raises(ValueError, match="act must be"):
        K10.bn_spec(x, act="gelu")
    g = K10.bn_geometry(torch.zeros(2, 3, 4, 5), "NCHW")
    assert g == (40, 20, 3)
    assert K10.bn_geometry(torch.zeros(2, 4, 5, 3), "NHWC") == (40, 1, 3)


def test_kernel_path_refuses_cpu_tensors():
    x = torch.zeros(2, 3, 4, 4)
    spec, geo = K10.bn_spec(x), K10.bn_geometry(x, "NCHW")
    with pytest.raises(ValueError, match="CUDA device"):
        K10._check(x, torch.zeros(3), torch.ones(3), None, None, None, geo)
    assert spec.out == torch.float32 and spec.tail == "none"
