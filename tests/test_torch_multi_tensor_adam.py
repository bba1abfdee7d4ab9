"""The multi-tensor AdamW (``AdamW(use_multi_tensor=True)``, the plain
version of ``ops/multi_tensor_adam.py`` on the CPU) against the JAX
package's fused path on its eager tier, and the flat layout it keeps.

* 3 steps with ``LinearWarmup(PolynomialDecay)`` and
  ``ClipGradByGlobalNorm(1.0)`` (the ERNIE fine-tune recipe), fp32
  parameters and AMP O2 bf16 parameters with fp32 masters: parameters and
  masters rtol 1e-5, atol 1e-6 (the same fp32 formulas; the global norm
  sums in another order, and XLA and PyTorch differ in the last bit of a
  few elementwise results). Held against the eager tier: the reference's
  captured tier fails its own eager parity test.
* ``ClipGradByValue``, and a parameter with no gradient (its state stays
  unchanged, as the reference's liveness mask keeps it), likewise.
* The layout: every parameter a view of a flat buffer at an aligned
  offset, the step's gradients copied into a flat gradient (a parameter
  without one reads zeros there, whatever an earlier step left); int8
  moments refused; ``ClipGradByNorm`` takes the per-parameter path, as in
  the reference; the master-free layout and mixed dtypes build the flat
  storage the reference builds.
* The update itself: the kernel's wrapper runs the plain version on CPU
  tensors; a gate of 0 writes nothing, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.ops import multi_tensor_adam as mta
from paddle_tpu_torch.ops import q8_adam
from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                        ClipGradByNorm, ClipGradByValue)
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(2)

SHAPES = [(64, 48), (48, 10)]   # weights of 3072 and 480, biases 48 and 10
RTOL, ATOL = 1e-5, 1e-6


def _models(seed=3):
    paddle.seed(seed)
    jm = paddle.nn.LayerList([paddle.nn.Linear(i, o) for i, o in SHAPES])
    tm = torch.nn.ModuleList([Linear(i, o, device="cpu") for i, o in SHAPES])
    with torch.no_grad():
        for jl, tl in zip(jm, tm):
            tl.weight.copy_(torch.from_numpy(np.array(jl.weight._data)))
            b = np.random.default_rng(seed).normal(0, 0.1, tl.bias.shape)
            tl.bias.copy_(torch.from_numpy(b.astype(np.float32)))
            jl.bias._set_data(jnp.asarray(tl.bias.numpy().copy()))
    return jm, tm


def _grads(step, scale):
    rng = np.random.default_rng(100 + step)
    out = []
    for i, o in SHAPES:
        out += [rng.normal(0, scale, (i, o)).astype(np.float32),
                rng.normal(0, scale, (o,)).astype(np.float32)]
    return out


def _sched(mod):
    return mod.LinearWarmup(mod.PolynomialDecay(5e-3, 4, end_lr=0.0,
                                                power=1.0),
                            warmup_steps=2, start_lr=0.0, end_lr=5e-3)


def _run(clip, o2=False, steps=3, scale=0.5, skip=None):
    """Both packages' multi-tensor AdamW over the same parameters and
    gradients; ``skip``: index of a parameter that gets no gradient."""
    jm, tm = _models()
    js, ts = _sched(jopt.lr), _sched(tlr)
    jo = jopt.AdamW(learning_rate=js, parameters=jm.parameters(),
                    weight_decay=0.01, use_multi_tensor=True,
                    grad_clip=clip(jopt))
    to = AdamW(learning_rate=ts, parameters=tm.parameters(),
               weight_decay=0.01, use_multi_tensor=True,
               grad_clip=clip(topt))
    if o2:
        jm, jo = paddle.amp.decorate(jm, jo, level="O2", dtype="bfloat16")
        tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16")
    jp, tp = list(jm.parameters()), list(tm.parameters())
    for s in range(steps):
        gs = _grads(s, scale)
        live = [i for i in range(len(gs)) if i != skip]
        sum((jp[i].astype("float32") * paddle.to_tensor(gs[i])).sum()
            for i in live).backward()
        jo.step()
        jo.clear_grad()
        sum((tp[i].float() * torch.from_numpy(gs[i])).sum()
            for i in live).backward()
        to.step()
        to.clear_grad()
        js.step()
        ts.step()
    return jo, to, jp, tp


def _check(jo, to, jp, tp, o2):
    fs, jfs = to._flat, jo._fused
    assert fs is not None and jfs is not None and to.t == jo._step_count
    for pj, pt, (off, n), (joff, jn) in zip(jp, tp, fs.offsets,
                                            jfs["offsets"]):
        want = np.asarray(pj._data, np.float32)
        got = pt.detach().float().numpy()
        if o2:   # bf16 parameters: one rounding of the masters
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        for mine, ref in ((fs.master, "master"), (fs.m, "m"), (fs.v, "v")):
            np.testing.assert_allclose(
                mine[off:off + n].numpy(),
                np.asarray(jfs[ref]._data[joff:joff + jn], np.float32),
                rtol=RTOL, atol=ATOL, err_msg=ref)


@pytest.mark.parametrize("o2", [False, True], ids=["fp32", "o2_bf16"])
def test_global_norm_clip_and_warmup_match_jax_eager_tier(o2):
    jo, to, jp, tp = _run(lambda m: m.ClipGradByGlobalNorm(1.0), o2=o2)
    _check(jo, to, jp, tp, o2)


def test_clip_by_value_matches_jax():
    jo, to, jp, tp = _run(lambda m: m.ClipGradByValue(0.3), scale=1.0)
    _check(jo, to, jp, tp, False)


def test_parameter_without_gradient_keeps_its_state():
    jm, tm = _models()
    before = [p.detach().clone() for p in tm.parameters()]
    jo, to, jp, tp = _run(lambda m: None, skip=1)
    _check(jo, to, jp, tp, False)
    off, n = to._flat.offsets[1]
    assert not to._flat.m[off:off + n].any()
    assert torch.equal(tp[1].detach(), before[1])


def test_flat_layout_views_and_alignment():
    _, tm = _models()
    params = list(tm.parameters())
    opt = AdamW(learning_rate=1e-3, parameters=params, use_multi_tensor=True)
    fs = opt._flat
    assert fs.param is None   # fp32: the parameters are the master
    base = fs.master.data_ptr()
    for p, (off, n) in zip(params, fs.offsets):
        assert off % 64 == 0 and p.numel() == n
        assert p.data_ptr() == base + 4 * off
    amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    assert fs.param.dtype == torch.bfloat16
    for p, (off, n) in zip(params, fs.offsets):
        assert p.dtype == torch.bfloat16
        assert p.data_ptr() == fs.param.data_ptr() + 2 * off
        # the master keeps the values from before the cast
        assert torch.equal(p.detach().reshape(-1),
                           fs.master[off:off + n].to(torch.bfloat16))
    sum(p.float().sum() for p in params).backward()
    live = fs.gather_grads()
    assert all(live) and fs.grad.dtype == torch.bfloat16
    assert fs.runs(live) == [(0, fs.total)]
    assert int(fs.grad.float().sum()) == sum(p.numel() for p in params)


def test_gather_copies_each_gradient_and_zeroes_a_missing_one():
    # each step's gradients are copied into the flat gradient; a parameter
    # without one reads zeros there, not what an earlier step left
    _, tm = _models()
    params = list(tm.parameters())
    opt = AdamW(learning_rate=1e-3, parameters=params, use_multi_tensor=True)
    fs = opt._flat
    sum(p.sum() for p in params).backward()
    assert fs.gather_grads() == (True,) * 4 and bool(
        torch.cat([fs.grad[o:o + n] for o, n in fs.offsets]).eq(1).all())
    opt.clear_grad()
    sum(2 * p.sum() for i, p in enumerate(params) if i != 1).backward()
    assert fs.gather_grads() == (True, False, True, True)
    for i, (o, n) in enumerate(fs.offsets):
        assert torch.equal(fs.grad[o:o + n], torch.full((n,), 0.0 if i == 1
                                                        else 2.0))


def test_refusals_and_fallbacks_follow_the_reference():
    p = [torch.nn.Parameter(torch.zeros(4))]
    with pytest.raises(ValueError, match="int8"):
        AdamW(parameters=p, use_multi_tensor=True, moment_dtype="int8")
    opt = AdamW(parameters=p, use_multi_tensor=True,
                grad_clip=ClipGradByNorm(1.0))
    assert opt._flat is None   # per-parameter path, as _materialize_state
    opt = AdamW(parameters=p, use_multi_tensor=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    assert opt._flat is not None
    # the master-free layout and mixed dtypes are ported: the flat storage
    # of each is what the reference builds (bf16 for master-free bf16
    # parameters, fp32 for a mix); their steps are held against the JAX
    # package in tests/test_torch_bf16_state.py
    for dts, master, want in (
            ((torch.bfloat16,) * 2, False, torch.bfloat16),
            ((torch.float32, torch.bfloat16), None, torch.float32),
            ((torch.float32, torch.bfloat16), False, torch.float32)):
        ps = [torch.nn.Parameter(torch.zeros(4, dtype=dt)) for dt in dts]
        jps = [paddle.nn.Linear(2, 2).weight for _ in dts]
        for jp_, dt in zip(jps, dts):
            jp_._set_data(jp_._data.astype(
                jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32))
        opt = AdamW(parameters=ps, use_multi_tensor=True,
                    use_master_weights=master)
        jo = jopt.AdamW(parameters=jps, use_multi_tensor=True,
                        use_master_weights=master)
        assert opt._flat.master.dtype == want
        assert str(jo._fused["master"]._data.dtype) == str(want).replace(
            "torch.", "")
    assert ClipGradByValue(1.0).min == -1.0


def _state(n, seed, pdtype):
    g = torch.Generator().manual_seed(seed)
    master = torch.randn(n, generator=g) * 0.02
    m = torch.randn(n, generator=g) * 1e-3
    v = torch.rand(n, generator=g) * 1e-4
    grad = (torch.randn(n, generator=g) * 1e-2).to(pdtype)
    param = None if pdtype == torch.float32 else master.to(pdtype)
    return master, m, v, param, grad


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_update_formula_and_gate(pdtype):
    n = 1000
    master, m, v, param, grad = _state(n, 1, pdtype)
    sc = q8_adam.scalar_block(1e-3, 0.19, 0.002, decay=1.0 - 1e-5,
                              grad_scale=0.5)
    kw = dict(scalars=sc, eps=1e-8, beta1=0.9, beta2=0.999, has_wd=True,
              grad_scale=True)
    g = grad.float() * np.float32(0.5)
    nm = 0.9 * m.double() + 0.1 * g.double()
    nv = 0.999 * v.double() + 0.001 * g.double() ** 2
    want = master.double() * (1 - 1e-5) - 1e-3 * (nm / 0.19) / (
        torch.sqrt(nv / 0.002) + 1e-8)
    st = [x.clone() if x is not None else None
          for x in (master, m, v, param)]
    mta.multi_tensor_adam_update(*st, grad, **kw)
    np.testing.assert_allclose(st[0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(st[1].numpy(), nm.numpy(), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(st[2].numpy(), nv.numpy(), rtol=1e-5,
                               atol=1e-12)
    if param is not None:
        assert torch.equal(st[3], st[0].to(pdtype))
    # a gate of 0 (the NaN gate withholding the step) writes nothing
    sc[4] = 0.0
    st = [x.clone() if x is not None else None
          for x in (master, m, v, param)]
    mta.multi_tensor_adam_update(*st, grad, **kw)
    for a, b in zip(st, (master, m, v, param)):
        assert b is None or torch.equal(a, b)


def test_ab_flat_grads_layouts_do_the_same_update(monkeypatch):
    # tools/ab_flat_grads.py times two layouts of the gradients (copied in,
    # or views accumulated into): from one state they give the same
    # parameters, bit for bit; without a card the tool exits 2
    from paddle_tpu_torch.tools import ab_flat_grads as ab
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (3, SHAPES[0][0])).astype(np.float32))
    out = {}
    for kind in ("copy", "views"):
        _, tm = _models()
        opt = AdamW(learning_rate=1e-2, parameters=tm.parameters(),
                    use_multi_tensor=True)
        ab._layout(torch, opt, kind)
        for _ in range(2):
            tm[1](tm[0](x)).square().sum().backward()
            opt.step()
            opt.clear_grad()
        out[kind] = [p.detach().clone() for p in tm.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(out["copy"], out["views"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab.main() == 2
