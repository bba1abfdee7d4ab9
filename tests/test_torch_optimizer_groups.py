"""Parameter groups, ``AdamW``'s ``lr_ratio`` and
``apply_decay_param_fun``, the optimizer ``state_dict`` and
``amp.GradScaler`` of the port (plain versions on the CPU) against the JAX
package's, on the same parameters and gradients:

* ``GradScaler``: the scale, the skipped steps and the parameters over
  steps with a planted ``inf`` gradient, and its ``state_dict``; a scaled
  step under ``jit.capture_step`` on a CPU model;
* groups with their own LR scale, weight decay and clip (``Adam`` and
  ``AdamW``; the JAX package takes its per-parameter path for them);
* ``lr_ratio`` and ``apply_decay_param_fun`` on the per-parameter and the
  multi-tensor paths (the multi-tensor kernel's per-tensor tables, run by
  its plain version here), and groups of LR scales on the multi-tensor
  path;
* a state saved by either package loading in the other and giving the
  same next step.

Tolerances, as ``tests/test_torch_optimizer.py``: fp32 parameters rtol
1e-6 (the same fp32 arithmetic; XLA and PyTorch differ in the last bit of
a few elementwise results, and the port multiplies the LR by its scale in
fp32 where the JAX package does it in Python floats); bf16 parameters
within one bf16 ulp, fp32 masters and moments rtol 1e-6. The loss scale
and the skipped-step counts are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import (Adam, AdamW, ClipGradByGlobalNorm,
                                        ClipGradByValue, set_parameter_names)
from paddle_tpu_torch.ops import multi_tensor_adam as mta
from paddle_tpu_torch.ops import q8_adam

torch.set_num_threads(2)

LR = 1e-3
SHAPES = [(64, 48), (128, 64), (32, 16)]
RTOL = 1e-6


def _models():
    """The same Linear layers in both packages, each port parameter named
    (``param_name``) as its JAX counterpart."""
    paddle.seed(3)
    jm = paddle.nn.LayerList([paddle.nn.Linear(i, o) for i, o in SHAPES])
    tm = torch.nn.ModuleList([Linear(i, o, device="cpu") for i, o in SHAPES])
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for jl, tl in zip(jm, tm):
            tl.weight.copy_(torch.from_numpy(np.array(jl.weight._data)))
            tl.bias.copy_(torch.from_numpy(
                rng.normal(0, 0.1, tl.bias.shape).astype(np.float32)))
            jl.bias._set_data(jnp.asarray(tl.bias.numpy().copy()))
    for jp, tp in zip(jm.parameters(), tm.parameters()):
        tp.param_name = jp.name
    return jm, tm


def _grads(step, inf_at=None):
    rng = np.random.default_rng(100 + step)
    out = []
    for i, o in SHAPES:
        out += [rng.normal(0, 0.01, (i, o)).astype(np.float32),
                rng.normal(0, 0.01, (o,)).astype(np.float32)]
    if step == inf_at:
        out[1][3] = np.inf
    return out


def _losses(jp, tp, gs):
    jl = sum((p.astype("float32") * paddle.to_tensor(g)).sum()
             for p, g in zip(jp, gs))
    tl = sum((p.float() * torch.from_numpy(g)).sum() for p, g in zip(tp, gs))
    return jl, tl


def _np32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(getattr(t, "_data", t), np.float32)


def _params_close(jp, tp, bf16=False):
    for a, b in zip(jp, tp):
        a, b = _np32(a), _np32(b)
        if bf16:
            np.testing.assert_allclose(b, a, rtol=2.0 ** -7, atol=1e-30)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-8)


def _groups(params, cfg):
    """Three groups over the parameters: (weight, bias) pairs of each
    layer, with the given options."""
    ps = list(params)
    return [dict(params=ps[2 * i:2 * i + 2], **c) for i, c in enumerate(cfg)]


def _train(jo, to, jp, tp, steps=4, inf_at=None, scalers=None):
    for s in range(steps):
        jl, tl = _losses(jp, tp, _grads(s, inf_at))
        if scalers is None:
            jl.backward()
            tl.backward()
            jo.step()
            to.step()
        else:
            js, ts = scalers
            js.scale(jl).backward()
            ts.scale(tl).backward()
            js.step(jo)
            js.update()
            ts.step(to)
            ts.update()
            assert ts.get_loss_scaling() == js.get_loss_scaling()
        jo.clear_grad()
        to.clear_grad()


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_tensor", [False, True])
def test_grad_scaler_trajectory_matches_jax(multi_tensor):
    jm, tm = _models()
    jo = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters())
    to = AdamW(learning_rate=LR, parameters=tm.parameters(),
               use_multi_tensor=multi_tensor)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    js, ts = paddle.amp.GradScaler(**kw), amp.GradScaler(**kw)
    jp, tp = list(jm.parameters()), list(tm.parameters())
    _train(jo, to, jp, tp, steps=5, inf_at=2, scalers=(js, ts))
    # step 2 skipped: 4 updates of 5; the scale doubled after steps 0-1,
    # halved at step 2 and doubled after steps 3-4
    assert to.t == int(jo._step_t._data) == 4
    _params_close(jp, tp)
    assert ts.state_dict() == js.state_dict()
    assert ts.state_dict()["scale"] == 2.0 ** 11


def test_grad_scaler_state_dict_round_trip_and_static_scale():
    ts = amp.GradScaler(init_loss_scaling=8.0)
    ts.load_state_dict({"scale": 32.0, "good_steps": 3, "bad_steps": 0})
    assert ts.get_loss_scaling() == 32.0
    assert ts.state_dict()["good_steps"] == 3
    loss = torch.tensor(2.0)
    assert float(ts.scale(loss)) == 64.0
    st = amp.GradScaler(use_dynamic_loss_scaling=False,
                        init_loss_scaling=4.0)
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamW(parameters=[p])
    st.scale((p * float("inf")).sum()).backward()
    st.step(opt)
    st.update()
    assert st.get_loss_scaling() == 4.0 and opt.t == 0
    assert not amp.GradScaler(enable=False).is_enable()


def test_grad_scaler_step_under_capture_step_on_a_cpu_model(monkeypatch):
    # fp16 O1 of a small block: a planted inf skips the step and halves the
    # scale, eagerly and through capture_step (a CPU model runs eagerly)
    monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", "auto")

    def build():
        torch.manual_seed(0)
        m = torch.nn.ModuleList([Linear(16, 16, device="cpu")])
        with torch.no_grad():
            m[0].weight.normal_(0, 0.1)
        return m, AdamW(learning_rate=1e-2, parameters=m.parameters(),
                        use_multi_tensor=True)
    xs = [torch.randn(4, 16, generator=torch.Generator().manual_seed(i))
          for i in range(3)]
    xs[1][0, 0] = float("inf")

    def loss_of(m, x):
        with amp.auto_cast(level="O1", dtype="float16"):
            return m[0](x).float().square().mean()
    (a, oa), (b, ob) = build(), build()
    sa, sb = amp.GradScaler(init_loss_scaling=256.0), \
        amp.GradScaler(init_loss_scaling=256.0)
    for x in xs:
        sa.scale(loss_of(a, x)).backward()
        sa.step(oa)
        sa.update()
        oa.clear_grad()

    def step(x):
        loss = loss_of(b, x)
        sb.scale(loss).backward()
        return loss

    def update():
        sb.step(ob)
        sb.update()
        ob.clear_grad()
    cap = jit.capture_step(step, update_fn=update)
    for x in xs:
        cap(x)
    assert cap.stats["bypasses"] == {"cpu": 3}
    assert oa.t == ob.t == 2
    assert sa.get_loss_scaling() == sb.get_loss_scaling() == 128.0
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# parameter groups, lr_ratio, apply_decay_param_fun
# ---------------------------------------------------------------------------

GROUP_CFGS = {
    "lr_scales": [{"learning_rate": 0.5}, {}, {"learning_rate": 2.0}],
    "clips": [{"grad_clip": None}, {"grad_clip": "global"},
              {"grad_clip": "value"}],
    "decays": [{"weight_decay": 0.1}, {}, {"weight_decay": 0.02,
                                           "learning_rate": 0.25}],
}


def _clip(kind, pkg):
    if kind == "global":
        return pkg.ClipGradByGlobalNorm(0.05)
    if kind == "value":
        return pkg.ClipGradByValue(0.004)
    return None


def _cfg(name, pkg):
    out = []
    for c in GROUP_CFGS[name]:
        c = dict(c)
        if "grad_clip" in c:
            c["grad_clip"] = _clip(c["grad_clip"], pkg)
        out.append(c)
    return out


class _TorchClips:
    ClipGradByGlobalNorm = ClipGradByGlobalNorm
    ClipGradByValue = ClipGradByValue


@pytest.mark.parametrize("multi_tensor", [False, True])
@pytest.mark.parametrize("cfg", sorted(GROUP_CFGS))
@pytest.mark.parametrize("opt", ["Adam", "AdamW"])
def test_parameter_groups_match_jax(opt, cfg, multi_tensor):
    jm, tm = _models()
    jcls = getattr(paddle.optimizer, opt)
    tcls = {"Adam": Adam, "AdamW": AdamW}[opt]
    jo = jcls(learning_rate=LR, parameters=_groups(
        jm.parameters(), _cfg(cfg, paddle.nn)))
    to = tcls(learning_rate=LR, parameters=_groups(
        tm.parameters(), _cfg(cfg, _TorchClips)),
        use_multi_tensor=multi_tensor)
    # a group's own clip or decay takes the per-parameter path
    assert (to._flat is not None) == (multi_tensor and cfg == "lr_scales")
    if to._flat is not None:
        assert to._flat.tables is not None
    jp, tp = list(jm.parameters()), list(tm.parameters())
    _train(jo, to, jp, tp)
    _params_close(jp, tp)


@pytest.mark.parametrize("multi_tensor", [False, True])
@pytest.mark.parametrize("what", ["lr_ratio", "apply_decay_param_fun",
                                  "both"])
def test_lr_ratio_and_decay_fun_match_jax(what, multi_tensor):
    jm, tm = _models()
    names = [p.name for p in jm.parameters()]
    ratio = {n: r for n, r in zip(names, (1.0, 0.5, 3.0, 1.0, 0.25, 2.0))}
    kw = {}
    if what in ("lr_ratio", "both"):
        # a port parameter's name is its param_name
        kw["lr_ratio"] = lambda p: ratio[getattr(p, "param_name", None)
                                         or p.name]
    if what in ("apply_decay_param_fun", "both"):
        kw["apply_decay_param_fun"] = lambda n: n not in names[1::2]
    jo = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.05,
                                parameters=jm.parameters(), **kw)
    to = AdamW(learning_rate=LR, weight_decay=0.05,
               parameters=tm.parameters(), use_multi_tensor=multi_tensor,
               **kw)
    assert (to._flat is not None) == multi_tensor
    jp, tp = list(jm.parameters()), list(tm.parameters())
    _train(jo, to, jp, tp)
    _params_close(jp, tp)


def test_multi_tensor_tables_equal_the_per_parameter_path():
    # the kernel's per-tensor tables do the per-parameter scalars' exact
    # fp32 operations: the two paths agree bit for bit
    outs = []
    for multi in (False, True):
        _, tm = _models()
        set_parameter_names(tm)
        to = AdamW(learning_rate=LR, weight_decay=0.05, parameters=_groups(
            tm.parameters(), GROUP_CFGS["lr_scales"]),
            lr_ratio=lambda p: 0.75 if p.dim() == 1 else 1.0,
            apply_decay_param_fun=lambda n: n.endswith("weight"),
            use_multi_tensor=multi)
        tp = list(tm.parameters())
        for p in tp:   # names are read when the optimizer is built
            p.param_name = "renamed"
        for s in range(3):
            sum((p * torch.from_numpy(g)).sum()
                for p, g in zip(tp, _grads(s))).backward()
            to.step()
            to.clear_grad()
        outs.append([p.detach().clone() for p in tp])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("multi_tensor", [False, True])
@pytest.mark.parametrize("opt", ["Adam", "AdamW"])
def test_groups_under_an_optimizer_global_norm_clip_match_jax(opt,
                                                              multi_tensor):
    # each group is clipped by its own global norm, as the reference's
    # per-group _collect_params_grads does: several groups under an
    # optimizer-level ClipGradByGlobalNorm take the per-parameter path
    jm, tm = _models()
    jcls = getattr(paddle.optimizer, opt)
    tcls = {"Adam": Adam, "AdamW": AdamW}[opt]
    cfg = GROUP_CFGS["lr_scales"]
    jo = jcls(learning_rate=LR, parameters=_groups(jm.parameters(), cfg),
              grad_clip=paddle.nn.ClipGradByGlobalNorm(0.05))
    to = tcls(learning_rate=LR, parameters=_groups(tm.parameters(), cfg),
              grad_clip=ClipGradByGlobalNorm(0.05),
              use_multi_tensor=multi_tensor)
    assert to._flat is None
    one = tcls(learning_rate=LR, parameters=list(tm.parameters()),
               grad_clip=ClipGradByGlobalNorm(0.05),
               use_multi_tensor=multi_tensor)
    assert (one._flat is not None) == multi_tensor   # one group still fuses
    jp, tp = list(jm.parameters()), list(tm.parameters())
    _train(jo, to, jp, tp)
    _params_close(jp, tp)


def test_decay_fun_needs_every_parameter_named():
    m = torch.nn.ModuleList([Linear(4, 3, device="cpu")])
    with pytest.raises(ValueError, match="set_parameter_names"):
        AdamW(parameters=m.parameters(), apply_decay_param_fun=lambda n: 1)
    set_parameter_names(m)
    AdamW(parameters=m.parameters(), apply_decay_param_fun=lambda n: 1)


def test_multi_tensor_reference_reads_each_slice_of_the_tables():
    n = 256
    g = torch.Generator().manual_seed(5)
    st = [torch.randn(n, generator=g) * 0.02, torch.zeros(n),
          torch.zeros(n)]
    grad = torch.randn(n, generator=g) * 1e-2
    sc = q8_adam.scalar_block(1e-2, 0.1, 0.001, decay=1.0 - 1e-2 * 0.1)
    tables = (torch.tensor([64, 192, 256]), torch.tensor([1.0, 0.5, 2.0]),
              torch.tensor([1.0, 0.0, 1.0]))
    kw = dict(eps=1e-8, beta1=0.9, beta2=0.999, has_wd=True)
    got = [t.clone() for t in st]
    mta.multi_tensor_adam_update(*got, None, grad, scalars=sc,
                                 tables=tables, wd=0.1, **kw)
    for (a, b), scale, decays in zip(((0, 64), (64, 192), (192, 256)),
                                     (1.0, 0.5, 2.0), (True, False, True)):
        one = [t[a:b].clone() for t in st]
        lr = torch.tensor(1e-2, dtype=torch.float32) * scale
        blk = torch.stack([lr, 1.0 - lr * 0.1, *sc[2:]])
        mta.multi_tensor_adam_update(*one, None, grad[a:b], scalars=blk,
                                     eps=1e-8, beta1=0.9, beta2=0.999,
                                     has_wd=decays)
        for x, y in zip(got, one):
            assert torch.equal(x[a:b], y)


# ---------------------------------------------------------------------------
# the optimizer state across packages
# ---------------------------------------------------------------------------

def _to_numpy_state(state):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict) and k == "master_weights":
            out[k] = {n: _np_of(t) for n, t in v.items()}
        elif k == "LR_Scheduler":
            out[k] = v
        else:
            out[k] = _np_of(v)
    return out


def _np_of(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return np.asarray(jnp.asarray(t.float().numpy()).astype(
                jnp.bfloat16))
        return t.numpy().copy()
    return np.asarray(t._data)


@pytest.mark.parametrize("layout", ["per_param", "multi_tensor", "o2",
                                    "master_free_bf16"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_loads_across_packages(direction, layout):
    # master_free_bf16: bench_llama's --state bf16 layout (multi-tensor,
    # bf16 moments, no masters: master_weights are the bf16 parameters'
    # slices of the flat storage), rounding off so that the next steps
    # compare; its parameters, moments and master_weights within one bf16
    # ulp
    free = layout == "master_free_bf16"
    multi, o2 = layout in ("multi_tensor", "master_free_bf16"), \
        layout in ("o2", "master_free_bf16")
    okw = dict(use_multi_tensor=True, moment_dtype="bfloat16",
               use_master_weights=False, stochastic_rounding=False) \
        if free else dict(use_multi_tensor=multi)
    dkw = dict(level="O2", dtype="bfloat16",
               master_weight=False if free else None)
    jm, tm = _models()
    jo = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                                **okw)
    to = AdamW(learning_rate=LR, parameters=tm.parameters(), **okw)
    if o2:
        jm, jo = paddle.amp.decorate(jm, jo, **dkw)
        tm, to = amp.decorate(tm, to, **dkw)
    jp, tp = list(jm.parameters()), list(tm.parameters())
    _train(jo, to, jp, tp, steps=3)
    src_state = jo.state_dict() if direction == "jax_to_port" \
        else to.state_dict()
    keys = {k for k in src_state if k != "master_weights"}
    want = {"step"} | {f"{p.param_name}_{a}" for p in tp
                       for a in ("moment1", "moment2")}
    assert keys == want
    assert set(src_state.get("master_weights", {})) == (
        {p.param_name for p in tp} if o2 else set())
    state = _to_numpy_state(src_state)
    # a fresh optimizer of the other package, over the source's parameters
    if direction == "jax_to_port":
        fresh_m = torch.nn.ModuleList([Linear(i, o, device="cpu")
                                       for i, o in SHAPES])
        with torch.no_grad():
            for p, q, src in zip(fresh_m.parameters(), tp, jp):
                p.copy_(torch.from_numpy(_np32(src)))
                p.param_name = q.param_name
        fresh = AdamW(learning_rate=LR, parameters=fresh_m.parameters(),
                      **okw)
        if o2:
            fresh_m, fresh = amp.decorate(fresh_m, fresh, **dkw)
        fresh.set_state_dict(state)
        fp = list(fresh_m.parameters())
        with torch.no_grad():   # the source's bf16 parameters
            for p, src in zip(fp, jp):
                p.copy_(torch.from_numpy(_np32(src)).to(p.dtype))
        _train(jo, fresh, jp, fp, steps=1)
        assert fresh.t == 4
        _params_close(jp, fp, bf16=o2)
        if o2:
            _masters_close(jo.state_dict(), fresh.state_dict(), bf16=free)
        if free:
            _moments_close(jo.state_dict(), fresh.state_dict())
    else:
        paddle.seed(3)
        fresh_m = paddle.nn.LayerList([paddle.nn.Linear(i, o)
                                       for i, o in SHAPES])
        for p, q in zip(fresh_m.parameters(), tp):
            p._set_data(jnp.asarray(_np32(q)))
        fresh = paddle.optimizer.AdamW(learning_rate=LR,
                                       parameters=fresh_m.parameters(),
                                       **okw)
        if o2:
            fresh_m, fresh = paddle.amp.decorate(fresh_m, fresh, **dkw)
            for p, q in zip(fresh_m.parameters(), tp):
                p._set_data(jnp.asarray(_np32(q)).astype(jnp.bfloat16))
        # the port's names are the source model's; the fresh JAX model's
        # differ: key the state by the fresh parameters' names
        rename = {q.param_name: p.name
                  for p, q in zip(fresh_m.parameters(), tp)}
        state = {_renamed(k, rename): v for k, v in state.items()}
        if "master_weights" in state:
            state["master_weights"] = {rename[n]: v for n, v in
                                       state["master_weights"].items()}
        fresh.set_state_dict(state)
        fp = list(fresh_m.parameters())
        _train(fresh, to, fp, tp, steps=1)
        assert int(fresh._step_t._data) == 4
        _params_close(fp, tp, bf16=o2)
        if o2:
            _masters_close(fresh.state_dict(), to.state_dict(),
                           rename=rename, bf16=free)
        if free:
            _moments_close(fresh.state_dict(), to.state_dict(),
                           rename=rename)


def _renamed(key, rename):
    for old, new in rename.items():
        if key.startswith(old + "_"):
            return new + key[len(old):]
    return key


def _masters_close(jstate, tstate, rename=None, bf16=False):
    jm = jstate["master_weights"]
    for n, t in tstate["master_weights"].items():
        if bf16:
            assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(_np32(t), _np32(jm[(rename or {}).get(
            n, n)]), rtol=2.0 ** -7 if bf16 else RTOL, atol=1e-8)


def _moments_close(jstate, tstate, rename=None):
    for k, t in tstate.items():
        if k.endswith(("_moment1", "_moment2")):
            assert t.dtype == torch.bfloat16
            np.testing.assert_allclose(
                _np32(t), _np32(jstate[_renamed(k, rename or {})]),
                rtol=2.0 ** -7, atol=1e-30)


def test_set_parameter_names_and_default_names():
    m = torch.nn.ModuleList([Linear(4, 3, device="cpu")])
    opt = AdamW(parameters=m.parameters())
    assert [opt._name(i) for i in range(2)] == ["param_0", "param_1"]
    set_parameter_names(m, "enc.")
    # names are read when the optimizer is built
    assert [opt._name(i) for i in range(2)] == ["param_0", "param_1"]
    opt = AdamW(parameters=m.parameters())
    assert sorted(opt.state_dict()) == [
        "enc.0.bias_moment1", "enc.0.bias_moment2", "enc.0.weight_moment1",
        "enc.0.weight_moment2", "step"]
