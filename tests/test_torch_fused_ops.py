"""The port's ``incubate`` fused ops and the plain versions of its fused
small-op kernels (``ops/fused_norm.py``, ``ops/rope.py``,
``ops/swiglu.py``, ``ops/softmax_cross_entropy.py``) on the CPU, where the
wrappers run the plain versions (the kernels themselves are held against
them on the card by ``chip_smoke.py``'s ``fused_ops_check``).

* each of the six ``incubate.nn.functional`` functions and the two layers
  against ``paddle_tpu.incubate`` on the same seeded numpy inputs, forward
  and gradients (the JAX package's own autograd), every optional argument
  covered. fp32: atol 1e-5 (the two differ by summation order only; 1e-6
  seen).
* AMP O2 bf16 (both sides cast by the op names ``fused_rms_norm``,
  ``fused_layer_norm``, ``fused_rope``, ``swiglu``): the norms do the same
  operations in the same order, so an output is at most one bf16 ulp off
  where an fp32 row sum rounds differently (2^-7 of |ref|; 0 seen); the
  JAX package's ``fused_rope`` rounds each product and the sum to bf16,
  the port rounds once, so an element may be up to three roundings of the
  products apart (3 x 2^-7 of |x1| + |x2|; 0.93 x 2^-7 seen); JAX's bf16
  ``silu`` rounds after each primitive and the port once (torch's silu),
  so SwiGLU is held within 2^-5 of |ref| (four ulps; 1.4e-2 seen). bf16
  gradients are held within 2^-6 of their largest element (8.6e-3 seen),
  SwiGLU's within 2^-5 (9.0e-3 seen).
* each plain version against the port's former plain op it replaces (kept
  below verbatim from before the kernels), bit for bit in fp32 and bf16,
  forward and gradients: ``rms_norm``, ``layer_norm``, the Llama rotary
  (``_rotate`` under ``apply_rotary`` and ``_rope_rows``), ``silu(g) * u``
  and ``cross_entropy`` (with ``ignore_index``, a batch where every row is
  ignored, labels of shape (N, 1) and strided logits).
* the backward plain versions (``fused_norm_bwd_reference``, the rotary
  turned back) against autograd of the forward ones: fp32 to summation
  order, bf16 within one rounding.

Dropout masks come from the hashed keep mask of ``ops/dropout.py`` under a
seed drawn from the caller's generator in the port, and from
``jax.random`` in the JAX package, so the two are compared at p = 0 or
outside training, and the mask itself against the hash of the seed the
generator gives.
"""

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import nn as jinn
from paddle_tpu.incubate import nn_functional as JF
from paddle_tpu_torch import amp
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.incubate import nn_functional as TF
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import DropoutRNG
from paddle_tpu_torch.ops import dropout as dr
from paddle_tpu_torch.ops import fused_norm as fn
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops import rope as rp
from paddle_tpu_torch.ops import softmax_cross_entropy as ce
from paddle_tpu_torch.ops import swiglu as sw

torch.set_num_threads(2)

F32_ATOL = 1e-5


def _keep(generator, shape, p):
    """The hidden-dropout mask ``ops/dropout.py`` draws under the seed
    ``generator`` gives, and the scale of the kept values."""
    seed = dr.draw_seed(generator, "cpu")
    return dr.keep_mask(seed, shape, p), float(np.float32(1.0 / (1.0 - p)))


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _jt(a):
    t = paddle.to_tensor(a)
    t.stop_gradient = False
    return t


def _tt(a):
    return torch.from_numpy(np.array(a)).requires_grad_()


def _jnp(t):
    return np.asarray(t._data, np.float32)


def _jgrad(t):
    return np.asarray(t.grad._data, np.float32)


def _objective_j(outs, weights):
    total = None
    for o, w in zip(outs, weights):
        term = (o.astype("float32") * paddle.to_tensor(w)).sum()
        total = term if total is None else total + term
    return total


def _objective_t(outs, weights):
    return sum((o.float() * torch.from_numpy(w)).sum()
               for o, w in zip(outs, weights))


def _close(got, want, atol=F32_ATOL, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _grad_close(got, want, frac, what=""):
    """Within ``frac`` of the largest element of the JAX gradient."""
    scale = max(float(np.abs(want).max()), 1e-12)
    assert np.abs(np.asarray(got, np.float32) - want).max() <= frac * scale, \
        what


# ---------------------------------------------------------------------------
# fused_rms_norm / fused_layer_norm
# ---------------------------------------------------------------------------

NORM_ARGS = list(itertools.product((False, True), repeat=4))


def _norm_pair(kind, weight, norm_bias, bias, residual, shape=(3, 5, 32),
               begin_norm_axis=-1, wshape=None, o2=False):
    cols = shape[-1] if wshape is None else int(np.prod(wshape))
    wshape = wshape or (shape[-1],)
    arrs = {"x": _np(1, *shape, scale=2.0, shift=0.5)}
    if weight:
        arrs["norm_weight"] = _np(2, *wshape, scale=0.3, shift=1.0)
    if norm_bias:
        arrs["norm_bias"] = _np(3, *wshape, scale=0.3)
    if bias:
        arrs["bias"] = _np(4, *wshape[-1:], scale=0.3).reshape(
            wshape[-1:]) if len(wshape) == 1 else _np(4, *wshape, scale=0.3)
    if residual:
        arrs["residual"] = _np(5, *shape)
    assert cols
    jfn = JF.fused_rms_norm if kind == "rms" else JF.fused_layer_norm
    tfn = TF.fused_rms_norm if kind == "rms" else TF.fused_layer_norm
    jargs = {k: _jt(v) for k, v in arrs.items()}
    targs = {k: _tt(v) for k, v in arrs.items()}
    if o2:
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            jout = jfn(begin_norm_axis=begin_norm_axis, **jargs)
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            tout = tfn(begin_norm_axis=begin_norm_axis, **targs)
    else:
        jout = jfn(begin_norm_axis=begin_norm_axis, **jargs)
        tout = tfn(begin_norm_axis=begin_norm_axis, **targs)
    jout = jout if isinstance(jout, tuple) else (jout,)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(jout) == len(tout) == (2 if residual else 1)
    ws = [_np(10 + i, *shape) for i in range(len(jout))]
    _objective_j(jout, ws).backward()
    _objective_t(tout, ws).backward()
    return jout, tout, jargs, targs


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("weight,norm_bias,bias,residual", NORM_ARGS)
def test_fused_norm_matches_jax_fp32(kind, weight, norm_bias, bias,
                                     residual):
    jout, tout, jargs, targs = _norm_pair(kind, weight, norm_bias, bias,
                                          residual)
    for j, t in zip(jout, tout):
        assert t.dtype == torch.float32
        _close(t.detach().numpy(), _jnp(j))
    for k in jargs:
        _close(targs[k].grad.numpy(), _jgrad(jargs[k]), what=k)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_fused_norm_begin_norm_axis_matches_jax(kind):
    jout, tout, jargs, targs = _norm_pair(kind, True, True, False, True,
                                          shape=(3, 4, 8), begin_norm_axis=1,
                                          wshape=(4, 8))
    for j, t in zip(jout, tout):
        _close(t.detach().numpy(), _jnp(j))
    for k in jargs:
        _close(targs[k].grad.numpy(), _jgrad(jargs[k]), what=k)


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("residual", [False, True])
def test_fused_norm_o2_bf16_tracks_jax(kind, residual):
    jout, tout, jargs, targs = _norm_pair(kind, True, True, True, residual,
                                          o2=True)
    for j, t in zip(jout, tout):
        assert t.dtype == torch.bfloat16
        want = _jnp(j)
        got = t.detach().float().numpy()
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()
    for k in jargs:
        _grad_close(targs[k].grad.numpy(), _jgrad(jargs[k]), 2.0 ** -6, k)


# ---------------------------------------------------------------------------
# fused_rotary_position_embedding
# ---------------------------------------------------------------------------

# (neox, tensors given, tables: "gen" | "sd" | "1s1d", position_ids,
#  time_major, kv heads)
ROPE_CASES = [
    (True, "q", "gen", False, False, 4),
    (True, "qk", "gen", False, False, 4),
    (True, "qkv", "sd", False, False, 4),
    (True, "qk", "1s1d", True, False, 2),
    (True, "qk", "gen", False, True, 4),
    (True, "qkv", "sd", True, True, 2),
    (False, "q", "gen", False, False, 4),
    (False, "qk", "sd", False, False, 2),
    (False, "qkv", "1s1d", True, False, 4),
    (False, "qk", "gen", True, True, 4),
    (False, "qkv", "gen", False, True, 2),
]


def _rope_inputs(given, tables, pids, time_major, hkv, neox, b=2, s=16,
                 h=4, d=32):
    shp = (s, b) if time_major else (b, s)
    arrs = {"q": _np(20, *shp, h, d)}
    if "k" in given:
        arrs["k"] = _np(21, *shp, hkv, d)
    if "v" in given:
        arrs["v"] = _np(22, *shp, hkv, d)
    extra = {}
    if tables != "gen":
        ang = np.random.default_rng(23).uniform(0, 6.3, (s, d // 2))
        emb = np.concatenate([ang, ang], -1) if neox else np.repeat(ang, 2,
                                                                    -1)
        cos, sin = np.cos(emb).astype(np.float32), np.sin(emb).astype(
            np.float32)
        if tables == "1s1d":
            cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        extra = {"cos": cos, "sin": sin}
    if pids:
        extra["position_ids"] = np.random.default_rng(24).integers(
            0, s, (b, s)).astype(np.int64)
    return arrs, extra


def _rope_pair(neox, given, tables, pids, time_major, hkv, o2=False):
    arrs, extra = _rope_inputs(given, tables, pids, time_major, hkv, neox)
    jargs = {k: _jt(v) for k, v in arrs.items()}
    targs = {k: _tt(v) for k, v in arrs.items()}
    jx = {k: paddle.to_tensor(v) for k, v in extra.items()}
    tx = {k: torch.from_numpy(v) for k, v in extra.items()}
    kw = dict(use_neox_rotary_style=neox, time_major=time_major)
    if o2:
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            jout = JF.fused_rotary_position_embedding(**jargs, **jx, **kw)
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            tout = TF.fused_rotary_position_embedding(**targs, **tx, **kw)
    else:
        jout = JF.fused_rotary_position_embedding(**jargs, **jx, **kw)
        tout = TF.fused_rotary_position_embedding(**targs, **tx, **kw)
    assert len(tout) == 3
    assert [t is None for t in tout] == [j is None for j in jout] == [
        n not in arrs for n in "qkv"]
    jo = [j for j in jout if j is not None]
    to = [t for t in tout if t is not None]
    ws = [_np(30 + i, *t.shape) for i, t in enumerate(to)]
    _objective_j(jo, ws).backward()
    _objective_t(to, ws).backward()
    return arrs, jo, to, jargs, targs


@pytest.mark.parametrize("neox,given,tables,pids,time_major,hkv",
                         ROPE_CASES)
def test_fused_rope_matches_jax_fp32(neox, given, tables, pids, time_major,
                                     hkv):
    _, jo, to, jargs, targs = _rope_pair(neox, given, tables, pids,
                                         time_major, hkv)
    for j, t in zip(jo, to):
        assert t.dtype == torch.float32
        _close(t.detach().numpy(), _jnp(j))
    for k in jargs:
        _close(targs[k].grad.numpy(), _jgrad(jargs[k]), what=k)


def _partner(x, neox):
    """The other element of each element's pair."""
    d = x.shape[-1]
    if neox:
        return np.concatenate([x[..., d // 2:], x[..., :d // 2]], -1)
    return x.reshape(*x.shape[:-1], d // 2, 2)[..., ::-1].reshape(x.shape)


@pytest.mark.parametrize("neox", [True, False])
def test_fused_rope_o2_bf16_tracks_jax(neox):
    arrs, jo, to, jargs, targs = _rope_pair(neox, "qkv", "sd", True, False,
                                            2, o2=True)
    for name, j, t in zip("qkv", jo, to):
        assert t.dtype == torch.bfloat16
        x = arrs[name]
        # each pair's products: |x1 c| + |x2 s| <= |x1| + |x2| per element
        mag = np.abs(x) + np.abs(_partner(x, neox))
        got, want = t.detach().float().numpy(), _jnp(j)
        assert (np.abs(got - want) <= 3 * 2.0 ** -7 * mag + 1e-6).all(), name
    for k in jargs:
        _grad_close(targs[k].grad.numpy(), _jgrad(jargs[k]), 2.0 ** -6, k)


# ---------------------------------------------------------------------------
# swiglu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("two_args", [False, True])
@pytest.mark.parametrize("o2", [False, True])
def test_swiglu_matches_jax(two_args, o2):
    arrs = {"x": _np(40, 3, 6, 32, scale=2.0)}
    if two_args:
        arrs["y"] = _np(41, 3, 6, 32, scale=2.0)
    jargs = {k: _jt(v) for k, v in arrs.items()}
    targs = {k: _tt(v) for k, v in arrs.items()}
    if o2:
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            jout = JF.swiglu(**jargs)
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            tout = TF.swiglu(**targs)
    else:
        jout, tout = JF.swiglu(**jargs), TF.swiglu(**targs)
    w = _np(42, *tout.shape)
    _objective_j([jout], [w]).backward()
    _objective_t([tout], [w]).backward()
    want, got = _jnp(jout), tout.detach().float().numpy()
    if o2:
        assert tout.dtype == torch.bfloat16
        assert (np.abs(got - want) <= 2.0 ** -5 * np.abs(want) + 1e-6).all()
        for k in jargs:
            _grad_close(targs[k].grad.numpy(), _jgrad(jargs[k]), 2.0 ** -5, k)
    else:
        _close(got, want)
        for k in jargs:
            _close(targs[k].grad.numpy(), _jgrad(jargs[k]), what=k)


# ---------------------------------------------------------------------------
# fused_dropout_add, fused_bias_dropout_residual_layer_norm and the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,training", [(0.0, True), (0.5, False)])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_fused_dropout_add_without_a_draw_matches_jax(p, training, mode):
    x, y = _np(50, 4, 16), _np(51, 4, 16)
    jx, jy, tx, ty = _jt(x), _jt(y), _tt(x), _tt(y)
    jout = JF.fused_dropout_add(jx, jy, p=p, training=training, mode=mode)
    tout = TF.fused_dropout_add(tx, ty, p=p, training=training, mode=mode)
    w = _np(52, 4, 16)
    _objective_j([jout], [w]).backward()
    _objective_t([tout], [w]).backward()
    _close(tout.detach().numpy(), _jnp(jout))
    _close(tx.grad.numpy(), _jgrad(jx))
    _close(ty.grad.numpy(), _jgrad(jy))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_fused_dropout_add_draws_its_mask_from_the_generator(mode):
    x, y = torch.randn(64, 32), torch.randn(64, 32)
    out = TF.fused_dropout_add(x, y, p=0.25, mode=mode,
                               generator=torch.Generator().manual_seed(3))
    keep, inv = _keep(torch.Generator().manual_seed(3), x.shape, 0.25)
    kept = x * inv if mode == "upscale_in_train" else x
    assert torch.equal(out, torch.where(keep, kept, 0.0) + y)
    assert 0.6 < keep.float().mean() < 0.9
    with pytest.raises(ValueError, match="generator"):
        TF.fused_dropout_add(x, y, p=0.25, mode=mode)
    with pytest.raises(ValueError, match="mode"):
        TF.fused_dropout_add(x, y, p=0.25, mode="nope",
                             generator=torch.Generator())


@pytest.mark.parametrize("bias,scale,shift", [(False, False, False),
                                              (True, True, True),
                                              (True, False, True),
                                              (False, True, False)])
def test_fused_bias_dropout_residual_layer_norm_matches_jax(bias, scale,
                                                            shift):
    arrs = {"x": _np(60, 3, 5, 32, scale=2.0), "residual": _np(61, 3, 5, 32)}
    if bias:
        arrs["bias"] = _np(62, 32, scale=0.3)
    if scale:
        arrs["ln_scale"] = _np(63, 32, scale=0.3, shift=1.0)
    if shift:
        arrs["ln_bias"] = _np(64, 32, scale=0.3)
    jargs = {k: _jt(v) for k, v in arrs.items()}
    targs = {k: _tt(v) for k, v in arrs.items()}
    jout = JF.fused_bias_dropout_residual_layer_norm(dropout_rate=0.0,
                                                     **jargs)
    tout = TF.fused_bias_dropout_residual_layer_norm(dropout_rate=0.0,
                                                     **targs)
    w = _np(65, 3, 5, 32)
    _objective_j([jout], [w]).backward()
    _objective_t([tout], [w]).backward()
    _close(tout.detach().numpy(), _jnp(jout))
    for k in jargs:
        _close(targs[k].grad.numpy(), _jgrad(jargs[k]), what=k)


def test_fused_bias_dropout_residual_layer_norm_draws_from_the_generator():
    x, res, b = torch.randn(8, 32), torch.randn(8, 32), torch.randn(32)
    out = TF.fused_bias_dropout_residual_layer_norm(
        x, res, bias=b, dropout_rate=0.3,
        generator=torch.Generator().manual_seed(5))
    keep, inv = _keep(torch.Generator().manual_seed(5), x.shape, 0.3)
    h = torch.where(keep, (x + b) * inv, 0.0) + res
    assert torch.equal(out, nn_ops.layer_norm(h, 32))


def test_fused_dropout_add_layer_matches_jax_and_draws_from_its_rng():
    paddle.seed(0)
    jl = jinn.FusedDropoutAdd(p=0.5)
    tl = tinn.FusedDropoutAdd(p=0.5, device="cpu")
    assert list(tl.state_dict()) == list(jl.state_dict()) == []
    x, y = _np(70, 4, 8), _np(71, 4, 8)
    jl.eval()
    tl.eval()
    _close(tl(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
           _jnp(jl(paddle.to_tensor(x), paddle.to_tensor(y))))
    tl.train()
    rng = DropoutRNG("cpu", seed=11)
    tl = tinn.FusedDropoutAdd(p=0.5, rng=rng)
    out = tl(torch.from_numpy(x), torch.from_numpy(y))
    seed = DropoutRNG("cpu", seed=11).next_seed()
    keep = dr.keep_mask(seed, x.shape, 0.5)
    assert torch.equal(out, torch.where(keep, torch.from_numpy(x) * 2.0, 0.0)
                       + torch.from_numpy(y))
    assert int(rng.counter) == 1


def test_fused_bias_dropout_residual_layer_norm_layer_matches_jax():
    paddle.seed(1)
    jl = jinn.FusedBiasDropoutResidualLayerNorm(32, dropout_rate=0.1)
    tl = tinn.FusedBiasDropoutResidualLayerNorm(32, dropout_rate=0.1,
                                                device="cpu")
    assert list(tl.state_dict()) == list(jl.state_dict())
    state = {k: _np(80 + i, *v.shape, scale=0.3, shift=1.0 if "scale" in k
                    else 0.0)
             for i, (k, v) in enumerate(jl.state_dict().items())}
    for k, v in state.items():
        getattr(jl, k)._set_data(paddle.to_tensor(v)._data)
    tl.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    jl.eval()
    tl.eval()
    x, res = _np(85, 2, 5, 32), _np(86, 2, 5, 32)
    jx, jr, tx, tr = _jt(x), _jt(res), _tt(x), _tt(res)
    jout, tout = jl(jx, jr), tl(tx, tr)
    w = _np(87, 2, 5, 32)
    _objective_j([jout], [w]).backward()
    _objective_t([tout], [w]).backward()
    _close(tout.detach().numpy(), _jnp(jout))
    _close(tx.grad.numpy(), _jgrad(jx))
    _close(tr.grad.numpy(), _jgrad(jr))
    for k in state:
        _close(getattr(tl, k).grad.numpy(), _jgrad(getattr(jl, k)), what=k)
    no_bias = tinn.FusedBiasDropoutResidualLayerNorm(32, bias_attr=False,
                                                     device="cpu")
    assert no_bias.linear_bias is None


# ---------------------------------------------------------------------------
# the plain versions against the port's former plain ops, bit for bit
# ---------------------------------------------------------------------------

def _old_rms_norm(x, weight=None, epsilon=1e-6):
    x, weight = amp.cast_inputs("rms_norm", x, weight)
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def _old_layer_norm(x, normalized_shape, weight=None, bias=None,
                    epsilon=1e-5):
    n = 1 if isinstance(normalized_shape, int) else len(normalized_shape)
    x, weight, bias = amp.cast_inputs("layer_norm", x, weight, bias)
    dims = tuple(range(x.dim() - n, x.dim()))
    xf = x.float()
    mu = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, unbiased=False, keepdim=True)
    out = ((xf - mu) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out if bias is None else out + bias


def _old_add(x, y):
    x, y = amp.cast_inputs("add", x, y)
    return x + y


def _old_rotate(x, c, s):
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _old_apply_rotary(x, cos, sin, position_offset=0):
    n = x.shape[1]
    x, cos, sin = amp.cast_inputs("rope", x, cos, sin)
    c = cos[position_offset:position_offset + n][None, :, None, :]
    s = sin[position_offset:position_offset + n][None, :, None, :]
    return _old_rotate(x, c, s)


def _old_rope_rows(x, cos, sin, t):
    idx = t.long()
    return _old_rotate(x, cos[idx][:, None, :], sin[idx][:, None, :])


def _old_cross_entropy(input, label, ignore_index=-100):
    (input,) = amp.cast_inputs("cross_entropy", input)
    logp = torch.log_softmax(input.float(), dim=-1)
    li = label.long()
    if li.dim() == logp.dim() and li.shape[-1] == 1:
        li = li.squeeze(-1)
    valid = li != ignore_index if ignore_index >= 0 else None
    idx = li if valid is None else torch.where(valid, li, 0)
    loss = -logp.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    if valid is None:
        return loss.mean()
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().float().clamp(min=1.0)


def _then_norm(h, norm):
    """The former post-add norm: ``(norm(h), h)``."""
    return norm(h), h


# float inputs of the plain versions: (dtype of the tensors, AMP level)
PLAIN_SETTINGS = [(torch.float32, None), (torch.bfloat16, None),
                  (torch.bfloat16, "O2"), (torch.float32, "O2")]


def _amp(level):
    return amp.auto_cast(level=level, dtype="bfloat16") if level \
        else amp.auto_cast(enable=False)


def _leaves(seed, dtype, *shapes):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(s, generator=g) * 1.5 + 0.2).to(dtype)
            .requires_grad_() for s in shapes]


def _same_run(new, old, inputs, seed=99):
    """Run both on clones of ``inputs``; outputs and gradients (of a
    random weighting) bit for bit equal."""
    a = [t.detach().clone().requires_grad_() for t in inputs]
    b = [t.detach().clone().requires_grad_() for t in inputs]
    out_a, out_b = new(*a), old(*b)
    out_a = out_a if isinstance(out_a, tuple) else (out_a,)
    out_b = out_b if isinstance(out_b, tuple) else (out_b,)
    assert len(out_a) == len(out_b)
    g = torch.Generator().manual_seed(seed)
    ws = [torch.randn(o.shape, generator=g) for o in out_a]
    for oa, ob in zip(out_a, out_b):
        assert oa.dtype == ob.dtype and torch.equal(oa, ob)
    sum((o.float() * w).sum() for o, w in zip(out_a, ws)).backward()
    sum((o.float() * w).sum() for o, w in zip(out_b, ws)).backward()
    for ta, tb in zip(a, b):
        assert torch.equal(ta.grad, tb.grad)


@pytest.mark.parametrize("dtype,level", PLAIN_SETTINGS)
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_plain_is_the_former_op(dtype, level, residual):
    shapes = [(2, 7, 48), (48,)] + ([(2, 7, 48)] if residual else [])
    ins = _leaves(1, dtype, *shapes)
    with _amp(level):
        if residual:
            _same_run(lambda x, w, r: nn_ops.rms_norm(x, w, 1e-5, r),
                      lambda x, w, r: _then_norm(
                          _old_add(x, r), lambda h: _old_rms_norm(h, w,
                                                                  1e-5)),
                      ins)
        else:
            _same_run(lambda x, w: nn_ops.rms_norm(x, w, 1e-5),
                      lambda x, w: _old_rms_norm(x, w, 1e-5), ins)
            _same_run(lambda x: nn_ops.rms_norm(x), _old_rms_norm, ins[:1])


@pytest.mark.parametrize("dtype,level", PLAIN_SETTINGS)
@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_plain_is_the_former_op(dtype, level, residual):
    shapes = [(2, 7, 48), (48,), (48,)] + ([(2, 7, 48)] if residual else [])
    ins = _leaves(2, dtype, *shapes)
    if residual:
        ins[3] = ins[3].detach().float().requires_grad_()  # mixed dtypes
    with _amp(level):
        if residual:
            _same_run(
                lambda x, w, b, r: nn_ops.layer_norm(x, 48, w, b, 1e-12, r),
                lambda x, w, b, r: _then_norm(
                    _old_add(r, x), lambda h: _old_layer_norm(h, 48, w, b,
                                                              1e-12)),
                ins)
        else:
            _same_run(lambda x, w, b: nn_ops.layer_norm(x, 48, w, b, 1e-12),
                      lambda x, w, b: _old_layer_norm(x, 48, w, b, 1e-12),
                      ins)
            _same_run(lambda x: nn_ops.layer_norm(x, [7, 48]),
                      lambda x: _old_layer_norm(x, [7, 48]), ins[:1])


@pytest.mark.parametrize("dtype,level", PLAIN_SETTINGS)
def test_rotary_plain_is_the_former_rotate(dtype, level):
    cos, sin = (torch.from_numpy(t) for t in tllama._rope_cache(64, 16,
                                                                 1e4))
    (x, k) = _leaves(3, dtype, (2, 9, 4, 16), (2, 9, 2, 16))
    with _amp(level):
        _same_run(lambda x: tllama.apply_rotary(x, cos, sin, 5),
                  lambda x: _old_apply_rotary(x, cos, sin, 5), [x])
        _same_run(lambda x, k: tllama._rotary([x, k], cos, sin, 3),
                  lambda x, k: (_old_apply_rotary(x, cos, sin, 3),
                                _old_apply_rotary(k, cos, sin, 3)), [x, k])
    t = torch.tensor([0, 5, 63], dtype=torch.int32)
    (q,) = _leaves(4, dtype, (3, 4, 16))
    _same_run(lambda q: tllama._rope_rows([q], cos, sin, t),
              lambda q: (_old_rope_rows(q, cos, sin, t),), [q])


@pytest.mark.parametrize("dtype,level", PLAIN_SETTINGS)
@pytest.mark.parametrize("packed", [False, True])
def test_swiglu_plain_is_silu_times_up(dtype, level, packed):
    ins = _leaves(5, dtype, *([(4, 5, 64)] if packed else [(4, 5, 32)] * 2))
    with _amp(level):
        if packed:
            _same_run(sw.swiglu, lambda x: torch.nn.functional.silu(
                x[..., :32]) * x[..., 32:], ins)
        else:   # as LlamaMLP calls it: g cast as the silu op casts it
            _same_run(lambda g, u: sw.swiglu(
                amp.cast_inputs("silu", g)[0], u),
                lambda g, u: nn_ops.silu(g) * u, ins)


CE_CASES = ["plain", "ignore", "all_ignored", "labels_n1", "shift",
            "strided_view"]


@pytest.mark.parametrize("dtype,level", PLAIN_SETTINGS)
@pytest.mark.parametrize("case", CE_CASES)
def test_cross_entropy_plain_is_the_former_op(dtype, level, case):
    from paddle_tpu_torch.ops.loss_ops import cross_entropy
    g = torch.Generator().manual_seed(6)
    v = 40
    ign = {"ignore": 3, "all_ignored": 7, "strided_view": 2}.get(case, -100)
    if case == "shift":
        (x,) = _leaves(7, dtype, (3, 11, v))
        lab = torch.randint(0, v, (3, 11), generator=g)
        with _amp(level):
            _same_run(
                lambda x: ce.softmax_cross_entropy(
                    x, lab, shift=True,
                    dtype=amp.cast_dtype("cross_entropy", x.dtype)),
                lambda x: _old_cross_entropy(x[:, :-1, :].reshape(-1, v),
                                             lab[:, 1:].reshape(-1)), [x])
        return
    shape = (3, 12, v) if case == "strided_view" else (20, v)
    (x,) = _leaves(8, dtype, shape)
    lab = torch.randint(0, v, shape[:-1], generator=g)
    if case == "ignore":
        lab[::3] = ign
    if case == "all_ignored":
        lab.fill_(ign)
    if case == "labels_n1":
        lab = lab[:, None].to(torch.int32)
    if case == "strided_view":
        lab = lab[:, ::2]
        lab[0] = ign
    view = (lambda t: t[:, ::2, :]) if case == "strided_view" else \
        (lambda t: t)
    with _amp(level):
        _same_run(lambda x: cross_entropy(view(x), lab, ignore_index=ign),
                  lambda x: _old_cross_entropy(view(x), lab, ign), [x])
        if case == "all_ignored":
            assert float(cross_entropy(x.detach(), lab,
                                       ignore_index=ign)) == 0.0


# ---------------------------------------------------------------------------
# the backward plain versions against autograd of the forward ones
# ---------------------------------------------------------------------------

BWD_SPECS = [
    ("rms plain fp32", fn.NormSpec("rms", 1e-5, torch.float32,
                                   torch.float32, None, torch.float32),
     torch.float32, None, False),
    ("rms O2 residual", fn.NormSpec("rms", 1e-5, torch.float32,
                                    torch.float32, torch.bfloat16,
                                    torch.float32),
     torch.bfloat16, torch.bfloat16, False),
    ("ln O2 residual", fn.NormSpec("ln", 1e-12, torch.float32, torch.float32,
                                   torch.bfloat16, torch.float32,
                                   torch.float32),
     torch.bfloat16, torch.float32, True),
    ("rms bf16 serving", fn.NormSpec("rms", 1e-5, torch.bfloat16,
                                     torch.bfloat16, torch.bfloat16,
                                     torch.bfloat16),
     torch.bfloat16, torch.bfloat16, False),
    ("ln fp32 fused pre-bias", fn.NormSpec(
        "ln", 1e-5, torch.float32, torch.float32, torch.float32,
        torch.float32, torch.float32, True), torch.float32, torch.float32,
     True),
    ("rms bf16 fused", fn.NormSpec("rms", 1e-6, torch.bfloat16,
                                   torch.bfloat16, torch.bfloat16,
                                   torch.bfloat16, None, True),
     torch.bfloat16, torch.bfloat16, False),
]


@pytest.mark.parametrize("name,spec,xd,rd,has_b", BWD_SPECS,
                         ids=[c[0] for c in BWD_SPECS])
def test_fused_norm_backward_plain_matches_autograd(name, spec, xd, rd,
                                                    has_b):
    rows, cols = 6, 64
    g = torch.Generator().manual_seed(12)

    def leaf(shape, dt, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g) * scale + shift).to(dt) \
            .requires_grad_()
    x = leaf((rows, cols), xd, 2.0)
    res = None if rd is None else leaf((rows, cols), rd)
    pb = leaf((cols,), spec.add, 0.2) if spec.fused and spec.add else None
    w = leaf((cols,), torch.bfloat16 if xd == torch.bfloat16 else
             torch.float32, 0.2, 1.0)
    b = leaf((cols,), w.dtype, 0.2) if has_b else None
    out, h = fn.fused_norm_reference(x, w, b, res, pb, spec=spec)
    dy = torch.randn(out.shape, generator=g).to(out.dtype)
    dres = None if h is None else torch.randn(h.shape, generator=g).to(
        h.dtype)
    outs, grads = [out], [dy]
    if h is not None:
        outs.append(h)
        grads.append(dres)
    ins = [t for t in (x, w, b, res, pb) if t is not None]
    auto = dict(zip([n for n, t in zip("xwbrp", (x, w, b, res, pb))
                     if t is not None],
                    torch.autograd.grad(outs, ins, grads)))
    hh = (x if h is None else h).detach()
    dx, dw, db, dpb = fn.fused_norm_bwd_reference(
        dy, dres, hh, w.detach(), spec=spec,
        dx_dtype=xd if spec.add is None else spec.add,
        bias_dtype=None if b is None else b.dtype,
        pre_bias_dtype=None if pb is None else pb.dtype)
    pairs = [(dx, auto["x"]), (dw, auto["w"])]
    if res is not None:
        pairs.append((dx, auto["r"]))
    if b is not None:
        pairs.append((db, auto["b"]))
    if pb is not None:
        pairs.append((dpb, auto["p"]))
    for got, want in pairs:
        got, want = got.float(), want.float()
        low = want.dtype != torch.float32 or xd == torch.bfloat16 or \
            spec.out == torch.bfloat16
        scale = float(want.abs().max())
        tol = (2.0 ** -7 if low else 1e-5) * (want.abs() + 0.01 * scale) \
            + 1e-6
        assert ((got - want).abs() <= tol).all(), (name, float(
            (got - want).abs().max()))


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_backward_plain_matches_autograd(neox, dtype):
    g = torch.Generator().manual_seed(13)
    x = torch.randn((2, 7, 3, 16), generator=g).to(dtype).requires_grad_()
    ang = torch.rand((10, 16 if not neox else 8), generator=g) * 6
    cos, sin = ang.cos(), ang.sin()
    kw = dict(offset=2, neox=neox, dtype=dtype, table_dtype=torch.bfloat16)
    (y,) = rp.rope_reference([x], cos, sin, **kw)
    dy = torch.randn(y.shape, generator=g).to(dtype)
    (want,) = torch.autograd.grad(y, x, dy)
    (got,) = rp.rope_reference([dy], cos, sin, backward=True, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_cpu_tensors_launch_no_kernel():
    counters = (fn.launches, rp.launches, sw.launches, ce.launches)
    before = [c.count for c in counters]
    x = torch.randn(4, 8, 2, 16, requires_grad=True)
    out, h = nn_ops.rms_norm(x, torch.ones(16), residual=x)
    (q,) = rp.rope(
        [x], torch.ones(8, 8), torch.zeros(8, 8))
    loss = ce.softmax_cross_entropy(x.reshape(-1, 16),
                                    torch.zeros(64, dtype=torch.long)) \
        + sw.swiglu(x).sum() + out.sum() + q.sum()
    loss.backward()
    assert [c.count for c in counters] == before


# ---------------------------------------------------------------------------
# the autograd functions around the kernels, with their launches replaced
# by the plain versions: every output and gradient lands in its slot
# ---------------------------------------------------------------------------

def _fake_norm_fwd(x, w, b, res, pb, spec, fns=None):
    with torch.no_grad():
        out, h = fn.fused_norm_reference(x, w, b, res, pb, spec=spec)
        hn = (x if h is None else h).to(spec.norm).float().reshape(
            -1, x.shape[-1])
        mean = hn.mean(-1) if spec.kind == "ln" else None
        var = hn.var(-1, unbiased=False) if spec.kind == "ln" else \
            hn.square().mean(-1)
    return out, h, mean, torch.rsqrt(var + spec.eps)


def _fake_norm_bwd(dy, dres, h, mean, rstd, weight, spec, *, dx_dtype,
                   want_w, bias_dtype, pre_bias_dtype, fns=None):
    dx, dw, db, dpb = fn.fused_norm_bwd_reference(
        dy, dres, h, weight, spec=spec, dx_dtype=dx_dtype,
        bias_dtype=bias_dtype, pre_bias_dtype=pre_bias_dtype)
    return dx, dw if want_w else None, db, dpb


def _fake_rope(xs, cos, sin, *, offset, positions, neox, dtype, table_dtype,
               backward, out_dtypes, fns=None):
    outs = rp.rope_reference(xs, cos, sin, offset=offset,
                             positions=positions, neox=neox, dtype=dtype,
                             table_dtype=table_dtype, backward=backward)
    return tuple(o.to(d) for o, d in zip(outs, out_dtypes))


def _fake_swiglu_fwd(g, u, packed, fns=None):
    with torch.no_grad():
        return sw.swiglu_reference(g, u)


def _fake_swiglu_bwd(g, u, dy, packed, fns=None):
    leaves = [t.detach().requires_grad_() for t in (g, u) if t is not None]
    with torch.enable_grad():   # a backward runs without grad mode
        return torch.autograd.grad(sw.swiglu_reference(*leaves), leaves, dy)


def _fake_ce_fwd(x3, lab2, l_used, ignore, x_cast, fns=None, *,
                 weight=None, eps=0.0, reduction="mean"):
    assert (weight, eps, reduction) == (None, 0.0, "mean")
    with torch.no_grad():
        rows = x3[:, :l_used].reshape(-1, x3.shape[-1]).to(x_cast).float()
        lab = lab2.reshape(-1).long()
        valid = (lab != ignore) if ignore >= 0 else torch.ones_like(
            lab, dtype=torch.bool)
        m = rows.max(-1).values
        logs = (rows - m[:, None]).exp().sum(-1).log()
        loss = ce.softmax_cross_entropy_reference(
            x3[:, :l_used].reshape(-1, x3.shape[-1]), lab, ignore,
            dtype=x_cast)
        out = torch.stack([loss, valid.sum().float()])
    return out, m, logs, valid.float()


def _fake_ce_bwd(x3, lab2, l_used, ignore, x_cast, m, logs, valid, out, g,
                 fns=None, *, weight=None, eps=0.0, reduction="mean"):
    assert (weight, eps, reduction) == (None, 0.0, "mean")
    leaf = x3.detach().requires_grad_()
    with torch.enable_grad():
        loss = ce.softmax_cross_entropy_reference(
            leaf[:, :l_used].reshape(-1, x3.shape[-1]), lab2.reshape(-1),
            ignore, dtype=x_cast)
        return torch.autograd.grad(loss, leaf, g)[0]


def _grads_of(outs, ins, seed=7):
    g = torch.Generator().manual_seed(seed)
    ws = [torch.randn(o.shape, generator=g) for o in outs]
    return torch.autograd.grad(
        sum((o.float() * w).sum() for o, w in zip(outs, ws)),
        [t for t in ins if t is not None])


@pytest.mark.parametrize("case", ["rms_o2_residual", "ln_fused_all",
                                  "rms_no_weight"])
def test_fused_norm_function_wiring(monkeypatch, case):
    monkeypatch.setattr(fn, "_launch_fwd", _fake_norm_fwd)
    monkeypatch.setattr(fn, "_launch_bwd", _fake_norm_bwd)
    f32, bf = torch.float32, torch.bfloat16
    spec, with_b, with_res, with_pb, with_w = {
        "rms_o2_residual": (fn.NormSpec("rms", 1e-5, f32, f32, bf, f32),
                            False, True, False, True),
        "ln_fused_all": (fn.NormSpec("ln", 1e-5, f32, f32, f32, f32, f32,
                                     True), True, True, True, True),
        "rms_no_weight": (fn.NormSpec("rms", 1e-6, f32, f32), False, False,
                          False, False)}[case]
    xd = bf if spec.add == bf else f32
    ins = _leaves(20, xd, (6, 32))
    x = ins[0]
    w = _leaves(21, xd, (32,))[0] if with_w else None
    b = _leaves(22, f32, (32,))[0] if with_b else None
    res = _leaves(23, xd, (6, 32))[0] if with_res else None
    pb = _leaves(24, f32, (32,))[0] if with_pb else None
    got = fn.FusedNorm.apply(x, w, b, res, pb, spec)
    got = got if isinstance(got, tuple) else (got,)
    want = fn.fused_norm_reference(x, w, b, res, pb, spec=spec)
    want = tuple(t for t in want if t is not None)
    assert len(got) == len(want)
    for a, c in zip(got, want):
        assert a.dtype == c.dtype and torch.equal(a, c)
    for a, c in zip(_grads_of(got, (x, w, b, res, pb)),
                    _grads_of(want, (x, w, b, res, pb))):
        assert a.dtype == c.dtype
        torch.testing.assert_close(a.float(), c.float(), rtol=2.0 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize("positions", [False, True])
def test_rope_function_wiring(monkeypatch, positions):
    monkeypatch.setattr(rp, "_launch", _fake_rope)
    q, k = _leaves(25, torch.bfloat16, (2, 5, 4, 16), (2, 5, 2, 16))
    ang = torch.rand(9, 8, generator=torch.Generator().manual_seed(1)) * 6
    cos, sin = ang.cos(), ang.sin()
    pos = torch.tensor([[0, 3, 8, 1, 2], [4, 4, 5, 6, 7]]) if positions \
        else None
    opts = dict(offset=0 if positions else 2, neox=True,
                dtype=torch.bfloat16, table_dtype=torch.bfloat16)
    got = rp.Rope.apply(cos, sin, pos, opts, q, k)
    want = rp.rope_reference([q, k], cos, sin, positions=pos, **opts)
    for a, c in zip(got, want):
        assert torch.equal(a, c)
    for a, c in zip(_grads_of(got, (q, k)), _grads_of(want, (q, k))):
        assert a.dtype == c.dtype and torch.equal(a, c)


@pytest.mark.parametrize("packed", [False, True])
def test_swiglu_function_wiring(monkeypatch, packed):
    monkeypatch.setattr(sw, "_launch_fwd", _fake_swiglu_fwd)
    monkeypatch.setattr(sw, "_launch_bwd", _fake_swiglu_bwd)
    ins = _leaves(26, torch.bfloat16, *([(3, 16)] if packed else
                                        [(3, 8)] * 2))
    args = (ins[0], None) if packed else tuple(ins)
    got = sw.SwiGLU.apply(*args)
    want = sw.swiglu_reference(*args)
    assert torch.equal(got, want)
    for a, c in zip(_grads_of([got], ins), _grads_of([want], ins)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("shift", [False, True])
def test_cross_entropy_function_wiring(monkeypatch, shift):
    monkeypatch.setattr(ce, "_launch_fwd", _fake_ce_fwd)
    monkeypatch.setattr(ce, "_launch_bwd", _fake_ce_bwd)
    (x,) = _leaves(27, torch.bfloat16, (2, 6, 10))
    lab = torch.randint(0, 10, (2, 6),
                        generator=torch.Generator().manual_seed(2))
    lab[0, 3] = 4
    if shift:
        x3, lab2, lu = x, lab[:, 1:], 5
    else:
        x3, lab2, lu = x, lab, 6
    got = ce.SoftmaxCrossEntropy.apply(x3, lab2, lu, 4, torch.float32)
    want = ce.softmax_cross_entropy_reference(x, lab, 4,
                                              dtype=torch.float32,
                                              shift=shift)
    torch.testing.assert_close(got, want)
    (ga,), (gb,) = _grads_of([got], [x]), _grads_of([want], [x])
    assert ga.dtype == gb.dtype and torch.equal(ga, gb)


def _kernel_path(monkeypatch):
    """CPU tensors take the kernel path, each launch done by its plain
    version."""
    for mod in (fn, rp, sw, ce):
        monkeypatch.setattr(mod, "plain_path", lambda t: False)
    monkeypatch.setattr(fn, "_launch_fwd", _fake_norm_fwd)
    monkeypatch.setattr(fn, "_launch_bwd", _fake_norm_bwd)
    monkeypatch.setattr(rp, "_launch", _fake_rope)
    monkeypatch.setattr(sw, "_launch_fwd", _fake_swiglu_fwd)
    monkeypatch.setattr(sw, "_launch_bwd", _fake_swiglu_bwd)
    monkeypatch.setattr(ce, "_launch_fwd", _fake_ce_fwd)
    monkeypatch.setattr(ce, "_launch_bwd", _fake_ce_bwd)


def _model_step(model_name, level):
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForSequenceClassification)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    g = torch.Generator().manual_seed(3)
    if model_name == "llama":
        cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
                               kv_heads=2, inter=48, max_pos=64)
        cfg.recompute = level == "O2"
        m = LlamaForCausalLM(cfg, device="cpu")
        ids = torch.randint(0, 64, (2, 16), generator=g)
        args, kw = (ids,), {"labels": ids}
    else:
        cfg = ErnieConfig.tiny(vocab=64, hidden=32, layers=2, heads=2,
                               inter=48, max_pos=32)
        cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
        m = ErnieForSequenceClassification(cfg, device="cpu")
        args = (torch.randint(1, 64, (2, 16), generator=g),)
        kw = {"labels": torch.randint(0, 2, (2,), generator=g)}
    if level:
        amp.decorate(m, level=level, dtype="bfloat16")
    with _amp(level):
        loss, _ = m(*args, **kw)
    loss.backward()
    return float(loss.detach()), {n: p.grad.float()
                                  for n, p in m.named_parameters()}


@pytest.mark.parametrize("model_name,level", [("llama", None),
                                              ("llama", "O2"),
                                              ("ernie", "O2")])
def test_models_train_through_the_autograd_functions(monkeypatch,
                                                     model_name, level):
    loss_p, grads_p = _model_step(model_name, level)
    _kernel_path(monkeypatch)
    loss_k, grads_k = _model_step(model_name, level)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for n, gp in grads_p.items():
        scale = float(gp.abs().max()) + 1e-12
        frac = 1e-5 if level is None else 2.0 ** -6
        assert float((grads_k[n] - gp).abs().max()) <= frac * scale, n


def test_serving_engine_runs_through_the_kernel_path(monkeypatch):
    # prefill (RoPE at an offset, the residual norm) and the paged decode
    # step (RoPE at the device positions t) through the autograd-free
    # kernel calls, every launch done by its plain version
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
                           kv_heads=2, inter=48, max_pos=64)
    m = LlamaForCausalLM(cfg, device="cpu")
    prompts = [np.random.default_rng(4).integers(0, 64, (n,), np.int32)
               for n in (9, 21)]

    def drain():
        eng = serving.Engine(*m.serving_callables(64), serving.ServingConfig(
            num_layers=2, num_heads=2, head_dim=8, max_len=64, max_batch=2,
            buckets=(1, 2), page_size=16, device="cpu"))
        futs = [eng.submit(serving.GenerationRequest(p, max_new_tokens=5))
                for p in prompts]
        eng.run()
        return [f.result(timeout=60).tokens for f in futs]
    want = drain()
    _kernel_path(monkeypatch)
    assert drain() == want
    ids = torch.from_numpy(prompts[0][None].astype(np.int64))
    assert m.generate(ids, max_new_tokens=5)[0, 9:].tolist() == want[0]
