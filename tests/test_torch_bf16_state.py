"""The bf16-state AdamW of ``benchmarks/bench_llama.py --state bf16``
(``AdamW(use_multi_tensor=True, moment_dtype="bfloat16",
use_master_weights=False)`` under ``amp.decorate(O2,
master_weight=False)``), moments in bf16 and fp16, and parameters of mixed
dtypes on the multi-tensor path, in the port (plain versions on the CPU)
against the JAX package on the same parameters and gradients.

* The master-free multi-tensor layout, built on bf16 parameters and built
  on fp32 ones that ``amp.decorate`` then casts: the flat storage is the
  bf16 parameters themselves (no fp32 buffer), 6 bytes a parameter with
  bf16 moments; with rounding off the parameters and moments are within
  one bf16 ulp of the JAX package's over 5 steps (they come out equal).
* Stochastic rounding: the port's rule given the JAX draw's bits gives
  ``paddle_tpu.optimizer._stochastic_round_bf16``'s result, bit for bit;
  on its own bits the port reproduces the JAX test
  ``test_master_free_without_sr_stalls_where_sr_learns`` (SGD and the
  multi-tensor AdamW); an element's draw does not depend on how the flat
  buffer splits into runs, nor on the launch (the bits are of the flat
  index, its high word included).
* bf16 and fp16 moments on the per-parameter and the multi-tensor paths:
  moments within one ulp of their dtype, fp32 parameters rtol 1e-6.
* Mixed fp32, bf16 and fp16 parameters on the multi-tensor path, with
  fp32 masters and master-free (the JAX package keeps an fp32 flat buffer
  for both): fp32 parameters rtol 1e-6, the low-precision ones within one
  ulp of their dtype; one launch per run of one dtype.
* The multi-tensor kernel's plain version: bf16 moments, the master-free
  storage with rounding on and off, and a closed gate writing nothing.
"""

import jax
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
from paddle_tpu_torch.ops._u32 import derive_seed

torch.set_num_threads(2)

SHAPES = [(64, 48), (48, 10)]
LR = 1e-2
RTOL = 1e-6
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
       torch.float32: jnp.float32}


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
            # a copy: jnp.asarray may alias the torch tensor's memory
            jl.bias._set_data(jnp.asarray(tl.bias.numpy().copy()))
    return jm, tm


def _grads(step, scale=0.5):
    rng = np.random.default_rng(100 + step)
    out = []
    for i, o in SHAPES:
        out += [rng.normal(0, scale, (i, o)).astype(np.float32),
                rng.normal(0, scale, (o,)).astype(np.float32)]
    return out


def _set_grads(jp, tp, gs):
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


def _close(got, want, dt):
    """``got`` within one ulp of ``dt`` of ``want`` (fp32: rtol 1e-6)."""
    if dt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)
    else:
        np.testing.assert_allclose(got, want, rtol=ULP[dt], atol=1e-30)


def _step_both(jo, to, jp, tp, steps=5, scale=0.5):
    for s in range(steps):
        _set_grads(jp, tp, _grads(s, scale))
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()


# ---------------------------------------------------------------------------
# the master-free multi-tensor layout (bench_llama's --state bf16)
# ---------------------------------------------------------------------------

def _bf16_state(order, sr=False):
    jm, tm = _models()
    kw = dict(learning_rate=LR, use_multi_tensor=True,
              moment_dtype="bfloat16", use_master_weights=False,
              stochastic_rounding=sr)
    if order == "built_on_bf16":
        # the parameters are bf16 before the optimizer sees them
        for pj, pt in zip(jm.parameters(), tm.parameters()):
            pj._set_data(pj._data.astype(jnp.bfloat16))
            pt.data = pt.data.to(torch.bfloat16)
    jo = jopt.AdamW(parameters=jm.parameters(), **kw)
    to = topt.AdamW(parameters=tm.parameters(), **kw)
    if order == "cast_after":
        jm, jo = paddle.amp.decorate(jm, jo, level="O2", dtype="bfloat16",
                                     master_weight=False)
        tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16",
                              master_weight=False)
    return jo, to, list(jm.parameters()), list(tm.parameters())


@pytest.mark.parametrize("order", ["built_on_bf16", "cast_after"])
def test_master_free_layout_without_sr_matches_jax(order):
    jo, to, jp, tp = _bf16_state(order)
    fs, jfs = to._flat, jo._fused
    assert fs.master.dtype == torch.bfloat16 == fs.m.dtype == fs.v.dtype
    assert jfs["master"]._data.dtype == jnp.bfloat16
    assert fs.master_free and not fs.lows and fs.param is None
    # no fp32 buffer of the parameters' size: 6 bytes a parameter (and
    # pad), the parameters views of the storage
    assert fs.state_bytes() == 6 * fs.total
    assert fs.grad.dtype == torch.bfloat16
    for p, (off, n) in zip(tp, fs.offsets):
        assert p.dtype == torch.bfloat16
        assert p.data_ptr() == fs.master.data_ptr() + 2 * off
    _step_both(jo, to, jp, tp)
    assert to.t == 5
    for pj, pt in zip(jp, tp):
        _close(_np32(pt), _np32(pj), torch.bfloat16)
    for mine, ref in ((fs.m, "m"), (fs.v, "v")):
        for (off, n), (joff, jn) in zip(fs.offsets, jfs["offsets"]):
            _close(_np32(mine[off:off + n]),
                   _np32(jfs[ref]._data[joff:joff + jn]), torch.bfloat16)


def test_rounding_given_jax_bits_matches_jax():
    x = jnp.asarray(np.concatenate([
        np.random.default_rng(0).normal(0, 1, 4093).astype(np.float32),
        np.array([np.inf, -np.inf, np.nan], np.float32)]))
    for s in range(3):
        key = jax.random.PRNGKey(s)
        want = jopt._stochastic_round_bf16(x, key)
        bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32)
                          & jnp.uint32(0xFFFF)).astype(np.int64)
        got = q8_adam.stochastic_round_bf16(torch.from_numpy(np.asarray(x)),
                                            torch.from_numpy(bits))
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy()[:-1],
            np.asarray(want).view(np.int16)[:-1])
        assert torch.isnan(got[-1])


@pytest.mark.parametrize("opt", ["sgd", "adamw_multi_tensor"])
def test_master_free_without_sr_stalls_where_sr_learns(opt):
    # tests/test_reduced_state_optimizer.py's property on the port's bits:
    # a step of about ulp(1.0) / 80 a step is lost by rounding to nearest
    # and kept in expectation by stochastic rounding
    out = {}
    for sr in (True, False):
        w = torch.nn.Parameter(torch.ones(1, 1, dtype=torch.bfloat16))
        if opt == "sgd":
            o = topt.SGD(learning_rate=1.0, parameters=[w])
            o._use_master_weights = False
            o._stochastic_rounding = sr
        else:
            o = topt.AdamW(learning_rate=1e-4, parameters=[w],
                           weight_decay=0.0, use_multi_tensor=True,
                           moment_dtype="bfloat16", use_master_weights=False,
                           stochastic_rounding=sr)
        for _ in range(4000):
            w.grad = torch.full((1, 1), 1e-4, dtype=torch.bfloat16)
            o.step()
        out[sr] = float(w.detach().float())
    assert abs(out[False] - 1.0) < 1e-6
    assert out[True] < 0.8


def _three_param_opt(sr=True):
    ps = [torch.nn.Parameter((torch.arange(n, dtype=torch.float32) % 7 - 3)
                             .mul(0.01).to(torch.bfloat16))
          for n in (300, 200, 130)]
    o = topt.AdamW(learning_rate=1e-3, parameters=ps, use_multi_tensor=True,
                   moment_dtype="bfloat16", use_master_weights=False,
                   stochastic_rounding=sr, seed=7)
    return ps, o


def test_draws_do_not_depend_on_the_runs():
    # one run (every parameter with a gradient) and two runs (the middle
    # one without): the first and last parameters take the same bits
    out = []
    for skip in (False, True):
        ps, o = _three_param_opt()
        for s in range(3):
            for i, p in enumerate(ps):
                p.grad = None if (skip and i == 1) else torch.full_like(
                    p, 0.3 * (i + 1) * (-1) ** s)
            o.step()
        assert len(o._flat.runs(o._flat.gather_grads())) == (2 if skip
                                                             else 1)
        out.append([p.detach().clone() for p in ps])
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][2], out[1][2])
    assert not torch.equal(out[0][1], out[1][1])


def test_update_split_into_pieces_draws_the_same_bits():
    # the plain version over the whole buffer and over two launches at
    # their flat offsets: bit-equal (master-free, rounding on)
    n = 5000
    g = torch.Generator().manual_seed(3)
    w = (torch.randn(n, generator=g) * 0.02).to(torch.bfloat16)
    m = (torch.randn(n, generator=g) * 1e-3).to(torch.bfloat16)
    v = (torch.rand(n, generator=g) * 1e-4).to(torch.bfloat16)
    grad = (torch.randn(n, generator=g) * 1e-2).to(torch.bfloat16)
    sc = q8_adam.scalar_block(1e-3, 0.19, 0.002, decay=1 - 1e-5)
    seed = derive_seed(torch.tensor(7), torch.tensor(3))
    kw = dict(scalars=sc, eps=1e-8, beta1=0.9, beta2=0.999, has_wd=True,
              seed=seed, stochastic_rounding=True)
    one = [x.clone() for x in (w, m, v)]
    mta.multi_tensor_adam_update(*one, None, grad, **kw)
    two = [x.clone() for x in (w, m, v)]
    for a, b in ((0, 2048), (2048, n)):
        mta.multi_tensor_adam_update(*(x[a:b] for x in two), None,
                                     grad[a:b], base=a, **kw)
    for x, y in zip(one, two):
        assert torch.equal(x, y)
    # the chunked plain version draws as one piece
    old = mta._REF_CHUNK
    mta._REF_CHUNK = 1024
    try:
        three = [x.clone() for x in (w, m, v)]
        mta.multi_tensor_adam_update(*three, None, grad, **kw)
    finally:
        mta._REF_CHUNK = old
    for x, y in zip(one, three):
        assert torch.equal(x, y)
    # rounding on moved some elements another way than to nearest
    near = [x.clone() for x in (w, m, v)]
    mta.multi_tensor_adam_update(*near, None, grad,
                                 **dict(kw, stochastic_rounding=False))
    assert torch.equal(near[1], one[1]) and torch.equal(near[2], one[2])
    assert not torch.equal(near[0], one[0])


def test_sr_bits_of_flat_indices_mix_the_high_word():
    # bits from an offset are the tail of bits from 0, and an index past
    # 2^32 draws other bits than the index 2^32 below it
    seed = 12345
    np.testing.assert_array_equal(
        q8_adam.sr_bits(seed, 1000, base=5000).numpy(),
        q8_adam.sr_bits(seed, 6000)[5000:].numpy())
    lo = q8_adam.sr_bits(seed, 4096, base=7)
    hi = q8_adam.sr_bits(seed, 4096, base=(1 << 32) + 7)
    assert (lo != hi).float().mean() > 0.99
    assert int(hi.min()) >= 0 and int(hi.max()) < 1 << 16


def test_gate_closed_writes_nothing_master_free():
    n = 1000
    g = torch.Generator().manual_seed(1)
    w = torch.randn(n, generator=g).to(torch.bfloat16)
    m, v = torch.zeros(n, dtype=torch.bfloat16), torch.ones(
        n, dtype=torch.bfloat16)
    grad = torch.randn(n, generator=g).to(torch.bfloat16)
    sc = q8_adam.scalar_block(1e-3, 0.1, 0.001, gate=0.0)
    st = [x.clone() for x in (w, m, v)]
    mta.multi_tensor_adam_update(*st, None, grad, scalars=sc, eps=1e-8,
                                 beta1=0.9, beta2=0.999, has_wd=False,
                                 seed=5, stochastic_rounding=True)
    for a, b in zip(st, (w, m, v)):
        assert torch.equal(a, b)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    n = 64
    bf = torch.zeros(n, dtype=torch.bfloat16)
    f = torch.zeros(n)
    sc = q8_adam.scalar_block(1e-3, 0.1, 0.001)
    kw = dict(scalars=sc, eps=1e-8, beta1=0.9, beta2=0.999, has_wd=False)
    with pytest.raises(ValueError, match="master-free"):
        mta.multi_tensor_adam_update(bf, bf, bf, bf.clone(), bf, **kw)
    with pytest.raises(ValueError, match="master-free"):
        mta.multi_tensor_adam_update(bf, bf, bf, None, f, **kw)
    with pytest.raises(ValueError, match="stochastic"):
        mta.multi_tensor_adam_update(f, f, f, None, f,
                                     stochastic_rounding=True, seed=1, **kw)
    with pytest.raises(ValueError, match="one dtype"):
        mta.multi_tensor_adam_update(f, bf, f, None, f, **kw)


# ---------------------------------------------------------------------------
# moments in bf16 and fp16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi", [False, True], ids=["per_param",
                                                      "multi_tensor"])
@pytest.mark.parametrize("mdt", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_low_precision_moments_match_jax(multi, mdt):
    jm, tm = _models()
    name = str(mdt).replace("torch.", "")
    kw = dict(learning_rate=LR, moment_dtype=name, use_multi_tensor=multi)
    jo = jopt.AdamW(parameters=jm.parameters(), **kw)
    to = topt.AdamW(parameters=tm.parameters(), **kw)
    jp, tp = list(jm.parameters()), list(tm.parameters())
    _step_both(jo, to, jp, tp, scale=0.05)
    for pj, pt in zip(jp, tp):
        _close(_np32(pt), _np32(pj), torch.float32)
    if multi:
        fs, jfs = to._flat, jo._fused
        assert fs.m.dtype == fs.v.dtype == mdt
        pairs = [(fs.m[o:o + n], jfs["m"]._data[jo_:jo_ + n])
                 for (o, n), (jo_, _) in zip(fs.offsets, jfs["offsets"])] + \
            [(fs.v[o:o + n], jfs["v"]._data[jo_:jo_ + n])
             for (o, n), (jo_, _) in zip(fs.offsets, jfs["offsets"])]
    else:
        pairs = [(to._accumulators[a][id(pt)],
                  jo._accumulators[a][id(pj)]._data)
                 for a in ("moment1", "moment2") for pj, pt in zip(jp, tp)]
    for mine, ref in pairs:
        assert mine.dtype == mdt and ref.dtype == JDT[mdt]
        _close(_np32(mine), _np32(ref), mdt)
    assert set(to.state_dict()) >= {f"{to._name(0)}_moment1",
                                    f"{to._name(0)}_moment2"}


def test_moment_dtype_values_as_the_reference():
    p = [torch.nn.Parameter(torch.zeros(4))]
    jp = list(paddle.nn.Linear(2, 2).parameters())
    for md in ("float32", "bfloat16", "float16", "int8"):
        topt.AdamW(parameters=p, moment_dtype=md)
    for md in ("foo", "bfloat"):
        with pytest.raises(TypeError):
            jopt.AdamW(parameters=jp, moment_dtype=md)
        with pytest.raises(TypeError):
            topt.AdamW(parameters=p, moment_dtype=md)


# ---------------------------------------------------------------------------
# parameters of mixed dtypes on the multi-tensor path
# ---------------------------------------------------------------------------

MIXED = (torch.float32, torch.bfloat16, torch.float16, torch.bfloat16)


@pytest.mark.parametrize("master", [None, False], ids=["masters",
                                                       "master_free"])
def test_mixed_dtypes_match_jax(master):
    jm, tm = _models()
    jp, tp = list(jm.parameters()), list(tm.parameters())
    with torch.no_grad():
        for pj, pt, dt in zip(jp, tp, MIXED):
            pt.data = pt.data.to(dt)
            pj._set_data(pj._data.astype(JDT[dt]))
    kw = dict(learning_rate=LR, use_multi_tensor=True,
              use_master_weights=master, stochastic_rounding=False)
    jo = jopt.AdamW(parameters=jp, **kw)
    to = topt.AdamW(parameters=tp, **kw)
    fs = to._flat
    assert fs.master.dtype == torch.float32
    assert jo._fused["master"]._data.dtype == jnp.float32
    assert fs.grad.dtype == torch.float32
    assert set(fs.lows) == {torch.bfloat16, torch.float16}
    for p, (off, _), dt in zip(tp, fs.offsets, MIXED):
        assert p.dtype == dt
        flat = fs.master if dt == torch.float32 else fs.lows[dt]
        assert p.data_ptr() == flat.data_ptr() + flat.element_size() * off
    # every parameter's dtype differs from its neighbour's: one launch each
    assert len(fs.runs((True,) * 4)) == 4
    _step_both(jo, to, jp, tp, scale=0.05)
    for pj, pt, dt in zip(jp, tp, MIXED):
        _close(_np32(pt), _np32(pj), dt)
    for (off, n), (joff, jn) in zip(fs.offsets, jo._fused["offsets"]):
        _close(fs.master[off:off + n].numpy(),
               _np32(jo._fused["master"]._data[joff:joff + jn]),
               torch.float32)
    # the low-precision parameters are rounded to nearest from the master
    for p, (off, n), dt in zip(tp, fs.offsets, MIXED):
        assert torch.equal(p.detach().reshape(-1),
                           fs.master[off:off + n].to(dt))
