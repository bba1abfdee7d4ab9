"""The port's fused inference stack against ``paddle_tpu.incubate`` on the
CPU: ``masked_multihead_attention`` (the dense branch, plain PyTorch in
both packages; the paged branch, the port's plain version against the
Pallas decode kernel under the interpreter), ``FusedMultiTransformer``
(prefill with and without caches, the causal ``seq_offset`` prefill,
decode over a list of caches, a stacked cache and the paged pool,
gradients), the state-dict converter, and the serving engine over the
bench's FMT stack (``tools/fmt_stack.py``) against the JAX engine with its
paged kernel on.

Sizes: E 128, H 2 (D 64), FF 256, L 2, vocab 64, fp32. The same numpy
weights (through ``convert.fmt_state_dict_from_paddle_tpu``) and inputs
go to both packages. Tolerances: fp32 outputs and caches rtol 1e-5 and
atol 1e-6 in units of the tensor's largest magnitude (outputs reach 4-5,
where XLA's and MKL's fp32 sums differ by a few ulps, 4.8e-7 each); pools
after a token write: native fp32 and int8 pools to the paged kernel's
atol 1e-5 after six decode steps; a bf16 pool is not bit-equal, since a
token's fp32 K/V that agree within RTOL can still lie on either side of a
bf16 midpoint: each element is within that tolerance of JAX's or one
bf16 step from it, and at most 1% of the elements written differ; token
transcripts equal; weight
gradients 1e-4 of each tensor's largest element.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import serving as jserving
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.incubate import nn as jinn
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch import serving
from paddle_tpu_torch.convert import fmt_state_dict_from_paddle_tpu
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.tools.fmt_stack import FMTStack

torch.set_num_threads(2)

E, H, FF, L, V = 128, 2, 256, 2, 64
D = E // H
B, S = 2, 12
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _retire_jax_engine_beacon():
    """The JAX reference engines here run to the end of their traffic
    without ``stop()``, which is what retires their ``serving.engine``
    beacon: retire it at teardown, or it goes stale 60 s later and every
    later ``/healthz`` in this process reads unhealthy."""
    yield
    jtrace.heartbeat_clear("serving.engine")


def _close(got, want):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL * scale)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x)


def _random_fmt_state(rng):
    """Weights at 1/sqrt(fan-in), biases and LN parameters away from their
    defaults, so that every parameter matters."""
    sd = {}
    for i in range(L):
        for tag, shape, fan in (
                ("ln_scale", (E,), 0), ("ln_bias", (E,), 0),
                ("qkv_w", (3, H, D, E), E), ("qkv_b", (3, H, D), 0),
                ("out_w", (E, E), E), ("out_b", (E,), 0),
                ("ffn_ln_scale", (E,), 0), ("ffn_ln_bias", (E,), 0),
                ("ffn1_w", (E, FF), E), ("ffn1_b", (FF,), 0),
                ("ffn2_w", (FF, E), FF), ("ffn2_b", (E,), 0)):
            x = rng.standard_normal(shape)
            x = x / np.sqrt(fan) if fan else 0.1 * x
            if tag.endswith("scale"):
                x = x + 1.0
            sd[f"l{i}_{tag}"] = x.astype(np.float32)
    return sd


def _jax_load(layer, np_state):
    layer.set_state_dict({k: paddle.to_tensor(v) for k, v in np_state.items()})


@pytest.fixture(scope="module")
def fmt_pair():
    paddle.seed(5)
    jf = jinn.FusedMultiTransformer(E, H, FF, num_layers=L,
                                    activation="gelu")
    jf.eval()
    state = _random_fmt_state(np.random.default_rng(0))
    _jax_load(jf, state)
    tf = tinn.FusedMultiTransformer(E, H, FF, num_layers=L, device="cpu")
    tf.load_state_dict(fmt_state_dict_from_paddle_tpu(state), strict=True)
    tf.eval().requires_grad_(False)
    yield jf, tf, state
    import gc
    del jf
    gc.collect()


def _x(rng, s, b=B):
    return rng.standard_normal((b, s, E)).astype(np.float32)


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

def test_converter_round_trip_keeps_keys_and_outputs(fmt_pair):
    jf, tf, state = fmt_pair
    assert set(tf.state_dict()) == set(jf.state_dict()) == set(state)
    x = _x(np.random.default_rng(1), S)
    want = _np(jf(paddle.to_tensor(x)))
    _close(tf(torch.from_numpy(x)), want)
    # back: the port's weights into a fresh JAX layer compute the same
    paddle.seed(9)
    jf2 = jinn.FusedMultiTransformer(E, H, FF, num_layers=L)
    jf2.eval()
    _jax_load(jf2, {k: v.numpy() for k, v in tf.state_dict().items()})
    np.testing.assert_array_equal(_np(jf2(paddle.to_tensor(x))), want)
    bad = dict(state)
    del bad["l1_ffn2_b"]
    with pytest.raises(ValueError, match="l1_ffn2_b"):
        fmt_state_dict_from_paddle_tpu(bad)
    bad = dict(state, l0_qkv_b=np.zeros((3, H, D + 1), np.float32))
    with pytest.raises(ValueError, match="l0_qkv_b"):
        fmt_state_dict_from_paddle_tpu(bad)


# ---------------------------------------------------------------------------
# masked_multihead_attention
# ---------------------------------------------------------------------------

MMHA_CASES = [  # t per row, mask shape (None, "b1", "bh"), bias
    ([3, 7], None, False),
    ([0, 9], None, True),
    ([5, 5], "b1", False),
    ([2, 8], "bh", True),
    ([9, 4], "b1", True),
]


@pytest.mark.parametrize("t,mask,bias", MMHA_CASES,
                         ids=lambda c: str(c).replace(" ", ""))
def test_mmha_dense_matches_jax(t, mask, bias):
    rng = np.random.default_rng(sum(t))
    max_len = 10
    x = rng.standard_normal((B, 3 * E)).astype(np.float32)
    cache = rng.standard_normal((2, B, H, max_len, D)).astype(np.float32)
    tt = np.asarray(t, np.int32)
    # stale contents at t must be overwritten, not added to
    cache[:, np.arange(B), :, tt] = 99.0
    kw = {}
    if bias:
        kw["bias"] = rng.standard_normal(3 * E).astype(np.float32)
    if mask is not None:
        lm = max(t) + 1
        m = rng.standard_normal((B, 1 if mask == "b1" else H, 1, lm))
        kw["src_mask"] = m.astype(np.float32)
    jo, jc = jinn.functional.masked_multihead_attention(
        paddle.to_tensor(x), cache_kv=paddle.to_tensor(cache),
        sequence_lengths=paddle.to_tensor(tt),
        **{k: paddle.to_tensor(v) for k, v in kw.items()})
    tc = torch.from_numpy(cache.copy())
    to, tc2 = tinn.functional.masked_multihead_attention(
        torch.from_numpy(x), cache_kv=tc,
        sequence_lengths=torch.from_numpy(tt),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert tc2 is tc                                     # in place
    _close(to, _np(jo))
    _close(tc, _np(jc))
    assert not (tc.numpy()[:, np.arange(B), :, tt] == 99.0).any()


@pytest.mark.parametrize("t,mask,bias", MMHA_CASES,
                         ids=lambda c: str(c).replace(" ", ""))
def test_mmha_dense_bf16_matches_jax_to_a_bf16_rounding(t, mask, bias):
    """bf16 inputs: the port takes the attention in fp32 and rounds once,
    the JAX package takes it in bf16. The outputs agree within 2^-7 of
    their largest magnitude (one bf16 ulp of the top binade), elementwise
    and in norm; the cache after the token write bit for bit."""
    rng = np.random.default_rng(sum(t))
    max_len = 10
    x = rng.standard_normal((B, 3 * E)).astype(np.float32)
    cache = rng.standard_normal((2, B, H, max_len, D)).astype(np.float32)
    tt = np.asarray(t, np.int32)
    kw = {}
    if bias:
        kw["bias"] = rng.standard_normal(3 * E).astype(np.float32)
    if mask is not None:
        m = rng.standard_normal((B, 1 if mask == "b1" else H, 1, max(t) + 1))
        kw["src_mask"] = m.astype(np.float32)

    def jbf(a):
        return paddle.to_tensor(a).astype("bfloat16")

    def tbf(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    jo, jc = jinn.functional.masked_multihead_attention(
        jbf(x), cache_kv=jbf(cache), sequence_lengths=paddle.to_tensor(tt),
        **{k: jbf(v) for k, v in kw.items()})
    tc = tbf(cache)
    to, _ = tinn.functional.masked_multihead_attention(
        tbf(x), cache_kv=tc, sequence_lengths=torch.from_numpy(tt),
        **{k: tbf(v) for k, v in kw.items()})
    assert to.dtype == torch.bfloat16
    want = np.asarray(jo._data.astype(jnp.float32))
    got = to.float().numpy()
    lim = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got - want).max() <= lim
    assert np.linalg.norm(got - want) <= 2.0 ** -7 * np.linalg.norm(want)
    np.testing.assert_array_equal(
        tc.float().numpy(), np.asarray(jc._data.astype(jnp.float32)))


def test_mmha_dense_defaults_and_bounds():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 3 * E)).astype(np.float32)
    cache = rng.standard_normal((2, B, H, 4, D)).astype(np.float32)
    # no sequence_lengths: t = 0 for every row; a scalar broadcasts
    jo, _ = jinn.functional.masked_multihead_attention(
        paddle.to_tensor(x), cache_kv=paddle.to_tensor(cache))
    to, _ = tinn.functional.masked_multihead_attention(
        torch.from_numpy(x), cache_kv=torch.from_numpy(cache.copy()))
    _close(to, _np(jo))
    ts, _ = tinn.functional.masked_multihead_attention(
        torch.from_numpy(x), cache_kv=torch.from_numpy(cache.copy()),
        sequence_lengths=torch.tensor(0, dtype=torch.int32))
    assert torch.equal(ts, to)
    for mha, wrap in ((jinn.functional.masked_multihead_attention,
                       paddle.to_tensor),
                      (tinn.functional.masked_multihead_attention,
                       torch.from_numpy)):
        with pytest.raises(ValueError, match="max_len"):
            mha(wrap(x), cache_kv=wrap(cache.copy()),
                sequence_lengths=wrap(np.asarray([1, 4], np.int32)))


PB, PPS, PP = 3, 16, 10                   # rows, page size, pool pages
PTABLES = np.asarray([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)


def _paged_pool(leg, rng):
    poolf = rng.standard_normal((PP, L, 2, H, PPS, D)).astype(np.float32)
    if leg == "int8":
        q8, sc = jkv.quantize_pages(jnp.asarray(poolf))
        return np.asarray(q8), np.asarray(sc)
    if leg == "bf16":
        return np.asarray(jnp.asarray(poolf).astype(jnp.bfloat16)), None
    return poolf, None


def _torch_of(a):
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16).view(np.int16) if a.dtype.name == "bfloat16" \
        else a


@pytest.mark.parametrize("leg", ["native", "bf16", "int8"])
def test_mmha_paged_matches_jax_kernel(leg):
    rng = np.random.default_rng(7)
    pool, scales = _paged_pool(leg, rng)
    x = rng.standard_normal((PB, 3 * E)).astype(np.float32)
    bias = rng.standard_normal(3 * E).astype(np.float32)
    t = np.asarray([PPS - 1, PPS, 2 * PPS + 3], np.int32)
    layer = 1
    jview = jpa.PagedDecodeCache(
        pool=paddle.to_tensor(pool), tables=paddle.to_tensor(PTABLES),
        t=paddle.to_tensor(t), page_size=PPS,
        scales=None if scales is None else paddle.to_tensor(scales),
        impl="kernel", interpret=True).at_layer(paddle.to_tensor(layer))
    jo, jview2 = jinn.functional.masked_multihead_attention(
        paddle.to_tensor(x), bias=paddle.to_tensor(bias), cache_kv=jview)
    tpool, tsc = _torch_of(pool), _torch_of(scales)
    tview = tpa.PagedDecodeCache(pool=tpool, tables=torch.from_numpy(PTABLES),
                                 t=torch.from_numpy(t), page_size=PPS,
                                 scales=tsc).at_layer(layer)
    to, tview2 = tinn.functional.masked_multihead_attention(
        torch.from_numpy(x), bias=torch.from_numpy(bias), cache_kv=tview)
    assert tview2.pool is tpool
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(_bits(tpool), _bits(_np(jview2.pool)))
    if leg == "int8":
        np.testing.assert_array_equal(tsc.numpy(), _np(jview2.scales))
    with pytest.raises(NotImplementedError, match="src_mask"):
        tinn.functional.masked_multihead_attention(
            torch.from_numpy(x), cache_kv=tview,
            src_mask=torch.zeros(PB, 1, 1, 4))


# ---------------------------------------------------------------------------
# refusals: the same exception type in both packages
# ---------------------------------------------------------------------------

def _refusal_calls(pkg, wrap):
    mha = pkg.functional.masked_multihead_attention
    x = wrap(np.zeros((B, 3 * E), np.float32))
    cache = wrap(np.zeros((2, B, H, 4, D), np.float32))
    src = wrap(np.zeros((B, 1, E), np.float32))
    return {
        "rotary_tensor": lambda f: mha(x, cache_kv=cache, rotary_tensor=x),
        "beam_cache_offset": lambda f: mha(x, cache_kv=cache,
                                           beam_cache_offset=x),
        "out_shift": lambda f: mha(x, cache_kv=cache, out_shift=x),
        "out_smooth": lambda f: mha(x, cache_kv=cache, out_smooth=x),
        "no_cache": lambda f: mha(x),
        "rotary_embs": lambda f: f(src, rotary_embs=src),
        "pre_caches": lambda f: f(src, pre_caches=[cache]),
        "seq_lens": lambda f: f(src, seq_lens=x),
        "seq_offset_with_time_step": lambda f: f(
            src, caches=wrap(np.zeros((L, 2, B, H, 4, D), np.float32)),
            time_step=1, seq_offset=0),
        "seq_offset_without_stacked_cache": lambda f: f(src, seq_offset=0),
        "seq_offset_with_cache_list": lambda f: f(
            src, caches=[cache] * L, seq_offset=0),
        "post_ln": lambda f: pkg.FusedMultiTransformer(
            E, H, FF, num_layers=1, normalize_before=False,
            **({"device": "cpu"} if pkg is tinn else {})),
        "trans_qkvw_false": lambda f: pkg.FusedMultiTransformer(
            E, H, FF, num_layers=1, trans_qkvw=False,
            **({"device": "cpu"} if pkg is tinn else {})),
    }


REFUSALS = list(_refusal_calls(tinn, torch.from_numpy))


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_raise_the_same_type_in_both_packages(fmt_pair, name):
    jf, tf, _ = fmt_pair
    types = []
    for pkg, wrap, f in ((jinn, paddle.to_tensor, jf),
                         (tinn, torch.from_numpy, tf)):
        with pytest.raises((NotImplementedError, ValueError)) as info:
            _refusal_calls(pkg, wrap)[name](f)
        types.append(info.type)
    assert types[0] is types[1], types


def test_paged_decode_with_attn_mask_raises(fmt_pair):
    _, tf, _ = fmt_pair
    view = tpa.PagedDecodeCache(
        pool=torch.zeros(4, L, 2, H, PPS, D),
        tables=torch.ones(1, 2, dtype=torch.int32),
        t=torch.zeros(1, dtype=torch.int32), page_size=PPS)
    with pytest.raises(NotImplementedError, match="attn_mask"):
        tf(torch.zeros(1, 1, E), caches=view, time_step=0,
           attn_mask=torch.zeros(1, 1, 1, 2))


# ---------------------------------------------------------------------------
# FusedMultiTransformer: prefill and decode
# ---------------------------------------------------------------------------

def _causal(s):
    return np.where(np.tril(np.ones((s, s), bool)), 0.0, -1e30
                    ).astype(np.float32)[None, None].repeat(B, 0)


@pytest.mark.parametrize("kind", ["none", "list", "stacked", "masked"])
def test_prefill_matches_jax(fmt_pair, kind):
    jf, tf, _ = fmt_pair
    rng = np.random.default_rng(3)
    x = _x(rng, S)
    max_len = S + 4
    zeros = np.zeros((2, B, H, max_len, D), np.float32)
    if kind == "none":
        _close(tf(torch.from_numpy(x)), _np(jf(paddle.to_tensor(x))))
        return
    if kind == "masked":
        m = _causal(S)
        _close(tf(torch.from_numpy(x), attn_mask=torch.from_numpy(m)),
               _np(jf(paddle.to_tensor(x), attn_mask=paddle.to_tensor(m))))
        return
    if kind == "list":
        jc = [paddle.to_tensor(zeros) for _ in range(L)]
        tc = [torch.from_numpy(zeros.copy()) for _ in range(L)]
    else:
        jc = paddle.to_tensor(np.stack([zeros] * L))
        tc = torch.from_numpy(np.stack([zeros] * L))
    jo, jc2 = jf(paddle.to_tensor(x), caches=jc)
    to, tc2 = tf(torch.from_numpy(x), caches=tc)
    assert tc2 is tc
    _close(to, _np(jo))
    if kind == "list":
        for a, b in zip(tc, jc2):
            _close(a, _np(b))
    else:
        _close(tc, _np(jc2))


@pytest.mark.parametrize("off", [0, 8])
def test_seq_offset_prefill_matches_jax_and_the_full_causal_prefill(fmt_pair,
                                                                     off):
    jf, tf, _ = fmt_pair
    x = _x(np.random.default_rng(4), S)
    shape = (L, 2, B, H, S + 4, D)
    # the full causal prefill, in the port
    full = torch.zeros(shape)
    full_out, _ = tf(torch.from_numpy(x), caches=full, seq_offset=0)
    # the prefix, then the tail at off, in both packages
    tc = torch.zeros(shape)
    jc = paddle.to_tensor(np.zeros(shape, np.float32))
    if off:
        tf(torch.from_numpy(x[:, :off]), caches=tc, seq_offset=0)
        _, jc = jf(paddle.to_tensor(x[:, :off]), caches=jc, seq_offset=0)
    to, _ = tf(torch.from_numpy(x[:, off:]), caches=tc, seq_offset=off)
    jo, jc = jf(paddle.to_tensor(x[:, off:]), caches=jc, seq_offset=off)
    _close(to, _np(jo))
    _close(tc, _np(jc))
    _close(to, full_out[:, off:])
    _close(tc[:, :, :, :, off:S], full[:, :, :, :, off:S])
    if off == 0:
        # causal: position i is the full prefill's of x[:, :i + 1]
        _close(to[:, :5], tf(torch.from_numpy(x[:, :5]), caches=torch.zeros(
            shape), seq_offset=0)[0])


NSTEPS = 6


def _prefilled(rng, max_len):
    x = _x(rng, S)
    steps = rng.standard_normal((NSTEPS, B, 1, E)).astype(np.float32)
    return x, steps


def test_decode_list_and_stacked_match_jax_and_each_other(fmt_pair):
    jf, tf, _ = fmt_pair
    max_len = S + NSTEPS
    x, steps = _prefilled(np.random.default_rng(5), max_len)
    zeros = np.zeros((2, B, H, max_len, D), np.float32)
    mask = paddle.to_tensor(_causal(S))
    _, jc = jf(paddle.to_tensor(x), attn_mask=mask,
               caches=[paddle.to_tensor(zeros) for _ in range(L)])
    tl = [torch.from_numpy(zeros.copy()) for _ in range(L)]
    tf(torch.from_numpy(x), attn_mask=torch.from_numpy(_causal(S)), caches=tl)
    ts = torch.stack(tl).clone()
    for k in range(NSTEPS):
        jo, jc = jf(paddle.to_tensor(steps[k]), caches=jc, time_step=S + k)
        lo, tl = tf(torch.from_numpy(steps[k]), caches=tl, time_step=S + k)
        so, ts = tf(torch.from_numpy(steps[k]), caches=ts,
                    time_step=torch.tensor(S + k, dtype=torch.int32))
        _close(lo, _np(jo))
        # one decode body serves both cache kinds: bit for bit
        assert torch.equal(lo, so)
    for i in range(L):
        _close(tl[i], _np(jc[i]))
        assert torch.equal(tl[i], ts[i])


@pytest.mark.parametrize("leg", ["native", "bf16", "int8"])
def test_decode_paged_matches_jax(fmt_pair, leg):
    jf, tf, _ = fmt_pair
    ps, per_slot = 8, 3
    max_len = ps * per_slot
    x, steps = _prefilled(np.random.default_rng(6), max_len)
    # prefill both into stacked caches, then into each package's pool
    jdense = paddle.to_tensor(np.zeros((L, 2, B, H, max_len, D), np.float32))
    _, jdense = jf(paddle.to_tensor(x), caches=jdense, seq_offset=0)
    tdense = torch.zeros(L, 2, B, H, max_len, D)
    tf(torch.from_numpy(x), caches=tdense, seq_offset=0)
    _close(tdense, _np(jdense))
    dense = _np(jdense)
    tables = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    npages = 1 + B * per_slot
    pool = np.zeros((npages, L, 2, H, ps, D), np.float32)
    for b in range(B):
        for j, pid in enumerate(tables[b]):
            pool[pid] = dense[:, :, b, :, j * ps:(j + 1) * ps]
    scales = None
    if leg == "int8":
        q8, sc = jkv.quantize_pages(jnp.asarray(pool))
        pool, scales = np.asarray(q8), np.asarray(sc)
    elif leg == "bf16":
        pool = np.asarray(jnp.asarray(pool).astype(jnp.bfloat16))
    jpool = paddle.to_tensor(pool)
    jsc = None if scales is None else paddle.to_tensor(scales)
    tpool, tsc = _torch_of(pool), _torch_of(scales)
    for k in range(NSTEPS):
        t = np.full((B,), S + k, np.int32)
        jview = jpa.PagedDecodeCache(
            pool=jpool, tables=paddle.to_tensor(tables), t=paddle.to_tensor(t),
            page_size=ps, scales=jsc, impl="kernel", interpret=True)
        jo, jview = jf(paddle.to_tensor(steps[k]), caches=jview,
                       time_step=paddle.to_tensor(t))
        jpool, jsc = jview.pool, jview.scales
        tview = tpa.PagedDecodeCache(
            pool=tpool, tables=torch.from_numpy(tables),
            t=torch.from_numpy(t), page_size=ps, scales=tsc)
        to, tview2 = tf(torch.from_numpy(steps[k]), caches=tview,
                        time_step=torch.from_numpy(t))
        assert tview2.pool is tpool
        np.testing.assert_allclose(_np(to), _np(jo), rtol=RTOL, atol=1e-5)
        if leg == "bf16":
            _bf16_pools_within_one_step(_np(jpool), tpool,
                                        written=(k + 1) * L * 2 * B * H * D)
        else:
            np.testing.assert_allclose(_np(jpool).astype(np.float32),
                                       tpool.float().numpy(), rtol=RTOL,
                                       atol=1e-5)


BF16_FLIP_SHARE = 0.01


def _bf16_ordinal(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as integers in value order: neighbouring bf16
    values differ by 1 (both zeros are 0)."""
    mag = (bits & 0x7FFF).astype(np.int64)
    return np.where(bits & 0x8000, -mag, mag)


def _bf16_pools_within_one_step(jpool, tpool, written: int):
    """A bf16 pool holds each token's fp32 K/V rounded once. The two
    packages' fp32 K/V agree within RTOL but differ by a few ulps (XLA's
    and MKL's sums), so a value near a bf16 midpoint may round to either
    side: every element is within the float pools' tolerance (rtol RTOL,
    atol 1e-5) of JAX's or one bf16 step from it, and the elements that
    differ at all are at most BF16_FLIP_SHARE of the elements written."""
    jb = np.asarray(jpool).view(np.uint16)
    tb = tpool.view(torch.int16).numpy().view(np.uint16)
    jf, tf = (torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)
              .float().numpy() for b in (jb, tb))
    near = np.abs(tf - jf) <= 1e-5 + RTOL * np.abs(jf)
    one_step = np.abs(_bf16_ordinal(jb) - _bf16_ordinal(tb)) <= 1
    bad = ~(near | one_step)
    assert not bad.any(), (f"{int(bad.sum())} elements neither within "
                           f"tolerance nor one bf16 step apart, e.g. "
                           f"jax {jf[bad][:4]} port {tf[bad][:4]}")
    differ = int(np.count_nonzero(jb != tb))
    assert differ <= BF16_FLIP_SHARE * written, \
        f"{differ} of {written} written elements differ"


def test_gradients_match_jax_in_training_mode(fmt_pair):
    _, _, state = fmt_pair
    paddle.seed(5)
    jf = jinn.FusedMultiTransformer(E, H, FF, num_layers=L,
                                    dropout_rate=0.0)
    _jax_load(jf, state)
    jf.train()
    tf = tinn.FusedMultiTransformer(E, H, FF, num_layers=L,
                                    dropout_rate=0.0, device="cpu")
    tf.load_state_dict(fmt_state_dict_from_paddle_tpu(state))
    tf.train()
    x = _x(np.random.default_rng(8), S)
    jout = jf(paddle.to_tensor(x))
    jout.sum().backward()
    tout = tf(torch.from_numpy(x))
    tout.sum().backward()
    _close(tout.detach(), _np(jout))
    jgrads = dict(zip([f"l{i}_{t}" for i in range(L) for t in
                       tinn._FMT_TAGS], [None] * (12 * L)))
    for name, p in jf.named_parameters():
        jgrads[name] = _np(p.grad)
    for name, p in tf.named_parameters():
        want = jgrads[name]
        scale = float(np.abs(want).max()) + 1e-12
        assert float(np.abs(p.grad.numpy() - want).max()) <= 1e-4 * scale, \
            name


# ---------------------------------------------------------------------------
# the slice: the serving engine over the FMT stack
# ---------------------------------------------------------------------------

MAX_LEN, PS_ENG, NEW = 64, 16, 5
PROMPT_LENS = (8, 5, 11)


@pytest.fixture(scope="module")
def stacks():
    """The JAX bench's stack (``bench_generation.py:283-331``) and the
    port's ``FMTStack`` on the same numpy weights."""
    paddle.seed(7)
    embed = jnn.Embedding(V, E)
    jf = jinn.FusedMultiTransformer(E, H, FF, num_layers=L,
                                    activation="gelu")
    final_ln = jnn.LayerNorm(E)
    head = jnn.Linear(E, V, bias_attr=False)
    rng = np.random.default_rng(9)
    state = _random_fmt_state(rng)
    _jax_load(jf, state)
    ln = {"weight": (1 + 0.1 * rng.standard_normal(E)).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(E)).astype(np.float32)}
    _jax_load(final_ln, ln)
    for layer in (embed, jf, final_ln, head):
        layer.eval()
    jf.prepare_decode()

    def lm_step(tok, cache, t):
        x, cache = jf(embed(tok), caches=cache, time_step=t)
        nxt = paddle.argmax(head(final_ln(x)), axis=-1)
        return nxt.astype("int32"), cache

    def prefill_raw(ids, cache):
        x, cache = jf(embed(ids), caches=cache, time_step=None)
        nxt = paddle.argmax(head(final_ln(x[:, -1:])), axis=-1)
        return nxt.astype("int32"), cache

    def prefill_causal_raw(ids, cache, start=0):
        x, cache = jf(embed(ids), caches=cache, time_step=None,
                      seq_offset=start)
        nxt = paddle.argmax(head(final_ln(x[:, -1:])), axis=-1)
        return nxt.astype("int32"), cache

    stack = FMTStack(V, E, H, FF, L, device="cpu")
    np_sd = lambda m: {k: _np(v) for k, v in m.state_dict().items()}  # noqa
    stack.load_state_dict(fmt_state_dict_from_paddle_tpu(
        state, embed=np_sd(embed), final_ln=ln, head=np_sd(head)),
        strict=True)
    yield (prefill_raw, prefill_causal_raw, lm_step), stack
    import gc
    del prefill_raw, prefill_causal_raw, lm_step, embed, jf, final_ln, head
    gc.collect()


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, V, (n,), dtype=np.int32) for n in PROMPT_LENS]


def _cfg(mod, kv_dtype, **kw):
    return mod.ServingConfig(num_layers=L, num_heads=H, head_dim=D,
                             max_len=MAX_LEN, max_batch=4, buckets=(1, 4),
                             page_size=PS_ENG, kv_dtype=kv_dtype, **kw)


def _drain(eng, mod, prompts):
    futs = [eng.submit(mod.GenerationRequest(p, max_new_tokens=NEW))
            for p in prompts]
    eng.run()
    return [f.result(timeout=60).tokens for f in futs]


@pytest.mark.parametrize("kv_dtype", ["native", "bf16", "int8"])
def test_engine_transcripts_match_jax_engine_and_reference(stacks, kv_dtype):
    (jprefill, _, jstep), stack = stacks
    prompts = _prompts()
    jeng = jserving.Engine(jprefill, jstep,
                           _cfg(jserving, kv_dtype, paged_attention="on"))
    want = _drain(jeng, jserving, prompts)
    teng = serving.Engine(*stack.serving_callables(),
                          _cfg(serving, kv_dtype, device="cpu"))
    assert not teng.prefix_sharing_enabled      # a 2-argument prefill
    got = _drain(teng, serving, prompts)
    assert got == want
    assert teng.kv.outstanding_pages == 0
    if kv_dtype == "native":
        assert got == [stack.reference(p, NEW, MAX_LEN) for p in prompts]


def test_reference_logits_pick_the_reference_and_follow_a_fed_transcript(
        stacks):
    _, stack = stacks
    prompt = _prompts()[0]
    toks = stack.reference(prompt, NEW, MAX_LEN)
    own = stack.reference_logits(prompt, toks, MAX_LEN)
    assert own.shape == (NEW, V) and own.dtype == torch.float32
    assert own.argmax(dim=1).tolist() == toks
    # fed another transcript, row i is the loop's logits at the context
    # prompt + fed[:i]: with the causal prefill, that of a prefill of it
    fed = np.random.default_rng(13).integers(0, V, (NEW,), dtype=np.int32)
    got = stack.reference_logits(prompt, fed, MAX_LEN, causal=True)
    for i in range(NEW):
        ctx = np.concatenate([prompt, fed[:i]])
        _close(got[i], stack.reference_logits(ctx, [0], MAX_LEN,
                                              causal=True)[0])


def test_shared_prefix_pair_matches_unshared(stacks):
    (_, jprefill_causal, jstep), stack = stacks
    rng = np.random.default_rng(12)
    base = rng.integers(0, V, (2 * PS_ENG,), dtype=np.int32)
    pair = [np.concatenate([base, rng.integers(0, V, (n,), dtype=np.int32)])
            for n in (5, 9)]
    out = {}
    for mode in ("on", "off"):
        eng = serving.Engine(*stack.serving_callables(causal=True),
                             _cfg(serving, "native", device="cpu",
                                  prefix_sharing=mode))
        # one after the other, so that the second finds the first's pages
        out[mode] = [_drain(eng, serving, [p])[0] for p in pair]
        stats = eng.decode_stats()["prefills"]
        assert stats == ({"full": 1, "tail": 1} if mode == "on"
                         else {"full": 2})
    assert out["on"] == out["off"]
    assert out["off"] == [stack.reference(p, NEW, MAX_LEN, causal=True)
                          for p in pair]
    jeng = jserving.Engine(jprefill_causal, jstep,
                           _cfg(jserving, "native", paged_attention="on",
                                prefix_sharing="on"))
    assert [_drain(jeng, jserving, [p])[0] for p in pair] == out["on"]
