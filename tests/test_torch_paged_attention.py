"""The port's paged decode attention (plain version on the CPU), its
in-place token write and the KV-cache pack helpers, against
``paddle_tpu.ops.paged_attention`` (the Pallas decode kernel under the
interpreter) and ``paddle_tpu.serving.kv_cache``.

Same numpy inputs to both. Attention outputs: fp32, atol 1e-5. Pool bytes:
the float leg is a copy, the int8 leg must be bitwise equal (pool and
scales).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving import kv_cache as tkv

torch.set_num_threads(2)

B, D, PS, S, L = 3, 8, 16, 4, 2
P = 12                                  # pool pages, page 0 scratch
TABLES = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)


def _pool(kv_dtype, hkv, rng):
    poolf = rng.standard_normal((P, L, 2, hkv, PS, D)).astype(np.float32)
    if kv_dtype == "int8":
        q8, sc = jkv.quantize_pages(jnp.asarray(poolf))
        return np.asarray(q8), np.asarray(sc)
    return poolf, None


def _qkv(rng, h, hkv):
    return (rng.standard_normal((B, h, D)).astype(np.float32),
            rng.standard_normal((B, hkv, D)).astype(np.float32),
            rng.standard_normal((B, hkv, D)).astype(np.float32))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


CASES = [  # kv leg, q heads, kv heads, t per row
    ("native", 2, 2, [PS - 1, PS, PS + 1]),      # page-boundary t
    ("int8", 2, 2, [PS - 1, PS, PS + 1]),
    ("native", 4, 2, [5, PS + 3, 2 * PS]),       # GQA rep 2
    ("int8", 4, 2, [5, PS + 3, 2 * PS]),
    ("native", 2, 2, [0, 0, 0]),                 # t = 0: out == v_new
    ("native", 2, 2, [S * PS - 1, 1, 3 * PS]),   # a full slot
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-h{c[1]}"
                         f"-kv{c[2]}-t{'_'.join(map(str, c[3]))}")
def test_decode_matches_paddle_tpu_kernel(case):
    leg, h, hkv, tv = case
    rng = np.random.default_rng(0)
    pool, scales = _pool(leg, hkv, rng)
    q, kn, vn = _qkv(rng, h, hkv)
    t = np.asarray(tv, np.int32)
    for layer in range(L):
        want = np.asarray(jpa.paged_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(pool), _j(scales), jnp.asarray(TABLES),
            jnp.asarray(t), jnp.asarray(layer), page_size=PS, impl="kernel",
            interpret=True))
        args = (_t(q), _t(kn), _t(vn), _t(pool), _t(scales), _t(TABLES),
                _t(t), layer)
        dense = tpa.paged_attention_dense(*args, page_size=PS)
        routed = tpa.paged_attention(*args, page_size=PS)
        np.testing.assert_allclose(dense.numpy(), want, rtol=0, atol=1e-5)
        assert torch.equal(routed, dense)
        if not t.any():
            np.testing.assert_allclose(
                dense.numpy(), np.repeat(vn, h // hkv, axis=1), rtol=0,
                atol=1e-6)


def _split_combine(q, kn, vn, pool, scales, tables, t, layer, pps):
    """Test-only plain version of the CUDA kernels' arithmetic
    (``csrc/paged_attention.cu``): each split of ``pps`` pages yields the
    partial ``(m, l, o)`` of every q head in log2 units (q scaled by
    1/sqrt(D) * log2 e, the int8 K scale on the logit and the V scale on
    the probability); splits past ``t`` yield none; the combine folds the
    live splits in split order, then the current token."""
    b, h, d = q.shape
    _, _, _, hkv, ps, _ = pool.shape
    rep = h // hkv
    qs = q.astype(np.float64) / np.sqrt(d) * np.log2(np.e)
    out = np.zeros((b, h, d))
    for bi in range(b):
        live = min(-(-int(t[bi]) // ps), tables.shape[1])
        for hi in range(h):
            kvh = hi // rep
            parts = []
            for p0 in range(0, live, pps):
                logits, vals = [], []
                for pg in range(p0, min(p0 + pps, live)):
                    pid = tables[bi, pg]
                    ks = vs = 1.0
                    if scales is not None:
                        ks, vs = scales[pid, layer, :, kvh]
                    nvalid = min(ps, int(t[bi]) - pg * ps)
                    kp = pool[pid, layer, 0, kvh, :nvalid].astype(np.float64)
                    vp = pool[pid, layer, 1, kvh, :nvalid].astype(np.float64)
                    logits.append(kp @ qs[bi, hi] * ks)
                    vals.append(vp * vs)
                s, v = np.concatenate(logits), np.concatenate(vals)
                m = s.max()
                p = np.exp2(s - m)
                parts.append((m, p.sum(), p @ v))
            st = float(kn[bi, kvh].astype(np.float64) @ qs[bi, hi])
            mx = max([st] + [m for m, _, _ in parts])
            num, den = np.zeros(d), 0.0
            for m, l, o in parts:                  # fixed order
                a = np.exp2(m - mx)
                den += a * l
                num += a * o
            at = np.exp2(st - mx)
            out[bi, hi] = (num + at * vn[bi, kvh]) / (den + at)
    return out


SPLIT_CASES = [  # kv leg, q heads, kv heads, pages per split, t per row
    ("native", 2, 2, 2, [0, 2 * PS, 2 * PS + 1]),        # t = 0, split edge
    ("int8", 2, 2, 2, [2 * PS - 1, 2 * PS, 2 * PS + 1]),
    ("native", 8, 2, 2, [PS - 1, PS, PS + 1]),           # rep 4, page edges
    ("int8", 8, 2, 2, [0, 2 * PS, 3 * PS + 1]),
    ("native", 2, 2, 1, [PS - 1, PS + 1, S * PS - 1]),   # a split per page
    ("int8", 8, 2, 3, [3 * PS, 3 * PS - 1, 1]),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: f"{c[0]}-h{c[1]}"
                         f"-kv{c[2]}-pps{c[3]}-t{'_'.join(map(str, c[4]))}")
def test_split_and_combine_matches_paddle_tpu_kernel(case):
    # the split-KV kernels' arithmetic (partials per chunk of pages, folded
    # in order with the current token) gives the JAX kernel's result
    leg, h, hkv, pps, tv = case
    rng = np.random.default_rng(5)
    pool, scales = _pool(leg, hkv, rng)
    q, kn, vn = _qkv(rng, h, hkv)
    t = np.asarray(tv, np.int32)
    layer = 1
    want = np.asarray(jpa._kernel_call(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pool),
        _j(scales), jnp.asarray(TABLES), jnp.asarray(t), jnp.asarray(layer),
        page_size=PS, interpret=True))
    got = _split_combine(q, kn, vn, pool, scales, TABLES, t, layer, pps)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for bi in np.flatnonzero(t == 0):      # only the current token: v_new
        np.testing.assert_array_equal(got[bi], np.repeat(vn[bi], h // hkv, 0))


@pytest.mark.parametrize("pages,rows", [(32, 16 * 32), (32, 4 * 32),
                                        (32, 16 * 8), (64, 16 * 32),
                                        (8, 16 * 32), (1, 1), (2048, 64)])
def test_split_plan_covers_the_table(pages, rows):
    # every page of a row lies in exactly one split, a split holds at least
    # one page, and a launch has about _SPLIT_BLOCKS blocks or one split
    # per page
    pps, nsplit = tpa.split_plan(pages, rows)
    assert pps >= 1 and (nsplit - 1) * pps < pages <= nsplit * pps
    assert nsplit * rows >= min(tpa._SPLIT_BLOCKS, pages * rows)
    assert pps == 1 or (nsplit + 1) * rows > tpa._SPLIT_BLOCKS / 2


@pytest.mark.parametrize("leg", ["native", "bf16", "int8"])
def test_scatter_token_inplace_matches_paddle_tpu(leg):
    rng = np.random.default_rng(1)
    hkv = 2
    pool, scales = _pool("int8" if leg == "int8" else "native", hkv, rng)
    if leg == "bf16":
        pool = np.asarray(jnp.asarray(pool).astype(jnp.bfloat16))
    _, kn, vn = _qkv(rng, hkv, hkv)
    t = np.asarray([PS - 1, PS, PS + 1], np.int32)
    layer = 1
    jpool, jsc = jpa.scatter_token_inplace(
        jnp.asarray(pool), _j(scales), jnp.asarray(TABLES), jnp.asarray(t),
        jnp.asarray(layer), jnp.asarray(kn), jnp.asarray(vn), page_size=PS)
    if leg == "bf16":
        tpool = torch.from_numpy(np.asarray(pool).view(np.uint16).copy()
                                 ).view(torch.bfloat16)
    else:
        tpool = _t(pool)
    tsc = _t(scales)
    out_pool, out_sc = tpa.scatter_token_inplace(
        tpool, tsc, _t(TABLES), _t(t), layer, _t(kn), _t(vn), PS)
    assert out_pool is tpool and out_sc is tsc          # in place
    if leg == "bf16":
        got = tpool.view(torch.uint16).numpy()
        want = np.asarray(jpool).view(np.uint16)
    else:
        got, want = tpool.numpy(), np.asarray(jpool)
    np.testing.assert_array_equal(got, want)
    if leg == "int8":
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


def test_quantize_pages_bitwise():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 2, 2, 3, PS, D)).astype(np.float32)
    x[0, 0, 0, 0] = 0.0                                  # zero page: scale 1
    jq, js = jkv.quantize_pages(jnp.asarray(x))
    tq, ts = tkv.quantize_pages(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("leg", ["native", "int8"])
def test_scatter_prefill_pages_matches_paddle_tpu(leg):
    rng = np.random.default_rng(3)
    hkv, n, true_len = 2, 3, 2 * PS + 5
    dense = rng.standard_normal((L, 2, 1, hkv, n * PS, D)).astype(np.float32)
    pool, scales = _pool(leg, hkv, rng)
    ids = np.asarray([7, 2, 9], np.int32)
    jpool, jsc = jkv.scatter_prefill_pages(
        jnp.asarray(dense), jnp.asarray(pool), _j(scales), jnp.asarray(ids),
        jnp.asarray(true_len), PS)
    tpool, tsc = _t(pool), _t(scales)
    tkv.scatter_prefill_pages(torch.from_numpy(dense), tpool, tsc,
                              torch.from_numpy(ids), true_len, PS)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    if leg == "int8":
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


def test_paged_decode_attention_needs_a_layer():
    rng = np.random.default_rng(4)
    pool, _ = _pool("native", 2, rng)
    q, kn, vn = _qkv(rng, 2, 2)
    cache = tpa.PagedDecodeCache(pool=_t(pool), tables=_t(TABLES),
                                 t=_t(np.asarray([1, 2, 3], np.int32)),
                                 page_size=PS)
    with pytest.raises(ValueError, match="layer"):
        tpa.paged_decode_attention(_t(q), _t(kn), _t(vn), cache)
    out, cache2 = tpa.paged_decode_attention(_t(q), _t(kn), _t(vn),
                                             cache.at_layer(1))
    assert out.shape == (B, 2, D) and cache2.pool is cache.pool
    # the token landed at t in its page, layer 1 only
    assert torch.equal(cache.pool[TABLES[2, 0], 1, 0, :, 3], _t(kn)[2])
    assert torch.equal(cache.pool[TABLES[2, 0], 1, 1, :, 3], _t(vn)[2])


def test_ab_paged_binds_the_wrapper_signature(monkeypatch):
    # the A/B tool calls each source's paged_decode by the parameter names
    # of its C signature: for this checkout's source they are the ctypes
    # types the wrapper binds, in order; without a card it exits 2
    import sys
    from pathlib import Path
    from paddle_tpu_torch.tools import ab_paged
    src = (Path(tpa.__file__).resolve().parent.parent / "csrc"
           / "paged_attention.cu").read_text()
    params = ab_paged.c_params(src, "paged_decode")
    assert [ty for ty, _ in params] == tpa._ARGTYPES
    assert [n for _, n in params][7:9] == ["part", "out"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["ab_paged", "--other", "other.cu"])
    assert ab_paged.main() == 2
