"""The segment-id and dropout variants of the port's flash attention (plain
versions on the CPU) against the JAX package's Pallas kernels, which run
under the interpreter on the CPU at lengths that are multiples of 128.

* B0: ``keep_mask_reference`` equals ``_keep_tile`` bit for bit over
  seeds (int32 extremes included), bh values, tile offsets and p;
* ``FlashAttention`` with segment ids and/or dropout (``seed`` given, the
  role ``fixed_seed_offset`` plays) against ``jax.vjp`` of
  ``_flash_core_seg`` / ``_flash_core_drop``: out atol 1e-5, dq/dk/dv
  atol 1e-4, fp32 (the tolerances of the flag-free parity tests). A row
  that sees no key emits 0 in the port and the mean of V in the Pallas
  forward (ROADMAP Queue C), so outputs and dq are compared on rows that
  see a key, and the upstream gradient of the other rows is 0 so that dk/dv
  compare everywhere;
* ``flash_attn_unpadded`` against the JAX package's, with and without
  dropout (``fixed_seed_offset``), on the tokens before ``cu_seqlens[-1]``;
* SDPA's routing: mask-free (dropout or not) goes to ``flash_attention``,
  a boolean key-padding mask to it with segment ids, an additive mask to
  the plain masked softmax; each against the JAX package's SDPA. JAX's own
  SDPA draws its dropout from ``jax.random`` on its plain path
  (``paddle_tpu/ops/nn_ops.py:396, 442``), so dropout parity at the model
  level goes through ``fixed_seed_offset`` / the kernels' hash, not SDPA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as PF
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops import nn_ops as jnn_ops
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import nn_ops

torch.set_num_threads(2)

D = 32


@pytest.mark.parametrize("seed,bh,q0,k0,p", [
    (0, 0, 0, 0, 0.1), (12345, 7, 128, 256, 0.1), (-5, 3, 0, 512, 0.5),
    (2 ** 31 - 1, 100, 4096, 8192, 0.3), (-2 ** 31, 5, 3, 7, 0.9),
    (987654321, 239, 1000, 64, 0.25)])
def test_keep_mask_matches_keep_tile_bit_for_bit(seed, bh, q0, k0, p):
    want = np.asarray(jfa._keep_tile(jnp.int32(seed), bh, q0, k0, 64, 128,
                                     1.0 - p))
    got = fa.keep_mask_reference(seed, bh, torch.arange(q0, q0 + 64)[:, None],
                                 torch.arange(k0, k0 + 128)[None, :], 1.0 - p)
    assert got.dtype == torch.bool and got.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_constants_round_once_to_fp32():
    keep, inv = fa.dropout_constants(0.1)
    assert keep == float(np.float32(0.9)) and inv == float(np.float32(1 / 0.9))
    with pytest.raises(ValueError):
        fa.dropout_constants(0.0)


def _inputs(b, lq, lk, h, hkv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, h, D)).astype(np.float32),
            rng.standard_normal((b, lk, hkv, D)).astype(np.float32),
            rng.standard_normal((b, lk, hkv, D)).astype(np.float32),
            rng.standard_normal((b, lq, h, D)).astype(np.float32))


def _segs(kind, b, lq, lk):
    """(q ids, kv ids) of a layout: two packed sequences a row, a padded
    tail of keys, or query ids that see no key in part of batch 1."""
    qs = np.zeros((b, lq), np.int32)
    ks = np.zeros((b, lk), np.int32)
    if kind == "packed":
        qs[:, lq // 3:] = 1
        ks[:, lk // 3:] = 1
    elif kind == "kv_pad":
        ks[:, 3 * lk // 4:] = 7
    elif kind == "unseen":
        qs[1, :lq // 4] = 5
    return qs, ks


CASES = [  # b, lq, lk, h, hkv, causal, segs, dropout
    (2, 128, 128, 2, 2, False, "packed", 0.0),
    (2, 256, 256, 2, 2, True, "packed", 0.0),
    (2, 128, 128, 2, 2, False, None, 0.1),
    (2, 128, 128, 2, 2, True, None, 0.25),
    (2, 256, 256, 2, 2, True, "packed", 0.1),
    (2, 128, 256, 2, 2, True, "kv_pad", 0.1),
    (2, 128, 128, 4, 2, True, "packed", 0.1),   # GQA 4/2
    (2, 128, 128, 2, 2, False, "unseen", 0.1),
]


def _ids(c):
    return "-".join(map(str, c))


def _jax(q, k, v, do, causal, qs, ks, p, seed, h, hkv):
    """Out and (dq, dk, dv) of the JAX package's core in (B, L, H, D), K/V
    repeated for its kernels and dk/dv summed back per group."""
    rep = h // hkv
    qh, kh, vh = (jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    kh, vh = jnp.repeat(kh, rep, axis=1), jnp.repeat(vh, rep, axis=1)
    scale = 1.0 / np.sqrt(D)
    if p > 0:
        fn = lambda a, b_, c: jfa._flash_core_drop(  # noqa: E731
            a, b_, c, jnp.asarray(qs), jnp.asarray(ks),
            jnp.asarray([seed], jnp.int32), causal, scale, p)
    else:
        fn = lambda a, b_, c: jfa._flash_core_seg(  # noqa: E731
            a, b_, c, jnp.asarray(qs), jnp.asarray(ks), causal, scale)
    out, vjp = jax.vjp(fn, qh, kh, vh)
    dq, dk, dv = vjp(jnp.asarray(do.transpose(0, 2, 1, 3)))
    b, _, lk, _ = kh.shape
    dk, dv = (np.asarray(g).reshape(b, hkv, rep, lk, D).sum(2)
              for g in (dk, dv))
    t = lambda x: np.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    return t(out), t(dq), t(dk), t(dv)


def _seen_rows(qs, ks, lq, lk, causal):
    vis = qs[:, :, None] == ks[:, None, :]
    if causal:
        vis = vis & np.tril(np.ones((lq, lk), bool), k=lk - lq)
    return vis.any(-1)   # (B, Lq)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_variants_match_jax_pallas_kernels(case):
    b, lq, lk, h, hkv, causal, kind, p = case
    q, k, v, do = _inputs(b, lq, lk, h, hkv, seed=lq + h)
    qs, ks = _segs(kind, b, lq, lk)   # dropout alone: zeros, as JAX takes it
    seen = _seen_rows(qs, ks, lq, lk, causal)
    do = do * seen[:, :, None, None]
    seed = 1234
    want = _jax(q, k, v, do, causal, qs, ks, p, seed, h, hkv)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    segs = (torch.from_numpy(qs), torch.from_numpy(ks)) if kind else (None,
                                                                       None)
    out = fa.FlashAttention.apply(qt, kt, vt, causal, None, *segs, p, seed)
    got = (out,) + torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    got = [g.detach().numpy() for g in got]
    np.testing.assert_allclose(got[0][seen], want[0][seen], rtol=0, atol=1e-5)
    assert not got[0][~seen].any()
    np.testing.assert_allclose(got[1][seen], want[1][seen], rtol=0, atol=1e-4)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_dropout_changes_output_and_eval_mode_does_not():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 128, 128, 2, 2))
    clean = TF.flash_attention(q, k, v, causal=True)
    drop = TF.flash_attention(q, k, v, dropout=0.5, causal=True,
                              fixed_seed_offset=3)
    again = TF.flash_attention(q, k, v, dropout=0.5, causal=True,
                               fixed_seed_offset=torch.tensor([3]))
    ev = TF.flash_attention(q, k, v, dropout=0.5, causal=True, training=False)
    assert (drop - clean).abs().max() > 1e-3
    assert torch.equal(drop, again) and torch.equal(ev, clean)
    with pytest.raises(ValueError, match="Generator"):
        TF.flash_attention(q, k, v, dropout=0.5)


def test_flash_attention_draws_its_seed_from_the_generator():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 128, 128, 2, 2))
    g = torch.Generator().manual_seed(9)
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=torch.Generator().manual_seed(9)))
    got = TF.flash_attention(q, k, v, dropout=0.2, generator=g)
    zeros = torch.zeros(1, 128, dtype=torch.int32)
    want = fa.flash_attention_reference(q, k, v, False, None, zeros, zeros,
                                        0.2, seed)
    assert torch.equal(got, want)


def test_dropout_without_ids_runs_the_segs_drop_variant_on_zero_ids():
    # dropout always carries segment ids, as _flash_core_drop takes them:
    # no dropout-only variant; the kernel arguments hold zero ids
    assert fa.VARIANTS == ("segs", "segs_drop")
    assert fa._variant(None, None, 0.1) == "segs_drop"
    assert fa._variant(None, None, 0.0) is None
    # the seed reaches the kernels as a pointer to its bits on the device
    args, (*segs, seed_t) = fa._segdrop_args(None, None, 0.1, 3, 2, 4, 5,
                                             "cpu")
    assert [tuple(x.shape) for x in segs] == [(2, 4), (2, 5)]
    assert all(x.dtype == torch.int32 and not x.any() for x in segs)
    assert int(seed_t) == 3 and args[3] == seed_t.data_ptr()
    assert args[2] == 1 and args[4:] == fa.dropout_constants(0.1)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 128, 128, 2, 2))
    zeros = torch.zeros(2, 128, dtype=torch.int32)
    for a, b in zip(fa.flash_attention_lse(q, k, v, True, None, None, None,
                                           0.1, 5),
                    fa.flash_attention_lse(q, k, v, True, None, zeros, zeros,
                                           0.1, 5)):
        assert torch.equal(a, b)


def _cu_inputs(lens, total, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((total, 2, D)).astype(np.float32)
                   for _ in range(4))
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return q, k, v, do, cu


@pytest.mark.parametrize("causal,p", [(False, 0.0), (True, 0.0),
                                      (True, 0.1)])
def test_flash_attn_unpadded_matches_jax(causal, p):
    lens, total = [1, 127, 100], 256          # 28 tail tokens past cu[-1]
    q, k, v, do, cu = _cu_inputs(lens, total, seed=5)
    live = np.arange(total) < cu[-1]
    do = do * live[:, None, None]
    jt = [paddle.to_tensor(x) for x in (q, k, v)]
    for t in jt:
        t.stop_gradient = False
    jout = PF.flash_attn_unpadded(
        *jt, paddle.to_tensor(cu), paddle.to_tensor(cu), 128, 128,
        dropout=p, causal=causal,
        fixed_seed_offset=paddle.to_tensor([77], "int32"))
    (jout * paddle.to_tensor(do)).sum().backward()
    tt = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tout = TF.flash_attn_unpadded(*tt, torch.from_numpy(cu),
                                  torch.from_numpy(cu), 128, 128, dropout=p,
                                  causal=causal, fixed_seed_offset=77)
    grads = torch.autograd.grad(tout, tt, torch.from_numpy(do))
    np.testing.assert_allclose(tout.detach().numpy()[live],
                               jout.numpy()[live], rtol=0, atol=1e-5)
    assert not tout.detach()[~torch.from_numpy(live)].any()
    for g, jtensor, rows in zip(grads, jt, (live, None, None)):
        want, g = jtensor.grad.numpy(), g.numpy()
        if rows is not None:
            want, g = want[rows], g[rows]
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4)


def test_unpadded_seg_ids_never_match_in_the_tail():
    cu = torch.tensor([0, 3, 5], dtype=torch.int32)
    qs = fa._unpadded_seg_ids(cu, 7, fa.TAIL_Q_SEG)
    ks = fa._unpadded_seg_ids(cu, 7, fa.TAIL_KV_SEG)
    assert qs.tolist() == [[0, 0, 0, 1, 1, fa.TAIL_Q_SEG, fa.TAIL_Q_SEG]]
    assert ks[0, 5:].tolist() == [fa.TAIL_KV_SEG] * 2


@pytest.fixture
def _jax_flash_path(monkeypatch):
    monkeypatch.setattr(jnn_ops, "_sdpa_flash_backend_ok", lambda: True)


def _spy(monkeypatch):
    calls = []
    real = nn_ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(nn_ops, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("mask_kind", ["none", "key_padding_3d",
                                       "key_padding_4d", "additive",
                                       "bool_rows"])
def test_sdpa_routes_as_the_jax_package(mask_kind, monkeypatch,
                                        _jax_flash_path):
    b, L, h = 2, 128, 2
    q, k, v, _ = _inputs(b, L, L, h, h, seed=11)
    rng = np.random.default_rng(12)
    valid = np.ones((b, L), bool)
    valid[1, 100:] = False
    mask = {"none": None,
            "key_padding_3d": valid[:, None, :],
            "key_padding_4d": valid[:, None, None, :],
            "additive": ((1.0 - valid[:, None, None, :]) * -1e4).astype(
                np.float32),
            "bool_rows": rng.random((b, 1, L, L)) > 0.2}[mask_kind]
    calls = _spy(monkeypatch)
    got = TF.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        training=False)
    want = PF.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)),
        attn_mask=None if mask is None else paddle.to_tensor(mask),
        training=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    to_flash = mask_kind in ("none", "key_padding_3d", "key_padding_4d")
    assert len(calls) == int(to_flash)
    if mask_kind.startswith("key_padding"):
        assert torch.equal(calls[0]["kv_segment_ids"],
                           torch.from_numpy(valid.astype(np.int32)))


def test_sdpa_dropout_routes_to_the_kernel_variant(monkeypatch):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 128, 128, 2, 2))
    calls = _spy(monkeypatch)
    g = torch.Generator().manual_seed(4)
    got = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                          is_causal=True, generator=g)
    assert calls[0]["dropout"] == 0.1
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=torch.Generator().manual_seed(4)))
    zeros = torch.zeros(2, 128, dtype=torch.int32)
    want = fa.flash_attention_reference(q, k, v, True, None, zeros, zeros,
                                        0.1, seed)
    assert torch.equal(got, want)
    # the plain (additive-mask) path drops with the same keep mask B0
    mask = torch.zeros(2, 1, 1, 128)
    plain = TF.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, dropout_p=0.1, is_causal=True,
        generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(plain.numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
