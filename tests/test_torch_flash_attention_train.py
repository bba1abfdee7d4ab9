"""The port's training attention (plain versions on the CPU) against the JAX
package's flash kernels run under the Pallas interpreter.

* forward with lse: ``flash_attention_lse`` against ``_pallas_flash(...,
  with_lse=True, interpret=True)``; out and lse, fp32, atol 1e-5;
* backward: the port's ``FlashAttention`` autograd against ``jax.vjp`` of
  ``_flash_core``, which on the CPU runs the forward-with-lse, dq and dk/dv
  Pallas kernels in interpret mode at tileable lengths; fp32, atol 1e-4
  (GQA: the JAX side is given repeated K/V, and its dk/dv are summed over
  each group);
* the plain backward against torch autograd through the materialised
  plain forward;
* fully masked rows (Lq > Lk, causal): out 0, lse 1e30, zero gradients,
  the convention of the JAX package's XLA path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(2)

D = 32

CASES = [  # b, lq, lk, h, h_kv, causal
    (1, 128, 128, 2, 2, True),
    (1, 256, 256, 2, 2, True),
    (1, 128, 128, 2, 2, False),
    (1, 128, 256, 2, 2, True),    # lq < lk: bottom-right causal
    (1, 128, 128, 4, 2, True),    # GQA 4/2
]


def _inputs(b, lq, lk, h, hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, D)).astype(np.float32)
    k = rng.standard_normal((b, lk, hkv, D)).astype(np.float32)
    v = rng.standard_normal((b, lk, hkv, D)).astype(np.float32)
    do = rng.standard_normal((b, lq, h, D)).astype(np.float32)
    return q, k, v, do


def _heads_first_jax(q, k, v, h):
    """(B, L, H, D) numpy -> (B, H, L, D) jax, K/V repeated to H heads."""
    qh, kh, vh = (jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    rep = h // k.shape[2]
    if rep > 1:
        kh, vh = jnp.repeat(kh, rep, axis=1), jnp.repeat(vh, rep, axis=1)
    return qh, kh, vh


def _ids(c):
    return "-".join(map(str, c))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_lse_matches_pallas_interpret(case):
    b, lq, lk, h, hkv, causal = case
    q, k, v, _ = _inputs(b, lq, lk, h, hkv)
    scale = 1.0 / np.sqrt(D)
    qh, kh, vh = _heads_first_jax(q, k, v, h)
    want_out, want_lse = jfa._pallas_flash(qh, kh, vh, causal, scale, 128,
                                           128, True, with_lse=True)
    out, lse = fa.flash_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
    assert out.shape == (b, lq, h, D) and lse.shape == (b, h, lq)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(want_out).transpose(0, 2, 1, 3),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_autograd_matches_jax_flash_vjp(case):
    b, lq, lk, h, hkv, causal = case
    q, k, v, do = _inputs(b, lq, lk, h, hkv, seed=1)
    scale = 1.0 / np.sqrt(D)
    qh, kh, vh = _heads_first_jax(q, k, v, h)
    out_j, vjp = jax.vjp(lambda a, b_, c: jfa._flash_core(a, b_, c, causal,
                                                          scale), qh, kh, vh)
    dq_j, dk_j, dv_j = (np.asarray(x) for x in vjp(
        jnp.asarray(do.transpose(0, 2, 1, 3))))
    rep = h // hkv
    dk_j = dk_j.reshape(b, hkv, rep, lk, D).sum(2)   # per-group sum
    dv_j = dv_j.reshape(b, hkv, rep, lk, D).sum(2)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TF.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(out_j).transpose(0, 2, 1, 3),
                               rtol=0, atol=1e-5)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), want.transpose(0, 2, 1, 3),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", [(2, 37, 37, 4, 2, True),
                                  (1, 16, 40, 2, 2, True),
                                  (1, 20, 20, 2, 1, False)], ids=_ids)
def test_plain_backward_matches_autograd_of_plain_forward(case):
    b, lq, lk, h, hkv, causal = case
    q, k, v, do = _inputs(b, lq, lk, h, hkv, seed=2)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ref = fa.flash_attention_reference(qt, kt, vt, causal)
    want = torch.autograd.grad(ref, (qt, kt, vt), torch.from_numpy(do))
    out, lse = fa.flash_attention_lse_reference(qt.detach(), kt.detach(),
                                                vt.detach(), causal)
    got = fa.flash_attention_bwd_reference(qt.detach(), kt.detach(),
                                           vt.detach(), out, lse,
                                           torch.from_numpy(do), causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_fully_masked_rows_zero_out_lse_and_grads():
    # lq > lk, causal bottom-right: the first lq - lk rows see no key
    b, lq, lk, h = 1, 8, 5, 2
    q, k, v, do = _inputs(b, lq, lk, h, h, seed=3)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.FlashAttention.apply(qt, kt, vt, True, None)
    _, lse = fa.flash_attention_lse(qt.detach(), kt.detach(), vt.detach(),
                                    causal=True)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    masked = lq - lk
    assert torch.equal(out[:, :masked], torch.zeros_like(out[:, :masked]))
    assert torch.all(lse[:, :, :masked] == fa.LSE_MASKED)
    assert torch.equal(dq[:, :masked], torch.zeros_like(dq[:, :masked]))
    # the JAX package's XLA path: the same zero rows and the same grads
    scale = 1.0 / np.sqrt(D)
    qh, kh, vh = _heads_first_jax(q, k, v, h)
    out_j, vjp = jax.vjp(lambda a, b_, c: jfa._xla_attention(a, b_, c, True,
                                                             scale), qh, kh, vh)
    grads_j = vjp(jnp.asarray(do.transpose(0, 2, 1, 3)))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(out_j).transpose(0, 2, 1, 3),
                               rtol=0, atol=1e-5)
    for got, want in zip((dq, dk, dv), grads_j):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).transpose(0, 2, 1, 3),
                                   rtol=0, atol=1e-5)


def test_sdpa_routes_by_grad_mode():
    q, k, v, _ = _inputs(1, 8, 8, 2, 2, seed=4)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TF.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    with torch.no_grad():
        plain = TF.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    assert plain.grad_fn is None
    np.testing.assert_allclose(out.detach().numpy(), plain.numpy(), rtol=0,
                               atol=1e-6)


def test_cpu_path_launches_nothing():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 2))
    counters = (fa.launches_lse, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    before = [c.count for c in counters]
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    assert [c.count for c in counters] == before


def test_device_tensors_never_take_the_plain_path():
    q = torch.empty(1, 4, 2, 64, device="meta")
    lse = torch.empty(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_lse(q, q, q, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, q, q, q, lse, q, causal=True)
