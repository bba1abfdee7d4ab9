"""The port's int8 AdamW step (plain version on the CPU) and its stochastic
rounding against the JAX package.

* the plain update against ``q8_adam_update(..., use_sr=False,
  interpret=True)``, the JAX Pallas kernel under the interpreter, with and
  without weight decay, fp32 and bf16 base: int8 codes within 1, scales
  rtol 2e-5, the fp32 step rtol 3e-5 (atol two ulps of base) and bf16 base
  within one bf16 ulp.
  The JAX kernel computes ``1 - beta2`` in fp32 (9.9998713e-4) where the
  port rounds it once from double (1.0000000e-3), as the JAX optimizer's
  chunked path does: 1.3e-5 apart, which moves sqrt(v) and the step by up
  to about 1e-5 relative;
* ragged parameters (2560 and 5000 elements, which the kernel masks)
  against JAX ``AdamW(moment_dtype="int8")``, whose CPU path is the chunked
  XLA leg;
* ``stochastic_round_bf16(x, bits)`` bit-equal to JAX's
  ``_stochastic_round_bf16(x, key)`` fed ``jax.random.bits(key)``;
* ``q8_quantize``/``q8_dequantize`` equal to the JAX optimizer's
  ``_q8_quantize``/``_q8_dequantize`` (same fp32 operations);
* SR unbiasedness and the rounding-bit hash.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter
from paddle_tpu.ops.q8_adam_pallas import q8_adam_update as jax_q8_update
from paddle_tpu.optimizer import (_q8_dequantize, _q8_quantize,
                                  _stochastic_round_bf16)
from paddle_tpu_torch.ops import q8_adam as q8
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

B = 2048
LR, WD, EPS, B1, B2 = 1e-2, 0.01, 1e-8, 0.9, 0.999


def _state(nb, seed):
    """Nonzero moments (quantized with the port's rule), base and grad."""
    rng = np.random.default_rng(seed)
    m_q, m_s = q8.q8_quantize(torch.from_numpy(
        rng.normal(0, 1e-3, nb * B).astype(np.float32)))
    v_q, v_s = q8.q8_quantize(torch.from_numpy(
        rng.uniform(0, 1e-3, nb * B).astype(np.float32)))
    base = rng.normal(0, 0.1, (nb, B)).astype(np.float32)
    grad = rng.normal(0, 0.01, (nb, B)).astype(np.float32)
    return m_q, m_s, v_q, v_s, base, grad


@pytest.mark.parametrize("wd", [True, False], ids=["wd", "no_wd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_update_matches_pallas_interpret(wd, dtype):
    nb, t = 3, 2
    m_q, m_s, v_q, v_s, base, grad = _state(nb, seed=7)
    c1, c2 = 1.0 - B1 ** t, 1.0 - B2 ** t
    if dtype == "bfloat16":
        base = base.astype(ml_dtypes.bfloat16).astype(np.float32)
        grad = grad.astype(ml_dtypes.bfloat16).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    scalars = jnp.array([LR, WD if wd else 0.0, c1, c2, EPS, B1, B2],
                        jnp.float32)
    mq_j, ms_j, vq_j, vs_j, base_j = (np.asarray(x, np.float32)
                                      if i % 2 else np.asarray(x)
                                      for i, x in enumerate(jax_q8_update(
        jnp.asarray(m_q.numpy()), jnp.asarray(m_s.numpy()[:, None]),
        jnp.asarray(v_q.numpy()), jnp.asarray(v_s.numpy()[:, None]),
        jnp.asarray(base, jdt), jnp.asarray(grad, jdt), scalars,
        jnp.zeros((1,), jnp.int32), use_sr=False, has_wd=wd,
        interpret=True)))
    tdt = getattr(torch, dtype)
    st = [m_q.clone(), m_s.clone(), v_q.clone(), v_s.clone(),
          torch.from_numpy(base).to(tdt).reshape(-1).clone()]
    q8.q8_adam_update(*st, torch.from_numpy(grad).to(tdt).reshape(-1),
                      scalars=q8.scalar_block(LR, c1, c2,
                                              1.0 - LR * WD if wd else None),
                      has_wd=wd, eps=EPS, beta1=B1, beta2=B2)
    assert np.abs(st[0].numpy().astype(int) - mq_j.astype(int)).max() <= 1
    assert np.abs(st[2].numpy().astype(int) - vq_j.astype(int)).max() <= 1
    np.testing.assert_allclose(st[1].numpy(), ms_j[:, 0], rtol=2e-5)
    np.testing.assert_allclose(st[3].numpy(), vs_j[:, 0], rtol=2e-5)
    got = st[4].float().numpy().reshape(nb, B)
    want = np.asarray(base_j, np.float32)
    if dtype == "float32":   # the step: base before the update minus after,
        # each side rounded once to base's fp32 grid (|base| < 0.5: ulp 3e-8)
        np.testing.assert_allclose(base - got, base - want, rtol=3e-5,
                                   atol=6e-8)
    else:                    # one bf16 ulp is at most 2^-7 relative
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("n", [2560, 5000])
def test_ragged_parameter_matches_jax_adamw_int8(n):
    rng = np.random.default_rng(n)
    w0 = rng.normal(0, 0.1, n).astype(np.float32)
    grads = [rng.normal(0, 0.01, n).astype(np.float32) for _ in range(3)]
    pj = Parameter(jnp.asarray(w0))
    opt_j = paddle.optimizer.AdamW(learning_rate=LR, parameters=[pj],
                                   moment_dtype="int8")
    pt = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt_t = AdamW(learning_rate=LR, parameters=[pt], moment_dtype="int8")
    for g in grads:
        (pj * paddle.to_tensor(g)).sum().backward()
        opt_j.step()
        opt_j.clear_grad()
        (pt * torch.from_numpy(g)).sum().backward()
        opt_t.step()
        opt_t.clear_grad()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj._data),
                               rtol=1e-6, atol=1e-8)
    for name in ("moment1", "moment2_sqrt"):
        want = np.asarray(opt_j._accumulators[name][id(pj)]._data)
        got = opt_t._accumulators[name][id(pt)].numpy()
        assert got.shape == want.shape == (-(-n // B), B)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert not got.reshape(-1)[n:].any()          # the masked tail
        np.testing.assert_allclose(
            opt_t._accumulators[name + "_scale"][id(pt)].numpy(),
            np.asarray(opt_j._accumulators[name + "_scale"][id(pj)]._data),
            rtol=2e-5)


@pytest.mark.parametrize("n", [5000, 2 * B])
def test_quantize_dequantize_match_jax(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(0, 1e-3, n) * (rng.random(n) < 0.9)).astype(np.float32)
    x[:B] = 0.0 if n == 2 * B else x[:B]          # an all-zero block: scale 1
    qj, sj = (np.asarray(a) for a in _q8_quantize(jnp.asarray(x)))
    qt, st = q8.q8_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(
        q8.q8_dequantize(qt, st, (n,)).numpy(),
        np.asarray(_q8_dequantize(jnp.asarray(qj), jnp.asarray(sj), (n,))))


def test_stochastic_round_matches_jax_given_its_bits():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0, 1, 4000), rng.normal(0, 1e-30, 100),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 3.3895e38, -3.3895e38, 1e-45],
    ]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    want = np.asarray(_stochastic_round_bf16(jnp.asarray(x), key))
    got = q8.stochastic_round_bf16(torch.from_numpy(x),
                                   torch.from_numpy(bits.astype(np.int64)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_stochastic_rounding_is_unbiased():
    # 1 + k / 512 for k = 1..3 lies between the bf16 neighbours 1 and
    # 1 + 1/128; over many seeds the mean of the rounded values is x
    x = torch.tensor([1 + 1 / 512, 1 + 2 / 512, 1 + 3 / 512, -0.3],
                     dtype=torch.float32).repeat(4096)
    acc = torch.zeros_like(x, dtype=torch.float64)
    seeds = 64
    for seed in range(seeds):
        acc += q8.stochastic_round_bf16(
            x, q8.sr_bits(seed, x.numel())).double()
    mean = (acc / seeds).view(4096, 4).mean(0)
    np.testing.assert_allclose(mean.numpy(), x[:4].double().numpy(),
                               rtol=0, atol=2e-5)


def _lowbias32_bits(seed, i):
    m = 0xFFFFFFFF
    h = ((i * 0x9E3779B1) & m) ^ ((seed * 0xC2B2AE3D) & m)
    h ^= h >> 16
    h = (h * 0x7FEB352D) & m
    h ^= h >> 15
    h = (h * 0x846CA68B) & m
    h ^= h >> 16
    return h >> 16


def test_rounding_bits_hash():
    a = q8.sr_bits(11, 5000)
    assert torch.equal(a, q8.sr_bits(11, 5000))
    b = q8.sr_bits(12, 5000)
    assert (a != b).float().mean() > 0.99
    assert int(a.min()) >= 0 and int(a.max()) < 2 ** 16
    # the torch arithmetic is the 32-bit hash, written out in Python ints
    for seed in (0, 11, 2 ** 31 - 2):
        got = q8.sr_bits(seed, 3000)[[0, 1, 2, 999, 2999]].tolist()
        assert got == [_lowbias32_bits(seed, i) for i in (0, 1, 2, 999, 2999)]
    # roughly uniform over 16 bits
    assert abs(float(a.double().mean()) - 32767.5) < 1200


def test_cpu_path_launches_nothing_and_device_tensors_raise():
    before = q8.launches.count
    st = [torch.zeros(1, B, dtype=torch.int8), torch.ones(1),
          torch.zeros(1, B, dtype=torch.int8), torch.ones(1),
          torch.ones(100)]
    hp = dict(has_wd=False, eps=1e-8, beta1=0.9, beta2=0.999)
    q8.q8_adam_update(*st, torch.ones(100),
                      scalars=q8.scalar_block(1e-3, 0.1, 0.001), **hp)
    assert q8.launches.count == before
    meta = [t.to("meta") for t in st]
    with pytest.raises(ValueError, match="CUDA"):
        q8.q8_adam_update(*meta, torch.ones(100, device="meta"),
                          scalars=q8.scalar_block(1e-3, 0.1, 0.001,
                                                  device="meta"), **hp)


def test_ab_q8_adam_variants(monkeypatch):
    # the arithmetic-only variant puts every global store of base and codes
    # behind a test that never holds; the division check's divisors are
    # AdamW's fp32 bias corrections; the tool exits 2 without a card
    import sys
    from pathlib import Path
    from paddle_tpu_torch.tools import ab_q8_adam as ab
    src = (Path(q8.__file__).resolve().parent.parent / "csrc"
           / "q8_adam.cu").read_text()
    arith = ab.arith_only(src)
    assert arith.count(ab._NEVER) == src.count(ab._NEVER) + 2
    for store in ("*reinterpret_cast<uint4*>(p + i0) =",
                  "*reinterpret_cast<uint2*>(mq + i0) = mout;",
                  "*reinterpret_cast<uint2*>(vq + i0) = vout;"):
        assert src.count(store) == 1
        assert ab._NEVER in arith[arith.index(store) - 120:arith.index(store)]
    with pytest.raises(ValueError):
        ab.arith_only("no kernel here")
    c = ab.divisors()
    assert len(c) == 2 * len(ab.STEPS)
    assert c[0] == float(np.float32(1.0) - np.float32(0.9))
    assert all(0.0 < x <= 1.0 for x in c)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["ab_q8_adam", "--other", "other.cu"])
    assert ab.main() == 2
