"""The port's flash-attention forward (plain version on the CPU) against
``paddle_tpu.nn.functional.flash_attention``.

At tileable lengths (multiples of 128 here) the JAX side runs its Pallas
kernel under the interpreter, as its own tests do on the CPU; ragged
lengths run its XLA fallback. Same numpy inputs to both, fp32, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as PF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

D = 32

CASES = [  # b, lq, lk, h, h_kv, causal
    (1, 128, 128, 4, 4, True),    # Pallas kernel (interpret)
    (2, 128, 128, 4, 2, True),    # GQA
    (1, 128, 256, 4, 4, True),    # lq < lk: bottom-right causal
    (1, 128, 128, 4, 4, False),
    (2, 37, 53, 4, 2, True),      # ragged: XLA fallback on the JAX side
    (1, 100, 100, 2, 1, False),
]


def _inputs(b, lq, lk, h, hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, D)).astype(np.float32)
    k = rng.standard_normal((b, lk, hkv, D)).astype(np.float32)
    v = rng.standard_normal((b, lk, hkv, D)).astype(np.float32)
    return q, k, v


def _paddle_flash(q, k, v, causal):
    # GQA: the JAX surface repeats kv heads itself before its kernel
    out = PF.flash_attention(paddle.to_tensor(q), paddle.to_tensor(k),
                             paddle.to_tensor(v), causal=causal)
    return np.asarray(out._data)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_sdpa_matches_paddle_tpu_flash(case):
    b, lq, lk, h, hkv, causal = case
    q, k, v = _inputs(b, lq, lk, h, hkv)
    want = _paddle_flash(q, k, v, causal)
    got = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=causal)
    assert got.shape == (b, lq, h, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_fully_masked_rows_emit_zero():
    # lq > lk, causal bottom-right: the first lq - lk rows see no key
    q, k, v = _inputs(1, 8, 5, 2, 2, seed=1)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True)
    assert torch.equal(out[:, :3], torch.zeros_like(out[:, :3]))
    assert torch.isfinite(out).all() and out[:, 3:].abs().sum() > 0


def test_masked_sdpa_on_cpu_matches_paddle_tpu():
    q, k, v = _inputs(2, 16, 16, 4, 2, seed=2)
    mask = np.random.default_rng(3).random((2, 1, 16, 16)) > 0.3
    mask[..., 0] = True
    want = np.asarray(PF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(mask), training=False)._data)
    got = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_device_tensor_with_mask_raises():
    # any non-CPU tensor with a mask: no kernel for it, never a CPU detour
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(NotImplementedError):
        TF.scaled_dot_product_attention(
            q, q, q, attn_mask=torch.ones(4, 4, dtype=torch.bool,
                                          device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q, causal=True)


def test_cpu_path_launches_nothing():
    q, k, v = _inputs(1, 4, 4, 2, 2)
    before = fa.launches.count
    fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v))
    assert fa.launches.count == before
