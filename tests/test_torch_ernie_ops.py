"""The plain versions of K5-K8, the port's embedding, bias-and-activation,
dropout and masked-softmax kernels (``ops/embedding.py``,
``ops/bias_act.py``, ``ops/dropout.py``, ``ops/softmax_mask.py``), on the
CPU, where the wrappers run them (the kernels themselves are held against
them on the card by ``chip_smoke.py``'s ``ernie_ops_check``).

* each plain version against the former plain op it replaces, kept below
  verbatim from before the kernels: the embedding (``weight[x.long()]``
  and ``where``) with its autograd gradient, bit for bit in fp32 and bf16
  wherever no id repeats more than ``CHUNK`` times (the backward's pieces);
  ``gelu``/``relu`` and ``linear`` then the activation, forward and
  gradients, bit for bit; the softmax of ``x + mask``, bit for bit;
* the hidden-dropout mask against B0's lowbias32 hash family
  (``keep_mask_reference`` and a scalar Python copy of the hash), the
  dropout values and gradients against their definition;
* K5's backward under the all-zero-ids skew: deterministic, in the
  kernel's piece order, within fp32 rounding of the exact sum;
* the four autograd functions and a tiny ERNIE O2 step through
  ``jit.capture_step`` (the CPU runs it eagerly) and a tiny Llama step,
  with every launch done by its plain version: the same losses and
  gradients as the plain path, and the launches an ERNIE step makes;
* the CPU launches no kernel.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                           ErnieForSequenceClassification)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import DropoutRNG
from paddle_tpu_torch.ops import bias_act as ba
from paddle_tpu_torch.ops import dropout as dr
from paddle_tpu_torch.ops import embedding as em
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops import softmax_mask as sm
from paddle_tpu_torch.ops._u32 import M32
from paddle_tpu_torch.ops.flash_attention import (dropout_constants,
                                                  keep_mask_reference)
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

torch.set_num_threads(2)

SETTINGS = [(torch.float32, None), (torch.bfloat16, None),
            (torch.float32, "O2")]


def _amp(level):
    return amp.auto_cast(level=level, dtype="bfloat16") if level else \
        amp.auto_cast(enable=False)


# ---------------------------------------------------------------------------
# the former plain ops, verbatim
# ---------------------------------------------------------------------------

def _old_embedding(x, weight, padding_idx=None):
    (weight,) = amp.cast_inputs("embedding", weight)
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def _old_linear(x, weight, bias=None):
    x, weight, bias = amp.cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def _old_relu(x):
    (x,) = amp.cast_inputs("relu", x)
    return torch.relu(x)


def _old_gelu(x, approximate=False):
    (x,) = amp.cast_inputs("gelu", x)
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate
                                    else "none")


def _old_softmax_mask(x, mask):
    return torch.softmax(x.float() + mask.float(), dim=-1).to(x.dtype)


def _lowbias32(seed, hi, lo):
    """B0's hash of (seed, the hidden-dropout stream, hi, lo) in Python
    ints."""
    h = ((hi * 0x9E3779B1) ^ (lo * 0x85EBCA77)) & M32
    h ^= (seed * 0xC2B2AE3D) & M32
    h ^= (dr.STREAM * 0x27D4EB2F) & M32
    h ^= h >> 16
    h = (h * 0x7FEB352D) & M32
    h ^= h >> 15
    h = (h * 0x846CA68B) & M32
    h ^= h >> 16
    return h


def _leaf(seed, shape, dtype, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype) \
        .requires_grad_()


# ---------------------------------------------------------------------------
# K5: the embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,level", SETTINGS)
@pytest.mark.parametrize("padding_idx", [None, 0, 5])
def test_embedding_plain_is_the_former_op(dtype, level, padding_idx):
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 40, (3, 50), generator=g)   # ids repeat, < 64x
    ids[0, :4] = 5
    w_old, w_new = (_leaf(2, (40, 24), dtype, 0.1) for _ in range(2))
    dy = torch.randn(3, 50, 24, generator=g)
    with _amp(level):
        old = _old_embedding(ids, w_old, padding_idx)
        new = nn_ops.embedding(ids, w_new, padding_idx)
    assert new.dtype == old.dtype and torch.equal(new, old)
    old.backward(dy.to(old.dtype))
    new.backward(dy.to(new.dtype))
    assert w_new.grad.dtype == w_old.grad.dtype
    assert torch.equal(w_new.grad, w_old.grad)
    if padding_idx is not None:
        assert not w_new.grad[padding_idx].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_backward_under_all_zero_ids_skew(dtype):
    # one id for all 1000 rows, as ERNIE's token-type ids: pieces of CHUNK
    # rows summed in token order, folded in piece order; deterministic
    g = torch.Generator().manual_seed(3)
    ids = torch.zeros(4, 250, dtype=torch.int64)
    dy = torch.randn(4, 250, 16, generator=g).to(dtype)
    first = em.embedding_bwd_reference(ids, dy, 4, None, dtype)
    again = em.embedding_bwd_reference(ids.clone(), dy.clone(), 4, None,
                                       dtype)
    assert torch.equal(first, again) and not first[1:].any()
    rows = dy.reshape(-1, 16).float()

    def add(a, b):
        return (a + b).to(dtype).float()
    parts = []
    for c0 in range(0, rows.shape[0], em.CHUNK):
        acc = torch.zeros(16)
        for r in rows[c0:c0 + em.CHUNK]:
            acc = add(acc, r)
        parts.append(acc)
    acc = torch.zeros(16)
    for part in parts:
        acc = add(acc, part)
    assert len(parts) == 16 and torch.equal(first[0].float(), acc)
    exact = rows.double().sum(0)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -4
    assert float((first[0].double() - exact).abs().max()) <= \
        tol * float(exact.abs().max())


def test_embedding_backward_mixes_short_and_long_runs():
    # runs around the CHUNK boundary, ids in any order, a padding id
    g = torch.Generator().manual_seed(4)
    ids = torch.cat([torch.full((65,), 3), torch.full((64,), 1),
                     torch.full((129,), 7), torch.arange(10)])
    ids = ids[torch.randperm(len(ids), generator=g)]
    dy = torch.randn(len(ids), 8, generator=g)
    got = em.embedding_bwd_reference(ids, dy, 12, 7, torch.float32)
    want = torch.zeros(12, 8, dtype=torch.float64).index_add_(
        0, ids, dy.double())
    want[7] = 0
    assert not got[7].any() and not got[10:].any()
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)
    # ids that no token hit stay 0; the short runs are the token-order sum
    assert torch.equal(got[1], _seq(dy[ids == 1]))


def _seq(rows):
    acc = torch.zeros(rows.shape[1])
    for r in rows:
        acc = acc + r
    return acc


# ---------------------------------------------------------------------------
# K6: bias and activation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,level", SETTINGS)
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_activation_plain_is_the_former_ops(dtype, level, act, bias):
    x_o, x_n = (_leaf(5, (6, 10, 16), dtype) for _ in range(2))
    w_o, w_n = (_leaf(6, (16, 24), dtype, 0.3) for _ in range(2))
    b_o, b_n = ((_leaf(7, (24,), dtype, 0.5) for _ in range(2)) if bias
                else (None, None))
    old_act = _old_relu if act == "relu" else (
        lambda h: _old_gelu(h, act == "gelu_tanh"))
    dy = torch.randn(6, 10, 24, generator=torch.Generator().manual_seed(8))
    with _amp(level):
        old = old_act(_old_linear(x_o, w_o, b_o))
        new = nn_ops.linear(x_n, w_n, b_n, activation=act)
    assert new.dtype == old.dtype and torch.equal(new, old)
    old.backward(dy.to(old.dtype))
    new.backward(dy.to(new.dtype))
    for o, n in ((x_o, x_n), (w_o, w_n), (b_o, b_n)):
        if o is not None:
            assert torch.equal(n.grad, o.grad)


@pytest.mark.parametrize("dtype,level", SETTINGS)
@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_and_relu_plain_are_the_former_ops(dtype, level, approximate):
    x_o, x_n = (_leaf(9, (7, 33), dtype, 2.0) for _ in range(2))
    with _amp(level):
        pairs = [(_old_gelu(x_o, approximate), nn_ops.gelu(x_n, approximate)),
                 (_old_relu(x_o), nn_ops.relu(x_n))]
    dy = torch.randn(7, 33, generator=torch.Generator().manual_seed(10))
    for old, new in pairs:
        assert new.dtype == old.dtype and torch.equal(new, old)
        go, = torch.autograd.grad(old, x_o, dy.to(old.dtype))
        gn, = torch.autograd.grad(new, x_n, dy.to(new.dtype))
        assert torch.equal(gn, go)


def test_bias_act_backward_plain_matches_autograd():
    y = torch.randn(130, 40, generator=torch.Generator().manual_seed(11))
    b = torch.randn(40, generator=torch.Generator().manual_seed(12))
    dy = torch.randn(130, 40, generator=torch.Generator().manual_seed(13))
    spec = ba.ActSpec("gelu", torch.float32, torch.float32)
    dyy, db = ba.bias_act_bwd_reference(y, b, dy, spec)
    h = (y + b).requires_grad_()
    (gh,) = torch.autograd.grad(torch.nn.functional.gelu(h), h, dy)
    assert torch.equal(dyy, gh)
    torch.testing.assert_close(db, gh.sum(0), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# K7: dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 12345, M32, 2 ** 31])
def test_dropout_mask_is_b0s_hash_family(seed):
    p = 0.3
    keep_prob, _ = dropout_constants(p)
    shape = (7, 45)
    mask = dr.keep_mask(seed, shape, p)
    i = torch.arange(7 * 45).view(shape)
    want = keep_mask_reference(seed, dr.STREAM, i >> 32, i & M32, keep_prob)
    assert torch.equal(mask, want)
    for flat in (0, 1, 17, 314):
        h = _lowbias32(seed, 0, flat)
        assert bool(mask.flatten()[flat]) == \
            ((h >> 8) * 2.0 ** -24 < keep_prob)
    # the high word of an index past 2^32 enters the hash as the row
    hi = keep_mask_reference(seed, dr.STREAM, torch.tensor([1, 2]),
                             torch.tensor([5, 5]), keep_prob)
    assert [bool(v) for v in hi] == [
        (_lowbias32(seed, r, 5) >> 8) * 2.0 ** -24 < keep_prob
        for r in (1, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("upscale", [True, False])
@pytest.mark.parametrize("residual", [None, torch.float32])
def test_dropout_values_and_gradients(dtype, upscale, residual):
    p, seed = 0.25, torch.tensor(77)
    x = _leaf(14, (64, 48), dtype)
    res = None if residual is None else _leaf(15, (64, 48), residual)
    out = dr.dropout(x, p, seed, residual=res, upscale=upscale)
    keep = dr.keep_mask(seed, x.shape, p)
    _, inv = dropout_constants(p)
    d = torch.where(keep, x * inv if upscale else x, 0.0)
    want = d if res is None else d + res
    assert out.dtype == want.dtype and torch.equal(out, want)
    assert 0.65 < float(keep.float().mean()) < 0.85
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(16)
                     ).to(out.dtype)
    gx = torch.autograd.grad(out, x, dy, retain_graph=True)[0]
    gd = dy.to(dtype)
    assert torch.equal(gx, torch.where(keep, gd * inv if upscale else gd,
                                       0.0))
    if res is not None:
        assert torch.equal(torch.autograd.grad(out, res, dy)[0], dy)


def test_dropout_draws_one_seed_from_the_rng_or_generator():
    x = torch.randn(16, 32)
    rng = DropoutRNG("cpu", seed=21)
    out = nn_ops.dropout(x, 0.5, True, generator=rng)
    assert int(rng.counter) == 1
    want = dr.dropout_reference(x, DropoutRNG("cpu", seed=21).next_seed(),
                                0.5)
    assert torch.equal(out, want)
    g, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    assert torch.equal(nn_ops.dropout(x, 0.5, generator=g),
                       dr.dropout_reference(x, dr.draw_seed(g2, "cpu"), 0.5))
    assert torch.equal(nn_ops.dropout(x, 0.5, False), x)
    assert not nn_ops.dropout(x, 1.0, generator=g).any()
    with pytest.raises(ValueError, match="generator"):
        nn_ops.dropout(x, 0.5)


# ---------------------------------------------------------------------------
# K8: the masked softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_shape", [(2, 1, 8, 20), (2, 3, 8, 20),
                                        (8, 20)])
def test_softmax_mask_plain_is_the_former_op(dtype, mask_shape):
    g = torch.Generator().manual_seed(17)
    x = (torch.randn(2, 3, 8, 20, generator=g) * 3).to(dtype)
    mask = torch.randn(mask_shape, generator=g).to(dtype)
    assert torch.equal(sm.softmax_mask(x, mask), _old_softmax_mask(x, mask))


@pytest.mark.parametrize("lq,lk", [(8, 8), (6, 10), (10, 6)])
def test_softmax_mask_upper_triangle_is_bottom_right_causal(lq, lk):
    x = torch.randn(2, 3, lq, lk, generator=torch.Generator().manual_seed(18))
    keep = torch.ones(lq, lk, dtype=torch.bool).tril(lk - lq)
    want = torch.softmax(torch.where(keep, x, -1e30), -1)
    assert torch.equal(sm.softmax_mask(x, causal=True), want)


def test_softmax_mask_backward_plain_matches_autograd():
    g = torch.Generator().manual_seed(19)
    x = torch.randn(2, 3, 8, 20, generator=g, requires_grad=True)
    mask = torch.randn(2, 1, 8, 20, generator=g)
    dy = torch.randn(2, 3, 8, 20, generator=g)
    y = sm.softmax_mask(x, mask)
    (gx,) = torch.autograd.grad(y, x, dy)
    got = sm.softmax_mask_bwd_reference(y.detach(), dy)
    torch.testing.assert_close(got, gx, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the autograd functions and whole steps, every launch by its plain version
# ---------------------------------------------------------------------------

def _fake_emb_fwd(ids, weight, pad, fns=None):
    em.launches.count += 1
    return em.embedding_reference(ids, weight, pad)


def _fake_emb_bwd(ids, dy, rows, pad, dtype, fns=None):
    em.launches.count += 1
    return em.embedding_bwd_reference(ids, dy, rows, pad, dtype)


def _fake_ba_fwd(y, b, spec, fns=None):
    ba.launches.count += 1
    with torch.no_grad():
        return ba.bias_act_reference(y, b, spec)


def _fake_ba_bwd(y, b, dy, spec, fns=None):
    ba.launches.count += 1
    dyy, db = ba.bias_act_bwd_reference(y, b, dy, spec)
    return dyy.to(y.dtype), None if db is None else db.to(b.dtype)


def _fake_dr_fwd(x, residual, seed_t, p, upscale, fns=None):
    dr.launches.count += 1
    with torch.no_grad():
        return dr.dropout_reference(x, seed_t, p, residual=residual,
                                    upscale=upscale)


def _fake_dr_bwd(dy, seed_t, p, upscale, x_dtype, fns=None):
    dr.launches.count += 1
    keep = dr.keep_mask(seed_t, dy.shape, p)
    gd = dy.to(x_dtype)
    _, inv = dropout_constants(p)
    return torch.where(keep, gd * inv if upscale else gd, 0.0)


def _fake_sm_fwd(x, mask, causal, fns=None):
    sm.launches.count += 1
    return sm.softmax_mask_reference(x, mask, causal)


def _fake_sm_bwd(y, dy, fns=None):
    sm.launches.count += 1
    return sm.softmax_mask_bwd_reference(y, dy)


def _kernel_path(monkeypatch):
    """CPU tensors take the kernel path, each launch done by its plain
    version (and counted)."""
    for mod in (em, ba, dr, sm):
        monkeypatch.setattr(mod, "plain_path", lambda t: False)
    for mod, fwd, bwd in ((em, _fake_emb_fwd, _fake_emb_bwd),
                          (ba, _fake_ba_fwd, _fake_ba_bwd),
                          (dr, _fake_dr_fwd, _fake_dr_bwd),
                          (sm, _fake_sm_fwd, _fake_sm_bwd)):
        monkeypatch.setattr(mod, "_launch_fwd", fwd)
        monkeypatch.setattr(mod, "_launch_bwd", bwd)


def _counts():
    return {m.launches.name: m.launches.count for m in (em, ba, dr, sm)}


def _grads(fn, leaves, seed=20):
    out = fn(*leaves)
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)
                     ).to(out.dtype)
    return [out] + list(torch.autograd.grad(out, leaves, dy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_functions_through_the_kernel_path(monkeypatch, dtype):
    ids = torch.randint(0, 30, (4, 70), generator=torch.Generator()
                        .manual_seed(21))
    ids[:, :3] = 2
    w = _leaf(22, (30, 16), dtype, 0.1)
    y, b = _leaf(23, (5, 9, 16), dtype), _leaf(24, (16,), dtype)
    x, res = _leaf(25, (6, 40), dtype), _leaf(26, (6, 40), torch.float32)
    s, mask = _leaf(27, (2, 3, 8, 20), dtype), torch.randn(2, 1, 8, 20)
    spec = ba.ActSpec("gelu", dtype, dtype)
    calls = [(lambda w: em.embedding(ids, w, 2), [w]),
             (lambda y, b: ba.bias_act(y, b, spec), [y, b]),
             (lambda x, r: dr.dropout(x, 0.2, torch.tensor(9), residual=r),
              [x, res]),
             (lambda s: sm.softmax_mask(s, mask.to(dtype)), [s]),
             (lambda s: sm.softmax_mask(s, causal=True), [s])]
    plain = [_grads(fn, leaves) for fn, leaves in calls]
    _kernel_path(monkeypatch)
    before = _counts()
    kernel = [_grads(fn, leaves) for fn, leaves in calls]
    counts = {k: v - before[k] for k, v in _counts().items()}
    assert counts == {"embedding": 2, "bias_act": 2, "dropout": 2,
                      "softmax_mask": 4}
    for i, (p, k) in enumerate(zip(plain, kernel)):
        for a, c in zip(p, k):
            assert a.dtype == c.dtype and a.shape == c.shape
            if i < 3:   # the softmax backward reads the rounded output
                assert torch.equal(a, c), i
            else:
                torch.testing.assert_close(c.float(), a.float(), rtol=0,
                                           atol=2e-2 if dtype == torch.bfloat16
                                           else 1e-6)


def _ernie_step(level, layers=2):
    cfg = ErnieConfig.tiny(vocab=64, hidden=32, layers=layers, heads=2,
                           inter=48, max_pos=32)
    m = ErnieForSequenceClassification(cfg, device="cpu", seed=3)
    sched_opt = AdamW(learning_rate=1e-3, parameters=m.parameters(),
                      weight_decay=0.01, use_multi_tensor=True,
                      grad_clip=ClipGradByGlobalNorm(1.0))
    if level:
        m, sched_opt = amp.decorate(m, sched_opt, level=level,
                                    dtype="bfloat16")
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(1, 64, (2, 16), generator=g)
    labels = torch.randint(0, 2, (2,), generator=g)

    def step(ids, labels):
        with _amp(level):
            loss, _ = m(ids, labels=labels)
        loss.backward()
        return loss
    grads = {}

    def update():
        grads.update({n: p.grad.float().clone()
                      for n, p in m.named_parameters()})
        sched_opt.step()
        sched_opt.clear_grad()
    cap = jit.capture_step(step, update_fn=update,
                           clear_fn=sched_opt.clear_grad, nan_gate=True)
    loss = float(cap(ids, labels))
    return loss, grads, int(m.ernie.rng.counter), cap.stats


def test_ernie_o2_captured_step_through_the_kernel_path(monkeypatch):
    # dropout on (the tiny config's 0.1): both runs draw the same seeds;
    # capture_step runs a CPU model's step eagerly (bypass "cpu")
    monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", "auto")
    loss_p, grads_p, ctr_p, stats = _ernie_step("O2")
    assert stats["bypasses"] == {"cpu": 1}
    _kernel_path(monkeypatch)
    before = _counts()
    loss_k, grads_k, ctr_k, _ = _ernie_step("O2")
    counts = {k: v - before[k] for k, v in _counts().items()}
    layers = 2
    assert counts == {"embedding": 8, "bias_act": 2 * layers,
                      "dropout": 2 * (2 * layers + 2), "softmax_mask": 0}
    assert ctr_k == ctr_p == 3 * layers + 2
    assert loss_k == loss_p
    for n, gp in grads_p.items():
        assert torch.equal(grads_k[n], gp), n


def test_llama_step_through_the_kernel_path(monkeypatch):
    def run():
        cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
                               kv_heads=2, inter=48, max_pos=64)
        m = LlamaForCausalLM(cfg, device="cpu")
        ids = torch.randint(0, 64, (2, 16),
                            generator=torch.Generator().manual_seed(3))
        loss, _ = m(ids, labels=ids)
        loss.backward()
        return float(loss), m.model.embed_tokens.weight.grad.clone()
    loss_p, g_p = run()
    _kernel_path(monkeypatch)
    before = _counts()
    loss_k, g_k = run()
    assert {k: v - before[k] for k, v in _counts().items()} == {
        "embedding": 2, "bias_act": 0, "dropout": 0, "softmax_mask": 0}
    assert loss_k == loss_p and torch.equal(g_k, g_p)


def test_cpu_tensors_launch_no_kernel():
    before = _counts()
    loss, _, _, _ = _ernie_step(None, layers=1)
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    sm.softmax_mask(x, causal=True).sum().backward()
    assert np.isfinite(loss) and _counts() == before
