"""Sampling in the port's ``generate`` against ``paddle_tpu``'s.

The filter (temperature, top-k, top-p) and the draw are held bit for bit:
JAX's ``default_generator.split_key`` is patched here (not in the package)
to hand out fixed keys, and ``jax.random.gumbel`` of the same key is fed to
the port's draw, so both sides draw ``argmax(logits + the same noise)``.

Tolerance: torch's fp32 ``softmax``/``cumsum`` differ from XLA's by an ulp
on most elements, so where ``top_p`` lies within ``CUT_TOL`` of one of the
row's cdf values the cut may move by one token. Such rows may differ; they
are counted, and at most ``MAX_NEAR_CUT_MISMATCH`` of each grid point's
rows may. Every other row must match exactly.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle
from paddle_tpu.core.random import default_generator
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(2)

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=48,
            max_pos=256)
CUT_TOL = 1e-6                 # |cdf - top_p| within which a cut may move
MAX_NEAR_CUT_MISMATCH = 4      # of a grid point's 64 rows
# the largest fp32 below 1: fp32 rounding leaves every cdf of some rows
# under it (JAX's cut index is then V: it keeps every token)
TOP_P_EDGE = float(np.float32(np.nextafter(np.float32(1), np.float32(0))))


def _jax_sample(logits, key, temperature, top_k, top_p):
    with mock.patch.object(default_generator, "split_key", lambda: key):
        return np.asarray(jgen.sample_token(jnp.asarray(logits), True,
                                            temperature, top_k, top_p))


def _jax_cdf(logits, temperature, top_k):
    """JAX's top-p cdf of the temperature-scaled, top-k-filtered rows."""
    arr = jnp.asarray(logits) / temperature if temperature != 1.0 \
        else jnp.asarray(logits)
    if top_k:
        kth = jnp.sort(arr, axis=-1)[..., -top_k][..., None]
        arr = jnp.where(arr < kth, -jnp.inf, arr)
    srt = jnp.sort(arr, axis=-1)[..., ::-1]
    return np.asarray(jnp.cumsum(jax.nn.softmax(srt, -1), axis=-1))


def _near_cut(cdf, top_p):
    if top_p >= 1.0:
        return np.zeros(cdf.shape[0], bool)
    return (np.abs(cdf - np.float32(top_p)) <= CUT_TOL).any(-1)


@pytest.mark.parametrize("vocab", [64, 32000])
@pytest.mark.parametrize("temperature", [0.7, 1.0, 1.3])
@pytest.mark.parametrize("top_k", [0, 1, 5, "V+10"])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5, TOP_P_EDGE])
def test_sample_token_matches_jax_under_injected_noise(vocab, temperature,
                                                       top_k, top_p):
    k = vocab + 10 if top_k == "V+10" else top_k
    rng = np.random.default_rng(vocab + int(temperature * 10))
    logits = (rng.standard_normal((64, vocab)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(vocab)
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    want = _jax_sample(logits, key, temperature, k, top_p)
    got = tgen.draw(tgen.filter_logits(torch.from_numpy(logits), temperature,
                                       k, top_p),
                    torch.from_numpy(noise)).numpy()
    near = _near_cut(_jax_cdf(logits, temperature, k), top_p)
    differ = got != want
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    assert int(differ.sum()) <= MAX_NEAR_CUT_MISMATCH


@pytest.mark.parametrize("top_k", [0, "V+10"])
def test_every_cdf_under_top_p_keeps_every_token(top_k):
    # JAX: cut_idx == V indexes past the end (NaN), nothing is cut; torch
    # would index out of range. Each package's cdf (they differ by ulps:
    # CUT_TOL) stays under top_p on some rows, and there every token stays
    rng = np.random.default_rng(1000)
    logits = (rng.standard_normal((256, 1000)) * 3).astype(np.float32)
    k = 1010 if top_k == "V+10" else 0
    jax_under = (_jax_cdf(logits, 1.0, k) < np.float32(TOP_P_EDGE)).all(-1)
    x = torch.from_numpy(logits)
    port_cdf = torch.cumsum(torch.softmax(
        torch.sort(x, dim=-1, descending=True).values, -1), -1)
    port_under = (port_cdf < TOP_P_EDGE).all(-1)
    assert int(port_under.sum()) >= 4 and jax_under.sum() >= 4
    assert (port_under.numpy() & jax_under).any()
    arr = tgen.filter_logits(x, 1.0, k, TOP_P_EDGE)
    assert torch.isfinite(arr[port_under]).all()
    jarr = np.asarray(jnp.where(jnp.asarray(logits) < jnp.take_along_axis(
        jnp.sort(jnp.asarray(logits), -1)[..., ::-1],
        jnp.full((256, 1), 1000), axis=-1), -jnp.inf, jnp.asarray(logits)))
    assert np.isfinite(jarr[jax_under]).all()   # JAX's NaN cut keeps all


def test_top_k_past_vocab_keeps_every_token():
    logits = torch.randn(3, 10, generator=torch.Generator().manual_seed(1))
    assert torch.equal(tgen.filter_logits(logits, 1.0, 11, 1.0), logits)
    assert torch.equal(tgen.filter_logits(logits, 1.0, 10, 1.0), logits)


def test_top_k_keeps_ties_at_the_kth_value():
    logits = torch.tensor([[3.0, 1.0, 1.0, 1.0, 0.5]])
    kept = torch.isfinite(tgen.filter_logits(logits, 1.0, 2, 1.0))
    assert kept.tolist() == [[True, True, True, True, False]]


def test_greedy_cases_need_no_generator():
    logits = torch.randn(4, 32, generator=torch.Generator().manual_seed(2))
    want = logits.argmax(-1)
    assert torch.equal(tgen.sample_token(logits, False, 0.7, 5, 0.9), want)
    assert torch.equal(tgen.sample_token(logits, True, 0.0, 5, 0.9), want)


def test_missing_generator_raises():
    logits = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="generator"):
        tgen.sample_token(logits, True, 0.7, 0, 1.0)
    m = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    with pytest.raises(ValueError, match="generator"):
        m.generate(torch.zeros(1, 3, dtype=torch.long), max_new_tokens=2,
                   do_sample=True)


def test_draw_frequencies_follow_the_kept_softmax():
    # the port's own Gumbel draw on a seeded generator: 40000 draws of one
    # row against the softmax of its kept logits (chi-square)
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.8, 0.5, 0.0, -0.5, -1.0, -1.5,
                            -2.0, -3.0, -4.0]])
    t, k, p = 0.8, 8, 0.95
    kept = tgen.filter_logits(logits, t, k, p)[0]
    probs = torch.softmax(kept.double(), -1)
    n = 40000
    g = torch.Generator().manual_seed(1234)
    ids = tgen.sample_token(logits.expand(n, -1), True, t, k, p, g)
    counts = torch.bincount(ids, minlength=logits.shape[1]).double()
    live = torch.isfinite(kept)
    assert counts[~live].sum() == 0          # nothing outside the kept set
    want = probs[live] / probs[live].sum() * counts.sum()
    res = stats.chisquare(counts[live].numpy(), want.numpy())
    assert res.pvalue > 1e-3, res


def test_same_seed_same_draws():
    logits = torch.randn(5, 40, generator=torch.Generator().manual_seed(3))
    a = tgen.sample_token(logits, True, 0.9, 10, 0.8,
                          torch.Generator().manual_seed(9))
    b = tgen.sample_token(logits, True, 0.9, 10, 0.8,
                          torch.Generator().manual_seed(9))
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(7)
    jm = JLlama(JConfig.tiny(**TINY))
    jm.eval()
    np_state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(np_state), strict=True)
    yield jm, tm
    import gc
    del jm
    gc.collect()


def _generate_both(jm, tm, prompt, keys, **kw):
    """Both packages' sampled generate, step i drawing JAX's Gumbel noise
    of ``keys[i]``."""
    jstep, tstep = iter(keys), iter(keys)

    def torch_noise(shape, generator, device=None):
        return torch.from_numpy(np.array(
            jax.random.gumbel(next(tstep), tuple(shape), jnp.float32)))
    with mock.patch.object(default_generator, "split_key",
                           lambda: next(jstep)):
        want = np.asarray(jm.generate(
            paddle.to_tensor(prompt.astype(np.int32)), do_sample=True,
            **kw)._data)
    with mock.patch.object(tgen, "gumbel_noise", torch_noise):
        got = tm.generate(torch.from_numpy(prompt), do_sample=True,
                          generator=torch.Generator(), **kw)
    return want, got.numpy()


def test_sampled_generate_matches_jax_with_eos_freezing(pair):
    jm, tm = pair
    prompt = np.random.default_rng(5).integers(0, 64, (3, 9))
    keys = [jax.random.PRNGKey(100 + i) for i in range(8)]
    kw = dict(max_new_tokens=8, temperature=0.8, top_k=20, top_p=0.9)
    want, got = _generate_both(jm, tm, prompt, keys, **kw)
    assert got.tolist() == want.tolist()
    # eos: a token row 0 samples at its third step; that row freezes there
    eos = int(want[0, 9 + 2])
    want, got = _generate_both(jm, tm, prompt, keys, eos_token_id=eos, **kw)
    assert got.tolist() == want.tolist()
    row = got[0, 9:].tolist()
    first = row.index(eos)
    assert first <= 2 and all(t == eos for t in row[first:])


def test_top_k_one_sampling_is_greedy(pair):
    _, tm = pair
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, 64, (2, 7)))
    greedy = tm.generate(prompt, max_new_tokens=6)
    sampled = tm.generate(prompt, max_new_tokens=6, do_sample=True,
                          temperature=0.7, top_k=1,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(greedy, sampled)
