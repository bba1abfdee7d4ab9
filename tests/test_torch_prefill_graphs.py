"""The serving engine's prefill, the body that a card captures as one CUDA
graph per prefill key ``(start, n)`` (``serving.engine.PrefillGraph``) and
the CPU engine calls eagerly (``serving.engine.prefill_body``).

* The body against the JAX engine's compiled ``prefill_program`` and tail
  program (``paddle_tpu/serving/engine.py``: ``prefill_body``,
  ``build_tail_program``) on the same numpy weights, prompts and page rows:
  the tiny Llama (a full prefill, then a tail at ``start`` 96 over its
  shared pages) and the FMT stack of ``tools/fmt_stack.py`` (the
  bidirectional prefill; the causal prefill, full then a tail at ``start``
  32), each on the native and the int8 pool. The JAX side runs with the
  SDPA routing seam open, so its prefill reaches the Pallas flash kernel
  in interpret mode. Tolerance: first tokens equal; every written pool
  page within 1e-5 of the page's largest magnitude (fp32), or int8 codes
  within one quantization step and scales within 1e-5 relative.
* Static-buffer reuse: two prompts of one key through one set of ``ids``
  and page-row buffers, one after the other, each bit-equal to its own
  fresh eager prefill (first token, its pages, positions past the true
  length zeroed over a pool of garbage) and the shared prefix pages
  untouched.
* Key logic: with the graph classes replaced by stand-ins that run the
  body eagerly (a CPU has no graphs), ``warmup(prompt_lens)`` registers
  ``(0, n)`` keys, an admission registers its own key, every admission is
  one replay, and the transcripts equal the plain CPU engine's;
  ``PrefillGraph`` on a CPU pool and ``Engine.prefill_graph`` on the CPU
  raise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import serving as jserving
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.ops import flash_attention as jflash
from paddle_tpu.ops import nn_ops as jnn_ops
from paddle_tpu_torch import serving
from paddle_tpu_torch.serving import engine as teng_mod
from paddle_tpu_torch.serving.engine import PrefillGraph, prefill_body

from test_torch_fused_multi_transformer import D as FMT_D
from test_torch_fused_multi_transformer import H as FMT_H
from test_torch_fused_multi_transformer import L as FMT_L
from test_torch_fused_multi_transformer import V as FMT_V
from test_torch_fused_multi_transformer import stacks  # noqa: F401
from test_torch_serving import MAX_LEN, PS, TINY, pair  # noqa: F401

torch.set_num_threads(2)

FP32_REL = 1e-5
FMT_MAX_LEN = 64


@pytest.fixture
def pallas_flash(monkeypatch):
    """Open the JAX SDPA routing seam and count the Pallas flash calls."""
    monkeypatch.setattr(jnn_ops, "_sdpa_flash_backend_ok", lambda: True)
    calls = []
    real = jflash._pallas_flash

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(jflash, "_pallas_flash", counted)
    return calls


def _llama_cfg(mod, kv_dtype, **kw):
    return mod.ServingConfig(num_layers=TINY["layers"],
                             num_heads=TINY["kv_heads"],
                             head_dim=TINY["hidden"] // TINY["heads"],
                             max_len=MAX_LEN, max_batch=2, buckets=(1, 2),
                             page_size=PS, kv_dtype=kv_dtype, **kw)


def _fmt_cfg(mod, kv_dtype, **kw):
    return mod.ServingConfig(num_layers=FMT_L, num_heads=FMT_H,
                             head_dim=FMT_D, max_len=FMT_MAX_LEN,
                             max_batch=4, buckets=(1, 4), page_size=16,
                             kv_dtype=kv_dtype, **kw)


def _jax_prefill(jeng, prompt, row, start=0) -> int:
    """One admission's prefill through the JAX engine's compiled program
    (the tail program at ``start > 0``); the pool is threaded back into
    the engine as its admission does."""
    args = (JT(jnp.asarray(prompt[None, start:], jnp.int32)),
            JT(jnp.asarray(row)), JT(jnp.asarray(prompt.size, jnp.int32)),
            JT(jeng.kv.pool), *jeng._scales_args())
    prog = jeng._tail_program(start) if start else jeng._prefill_program
    outs = prog(*args)
    jeng._set_pool(outs[1], outs[2] if jeng._quantized else None)
    return int(np.asarray(outs[0]._data)[0, 0])


def _port_prefill(eng, prompt, row, start=0) -> int:
    pages = row[:eng.kv.pages_for(int(prompt.size))]
    nxt = prefill_body(eng._prefill_fn, eng.kv,
                       torch.as_tensor(prompt[None, start:],
                                       dtype=torch.int64),
                       torch.as_tensor(pages), start)
    return int(nxt.reshape(-1)[0])


def _pages_close(teng, jeng, page_ids):
    """The port's pool pages against the JAX engine's, as the module
    docstring says."""
    ids = np.asarray(page_ids)
    got = teng.kv.pool[torch.as_tensor(ids)].numpy()
    want = np.asarray(jeng.kv.pool)[ids]
    if teng.kv.scales is None:
        for g, w in zip(got, want):
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=FP32_REL,
                                       atol=FP32_REL * scale)
        return
    got_sc = teng.kv.scales[torch.as_tensor(ids)].numpy()
    want_sc = np.asarray(jeng.kv.scales)[ids]
    np.testing.assert_allclose(got_sc, want_sc, rtol=FP32_REL, atol=0)
    step = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert step.max() <= 1, f"int8 codes differ by {step.max()} steps"


def _rows(eng, start, first_len, tail_len):
    """A full prompt's row (pages 1..) and a second prompt's row that maps
    the first ``start // ps`` of them and continues on fresh pages."""
    kv = eng.kv
    ps = kv.config.page_size
    k_a = kv.pages_for(first_len)
    row_a = kv.table_row(list(range(1, 1 + k_a)))
    shared = list(range(1, 1 + start // ps))
    k_b = kv.pages_for(start + tail_len) - len(shared)
    row_b = kv.table_row(shared + list(range(1 + k_a, 1 + k_a + k_b)))
    return row_a, row_b


def _full_then_tail(teng, jeng, prompt_a, prompt_b, start):
    """Prefill ``prompt_a`` whole, then ``prompt_b`` over the first
    ``start`` positions of its pages, on both engines; tokens equal and
    every page both wrote close."""
    row_a, row_b = _rows(teng, start, prompt_a.size, prompt_b.size - start)
    assert _port_prefill(teng, prompt_a, row_a) \
        == _jax_prefill(jeng, prompt_a, row_a)
    _pages_close(teng, jeng, row_a[row_a > 0])
    if start:
        assert _port_prefill(teng, prompt_b, row_b, start) \
            == _jax_prefill(jeng, prompt_b, row_b, start)
        _pages_close(teng, jeng, np.union1d(row_a[row_a > 0],
                                            row_b[row_b > 0]))


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_llama_body_matches_jax_prefill_and_tail_programs(pair, kv_dtype,
                                                          pallas_flash):
    jm, tm = pair
    rng = np.random.default_rng(21)
    prompt_a = rng.integers(0, TINY["vocab"], (128,), dtype=np.int32)
    start = 96
    prompt_b = np.concatenate([prompt_a[:start], rng.integers(
        0, TINY["vocab"], (20,), dtype=np.int32)])
    jeng = jserving.Engine(*jm.serving_callables(MAX_LEN), _llama_cfg(
        jserving, kv_dtype, paged_attention="on", prefix_sharing="on"))
    teng = serving.Engine(*tm.serving_callables(MAX_LEN), _llama_cfg(
        serving, kv_dtype, prefix_sharing="on", device="cpu"))
    _full_then_tail(teng, jeng, prompt_a, prompt_b, start)
    assert any(s[2] == 128 for s in pallas_flash), pallas_flash


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_fmt_bidirectional_body_matches_jax_prefill_program(stacks, kv_dtype,
                                                            pallas_flash):
    (jprefill, _, jstep), stack = stacks
    prompt = np.random.default_rng(22).integers(0, FMT_V, (41,),
                                                dtype=np.int32)
    jeng = jserving.Engine(jprefill, jstep, _fmt_cfg(
        jserving, kv_dtype, paged_attention="on"))
    teng = serving.Engine(*stack.serving_callables(),
                          _fmt_cfg(serving, kv_dtype, device="cpu"))
    _full_then_tail(teng, jeng, prompt, prompt, 0)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_fmt_causal_tail_body_matches_jax_tail_program(stacks, kv_dtype,
                                                       pallas_flash):
    (_, jprefill_causal, jstep), stack = stacks
    rng = np.random.default_rng(23)
    prompt_a = rng.integers(0, FMT_V, (40,), dtype=np.int32)
    start = 32
    prompt_b = np.concatenate([prompt_a[:start], rng.integers(
        0, FMT_V, (13,), dtype=np.int32)])
    jeng = jserving.Engine(jprefill_causal, jstep, _fmt_cfg(
        jserving, kv_dtype, paged_attention="on", prefix_sharing="on"))
    teng = serving.Engine(*stack.serving_callables(causal=True), _fmt_cfg(
        serving, kv_dtype, prefix_sharing="on", device="cpu"))
    _full_then_tail(teng, jeng, prompt_a, prompt_b, start)


# ---------------------------------------------------------------------------
# one key's static buffers, reused by prompts of other content
# ---------------------------------------------------------------------------

def _garbage_engine(callables, kv_dtype, seed):
    """A CPU engine over a pool of random values, so that a page position
    the prefill should zero shows if it was not."""
    eng = serving.Engine(*callables, _llama_cfg(
        serving, kv_dtype, prefix_sharing="on", device="cpu"))
    gen = torch.Generator().manual_seed(seed)
    kv = eng.kv
    if kv.scales is None:
        kv.pool.copy_(torch.randn(kv.pool.shape, generator=gen))
    else:
        kv.pool.copy_(torch.randint(-127, 128, kv.pool.shape, generator=gen,
                                    dtype=torch.int8))
        kv.scales.copy_(torch.rand(kv.scales.shape, generator=gen) + 0.5)
    return eng


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("start", [0, 32])
def test_static_buffers_serve_prompts_of_one_key_bit_equal(pair, kv_dtype,
                                                           start):
    _, tm = pair
    callables = tm.serving_callables(MAX_LEN)
    n = 21
    rng = np.random.default_rng(24)
    prefix = rng.integers(0, TINY["vocab"], (start,), dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, TINY["vocab"], (n,), dtype=np.int32)]) for _ in range(2)]
    k = -(-(start + n) // PS)
    shared = list(range(1, 1 + start // PS))
    rows = [np.asarray(shared + list(range(1 + len(shared) + i * k,
                                           1 + len(shared) + i * k + k
                                           - len(shared))), np.int32)
            for i in range(2)]
    eng = _garbage_engine(callables, kv_dtype, seed=5)
    pool0 = eng.kv.pool.clone()
    ids = torch.zeros((1, n), dtype=torch.int64)
    pages = torch.zeros((k,), dtype=torch.int32)
    for prompt, row in zip(prompts, rows):
        ids.copy_(torch.as_tensor(prompt[None, start:]))
        pages.copy_(torch.as_tensor(row))
        tok = int(prefill_body(eng._prefill_fn, eng.kv, ids, pages, start))
        fresh = _garbage_engine(callables, kv_dtype, seed=5)
        want = _port_prefill(fresh, prompt, row, start)
        assert tok == want
        own = torch.as_tensor(row[len(shared):]).long()
        assert torch.equal(eng.kv.pool[own], fresh.kv.pool[own])
        if eng.kv.scales is not None:
            assert torch.equal(eng.kv.scales[own], fresh.kv.scales[own])
        last = eng.kv.pool[int(row[-1])]
        assert not last[:, :, :, (start + n) % PS:].any()
        if shared:
            assert torch.equal(eng.kv.pool[shared], pool0[shared])
    # the first prompt's own pages were not written by the second
    first_own = torch.as_tensor(rows[0][len(shared):]).long()
    fresh = _garbage_engine(callables, kv_dtype, seed=5)
    _port_prefill(fresh, prompts[0], rows[0], start)
    assert torch.equal(eng.kv.pool[first_own], fresh.kv.pool[first_own])


# ---------------------------------------------------------------------------
# the engine's key logic, with eager stand-ins for the graphs
# ---------------------------------------------------------------------------

class _EagerPrefillGraph:
    """Stands in for ``PrefillGraph`` on the CPU: the same static buffers
    and key, :meth:`replay` an eager call of the body. ``captured`` lists
    the keys built, in order."""

    captured: list = []

    def __init__(self, prefill_fn, kv, start, n, mempool, side):
        self.key = (start, n)
        self.captured.append(self.key)
        self.ids = torch.zeros((1, n), dtype=torch.int64)
        self.pages = torch.zeros((kv.pages_for(start + n),),
                                 dtype=torch.int32)
        self._run = lambda: prefill_body(prefill_fn, kv, self.ids,
                                         self.pages, start)
        self.replays = 0
        self.capture_s = 0.0

    def load(self, ids, pages):
        self.ids.copy_(torch.as_tensor(ids))
        self.pages.copy_(torch.as_tensor(pages))

    def replay(self):
        self.replays += 1
        return self._run()


class _NoDecodeGraph:
    """Stands in for ``DecodeGraph`` on the CPU: decode steps stay eager."""

    def __init__(self, step_fn, kv, bucket, mempool, side):
        self.replays = 0


@pytest.fixture
def stand_in_engine(pair, monkeypatch):
    """``make(prefix_sharing)``: a CPU engine that takes the card's
    branches, its prefills through ``prefill_graph`` (eager stand-ins),
    its decode steps eager; and a plain CPU engine beside it."""
    _, tm = pair
    monkeypatch.setattr(teng_mod, "PrefillGraph", _EagerPrefillGraph)
    monkeypatch.setattr(_EagerPrefillGraph, "captured", [])
    monkeypatch.setattr(teng_mod, "DecodeGraph", _NoDecodeGraph)
    real_decode = serving.Engine._decode

    def decode_eager(self, tok, tables, t):
        device, self.device = self.device, torch.device("cpu")
        try:
            return real_decode(self, tok, tables, t)
        finally:
            self.device = device

    monkeypatch.setattr(serving.Engine, "_decode", decode_eager)

    def make(prefix_sharing="on", memory_short=lambda: False):
        engines = [serving.Engine(*tm.serving_callables(MAX_LEN), _llama_cfg(
            serving, "native", prefix_sharing=prefix_sharing, device="cpu"))
            for _ in range(2)]
        eng = engines[0]
        eng._capture_args = lambda: (None, None)
        eng._memory_short = memory_short
        eng.device = torch.device("cuda")       # the card's branches
        return engines

    return make


def _drain(eng, prompts, n_new=4):
    futs = [eng.submit(serving.GenerationRequest(p, max_new_tokens=n_new))
            for p in prompts]
    eng.run()
    return [f.result(timeout=60).tokens for f in futs]


def test_warmup_and_admissions_register_their_keys(stand_in_engine):
    eng, plain = stand_in_engine()
    rng = np.random.default_rng(25)
    eng.warmup([9, 23])
    # the pool's primer first, at max_len, and not kept
    assert _EagerPrefillGraph.captured == [(0, MAX_LEN), (0, 9), (0, 23)]
    stats = eng.decode_stats()
    assert stats["prefill_replays"] == {(0, 9): 0, (0, 23): 0}
    assert stats["prefill_graphs"] == 3
    assert stats["prefill_graphs_live"] == 2
    base = rng.integers(0, TINY["vocab"], (2 * PS,), dtype=np.int32)
    prompts = [rng.integers(0, TINY["vocab"], (9,), dtype=np.int32),
               np.concatenate([base, rng.integers(0, TINY["vocab"], (5,),
                                                  dtype=np.int32)]),
               np.concatenate([base, rng.integers(0, TINY["vocab"], (7,),
                                                  dtype=np.int32)])]
    # one after the other, so that the third finds the second's pages
    got = [_drain(eng, [p])[0] for p in prompts]
    want = [_drain(plain, [p])[0] for p in prompts]
    assert got == want
    stats = eng.decode_stats()
    assert stats["prefills"] == {"full": 2, "tail": 1}
    assert stats["prefill_replays"] == {(0, 9): 1, (0, 23): 0, (0, 37): 1,
                                        (2 * PS, 7): 1}
    assert stats["prefill_graphs"] == 5
    assert stats["prefill_graphs_live"] == 4
    assert stats["prefill_evictions"] == 0
    assert _EagerPrefillGraph.captured.count((0, MAX_LEN)) == 1
    assert sum(stats["prefill_replays"].values()) \
        == sum(stats["prefills"].values())
    assert eng.kv.outstanding_pages == 0


def test_least_recently_used_prefill_graphs_make_room(stand_in_engine):
    """While memory is short, a new key drops the least recently used
    graphs first (one at a time, re-checking); a dropped key is captured
    again at its next admission, its replays still counted."""
    checks = []
    short = {"on": False}

    def memory_short():
        checks.append(len(eng._prefill_graphs))
        # short until one graph is gone
        return short["on"] and len(eng._prefill_graphs) >= 3

    eng, plain = stand_in_engine(memory_short=memory_short)
    rng = np.random.default_rng(26)
    prompts = {n: rng.integers(0, TINY["vocab"], (n,), dtype=np.int32)
               for n in (9, 11, 13, 15)}
    eng.warmup([9, 11, 13])
    assert list(eng._prefill_graphs) == [(0, 9), (0, 11), (0, 13)]
    assert _drain(eng, [prompts[9]]) == _drain(plain, [prompts[9]])
    assert list(eng._prefill_graphs) == [(0, 11), (0, 13), (0, 9)]
    checks.clear()
    short["on"] = True
    assert _drain(eng, [prompts[15]]) == _drain(plain, [prompts[15]])
    # (0, 11), the least recently used, made room; then there was room
    assert checks == [3, 2]
    assert list(eng._prefill_graphs) == [(0, 13), (0, 9), (0, 15)]
    assert _drain(eng, [prompts[11]]) == _drain(plain, [prompts[11]])
    assert list(eng._prefill_graphs) == [(0, 9), (0, 15), (0, 11)]
    stats = eng.decode_stats()
    assert stats["prefill_graphs"] == 6 and stats["prefill_graphs_live"] == 3
    assert stats["prefill_evictions"] == 2
    assert stats["prefill_replays"] == {(0, 9): 1, (0, 11): 1, (0, 13): 0,
                                        (0, 15): 1}
    # a key in the cache is used without a memory check
    checks.clear()
    assert _drain(eng, [prompts[9]]) == _drain(plain, [prompts[9]])
    assert checks == []
    assert eng.decode_stats()["prefill_replays"][(0, 9)] == 2
    assert eng.kv.outstanding_pages == 0


def test_prefill_graph_keys_are_checked(stand_in_engine):
    eng, _ = stand_in_engine()
    assert eng.prefill_graph(PS, 3).key == (PS, 3)
    assert eng.prefill_graph(PS, 3) is eng.prefill_graph(PS, 3)
    assert eng.decode_stats()["prefill_graphs"] == 2      # and the primer
    off, _ = stand_in_engine("off")
    with pytest.raises(ValueError, match="prefix sharing"):
        off.prefill_graph(PS, 3)
    assert off.prefill_graph(0, 3).key == (0, 3)


def test_prefill_graph_needs_a_card(pair):
    _, tm = pair
    eng = serving.Engine(*tm.serving_callables(MAX_LEN), _llama_cfg(
        serving, "native", device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        eng.prefill_graph(0, 9)
    with pytest.raises(ValueError, match="CUDA"):
        PrefillGraph(eng._prefill_fn, eng.kv, 0, 9, None)
    for start, n in ((PS // 2, 9), (0, 0), (PS, MAX_LEN)):
        with pytest.raises(ValueError, match="page-aligned"):
            PrefillGraph(eng._prefill_fn, eng.kv, start, n, None)
    _drain(eng, [np.arange(9, dtype=np.int32)])
    stats = eng.decode_stats()
    assert stats["prefill_replays"] == {} and stats["prefill_graphs"] == 0
    assert stats["prefill_graphs_live"] == stats["prefill_evictions"] == 0
    assert stats["prefill_capture_s"] == 0
    assert stats["prefills"] == {"full": 1}


def test_host_memory_reads_available_and_total():
    available, total = teng_mod._host_memory()
    assert 0 < available <= total
