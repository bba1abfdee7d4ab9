"""The port's prefix-cache page sharing against ``paddle_tpu.serving`` on the
same numpy prompts.

* The chain index of ``paddle_tpu_torch.serving.kv_cache.PagedKVCache``:
  chain digests (byte-equal to the JAX package's), the publish / acquire /
  free lifecycle with its idle LRU, the tail that keeps a prompt token,
  ``min_shared_pages``, the double-free guard, reclaim under pressure, the
  stats schema.
* The engine over the toy callables of ``tests/test_prefix_sharing.py``
  (per-token K/V, so a tail prefill over a resident prefix is exact),
  ported to torch with a step that reads the pool through the page tables:
  shared and unshared transcripts equal each other and the JAX engine's on
  the native and int8 legs, shared pages keep their bytes while a sibling
  maps them, a concurrent shared batch, the scheduler charging the tail
  only, a 2-argument prefill keeping sharing off.
* The tiny Llama from a JAX state dict: shared and unshared transcripts
  equal each other and the JAX engine's, native and int8.

Tolerance: tokens equal; pool pages bit-equal where the JAX tests hold them
bit-identical.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu_torch import serving
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.paged_attention import (PagedDecodeCache,
                                                  scatter_token_inplace)
from paddle_tpu_torch.serving import kv_cache as kvc

from test_prefix_sharing import BASE, PS, SHARED_PROMPTS
from test_prefix_sharing import make_engine3 as jax_engine3
from test_serving import D, H, L, M, V

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# the toy LM of tests/test_serving.py in torch: K/V of a token is a ramp of
# its value, the next token the argmax of a position-weighted readout of
# layer 0's K up to the write position
# ---------------------------------------------------------------------------

_W = torch.from_numpy(np.linspace(-1.0, 1.0, D * V).reshape(D, V)
                      .astype(np.float32))
_POSW = (torch.arange(M, dtype=torch.float32) + 1.0) / M


@pytest.fixture(autouse=True)
def _retire_jax_engine_beacon():
    """The JAX reference engines here run to the end of their traffic
    without ``stop()``, which is what retires their ``serving.engine``
    beacon: retire it at teardown, or it goes stale 60 s later and every
    later ``/healthz`` in this process reads unhealthy."""
    yield
    jtrace.heartbeat_clear("serving.engine")


def _kv_of(tok_f):
    ramp_d = (torch.arange(D, dtype=torch.float32) + 1.0) / D
    ramp_h = (torch.arange(H, dtype=torch.float32) + 1.0) / H
    base = (tok_f[..., None, None] + 1.0) / V
    return base * ramp_h[:, None] * ramp_d[None, :]


def _readout(k0, valid):
    """k0 (B, H, m, D), valid (B, m) -> logits (B, V)."""
    m = k0.shape[2]
    feat = torch.einsum("bhmd,bm,m->bd", k0.float(), valid.float(),
                        _POSW[:m])
    return feat @ _W


def toy_prefill3(ids, cache, start=0):
    """(1, n) ids at positions [start, start + n) of (L, 2, 1, H, m, D)."""
    n = ids.shape[1]
    kv = _kv_of(ids[0].float()).transpose(0, 1)          # (H, n, D)
    cache[:, :, 0, :, start:start + n] = kv.to(cache.dtype)
    valid = (torch.arange(cache.shape[4]) < start + n)[None, :]
    nxt = _readout(cache[0, 0], valid).argmax(dim=-1)
    return nxt.to(torch.int32)[:, None], cache


def toy_prefill2(ids, cache):
    return toy_prefill3(ids, cache)


def toy_step(tok, cache: PagedDecodeCache, t):
    """The JAX toy's dense tier over the pool: gather layer 0's K pages
    (dequantized), put the token in at ``t``, read out; then write the
    token's K/V into every layer's page."""
    kv = _kv_of(tok[:, 0].float())                       # (B, H, D)
    pool, sc, tables = cache.pool, cache.scales, cache.tables.long()
    b, s = tables.shape
    k0 = pool[tables][:, :, 0, 0].float()                 # (B, S, H, ps, D)
    if sc is not None:
        k0 = k0 * sc[tables][:, :, 0, 0][..., None, None]
    ps = k0.shape[3]
    k0 = k0.permute(0, 2, 1, 3, 4).reshape(b, H, s * ps, D)
    pos = torch.arange(s * ps)
    t64 = t.long()
    at_t = (pos[None, :] == t64[:, None])[:, None, :, None]
    k0 = torch.where(at_t, kv[:, :, None, :], k0)
    nxt = _readout(k0, pos[None, :] <= t64[:, None]).argmax(dim=-1)
    for layer in range(pool.shape[1]):
        scatter_token_inplace(pool, sc, cache.tables, t, layer, kv, kv,
                              cache.page_size)
    return nxt.to(torch.int32)[:, None], cache


def port_engine3(prefix_sharing="auto", max_batch=2, prefill=toy_prefill3,
                 **kw):
    return serving.Engine(prefill, toy_step, serving.ServingConfig(
        num_layers=L, num_heads=H, head_dim=D, max_len=M,
        max_batch=max_batch, buckets=(1, max_batch), page_size=PS,
        prefix_sharing=prefix_sharing, device="cpu", **kw))


def _drain(eng, mod, prompts, n_new=4):
    futs = [eng.submit(mod.GenerationRequest(p, max_new_tokens=n_new))
            for p in prompts]
    eng.run()
    return [f.result(timeout=30).tokens for f in futs]


def _pool(num_pages=12, **kw):
    return kvc.PagedKVCache(kvc.KVCacheConfig(
        num_layers=L, num_heads=H, head_dim=D, max_len=M, page_size=PS,
        num_pages=num_pages, **kw), torch.device("cpu"))


# ---------------------------------------------------------------------------
# chain hashing and the index lifecycle
# ---------------------------------------------------------------------------

class TestChainIndex:
    def test_chain_digests_prefix_property(self):
        a = np.arange(10, dtype=np.int32)
        b = np.concatenate([a[:4], np.asarray([99, 98], np.int32), a[6:]])
        da, db = (kvc.prefix_chain_digests(x, 4) for x in (a, b))
        assert len(da) == 2                    # the partial page is left out
        assert da[0] == db[0] and da[1] != db[1]
        c = np.concatenate([a[4:8], a[4:8]]).astype(np.int32)
        dc = kvc.prefix_chain_digests(c, 4)
        assert dc[0] != dc[1]                  # chained, not per page
        assert kvc.prefix_chain_digests(a, 4, limit=1) == da[:1]
        for x in (a, b, c, SHARED_PROMPTS[0]):
            assert kvc.prefix_chain_digests(x, 4) == \
                jkvc.prefix_chain_digests(x, 4)

    def test_publish_acquire_free_lifecycle(self):
        pool = _pool()
        owner = pool.alloc(4)
        assert pool.publish(SHARED_PROMPTS[0], owner) == 3
        assert len(pool.prefix_summary()) == 3
        assert pool.peek_prefix_pages(SHARED_PROMPTS[1]) == 3
        shared = pool.acquire_prefix(SHARED_PROMPTS[1])
        assert shared == owner[:3]
        assert pool.refcounts()[owner[0]] == 2
        pool.free(shared)
        assert pool.refcounts()[owner[0]] == 1
        pool.free(owner)
        assert pool.outstanding_pages == 0
        assert pool.idle_pages == 3
        assert pool.free_pages == pool.config.num_pages - 1
        again = pool.acquire_prefix(SHARED_PROMPTS[2])
        assert again == owner[:3]
        assert pool.refcounts()[owner[0]] == 1
        pool.free(again)

    def test_tail_page_keeps_at_least_one_prompt_token(self):
        pool = _pool()
        owner = pool.alloc(4)
        pool.publish(BASE, owner)              # exactly 3 full pages
        assert pool.peek_prefix_pages(BASE) == 2
        got = pool.acquire_prefix(BASE)
        assert got == owner[:2]
        pool.free(got)
        pool.free(owner)

    def test_min_shared_pages_threshold(self):
        pool = _pool(min_shared_pages=2)
        owner = pool.alloc(4)
        pool.publish(SHARED_PROMPTS[0], owner)
        assert pool.acquire_prefix(SHARED_PROMPTS[0][:PS + 2]) == []
        assert pool.refcounts()[owner[0]] == 1
        assert len(pool.acquire_prefix(SHARED_PROMPTS[1])) == 3
        pool.free(owner)
        with pytest.raises(ValueError, match="min_shared_pages"):
            _pool(min_shared_pages=0)

    def test_double_free_guard_raises_and_counts(self):
        pool = _pool()
        ids = pool.alloc(2)
        pool.free(ids)
        with pytest.raises(ValueError, match="free"):
            pool.free(ids[:1])
        assert pool.double_free_total == 1
        owner = pool.alloc(3)
        pool.publish(SHARED_PROMPTS[0][:2 * PS], owner[:2])
        pool.free(owner)
        with pytest.raises(ValueError, match="free"):
            pool.free([owner[0]])              # idle: its rc is already 0
        with pytest.raises(ValueError, match="scratch"):
            pool.free([0])
        assert pool.prefix_stats()["double_free_total"] == 3.0

    def test_pressure_reclaims_idle_lru_first(self):
        pool = _pool(num_pages=8)              # 7 usable
        a = pool.alloc(3)
        pool.publish(SHARED_PROMPTS[0][:3 * PS], a)
        pool.free(a)                           # 3 idle and indexed, 4 free
        grab = pool.alloc(6)                   # 2 of them reclaimed
        assert grab is not None and len(grab) == 6
        assert a[0] in grab and a[1] in grab and a[2] not in grab
        assert pool.idle_pages == 1
        assert len(pool.prefix_summary()) == 1
        assert pool.alloc(2) is None
        pool.free(grab)

    def test_high_water_and_stats_schema(self):
        pool = _pool()
        a = pool.alloc(5)
        pool.free(a[:2])
        stats = pool.prefix_stats()
        assert stats["pages_high_water"] == 5.0
        assert stats["pages_in_use"] == 3.0
        jpool = jkvc.PagedKVCache(jkvc.KVCacheConfig(
            num_layers=L, num_heads=H, head_dim=D, max_len=M, page_size=PS,
            num_pages=12))
        assert set(stats) == set(jpool.prefix_stats())
        pool.free(a[2:])


# ---------------------------------------------------------------------------
# the engine over the toy: parity with the JAX engine, copy-on-write, cost
# ---------------------------------------------------------------------------

class TestEngineSharing:
    @pytest.mark.parametrize("kv_dtype", ["native", "int8"])
    def test_shared_transcripts_match_unshared_and_jax(self, kv_dtype):
        want = _drain(jax_engine3("on", kv_dtype=kv_dtype), jserving,
                      SHARED_PROMPTS)
        ref = _drain(port_engine3("off", kv_dtype=kv_dtype), serving,
                     SHARED_PROMPTS)
        eng = port_engine3("on", kv_dtype=kv_dtype)
        got = _drain(eng, serving, SHARED_PROMPTS)
        assert got == ref == want
        assert eng.kv.prefix_stats()["prefix_pages_shared_total"] >= 3.0
        req, comp = eng.prefill_token_stats()
        assert comp < req == sum(p.size for p in SHARED_PROMPTS)
        assert eng.decode_stats()["prefills"]["tail"] >= 1
        assert eng.kv.outstanding_pages == 0
        assert eng.kv.refcounts() == {}

    @pytest.mark.parametrize("kv_dtype", ["native", "int8"])
    def test_cow_shared_page_bytes_never_rewritten(self, kv_dtype):
        eng = port_engine3("on", kv_dtype=kv_dtype)
        _drain(eng, serving, SHARED_PROMPTS[:1])    # publish the base chain
        page_ids = [eng.kv._index[h]
                    for h in kvc.prefix_chain_digests(BASE, PS)]
        before = eng.kv.pool[page_ids].clone()
        scales0 = (eng.kv.scales[page_ids].clone()
                   if eng.kv.scales is not None else None)
        _drain(eng, serving, SHARED_PROMPTS[1:2])   # maps, tail, decodes
        assert eng.decode_stats()["prefills"] == {"full": 1, "tail": 1}
        assert torch.equal(before, eng.kv.pool[page_ids])
        if scales0 is not None:
            assert torch.equal(scales0, eng.kv.scales[page_ids])

    def test_concurrent_shared_batch_matches_reference(self):
        ref = _drain(port_engine3("off"), serving, SHARED_PROMPTS[:2])
        eng = port_engine3("on")
        futs = [eng.submit(serving.GenerationRequest(p, max_new_tokens=4))
                for p in SHARED_PROMPTS[:2]]
        eng.run()
        assert [f.result(timeout=30).tokens for f in futs] == ref
        assert eng.kv.prefix_stats()["prefix_pages_shared_total"] >= 3.0
        # both were in flight together: the second mapped the first's pages
        assert eng.decode_stats()["steps"] == {2: 3}

    def test_scheduler_charges_unshared_tail_only(self):
        eng = port_engine3("on")
        _drain(eng, serving, SHARED_PROMPTS[:1])
        req = serving.GenerationRequest(SHARED_PROMPTS[1], max_new_tokens=2)
        full = int(SHARED_PROMPTS[1].size)
        assert eng._prefill_cost(req) == full - 3 * PS
        assert eng.scheduler.prefill_cost is not None
        assert port_engine3("off").scheduler.prefill_cost is None

    def test_budget_admits_by_tail_cost(self):
        # a budget below two full prompts admits both at one boundary once
        # the chain is resident, since each is charged its tail only
        budget = int(SHARED_PROMPTS[1].size) + 2
        eng = port_engine3("on", policy="budget",
                           prefill_token_budget=budget)
        _drain(eng, serving, SHARED_PROMPTS[:1])
        for p in SHARED_PROMPTS[1:]:
            eng.submit(serving.GenerationRequest(p, max_new_tokens=4))
        eng.step()
        assert eng.active_requests == 2
        assert eng.decode_stats()["prefills"] == {"full": 1, "tail": 2}
        eng.run()
        assert eng.kv.outstanding_pages == 0

    def test_two_arg_prefill_keeps_sharing_off(self):
        eng = port_engine3("auto", prefill=toy_prefill2)
        assert not eng.prefix_sharing_enabled
        assert eng.scheduler.prefill_cost is None
        with pytest.raises(ValueError, match="prefix"):
            port_engine3("on", prefill=toy_prefill2)
        with pytest.raises(ValueError, match="prefix_sharing"):
            serving.ServingConfig(num_layers=L, num_heads=H, head_dim=D,
                                  max_len=M, prefix_sharing="yes")

    def test_alloc_raise_does_not_strand_prefix_refs(self, monkeypatch):
        eng = port_engine3("on")
        _drain(eng, serving, [SHARED_PROMPTS[0]])

        def pool_fault(n):
            raise RuntimeError("pool fault")

        monkeypatch.setattr(eng.kv, "alloc", pool_fault)
        fut = eng.submit(serving.GenerationRequest(SHARED_PROMPTS[1],
                                                   max_new_tokens=3))
        with pytest.raises(RuntimeError, match="pool fault"):
            eng._admit()
        with pytest.raises(RuntimeError, match="pool fault"):
            fut.result(timeout=1)
        assert eng.kv.refcounts() == {}


# ---------------------------------------------------------------------------
# the tiny Llama through both engines, native and int8
# ---------------------------------------------------------------------------

LLAMA = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=48,
             max_pos=64)


@pytest.fixture(scope="module")
def llama_pair():
    paddle.seed(11)
    jm = JLlama(JConfig.tiny(**LLAMA))
    jm.eval()
    np_state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**LLAMA), device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(np_state), strict=True)
    yield jm, tm
    import gc
    del jm
    gc.collect()


class TestLlamaSharing:
    @pytest.mark.parametrize("paged,kv_dtype", [("off", "native"),
                                                ("on", "int8")])
    def test_shared_vs_unshared_match_jax(self, llama_pair, paged,
                                          kv_dtype):
        jm, tm = llama_pair
        rng = np.random.default_rng(23)
        base = rng.integers(0, 64, (2 * PS + 1,), dtype=np.int32)
        prompts = [np.concatenate([base, rng.integers(0, 64, (k,),
                                                      dtype=np.int32)])
                   for k in (2, 4)]
        shape = dict(num_layers=2, num_heads=2, head_dim=8, max_len=64,
                     max_batch=2, buckets=(1, 2), page_size=PS,
                     kv_dtype=kv_dtype)
        want = _drain(jserving.Engine(
            *jm.serving_callables(64), jserving.ServingConfig(
                paged_attention=paged, prefix_sharing="on", **shape)),
            jserving, prompts)
        got = {}
        for mode in ("off", "on"):
            eng = serving.Engine(*tm.serving_callables(64),
                                 serving.ServingConfig(
                                     prefix_sharing=mode, device="cpu",
                                     **shape))
            got[mode] = _drain(eng, serving, prompts)
            assert eng.kv.outstanding_pages == 0
        assert got["on"] == got["off"] == want
        assert eng.kv.prefix_stats()["prefix_pages_shared_total"] >= 2.0
        assert eng.decode_stats()["prefills"] == {"full": 1, "tail": 1}

    def test_tail_prefill_writes_only_its_positions(self, llama_pair):
        # prefill_fn(ids, cache, start) over a cache holding the prefix:
        # the prefix positions are left as they were, the tail's K/V and
        # token equal a full prefill's
        _, tm = llama_pair
        prefill_fn, _ = tm.serving_callables(64)
        ids = torch.as_tensor(np.random.default_rng(3).integers(
            0, 64, (1, 13)), dtype=torch.int64)
        full = torch.zeros(2, 2, 1, 2, 16, 8)
        with torch.no_grad():
            tok_full, _ = prefill_fn(ids, full)
            tail = torch.zeros_like(full)
            tail[..., :8, :] = full[..., :8, :]
            prefix = tail[..., :8, :].clone()
            tok_tail, _ = prefill_fn(ids[:, 8:], tail, 8)
        assert torch.equal(tail[..., :8, :], prefix)
        assert torch.equal(tok_tail, tok_full)
        torch.testing.assert_close(tail, full, rtol=1e-5, atol=1e-6)
