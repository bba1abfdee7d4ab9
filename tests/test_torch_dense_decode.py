"""The port's dense decode tier (``ServingConfig.paged_attention="off"``:
``serving.engine.dense_decode_body``, ``kv_cache.gather_pages`` /
``scatter_token_page``) against ``paddle_tpu.serving`` on its dense tier, on
the CPU, where the port's engine runs the body eagerly (a card replays
``DenseDecodeGraph``, ``chip_smoke.py``):

* greedy transcripts equal the JAX engine's on a tiny Llama (native and
  int8 pools), on ``tests/test_serving.py``'s toy callables rewritten in
  torch (native, bf16 and int8 pools), and on a 2-layer
  ``FusedMultiTransformer`` stack; every page back after the drain;
* ``gather_pages`` / ``scatter_token_page`` bit for bit against the JAX
  functions on fp32, bf16 and int8 pools;
* the tier's resolution: ``PADDLE_TPU_PAGED_ATTENTION`` and its spellings,
  a typo raising, the config field winning; ``auto`` on the kernel tier on
  every device (the port's divergence: the JAX package takes the dense tier
  on the CPU); the demotion of a kernel-tier engine whose shape the kernel
  cannot serve, with its warning and ``path=dense`` steps;
* seeded faults on the dense tier give the JAX engine's outcomes, trace and
  counters, and each dense bucket files its ``serving.decode`` cost record.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.serving import kv_cache as tkv

import test_serving as jtoy
from test_torch_fused_multi_transformer import (  # noqa: F401  (fixture)
    stacks)
from test_torch_fused_multi_transformer import _cfg as fmt_cfg
from test_torch_fused_multi_transformer import _prompts as fmt_prompts
from test_torch_serving import (  # noqa: F401  (fixtures)
    _retire_jax_engine_beacon, pair)
from test_torch_serving import _cfg as llama_cfg
from test_torch_serving import _prompts as llama_prompts
from test_torch_serving import MAX_LEN

torch.set_num_threads(2)


def _drain(eng, mod, prompts, new):
    futs = [eng.submit(mod.GenerationRequest(p, max_new_tokens=new))
            for p in prompts]
    eng.run()
    return [f.result(timeout=60).tokens for f in futs]


# ---------------------------------------------------------------------------
# the engine on the dense tier against the JAX engine's


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_llama_dense_tier_matches_jax(pair, kv_dtype):
    jm, tm = pair
    prompts = llama_prompts()
    jeng = jserving.Engine(*jm.serving_callables(MAX_LEN),
                           llama_cfg(jserving, kv_dtype,
                                     paged_attention="off"))
    want = _drain(jeng, jserving, prompts, 6)
    teng = serving.Engine(*tm.serving_callables(MAX_LEN),
                          llama_cfg(serving, kv_dtype, device="cpu",
                                    paged_attention="off"))
    assert teng.decode_path == "dense"
    got = _drain(teng, serving, prompts, 6)
    assert got == want
    assert teng.kv.outstanding_pages == 0
    assert teng.kv.free_pages == teng.kv.config.num_pages - 1


def test_llama_dense_tier_equals_the_kernel_tier(pair):
    _, tm = pair
    prompts = llama_prompts()
    out = {}
    for tier in ("off", "on"):
        eng = serving.Engine(*tm.serving_callables(MAX_LEN),
                             llama_cfg(serving, "native", device="cpu",
                                       paged_attention=tier))
        out[tier] = _drain(eng, serving, prompts, 6)
    assert out["off"] == out["on"]


# tests/test_serving.py's toy LM, in torch: a cache-dependent greedy argmax
_W = torch.from_numpy(np.asarray(jtoy._W))
_POSW = torch.from_numpy(np.asarray(jtoy._POSW))


def _kv_of(tok_f):
    ramp_d = (torch.arange(jtoy.D, dtype=torch.float32) + 1.0) / jtoy.D
    ramp_h = (torch.arange(jtoy.H, dtype=torch.float32) + 1.0) / jtoy.H
    base = (tok_f[..., None, None] + 1.0) / jtoy.V
    return base * ramp_h[:, None] * ramp_d[None, :]


def _readout(cache00, valid):
    m = cache00.shape[-2]
    feat = torch.einsum("...hmd,...m,m->...d", cache00.float(),
                        valid.float(), _POSW[:m])
    return feat @ _W


def toy_step(tok, cache, t):
    """(B, 1), (L, 2, B, H, M, D), (B,) -> next token and the cache, with
    position t written in place."""
    b, m = tok.shape[0], cache.shape[4]
    kv = _kv_of(tok[:, 0].float())                         # (B, H, D)
    rows = torch.arange(b)
    for layer in range(jtoy.L):
        for s in range(2):
            cache[layer, s, rows, :, t.long()] = kv.to(cache.dtype)
    valid = torch.arange(m)[None, :] <= t.long()[:, None]
    nxt = _readout(cache[0, 0], valid).argmax(-1).to(torch.int32)[:, None]
    return nxt, cache


def toy_prefill(ids, cache):
    lp, m = ids.shape[1], cache.shape[4]
    kv = _kv_of(ids[0].float()).permute(1, 0, 2)          # (H, lp, D)
    cache[:, :, 0, :, :lp] = kv.to(cache.dtype)
    valid = (torch.arange(m) < lp)[None, :]
    nxt = _readout(cache[0, 0], valid).argmax(-1).to(torch.int32)[:, None]
    return nxt, cache


@pytest.mark.parametrize("kv_dtype", ["native", "bf16", "int8"])
def test_toy_callables_dense_tier_matches_jax(kv_dtype):
    jeng = jtoy.make_engine(kv_dtype=kv_dtype, paged_attention="off")
    want = _drain(jeng, jserving, jtoy.PROMPTS, 9)
    cfg = serving.ServingConfig(
        num_layers=jtoy.L, num_heads=jtoy.H, head_dim=jtoy.D,
        max_len=jtoy.M, max_batch=4, buckets=(1, 4), page_size=16,
        kv_dtype=kv_dtype, device="cpu", paged_attention="off")
    teng = serving.Engine(toy_prefill, toy_step, cfg)
    got = _drain(teng, serving, jtoy.PROMPTS, 9)
    assert got == want
    if kv_dtype == "native":
        assert got == [jtoy.dense_reference(p, 9) for p in jtoy.PROMPTS]
    assert teng.kv.outstanding_pages == 0


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_fmt_stack_dense_tier_matches_jax(stacks, kv_dtype):  # noqa: F811
    (jprefill, _, jstep), stack = stacks
    prompts = fmt_prompts()
    jeng = jserving.Engine(jprefill, jstep,
                           fmt_cfg(jserving, kv_dtype, paged_attention="off"))
    want = _drain(jeng, jserving, prompts, 6)
    teng = serving.Engine(*stack.serving_callables(),
                          fmt_cfg(serving, kv_dtype, device="cpu",
                                  paged_attention="off"))
    got = _drain(teng, serving, prompts, 6)
    assert got == want
    assert teng.kv.outstanding_pages == 0


# ---------------------------------------------------------------------------
# gather_pages / scatter_token_page against the JAX functions

_POOL = (6, 2, 2, 3, 8, 4)          # pages, L, 2, H, ps, D


def _pools(leg, rng):
    x = rng.standard_normal(_POOL).astype(np.float32)
    if leg == "int8":
        q8, sc = jkv.quantize_pages(jnp.asarray(x))
        return (np.asarray(q8), np.asarray(sc)), \
            (torch.from_numpy(np.array(q8)), torch.from_numpy(np.array(sc)))
    if leg == "bf16":
        j = jnp.asarray(x, jnp.bfloat16)
        return (j, None), (torch.from_numpy(x).bfloat16(), None)
    return (x, None), (torch.from_numpy(x), None)


def _t_of(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("leg", ["fp32", "bf16", "int8"])
def test_gather_pages_matches_jax(leg):
    (jp, js), (tp, ts) = _pools(leg, np.random.default_rng(1))
    tables = np.array([[1, 3, 0], [5, 2, 4]], np.int32)
    dt_j = jnp.bfloat16 if leg == "bf16" else jnp.float32
    dt_t = torch.bfloat16 if leg == "bf16" else torch.float32
    want = jkv.gather_pages(jnp.asarray(jp), None if js is None
                            else jnp.asarray(js), jnp.asarray(tables), dt_j)
    got = tkv.gather_pages(tp, ts, torch.from_numpy(tables), dt_t)
    assert got.shape == (2, 2, 2, 3, 24, 4) and got.dtype == dt_t
    assert torch.equal(got, _t_of(want))
    out = torch.full(got.shape, float("nan"), dtype=dt_t)
    assert tkv.gather_pages(tp, ts, torch.from_numpy(tables), dt_t,
                            out=out) is out
    assert torch.equal(out, got)
    one = tkv.gather_pages(tp, ts, torch.tensor([5, 2]), dt_t)
    assert torch.equal(one, got[:, :, 1:2, :, :16])


@pytest.mark.parametrize("leg", ["fp32", "bf16", "int8"])
def test_scatter_token_page_matches_jax(leg):
    rng = np.random.default_rng(2)
    (jp, js), (tp, ts) = _pools(leg, rng)
    tables = np.array([[1, 3, 0], [5, 2, 4], [0, 0, 0]], np.int32)
    t = np.array([10, 3, 0], np.int32)
    dt_j = jnp.bfloat16 if leg == "bf16" else jnp.float32
    dense = rng.standard_normal((2, 2, 3, 3, 24, 4)).astype(np.float32)
    jdense = jnp.asarray(dense, dt_j)
    pool2, sc2 = jkv.scatter_token_page(
        jdense, jnp.asarray(jp), None if js is None else jnp.asarray(js),
        jnp.asarray(tables), jnp.asarray(t), 8)
    tkv.scatter_token_page(_t_of(jdense), tp, ts, torch.from_numpy(tables),
                           torch.from_numpy(t), 8)
    # page 0 is the scratch page the padded row writes
    assert torch.equal(tp[1:], _t_of(pool2)[1:])
    if ts is not None:
        assert torch.equal(ts[1:], _t_of(sc2)[1:])


# ---------------------------------------------------------------------------
# which tier


@pytest.mark.parametrize("raw,want", [
    ("", "auto"), ("auto", "auto"), (" ON ", "on"), ("off", "off"),
    ("0", "off"), ("false", "off"), ("disabled", "off"), ("1", "on"),
    ("kernel", "on"), ("enable", "on")])
def test_mode_spellings_match_jax(monkeypatch, raw, want):
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTENTION", raw)
    assert tpa.mode() == jpa.mode() == want


def test_mode_typo_raises(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTENTION", "dense")
    for mod in (tpa, jpa):
        with pytest.raises(ValueError, match="auto|on|off"):
            mod.mode()
    with pytest.raises(ValueError):
        serving.ServingConfig(num_layers=1, num_heads=1, head_dim=64,
                              max_len=64, max_batch=1, buckets=(1,),
                              page_size=16)
    with pytest.raises(ValueError, match="paged_attention"):
        serving.ServingConfig(num_layers=1, num_heads=1, head_dim=64,
                              max_len=64, max_batch=1, buckets=(1,),
                              page_size=16, paged_attention="dense")


def test_config_field_wins_over_the_knob(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTENTION", "off")
    kw = dict(num_layers=1, num_heads=1, head_dim=64, max_len=64,
              max_batch=1, buckets=(1,), page_size=16)
    assert serving.ServingConfig(**kw).paged_attention == "off"
    assert serving.ServingConfig(paged_attention="On", **kw) \
        .paged_attention == "on"
    assert tpa.decode_path() == "dense"
    assert tpa.decode_path("on") == "kernel"


def test_auto_is_the_kernel_tier_on_every_device(monkeypatch):
    """The divergence by design: the JAX package's ``auto`` takes the dense
    tier on the CPU, the port's the kernel tier (whose CPU path is the
    kernel's plain version, not an interpreter)."""
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTENTION", raising=False)
    assert jpa.decode_path("auto") == "dense"      # the JAX package, CPU
    assert tpa.decode_path("auto") == "kernel"
    assert tpa.decode_path() == "kernel"
    eng = serving.Engine(toy_prefill, toy_step, serving.ServingConfig(
        num_layers=jtoy.L, num_heads=jtoy.H, head_dim=jtoy.D,
        max_len=jtoy.M, max_batch=1, buckets=(1,), page_size=16,
        device="cpu"))
    assert eng.decode_path == "kernel"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int8"])
def test_kernel_eligible_is_the_jax_tiling_rule(dtype):
    for ps in (4, 8, 16, 24, 32, 64, 256, 512):
        for d in (60, 64, 96, 128, 256):
            assert tpa.kernel_eligible(ps, d, getattr(torch, dtype)) == \
                jpa.kernel_eligible(ps, d, getattr(jnp, dtype)), (ps, d)


def test_card_engine_past_the_kernels_limits_raises_at_construction():
    """On a card a shape the JAX rule takes but the kernel cannot serve
    raises (the JAX package's kernel serves it); one the JAX rule refuses
    is demoted; the kernel's own shapes stay. Decided from the
    configuration alone, before anything is allocated."""
    card = torch.device("cuda")

    def kv(ps, d, kv_dtype="native"):
        return serving.ServingConfig(
            num_layers=2, num_heads=4, head_dim=d, max_len=1024,
            max_batch=1, buckets=(1,), page_size=ps,
            compute_dtype="bfloat16", kv_dtype=kv_dtype,
            device="cpu").kv_config()
    assert tengine._kernel_tier_serves(card, kv(64, 128))
    assert tengine._kernel_tier_serves(card, kv(256, 128, "int8"))
    assert not tengine._kernel_tier_serves(card, kv(8, 128))
    assert not tengine._kernel_tier_serves(card, kv(64, 60))
    for ps, d in ((512, 128), (256, 128), (64, 96), (64, 256)):
        with pytest.raises(NotImplementedError, match="paged kernel serves"):
            tengine._kernel_tier_serves(card, kv(ps, d))
    assert tengine._kernel_tier_serves(torch.device("cpu"), kv(512, 96))


def test_ineligible_shape_is_demoted_with_a_warning(monkeypatch, caplog):
    """On a card an engine whose shape the JAX package's tiling rule
    refuses is built on the dense tier; the CPU engine's kernel tier is the
    plain version, which serves any shape (as the JAX package's interpreter
    does), so the card's rule is put in here."""
    monkeypatch.setattr(tengine, "_kernel_tier_serves",
                        lambda device, cfg: tpa.kernel_eligible(
                            cfg.page_size, cfg.head_dim, cfg.storage_dtype))
    cfg = serving.ServingConfig(
        num_layers=jtoy.L, num_heads=jtoy.H, head_dim=jtoy.D,
        max_len=jtoy.M, max_batch=4, buckets=(1, 4), page_size=16,
        device="cpu", paged_attention="on")
    assert not jpa.kernel_eligible(16, jtoy.D, jnp.float32)
    obs.reset()
    obs.enable()
    try:
        with caplog.at_level(logging.WARNING,
                             logger="paddle_tpu_torch.serving.engine"):
            eng = serving.Engine(toy_prefill, toy_step, cfg)
        assert eng.decode_path == "dense"
        assert any("dense decode tier" in r.getMessage()
                   for r in caplog.records)
        got = _drain(eng, serving, jtoy.PROMPTS[:2], 5)
        assert got == [jtoy.dense_reference(p, 5) for p in jtoy.PROMPTS[:2]]
        steps = obs.snapshot()["serving.paged_attention_steps_total"]
        assert set(steps) == {"path=dense"} and steps["path=dense"] > 0
    finally:
        obs.disable()
        obs.reset()


# ---------------------------------------------------------------------------
# faults and the cost registry on the dense tier


@pytest.fixture(scope="module")
def chaos_pair():
    """``test_torch_serving_chaos.py``'s tiny Llama, weights carried."""
    from paddle_tpu.models.llama import LlamaConfig as JConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    import test_torch_serving_chaos as chaos
    paddle.seed(11)
    jm = JLlama(JConfig.tiny(**chaos.TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(**chaos.TINY), device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()}),
        strict=True)
    yield jm, tm
    import gc
    del jm
    gc.collect()


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_on_the_dense_tier_matches_the_jax_engine(chaos_pair,
                                                        monkeypatch,
                                                        kv_dtype, seed):
    """The seeded faults at admission, step, watchdog and drain: the same
    outcomes, fault trace and counters as the JAX engine's dense tier."""
    import test_torch_serving_chaos as chaos
    from paddle_tpu.resilience import faults as jfaults
    from paddle_tpu_torch.resilience import faults
    for mod in (jobs, obs):
        monkeypatch.setattr(mod, "_REGISTRY", mod.Registry())
        monkeypatch.setattr(mod, "_ENABLED", True)
    jm, tm = chaos_pair
    jeng = jserving.Engine(*jm.serving_callables(chaos.MAX_LEN), chaos._cfg(
        jserving, kv_dtype, paged_attention="off", max_replays=1))
    teng = serving.Engine(*tm.serving_callables(chaos.MAX_LEN), chaos._cfg(
        serving, kv_dtype, device="cpu", paged_attention="off",
        max_replays=1))
    assert teng.decode_path == "dense"
    prompts = chaos._prompts()
    js, ts = (chaos._parity_schedule(jfaults, seed),
              chaos._parity_schedule(faults, seed))
    want = chaos._chaos_run(jeng, jserving, jfaults, js, prompts)
    got = chaos._chaos_run(teng, serving, faults, ts, prompts)
    assert got == want
    assert ts.trace == js.trace and len(ts.trace) >= 2
    assert chaos._counters(obs.snapshot()) == chaos._counters(jobs.snapshot())
    assert obs.snapshot()["serving.paged_attention_steps_total"].keys() \
        == {"path=dense"}
    assert teng.kv.outstanding_pages == 0


def test_dense_buckets_file_their_decode_cost_records(monkeypatch):
    from paddle_tpu_torch.observability import cost
    monkeypatch.setenv("PADDLE_TPU_COST", "on")
    obs.enable()
    obs.reset()
    try:
        assert cost.installed()
        eng = serving.Engine(toy_prefill, toy_step, serving.ServingConfig(
            num_layers=jtoy.L, num_heads=jtoy.H, head_dim=jtoy.D,
            max_len=jtoy.M, max_batch=4, buckets=(1, 4), page_size=16,
            device="cpu", paged_attention="off"))
        eng.warmup(prompt_lens=[5])
        buckets = cost.decode_bucket_records()
        assert set(buckets) == {1, 4}
        for b, rec in buckets.items():
            assert rec["site"] == "serving.decode" and f"[b={b}]" in \
                rec["program"]
            # the gather writes the b-row stacked cache once at least
            assert rec["bytes_accessed"] >= jtoy.L * 2 * b * jtoy.H \
                * jtoy.M * jtoy.D * 4
        del eng
    finally:
        obs.disable()
        obs.reset()
