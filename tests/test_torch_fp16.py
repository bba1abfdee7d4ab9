"""fp16 end to end: the port against the JAX package at small sizes on the
CPU (the kernels' plain versions), from the same numpy inputs and weights.

One fp16 ulp is 2^-10 of a value (bf16's is 2^-7). The bounds:

* (a) tiny ERNIE under AMP O2 fp16 (fp32 masters) with
  ``GradScaler(init_loss_scaling=2**15)`` and AdamW, per-parameter and
  multi-tensor: one step, and three steps whose second batch carries a
  planted ``inf`` (its scaled loss times inf). The bounds of
  ``test_torch_ernie.py::test_amp_o2_bf16_step_tracks_jax`` with fp16's ulp
  in bf16's place: each loss rtol 1.5e-2; each unscaled gradient of the
  first step within 15% of its largest element (the k biases, whose exact
  gradient is 0, below 1e-3); each parameter within 2 lr a step applied
  plus one fp16 ulp of the JAX one. The loss-scale history (2^15, then
  2^14 after the planted step) and the steps applied (the planted one
  skipped) equal JAX's.
* (b) flash forward with lse and backward (D 64 and 128, causal and not,
  segment ids, segment ids with dropout at a fixed seed, dO at unit size
  and at a loss-scaled 8x): the plain versions against the Pallas kernels
  under the interpreter, both fp16. out, dq, dk, dv within two fp16 ulps
  (2^-9) of the larger of |want| and an eighth of the tensor's largest
  element: one rounding on each side, plus the Pallas kernels' fp32 sums
  where they cancel (0.999 ulp seen); lse (fp32) atol 1e-5.
* (c) paged decode, fp16 q on fp16, bf16 and int8 pools, against
  ``_decode_kernel`` interpreted: one fp16 ulp of the larger of |want| and
  an eighth of the largest (two results of one rounding each).
* (d) the tiny Llama engine at ``compute_dtype="float16"`` on the native
  and int8 pools: transcripts equal to the JAX engine's (its paged kernel
  interpreted) and every page back after the drain.
* (e) multi-tensor AdamW with fp16 parameters and gradients against the
  JAX package's ``Adam._fused_step`` (three steps, the fine-tune recipe's
  schedule and clip): masters, m and v rtol 1e-5, atol 1e-6 (the fp32
  formulas of ``test_torch_multi_tensor_adam.py``), the fp16 parameters one
  rounding of the masters (rtol 2^-10).
* (f) the wrappers' checks: fp16 takes a dtype code, float64 and mixed
  dtypes raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu import serving as jserving
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops import nn_ops as jnn_ops
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch import amp, serving
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import multi_tensor_adam as mta
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

import test_torch_ernie as te

torch.set_num_threads(2)

H16 = torch.float16
ULP = 2.0 ** -10


@pytest.fixture(autouse=True)
def _retire_jax_engine_beacon():
    """The JAX reference engines here run to the end of their traffic
    without ``stop()``, which is what retires their ``serving.engine``
    beacon: retire it at teardown, or it goes stale 60 s later and every
    later ``/healthz`` in this process reads unhealthy."""
    yield
    jtrace.heartbeat_clear("serving.engine")


@pytest.fixture(autouse=True)
def _jax_flash_path(monkeypatch):
    monkeypatch.setattr(jnn_ops, "_sdpa_flash_backend_ok", lambda: True)


def _within_ulps(got, want, ulps):
    """|got - want| <= ulps fp16 ulps of max(|want|, max|want| / 8)."""
    g, w = (np.asarray(x, np.float64) for x in (got, want))
    floor = np.abs(w).max() / 8
    lim = ulps * ULP * np.maximum(np.abs(w), floor)
    assert np.all(np.abs(g - w) <= lim), float(
        (np.abs(g - w) / np.maximum(np.abs(w), floor)).max() / ULP)


# ---------------------------------------------------------------------------
# (a) tiny ERNIE, O2 fp16, GradScaler
# ---------------------------------------------------------------------------

def _ernie_fp16_steps(multi_tensor: bool, steps: int):
    """Both packages' steps from one state dict; the second of three
    batches carries an inf. Returns losses, scale histories, the first
    step's unscaled gradients, the steps applied and both models."""
    jm, tm = te._pair(seed=4)
    lr = 1e-3
    jo = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                parameters=jm.parameters(),
                                use_multi_tensor=multi_tensor)
    jm, jo = paddle.amp.decorate(jm, jo, level="O2", dtype="float16")
    to = AdamW(learning_rate=lr, weight_decay=0.01,
               parameters=tm.parameters(), use_multi_tensor=multi_tensor)
    tm, to = amp.decorate(tm, to, level="O2", dtype="float16")
    js = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 15)
    ts = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    out = {"jl": [], "tl": [], "js": [], "ts": []}
    for i in range(steps):
        ids, labels, _ = te._batch(seed=1 + i)
        w = float("inf") if i == 1 else 1.0
        scale = js.get_loss_scaling()
        with paddle.amp.auto_cast(level="O2", dtype="float16"):
            jl, _ = jm(paddle.to_tensor(ids.astype(np.int32)),
                       labels=paddle.to_tensor(labels))
        (js.scale(jl) * w).backward()
        with amp.auto_cast(level="O2", dtype="float16"):
            tl, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        assert tl.dtype == torch.float32
        (ts.scale(tl) * w).backward()
        if i == 0:
            out["jg"] = {n: np.asarray(p.grad._data, np.float32) / scale
                         for n, p in jm.named_parameters()}
            out["tg"] = {n: p.grad.float().numpy() / scale
                         for n, p in tm.named_parameters()}
        js.step(jo)
        js.update()
        jo.clear_grad()
        ts.step(to)
        ts.update()
        to.clear_grad()
        out["jl"].append(float(jl.numpy()))
        out["tl"].append(float(tl.detach()))
        out["js"].append(js.get_loss_scaling())
        out["ts"].append(ts.get_loss_scaling())
    out.update(jm=jm, tm=tm, lr=lr, japplied=jo._step_count, tapplied=to.t)
    return out


@pytest.mark.parametrize("steps", [1, 3], ids=["one_step", "three_steps_inf"])
@pytest.mark.parametrize("multi_tensor", [False, True],
                         ids=["per_param", "multi_tensor"])
def test_amp_o2_fp16_grad_scaler_tracks_jax(multi_tensor, steps):
    r = _ernie_fp16_steps(multi_tensor, steps)
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1.5e-2)
    assert r["ts"] == r["js"] == [2.0 ** 15, 2.0 ** 14, 2.0 ** 14][:steps]
    assert r["tapplied"] == r["japplied"] == min(steps, 2)
    for name, g in r["jg"].items():
        if name.endswith("k_proj.bias"):
            # exactly 0 (softmax ignores a shift common to every key)
            assert np.abs(r["tg"][name]).max() < 1e-3, name
            continue
        scale = max(float(np.abs(g).max()), 1e-12)
        assert np.abs(r["tg"][name] - g).max() <= 0.15 * scale, name
    jp = {n: np.asarray(p._data, np.float32)
          for n, p in r["jm"].named_parameters()}
    for n, p in r["tm"].named_parameters():
        assert p.dtype == H16
        got = p.float().detach().numpy()
        tol = 2 * r["lr"] * r["tapplied"] \
            + np.maximum(np.abs(got), np.abs(jp[n])) * ULP
        assert (np.abs(got - jp[n]) <= tol).all(), n


def test_fp16_step_through_capture_step_matches_eager():
    # the chip leg's form: jit.capture_step with the NaN gate over the
    # scaler's gated step (a CPU call bypasses the graph) gives the eager
    # loop's losses, scales and parameters bit for bit
    from paddle_tpu_torch import jit
    runs = []
    for captured in (False, True):
        _, tm = te._pair(seed=4)
        to = AdamW(learning_rate=1e-3, weight_decay=0.01,
                   parameters=tm.parameters(), use_multi_tensor=True)
        tm, to = amp.decorate(tm, to, level="O2", dtype="float16")
        sc = amp.GradScaler(init_loss_scaling=2.0 ** 15)

        def step(ids, labels, w, tm=tm, sc=sc):
            with amp.auto_cast(level="O2", dtype="float16"):
                loss, _ = tm(ids, labels=labels)
            (sc.scale(loss) * w).backward()
            return loss

        def update(to=to, sc=sc):
            sc.step(to)
            sc.update()
            to.clear_grad()
        call = jit.capture_step(step, update_fn=update, clear_fn=to.clear_grad,
                                nan_gate=True) if captured else None
        losses, scales = [], []
        for i in range(3):
            ids, labels, _ = te._batch(seed=1 + i)
            args = (torch.from_numpy(ids), torch.from_numpy(labels),
                    torch.tensor(float("inf") if i == 1 else 1.0))
            if captured:
                loss = call(*args)
            else:
                loss = step(*args)
                update()
            losses.append(float(loss.detach()))
            scales.append(sc.get_loss_scaling())
        runs.append((losses, scales, to.t,
                     [p.detach().clone() for p in tm.parameters()]))
    (l0, s0, t0, p0), (l1, s1, t1, p1) = runs
    assert l0 == l1 and s0 == s1 == [2.0 ** 15, 2.0 ** 14, 2.0 ** 14]
    assert t0 == t1 == 2
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


# ---------------------------------------------------------------------------
# (b) flash attention, fp16, against the Pallas kernels interpreted
# ---------------------------------------------------------------------------

FLASH_CASES = [  # D, causal, segment ids, dropout, dO scale
    (64, True, None, 0.0, 1.0),
    (128, True, None, 0.0, 8.0),
    (64, False, "packed", 0.0, 1.0),
    (128, True, "packed", 0.0, 8.0),
    (64, True, "packed", 0.1, 8.0),
    (128, False, "packed", 0.1, 1.0),
    (64, False, None, 0.1, 8.0),
]


def _flash_inputs(b, lq, lk, h, d, seed, dscale):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float16)
    k = rng.standard_normal((b, lk, h, d)).astype(np.float16)
    v = rng.standard_normal((b, lk, h, d)).astype(np.float16)
    do = (rng.standard_normal((b, lq, h, d)) * dscale).astype(np.float16)
    return q, k, v, do


def _segs(kind, b, lq, lk):
    qs, ks = np.zeros((b, lq), np.int32), np.zeros((b, lk), np.int32)
    if kind == "packed":
        qs[:, lq // 3:] = 1
        ks[:, lk // 3:] = 1
    return qs, ks


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_fp16_matches_pallas_interpret(case):
    d, causal, kind, p, dscale = case
    b, L, h, seed = 1, 128, 2, 1234
    q, k, v, do = _flash_inputs(b, L, L, h, d, d + L, dscale)
    qs, ks = _segs(kind, b, L, L)
    scale = 1.0 / np.sqrt(d)
    qh, kh, vh = (jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    if p > 0:
        def core(a, b_, c):
            return jfa._flash_core_drop(a, b_, c, jnp.asarray(qs),
                                        jnp.asarray(ks),
                                        jnp.asarray([seed], jnp.int32),
                                        causal, scale, p)
    elif kind:
        def core(a, b_, c):
            return jfa._flash_core_seg(a, b_, c, jnp.asarray(qs),
                                       jnp.asarray(ks), causal, scale)
    else:
        def core(a, b_, c):
            return jfa._flash_core(a, b_, c, causal, scale)
    out_j, vjp = jax.vjp(core, qh, kh, vh)
    want = [np.asarray(x).transpose(0, 2, 1, 3)
            for x in (out_j, *vjp(jnp.asarray(do.transpose(0, 2, 1, 3))))]
    assert want[0].dtype == np.float16
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    segs = (torch.from_numpy(qs), torch.from_numpy(ks)) if kind or p \
        else (None, None)
    out = fa.FlashAttention.apply(qt, kt, vt, causal, None, *segs, p, seed)
    got = (out,) + torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    assert all(g.dtype == H16 for g in got)
    for g, w in zip(got, want):
        _within_ulps(g.detach().numpy(), w, 2)


@pytest.mark.parametrize("d,causal", [(64, False), (128, True)])
def test_flash_fp16_forward_lse_matches_pallas_interpret(d, causal):
    q, k, v, _ = _flash_inputs(1, 128, 128, 2, d, 7, 1.0)
    qh, kh, vh = (jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    want_out, want_lse = jfa._pallas_flash(qh, kh, vh, causal,
                                           1.0 / np.sqrt(d), 128, 128, True,
                                           with_lse=True)
    out, lse = fa.flash_attention_lse(*(torch.from_numpy(x)
                                        for x in (q, k, v)), causal=causal)
    assert out.dtype == H16 and lse.dtype == torch.float32
    _within_ulps(out.numpy(), np.asarray(want_out).transpose(0, 2, 1, 3), 2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=1e-5)


def test_flash_fp16_plain_versions_return_fp16():
    q, k, v, do = (torch.from_numpy(x) for x in
                   _flash_inputs(1, 40, 40, 2, 64, 3, 1.0))
    out = fa.flash_attention_reference(q, k, v, causal=True)
    o2, lse = fa.flash_attention_lse_reference(q, k, v, causal=True)
    grads = fa.flash_attention_bwd_reference(q, k, v, o2, lse, do,
                                             causal=True)
    assert {x.dtype for x in (out, o2, *grads)} == {H16}
    assert lse.dtype == torch.float32


# ---------------------------------------------------------------------------
# (c) paged decode, fp16 q, against _decode_kernel interpreted
# ---------------------------------------------------------------------------

PB, PD, PPS, PS_, PL = 3, 64, 16, 4, 2
PP = 12
TABLES = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)


@pytest.mark.parametrize("pool_kind", ["fp16", "bf16", "int8"])
@pytest.mark.parametrize("h,hkv,t", [(2, 2, [PPS - 1, PPS, PPS + 1]),
                                     (4, 2, [5, PPS + 3, 2 * PPS]),
                                     (2, 2, [0, 1, 3 * PPS])],
                         ids=["page_edges", "gqa", "t0_full"])
def test_paged_decode_fp16_q_matches_paddle_tpu_kernel(pool_kind, h, hkv, t):
    rng = np.random.default_rng(len(pool_kind) + h)
    poolf = rng.standard_normal((PP, PL, 2, hkv, PPS, PD)).astype(np.float32)
    if pool_kind == "int8":
        q8, sc = jkv.quantize_pages(jnp.asarray(poolf))
        jpool, jsc = q8, sc
    else:
        jpool = jnp.asarray(poolf).astype(
            jnp.float16 if pool_kind == "fp16" else jnp.bfloat16)
        jsc = None
    q, kn, vn = (rng.standard_normal(s).astype(np.float16) for s in
                 ((PB, h, PD), (PB, hkv, PD), (PB, hkv, PD)))
    tt = np.asarray(t, np.int32)
    want = np.asarray(jpa._kernel_call(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jpool, jsc,
        jnp.asarray(TABLES), jnp.asarray(tt), 1, page_size=PPS,
        interpret=True))
    assert want.dtype == np.float16
    tpool = state_dict_from_paddle_tpu({"p": np.asarray(jpool)})["p"]
    tsc = None if jsc is None else torch.from_numpy(np.array(jsc))
    got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(kn),
                              torch.from_numpy(vn), tpool, tsc,
                              torch.from_numpy(TABLES), torch.from_numpy(tt),
                              1, page_size=PPS)
    assert got.dtype == H16 and tpool.dtype == {
        "fp16": H16, "bf16": torch.bfloat16, "int8": torch.int8}[pool_kind]
    _within_ulps(got.numpy(), want, 1)


# ---------------------------------------------------------------------------
# (d) the tiny Llama engine at compute_dtype="float16"
# ---------------------------------------------------------------------------

LLAMA = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=48,
             max_pos=256)
MAX_LEN, PAGE, NEW = 160, 16, 6
# what the JAX engine serves from these weights and prompts (held live
# below too): the int8 pool's third request leaves the native one's at its
# fifth token
WANT = {"native": [[6, 40, 10, 10, 0, 59], [15, 13, 45, 31, 2, 45],
                   [24, 14, 11, 45, 17, 22]],
        "int8": [[6, 40, 10, 10, 0, 59], [15, 13, 45, 31, 2, 45],
                 [24, 14, 11, 45, 14, 14]]}


@pytest.fixture(scope="module")
def llama_fp16_pair():
    paddle.seed(11)
    jm = JLlama(JLlamaConfig.tiny(**LLAMA))
    jm.eval()
    jm = paddle.amp.decorate(jm, level="O2", dtype="float16")
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig.tiny(**LLAMA)
    cfg.dtype = "float16"
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(state), strict=True)
    yield jm, tm
    del jm


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 64, (n,), dtype=np.int32) for n in (128, 9, 23)]


def _drain(eng, mod):
    futs = [eng.submit(mod.GenerationRequest(p, max_new_tokens=NEW))
            for p in _prompts()]
    eng.run()
    return [f.result(timeout=60).tokens for f in futs]


def _serving_cfg(mod, kv_dtype, **kw):
    return mod.ServingConfig(num_layers=2, num_heads=2, head_dim=8,
                             max_len=MAX_LEN, max_batch=2, buckets=(1, 2),
                             page_size=PAGE, kv_dtype=kv_dtype,
                             compute_dtype="float16", **kw)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_engine_fp16_transcripts_match_paddle_tpu(llama_fp16_pair, kv_dtype):
    jm, tm = llama_fp16_pair
    assert all(p.dtype == H16 for p in tm.parameters())
    jeng = jserving.Engine(*jm.serving_callables(MAX_LEN),
                           _serving_cfg(jserving, kv_dtype,
                                        paged_attention="on"))
    want = _drain(jeng, jserving)
    assert want == WANT[kv_dtype]
    teng = serving.Engine(*tm.serving_callables(MAX_LEN),
                          _serving_cfg(serving, kv_dtype, device="cpu"))
    assert teng.kv.pool.dtype == (H16 if kv_dtype == "native"
                                  else torch.int8)
    assert _drain(teng, serving) == want
    for eng in (jeng, teng):
        assert eng.kv.outstanding_pages == 0
        assert eng.kv.free_pages == eng.kv.config.num_pages - 1


def test_fp16_configs_accept_what_the_jax_package_accepts():
    assert LlamaConfig(dtype="float16").torch_dtype == H16
    kv = serving.ServingConfig(num_layers=1, num_heads=1, head_dim=8,
                               max_len=32, page_size=16,
                               compute_dtype="float16").kv_config()
    assert kv.torch_compute_dtype == H16 and kv.storage_dtype == H16
    kv.kv_dtype = "bf16"
    assert kv.storage_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        serving.ServingConfig(num_layers=1, num_heads=1, head_dim=8,
                              max_len=32, page_size=16,
                              compute_dtype="float64").kv_config()
    # numpy fp16 arrives as torch.float16, bits unchanged
    a = np.asarray([1.0, -2.5, 65504.0, 6e-8], np.float16)
    t = state_dict_from_paddle_tpu({"w": a})["w"]
    assert t.dtype == H16
    np.testing.assert_array_equal(t.numpy().view(np.uint16),
                                  a.view(np.uint16))


def test_int8_pool_gather_dequantizes_in_fp16():
    # the shared-prefix gather dequantizes int8 pages by a multiply in the
    # compute dtype, as the JAX package's gather_pages does
    from paddle_tpu_torch.serving import kv_cache as tkv
    rng = np.random.default_rng(9)
    pages = rng.standard_normal((3, 2, 2, 2, 16, 8)).astype(np.float32)
    q8, sc = jkv.quantize_pages(jnp.asarray(pages))
    tables = jnp.asarray([[1, 2]], jnp.int32)
    want = np.asarray(jkv.gather_pages(q8, sc, tables, jnp.float16))
    got = tkv.gather_pages(torch.from_numpy(np.asarray(q8)),
                           torch.from_numpy(np.asarray(sc)),
                           torch.tensor([1, 2]), H16)
    assert got.dtype == H16
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (e) multi-tensor AdamW on fp16 parameters
# ---------------------------------------------------------------------------

SHAPES = [(64, 48), (48, 10)]


def _linear_pair(seed=3):
    paddle.seed(seed)
    jm = paddle.nn.LayerList([paddle.nn.Linear(i, o) for i, o in SHAPES])
    tm = torch.nn.ModuleList([Linear(i, o, device="cpu") for i, o in SHAPES])
    with torch.no_grad():
        for jl, tl in zip(jm, tm):
            tl.weight.copy_(torch.from_numpy(np.array(jl.weight._data)))
            b = np.random.default_rng(seed).normal(0, 0.1, tl.bias.shape)
            tl.bias.copy_(torch.from_numpy(b.astype(np.float32)))
            jl.bias._set_data(jnp.asarray(tl.bias.numpy().copy()))
    return jm, tm


def _sched(mod):
    return mod.LinearWarmup(mod.PolynomialDecay(5e-3, 4, end_lr=0.0,
                                                power=1.0),
                            warmup_steps=2, start_lr=0.0, end_lr=5e-3)


def test_multi_tensor_adam_fp16_matches_fused_step():
    jm, tm = _linear_pair()
    js, ts = _sched(jopt.lr), _sched(tlr)
    jo = jopt.AdamW(learning_rate=js, parameters=jm.parameters(),
                    weight_decay=0.01, use_multi_tensor=True,
                    grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    to = AdamW(learning_rate=ts, parameters=tm.parameters(),
               weight_decay=0.01, use_multi_tensor=True,
               grad_clip=topt.ClipGradByGlobalNorm(1.0))
    jm, jo = paddle.amp.decorate(jm, jo, level="O2", dtype="float16")
    tm, to = amp.decorate(tm, to, level="O2", dtype="float16")
    jp, tp = list(jm.parameters()), list(tm.parameters())
    assert all(p.dtype == H16 for p in tp) and to._flat.grad.dtype == H16
    for s in range(3):
        rng = np.random.default_rng(100 + s)
        gs = [rng.normal(0, 0.5, tuple(p.shape)).astype(np.float32)
              for p in tp]
        sum((p.astype("float32") * paddle.to_tensor(g)).sum()
            for p, g in zip(jp, gs)).backward()
        jo.step()
        jo.clear_grad()
        sum((p.float() * torch.from_numpy(g)).sum()
            for p, g in zip(tp, gs)).backward()
        to.step()
        to.clear_grad()
        js.step()
        ts.step()
    fs, jfs = to._flat, jo._fused
    assert to.t == jo._step_count == 3
    assert fs.master.dtype == torch.float32
    for pj, pt, (off, n), (joff, jn) in zip(jp, tp, fs.offsets,
                                            jfs["offsets"]):
        assert pt.dtype == H16
        np.testing.assert_allclose(pt.detach().float().numpy(),
                                   np.asarray(pj._data, np.float32),
                                   rtol=ULP, atol=0)
        for mine, ref in ((fs.master, "master"), (fs.m, "m"), (fs.v, "v")):
            np.testing.assert_allclose(
                mine[off:off + n].numpy(),
                np.asarray(jfs[ref]._data[joff:joff + jn], np.float32),
                rtol=1e-5, atol=1e-6, err_msg=ref)


def test_multi_tensor_adam_fp16_plain_version_rounds_to_nearest():
    # the update writes the fp16 parameter as the new master rounded to
    # nearest (no stochastic rounding: that is bf16's without masters)
    from paddle_tpu_torch.ops import q8_adam
    g = torch.Generator().manual_seed(0)
    n = 4096
    master = torch.randn(n, generator=g) * 0.02
    m, v = torch.zeros(n), torch.zeros(n)
    param = master.to(H16)
    grad = (torch.randn(n, generator=g) * 1e-2).to(H16)
    sc = q8_adam.scalar_block(1e-3, 0.1, 0.001, 1.0 - 1e-5, device="cpu")
    mta.multi_tensor_adam_update(master, m, v, param, grad, scalars=sc,
                                 eps=1e-8, beta1=0.9, beta2=0.999,
                                 has_wd=True)
    assert torch.equal(param, master.to(H16))
    assert not torch.equal(master, param.float())


# ---------------------------------------------------------------------------
# (f) the wrappers' dtype checks
# ---------------------------------------------------------------------------

class _OnCard:
    """A stand-in for a contiguous, aligned CUDA tensor: what the kernel
    wrappers' checks read before any launch."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def contiguous(self):
        return self

    def data_ptr(self):
        return 0


def test_flash_kernel_inputs_take_fp16_and_refuse_float64_and_mixed():
    def xs(*dts):
        return [_OnCard((1, 8, 2, 64), dt) for dt in dts]
    _, code = fa._kernel_inputs(*xs(H16, H16, H16))
    assert code == 2
    assert fa._kernel_inputs(*xs(torch.bfloat16, torch.bfloat16,
                                 torch.bfloat16))[1] == 1
    with pytest.raises(TypeError):
        fa._kernel_inputs(*xs(torch.float64, torch.float64, torch.float64))
    with pytest.raises(TypeError):
        fa._kernel_inputs(*xs(H16, torch.bfloat16, H16))
    with pytest.raises(TypeError):
        fa._kernel_inputs(*xs(H16, H16, torch.float32))


def test_paged_kernel_takes_fp16_and_refuses_float64_and_mixed():
    assert tpa._Q_CODES[H16] == 2 and tpa._POOL_CODES[H16] == 3
    assert tpa._POOL_CODES[torch.int8] == 2   # the int8 code is unchanged
    pool = _OnCard((5, 1, 2, 2, 16, 64), H16)
    tables = _OnCard((2, 2), torch.int32)
    t = _OnCard((2,), torch.int32)

    def call(qdt, kdt=None, pool=pool):
        q = _OnCard((2, 2, 64), qdt)
        kv = _OnCard((2, 2, 64), kdt or qdt)
        return tpa.call_kernel(None, q, kv, kv, pool, None, tables, t, 0,
                               page_size=16)
    with pytest.raises(TypeError, match="float16"):
        call(torch.float64)
    with pytest.raises(TypeError):
        call(H16, torch.bfloat16)
    with pytest.raises(TypeError, match="float16"):
        call(H16, pool=_OnCard((5, 1, 2, 2, 16, 64), torch.float64))


def test_multi_tensor_adam_takes_fp16_and_refuses_float64():
    from paddle_tpu_torch.ops import q8_adam
    n = 64
    sc = q8_adam.scalar_block(1e-3, 0.1, 0.001, 1.0, device="cpu")
    f32 = [torch.zeros(n) for _ in range(3)]
    mta.multi_tensor_adam_update(*f32, torch.zeros(n, dtype=H16),
                                 torch.ones(n, dtype=H16), scalars=sc,
                                 eps=1e-8, beta1=0.9, beta2=0.999,
                                 has_wd=False)
    assert mta._DTYPE_CODES[H16] == 2
    for param, grad in ((torch.zeros(n, dtype=torch.float64),
                         torch.ones(n, dtype=H16)),
                        (torch.zeros(n, dtype=H16),
                         torch.ones(n, dtype=torch.float64))):
        with pytest.raises(ValueError, match="fp16"):
            mta.multi_tensor_adam_update(
                *(torch.zeros(n) for _ in range(3)), param, grad,
                scalars=sc, eps=1e-8, beta1=0.9, beta2=0.999, has_wd=False)
