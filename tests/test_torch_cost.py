"""The port's program cost registry (``paddle_tpu_torch.observability.cost``)
against ``paddle_tpu.observability.cost``, where the port has the surface.

Covered on the CPU: the mode and its off state (no hook, no record); the
serving engine's decode-bucket and prefill records from ``warmup()`` and
their retirement with the engine; the captured step's ``train.step`` record
(its CPU tier counts a signature's first call); degradation (a failing
count is counted, never raised); ``flops()`` feeding an analytic record and
equal to ``paddle.flops``; the ledger's arithmetic and its ``param``,
``master``, ``moment`` and ``kv_pool`` bytes against the JAX ledger for one
tiny Llama under int8 AdamW and O2; the warning latch, the device model,
the utilization join; the Prometheus names; ``/debug/cost``, the flight
dump's ``cost`` key and ``/healthz``'s ``hbm`` component.

Closed forms are held exactly: a Linear's ``addmm`` flops and bytes, each
attention cost function, and the CPU decode program's flops. A tiny Llama
forward's count is held against ``cost_analysis()`` of the JAX package's
program within ``XLA_FLOPS_RATIO``: the port counts matrix products only,
XLA also the elementwise work (softmax, norms, SiLU, RoPE, residuals), 7.3%
of this program's flops.

The suite runs with ``PADDLE_TPU_COST=off`` (conftest): every test here
opts in through ``cost_on``.
"""

import dataclasses
import gc
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import observability as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.observability import cost as jcost
from paddle_tpu_torch import amp, flops, jit, serving
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch._native import build as native_build
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import cost
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=48,
            max_pos=256)
MAX_LEN, PS = 64, 16
XLA_FLOPS_RATIO = (0.85, 1.0)   # port count / XLA's, tiny Llama forward


@pytest.fixture()
def cost_on(monkeypatch):
    """The port's metrics enabled and reset, the registry installed for one
    test (the suite-wide PADDLE_TPU_COST=off overridden here)."""
    monkeypatch.setenv("PADDLE_TPU_COST", "on")
    tobs.enable()
    tobs.reset()
    cost._HBM_WARN_ONCE[0] = False
    assert cost.installed()
    yield cost
    tobs.disable()
    tobs.reset()
    cost._HBM_WARN_ONCE[0] = False


def _llama(seed=7):
    return LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu",
                            generator=torch.Generator().manual_seed(seed))


def _engine(model, **kw):
    cfg = serving.ServingConfig(num_layers=2, num_heads=2, head_dim=8,
                                max_len=MAX_LEN, max_batch=4,
                                buckets=(1, 4), page_size=PS, device="cpu",
                                **kw)
    return serving.Engine(*model.serving_callables(MAX_LEN), cfg)


def _matmul_params(cfg) -> int:
    """Weights of the products one token goes through (the head too)."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    return cfg.num_hidden_layers * (2 * h * h + 2 * h * kv + 3 * h * i) \
        + h * v


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------

def test_public_surface_matches_the_jax_package():
    assert set(jcost.__all__) <= set(cost.__all__)
    assert [f.name for f in dataclasses.fields(cost.ProgramCostRecord)] == \
        [f.name for f in dataclasses.fields(jcost.ProgramCostRecord)]
    assert cost._DEVICE_DEFAULTS["cpu"] == jcost._DEVICE_DEFAULTS["cpu"]


def test_metric_families_and_prometheus_names_match(cost_on):
    jobs.enable()
    try:
        jfam = {f.name for f in jobs.default_registry().families()
                if f.name.startswith("cost.")}
    finally:
        jobs.disable()
    tfam = {f.name for f in tobs.default_registry().families()
            if f.name.startswith("cost.")}
    assert tfam == jfam and len(tfam) == 10
    cost.record_analytic("net", 10.0)
    cost.hbm_ledger()
    text = tobs.prometheus_text()
    for fam in ("cost_programs", "cost_programs_captured_total",
                "cost_program_flops", "cost_hbm_bytes"):
        assert fam in text, fam


def test_mode_resolution(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_COST", raising=False)
    assert cost.mode() == "on"
    for off in ("off", "0", "false", "no"):
        monkeypatch.setenv("PADDLE_TPU_COST", off)
        assert cost.mode() == "off"


def test_off_means_no_hooks_and_no_records(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_COST", "off")
    tobs.enable()
    try:
        assert not cost.installed()
        with cost.counted() as tally:
            assert tally is None and native_build.cost_hook is None
        cost.clear()
        eng = _engine(_llama())
        eng.warmup(prompt_lens=[5])
        assert cost.records() == []
    finally:
        tobs.disable()


def test_counting_hooks_kernel_launches_and_restores(cost_on):
    seen = []
    counter = native_build.LaunchCounter("cost_probe")
    with cost.counted() as tally:
        assert native_build.cost_hook is not None
        counter.launched(2, lambda a, b: (a, b), 3.0, 5.0)
        counter.launched()                 # no cost function: not counted
        seen.append(counter.count)
    assert native_build.cost_hook is None
    assert tally.kernels == {"cost_probe": [2, 6.0, 10.0]}
    assert tally.flops == 6.0 and tally.bytes_accessed == 10.0
    assert seen == [3]
    counter.launched(1, lambda: pytest.fail("a cost outside a count"))


# ---------------------------------------------------------------------------
# capture sites
# ---------------------------------------------------------------------------

def test_serving_bucket_warmup_records_and_engine_death(cost_on):
    model = _llama()
    eng = _engine(model)
    eng.warmup(prompt_lens=[5])
    buckets = cost.decode_bucket_records()
    assert set(buckets) == set(eng.config.buckets) == {1, 4}
    n_mat = _matmul_params(model.config)
    kv = eng.kv.config
    m = kv.pages_per_slot * kv.page_size
    for b, rec in buckets.items():
        assert rec["site"] == "serving.decode" and rec["bucket"] == b
        assert f"[b={b}]" in rec["program"]
        assert rec["model_source"] == "analytic"
        assert rec["bytes_accessed"] > 0 and rec["temp_bytes"] is None
        # the CPU step's products: 2 b per weight, and the plain paged
        # attention's two dense products over the slot's m positions
        attn = model.config.num_hidden_layers * 4 * b * \
            model.config.num_attention_heads * model.config.head_dim * m
        assert rec["flops"] == 2 * b * n_mat + attn
    prefill = cost.records(site="serving.prefill")
    assert len(prefill) == 1 and "[len=5]" in prefill[0]["program"]
    # a second warm-up counts nothing new
    eng.warmup(prompt_lens=[5])
    assert len(cost.records()) == 3
    del eng
    gc.collect()
    assert cost.records(site="serving.decode") == []
    assert cost.records(site="serving.prefill") == []
    retired = tobs.snapshot()["cost.records_retired_total"]
    assert retired["site=serving.decode"] == 2
    assert retired["site=serving.prefill"] == 1


def test_train_step_record_on_the_cpu_tier(cost_on, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", "auto")
    model = _llama()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())

    def train_step(ids):
        loss, _ = model(ids, labels=ids)
        loss.backward()
        return loss

    step = jit.capture_step(train_step, update_fn=opt.step,
                            clear_fn=opt.clear_grad)
    ids = torch.randint(0, 64, (2, 12), generator=torch.Generator()
                        .manual_seed(0))
    step(ids)
    opt.clear_grad()
    recs = cost.records(site="train.step")
    assert len(recs) == 1 and recs[0]["program"] == "train_step"
    assert recs[0]["flops"] > 0 and recs[0]["bytes_accessed"] > 0
    step(ids)                             # same signature: not recounted
    step(ids[:, :8])                      # a new one: counted
    assert len(cost.records(site="train.step")) == 2
    # the ledger sees the step's model and optimizer
    led = cost.hbm_ledger()
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    assert led["param_bytes"] >= params and led["moment_bytes"] >= 2 * params
    del step
    gc.collect()
    assert cost.records(site="train.step") == []


def test_failing_count_degrades_and_is_counted(cost_on):
    owner = torch.nn.Linear(2, 2)
    counter = native_build.LaunchCounter("cost_broken")

    def broken():
        raise RuntimeError("no shapes")
    with cost.counted() as tally:
        counter.launched(1, broken)       # raises nothing to the caller
    rec = cost.record_program(owner, "p", "serving.decode", "p", tally)
    assert tally.failed and rec.model_source == "none" and rec.flops is None
    with cost.counted() as empty:
        pass
    rec = cost.record_program(owner, "q", "serving.decode", "q", empty)
    assert rec.model_source == "none"
    fails = tobs.snapshot()["cost.analysis_failures_total"]
    assert fails["reason=count_error"] == 1
    assert fails["reason=no_count"] == 1
    assert {r["key"] for r in cost.records()} == {
        cost._program_key(owner, "p"), cost._program_key(owner, "q")}


def test_flops_counter_feeds_analytic_records_and_equals_paddle_flops(
        cost_on):
    jnet = jnn.Sequential(jnn.Linear(8, 8), jnn.LayerNorm(8), jnn.ReLU())
    want = paddle.flops(jnet, [2, 8])
    net = torch.nn.Sequential(tnn.Linear(8, 8, device="cpu"),
                              tnn.LayerNorm(8, device="cpu"),
                              torch.nn.ReLU())
    total = flops(net, [2, 8])
    assert total == want > 0
    recs = cost.records(site="analytic")
    assert len(recs) == 1 and recs[0]["model_source"] == "analytic"
    assert recs[0]["flops"] == float(total)


# ---------------------------------------------------------------------------
# closed forms
# ---------------------------------------------------------------------------

def test_linear_count_is_the_closed_form(cost_on):
    lin = tnn.Linear(16, 24, device="cpu")
    x = torch.randn(3, 5, 16)
    with torch.no_grad(), cost.counted() as tally:
        y = lin(x)
    assert tally.flops == 2 * 15 * 16 * 24
    # the product reads x and W and writes x @ W; the bias add reads it and
    # b and writes y (views move no bytes)
    assert tally.bytes_accessed == 4 * (x.numel() + 16 * 24 + y.numel()
                                        + y.numel() + 24 + y.numel())


@pytest.mark.parametrize("lq,lk,causal", [(128, 128, True), (16, 1040, True),
                                          (256, 128, True), (1, 1064, True),
                                          (200, 300, False)])
def test_attention_cost_closed_forms(lq, lk, causal):
    b, h, hkv, d, item = 2, 8, 2, 64, 2
    pairs = lq * lk if not causal else sum(
        min(lk, max(0, i + lk - lq + 1)) for i in range(lq))
    assert fa.attention_pairs(lq, lk, causal) == pairs
    qb, kb, row = item * d * b * lq * h, item * d * b * lk * hkv, b * h * lq * 4
    want = {"fwd": (4, 2 * qb + 2 * kb), "fwd_lse": (4, 2 * qb + 2 * kb + row),
            "bwd_dq": (6, 3 * qb + 2 * kb + 2 * row),
            "bwd_dkv": (8, 2 * qb + 4 * kb + 2 * row)}
    for entry, (prod, nbytes) in want.items():
        got = fa.attention_cost(entry, b, lq, lk, h, hkv, d, item, causal)
        assert got == (prod * b * h * d * pairs, float(nbytes))
    segs = fa.attention_cost("fwd", b, lq, lk, h, hkv, d, item, causal, True)
    assert segs[1] == 2 * qb + 2 * kb + 4 * b * (lq + lk)


def test_tiny_llama_forward_count_against_xla(cost_on, monkeypatch):
    paddle.seed(7)
    jm = JLlama(JConfig.tiny(**TINY))
    jm.eval()
    np_state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(np_state), strict=True)
    ids = np.random.default_rng(0).integers(0, 64, (2, 24))
    monkeypatch.setenv("PADDLE_TPU_COST", "on")
    jcost.install()
    jcost.clear()
    try:
        @paddle.jit.to_static
        def forward(x):
            return jm(x)
        forward(paddle.to_tensor(ids.astype(np.int32)))
        (rec,) = jcost.records(site="jit")
    finally:
        jcost.uninstall()
        jcost.clear()
    with torch.no_grad(), cost.counted() as tally:
        tm(torch.from_numpy(ids))
    cfg = tm.config
    closed = 2 * 2 * 24 * _matmul_params(cfg) + cfg.num_hidden_layers * 4 \
        * 2 * cfg.num_attention_heads * cfg.head_dim * 24 * 24
    assert tally.flops == closed
    lo, hi = XLA_FLOPS_RATIO
    assert lo <= tally.flops / rec["flops"] <= hi, (tally.flops, rec["flops"])


# ---------------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------------

def test_hbm_ledger_arithmetic(cost_on):
    gc.collect()
    led0 = cost.hbm_ledger()
    net = tnn.Linear(8, 8, device="cpu")
    cost.register_state(net)
    led1 = cost.hbm_ledger()
    assert led1["param_bytes"] - led0["param_bytes"] == (64 + 8) * 4

    class FakeArr:
        nbytes = 4096

    class FakeKV:
        pool = FakeArr()
        scales = None

    kv = FakeKV()
    cost.register_kv_cache(kv)
    led2 = cost.hbm_ledger()
    assert led2["kv_pool_bytes"] - led1["kv_pool_bytes"] == 4096
    cost._store(cost.ProgramCostRecord(
        key="k", site="train.step", program="step", model_source="analytic",
        temp_bytes=1 << 20))
    led3 = cost.hbm_ledger()
    assert led3["program_temp_peak_bytes"] == 1 << 20
    assert led3["peak_hbm_bytes"] == (led3["state_bytes_total"]
                                      + led3["kv_pool_bytes"] + (1 << 20))
    assert led3["headroom_bytes"] == led3["hbm_bytes"] - \
        led3["peak_hbm_bytes"]
    del kv, net
    gc.collect()
    led4 = cost.hbm_ledger()
    assert led4["kv_pool_bytes"] == led0["kv_pool_bytes"]
    assert led4["param_bytes"] == led0["param_bytes"]


def test_ledger_bytes_equal_the_jax_ledger(cost_on, monkeypatch):
    # one tiny Llama under O2 bf16 and int8 AdamW, one step, in each
    # package, and an int8 engine pool of one config: param, master,
    # moment and kv_pool bytes equal byte for byte (deltas over each
    # process-wide ledger)
    monkeypatch.setattr(jcost, "_HBM_WARN_ONCE", [True])
    ids = np.random.default_rng(1).integers(0, 64, (2, 12))
    gc.collect()
    j0 = jcost.hbm_ledger()
    paddle.seed(7)
    jm = JLlama(JConfig.tiny(**TINY))
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  moment_dtype="int8")
    jm, jopt = jamp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jloss, _ = jm(paddle.to_tensor(ids.astype(np.int32)),
                      labels=paddle.to_tensor(ids.astype(np.int32)))
    jloss.backward()
    jopt.step()
    jopt.clear_grad()
    jcfg = jserving.ServingConfig(num_layers=2, num_heads=2, head_dim=8,
                                  max_len=MAX_LEN, max_batch=4,
                                  buckets=(1, 4), page_size=PS,
                                  kv_dtype="int8")
    jeng = jserving.Engine(*jm.serving_callables(MAX_LEN), jcfg)
    j1 = jcost.hbm_ledger()

    gc.collect()
    t0 = cost.hbm_ledger()
    tm = _llama()
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                moment_dtype="int8")
    tm, opt = amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    cost.register_state(tm, opt)
    x = torch.from_numpy(ids)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        loss, _ = tm(x, labels=x)
    loss.backward()
    opt.step()
    opt.clear_grad()
    teng = _engine(tm, kv_dtype="int8")
    t1 = cost.hbm_ledger()
    for comp in ("param_bytes", "master_bytes", "moment_bytes",
                 "kv_pool_bytes"):
        assert t1[comp] - t0[comp] == j1[comp] - j0[comp] > 0, comp
    del jeng, teng


def test_hbm_low_headroom_warns_once(cost_on, monkeypatch, caplog):
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", "1")
    net = tnn.Linear(4, 4, device="cpu")
    cost.register_state(net)
    with caplog.at_level("WARNING", cost.__name__):
        cost.hbm_ledger()
        assert any("HBM headroom" in r.message for r in caplog.records)
        caplog.clear()
        cost.hbm_ledger()                 # latched: once per process
        assert not caplog.records


def test_device_model_env_overrides(cost_on, monkeypatch):
    dev = cost.device_model()
    assert dev["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert dev["source"] == "default"
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", "1000")
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "2e12")
    monkeypatch.setenv("PADDLE_TPU_HBM_BW_BYTES", "5e9")
    dev = cost.device_model()
    assert dev["hbm_bytes"] == 1000 and dev["peak_flops"] == 2e12
    assert dev["hbm_bw_bytes"] == 5e9 and dev["source"] == "env"


# ---------------------------------------------------------------------------
# utilization join
# ---------------------------------------------------------------------------

def test_utilization_join_math(cost_on, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("PADDLE_TPU_HBM_BW_BYTES", "1e9")
    cost._store(cost.ProgramCostRecord(
        key="step", site="train.step", program="step",
        model_source="analytic", flops=2e9, bytes_accessed=1e8))
    cost._store(cost.ProgramCostRecord(
        key="dec", site="serving.decode", program="decode[b=4]",
        model_source="analytic", flops=5e8, bucket=4))
    tobs.observe("train.step_seconds", 0.01)
    tobs.observe("serving.tpot_seconds", 0.005)
    rows = {r["key"]: r for r in cost.utilization()}
    assert rows["step"]["mfu"] == pytest.approx(2e9 / (0.01 * 1e12))
    assert rows["step"]["bandwidth_util"] == pytest.approx(
        1e8 / (0.01 * 1e9))
    assert rows["dec"]["mfu"] == pytest.approx(5e8 / (0.005 * 1e12))
    assert rows["dec"]["bandwidth_util"] is None
    snap = tobs.snapshot()
    assert snap["cost.mfu"]["site=train.step,program=step"] == \
        pytest.approx(0.2)


def test_utilization_empty_without_timings(cost_on):
    cost._store(cost.ProgramCostRecord(
        key="step", site="train.step", program="step",
        model_source="analytic", flops=2e9))
    assert cost.utilization() == []


# ---------------------------------------------------------------------------
# operator surfaces
# ---------------------------------------------------------------------------

def test_debug_cost_route(cost_on):
    eng = _engine(_llama())
    eng.warmup()
    from paddle_tpu_torch.observability.http import start_http_server
    srv = start_http_server(0)
    try:
        doc = json.load(urllib.request.urlopen(
            srv.url + "/debug/cost", timeout=10))
    finally:
        srv.close()
    assert doc["mode"] == "on" and doc["installed"] is True
    assert {r["site"] for r in doc["records"]} == {"serving.decode"}
    assert len(doc["records"]) == 2
    assert doc["hbm"]["hbm_bytes"] > 0 and doc["hbm"]["kv_pool_bytes"] > 0
    assert "utilization" in doc and doc["device"]["platform"] in ("cpu",
                                                                  "gpu")
    del eng


def test_route_index_names_debug_cost(cost_on):
    from paddle_tpu_torch.observability.http import start_http_server
    srv = start_http_server(0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/nope", timeout=10)
        doc = json.loads(e.value.read())
    finally:
        srv.close()
    assert "/debug/cost" in doc["routes"]


@pytest.fixture
def port_tracing(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(tmp_path))
    ttrace.set_mode("on")
    ttrace.clear()
    ttrace.flight_recorder().clear()
    yield ttrace
    ttrace.set_mode("off")
    ttrace.clear()
    ttrace.flight_recorder().clear()


def test_flight_dump_carries_cost_snapshot(cost_on, port_tracing):
    cost._store(cost.ProgramCostRecord(
        key="k", site="train.step", program="step", model_source="analytic",
        flops=1.0))
    p = port_tracing.flight_recorder().dump("test_cost_abort")
    with open(p) as f:
        doc = json.load(f)
    assert doc["cost"]["records"][0]["key"] == "k"
    assert "hbm" in doc["cost"]


def test_flight_dump_cost_off(port_tracing, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_COST", "off")
    cost.uninstall()
    p = port_tracing.flight_recorder().dump("test_cost_off")
    with open(p) as f:
        assert json.load(f)["cost"]["mode"] == "off"


def test_healthz_hbm_component_is_503_independent(cost_on, port_tracing):
    try:
        port_tracing.heartbeat("test.engine", ttl_s=60.0)
        doc = port_tracing.health()
        assert doc["status"] == "ok"
        hbm = doc["components"]["hbm"]
        assert hbm["ok"] is True and hbm["stale"] is False
        assert hbm["headroom_bytes"] == hbm["hbm_bytes"] - \
            hbm["peak_hbm_bytes"]
        port_tracing.heartbeat("stale.engine", ttl_s=0.0)
        doc = port_tracing.health()
        assert doc["status"] == "unhealthy"
        assert doc["components"]["hbm"]["ok"] is True
    finally:
        port_tracing.heartbeat_clear("test.engine")
        port_tracing.heartbeat_clear("stale.engine")


def test_healthz_has_no_hbm_component_when_off(port_tracing):
    cost.uninstall()
    assert "hbm" not in port_tracing.health()["components"]
