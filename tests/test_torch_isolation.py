"""The port stands alone: importing every module of ``paddle_tpu_torch``
(``incubate`` and ``tools.fmt_stack`` among them) loads neither JAX nor
``paddle_tpu``; its entry points (model, engine, layers, ``incubate``'s
fused layers, ``FusedMultiTransformer`` and the FMT serving stack) need a
card unless the caller asks for the CPU, and device tensors never take a
plain CPU path (the fused small ops, K5-K8, the FMT's paged decode, the
MoE routing kernel K9 and the multi-tensor AdamW's per-tensor tables
included); ``incubate.moe``, ``ops.moe`` and ``amp.GradScaler`` load no
JAX; ``chip_smoke.py`` fails without a card or without the package; the
kernel bindings match their C entry points."""

import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import NoDeviceError, amp, resolve_device
from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                           ErnieForSequenceClassification,
                                           ErnieModel)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import (Dropout, DropoutRNG, Embedding, LayerNorm,
                                 Linear, RMSNorm)
from paddle_tpu_torch.jit import capture_step
from paddle_tpu_torch.incubate import nn as inn
from paddle_tpu_torch.ops import bias_act as ba
from paddle_tpu_torch.ops import dropout as dr
from paddle_tpu_torch.ops import embedding as em
from paddle_tpu_torch.incubate import moe as tmoe
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_norm as fn
from paddle_tpu_torch.ops import moe as k9
from paddle_tpu_torch.ops import multi_tensor_adam as mta
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import q8_adam as q8
from paddle_tpu_torch.ops import rope as rp
from paddle_tpu_torch.ops import softmax_cross_entropy as ce
from paddle_tpu_torch.ops import softmax_mask as sm
from paddle_tpu_torch.ops import swiglu as sw
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.serving import (DecodeGraph, Engine, KVCacheConfig,
                                      PagedKVCache, ServingConfig,
                                      prefix_chain_digests)
from paddle_tpu_torch.tools.fmt_stack import FMTStack

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"paddle_tpu_torch.tools.fmt_stack",
        "paddle_tpu_torch.incubate.nn_functional",
        "paddle_tpu_torch.incubate.moe",
        "paddle_tpu_torch.ops.moe"} <= set(names), names
from paddle_tpu_torch.amp import GradScaler
GradScaler()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax_and_no_paddle_tpu():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_a_card_unless_cpu_is_asked():
    cfg = LlamaConfig.tiny(vocab=16, hidden=16, layers=1, heads=2,
                           kv_heads=2, inter=16)
    scfg = ServingConfig(num_layers=1, num_heads=2, head_dim=8, max_len=32,
                         page_size=16)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(NoDeviceError):
        resolve_device()
    with pytest.raises(NoDeviceError):
        LlamaForCausalLM(cfg)
    with pytest.raises(NoDeviceError):
        Engine(lambda *a: None, lambda *a: None, scfg)
    # prefix sharing and the decode graphs add no way round the card
    with pytest.raises(NoDeviceError):
        Engine(lambda ids, cache, start=0: None, lambda *a: None,
               ServingConfig(num_layers=1, num_heads=2, head_dim=8,
                             max_len=32, page_size=16, prefix_sharing="on"))
    # the new serving names import without JAX (the walk above) and run
    # no device work of their own on the CPU
    assert len(prefix_chain_digests(list(range(40)), 16)) == 2
    kv = PagedKVCache(KVCacheConfig(
        num_layers=1, num_heads=2, head_dim=8, max_len=32, page_size=16,
        num_pages=3), torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        DecodeGraph(lambda *a: None, kv, 1, None)
    for layer in (lambda **kw: Linear(4, 4, **kw),
                  lambda **kw: Embedding(8, 4, **kw),
                  lambda **kw: RMSNorm(4, **kw),
                  lambda **kw: inn.FusedBiasDropoutResidualLayerNorm(4, **kw),
                  lambda **kw: inn.FusedDropoutAdd(0.1, **kw),
                  lambda **kw: inn.FusedLinear(4, 4, **kw),
                  lambda **kw: inn.FusedFeedForward(4, 8, **kw),
                  lambda **kw: inn.FusedMultiHeadAttention(4, 2, **kw),
                  lambda **kw: inn.FusedTransformerEncoderLayer(4, 2, 8,
                                                                **kw)):
        with pytest.raises(NoDeviceError):
            layer()
        assert all(p.device.type == "cpu"
                   for p in layer(device="cpu").parameters())
    assert resolve_device("cpu").type == "cpu"
    m = LlamaForCausalLM(cfg, device="cpu")
    # amp.decorate casts in place where the parameters live
    opt = AdamW(parameters=m.parameters(), moment_dtype="int8")
    amp.decorate(m, opt, level="O2", dtype="bfloat16")
    assert all(p.device.type == "cpu" and p.dtype == torch.bfloat16
               for p in m.parameters())


_IMPORT_SERVING = """
import sys
import paddle_tpu_torch.observability
import paddle_tpu_torch.observability.http
import paddle_tpu_torch.resilience
import paddle_tpu_torch.serving
from paddle_tpu_torch.serving import StepWatchdog, TTFT_BUCKETS
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_observability_resilience_and_serving_load_no_jax():
    r = subprocess.run([sys.executable, "-c", _IMPORT_SERVING], cwd=ROOT,
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


_IMPORT_FRONT_DOOR = """
import sys
import paddle_tpu_torch.serving.router
import paddle_tpu_torch.serving.http
import paddle_tpu_torch.serving.fleet
import paddle_tpu_torch.serving.fleet_worker
import paddle_tpu_torch.resilience.breaker
import paddle_tpu_torch.distributed.rpc
from paddle_tpu_torch.serving import (FleetSupervisor, FrontDoor, Router,
                                      status_for)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_router_front_door_and_fleet_load_no_jax():
    r = subprocess.run([sys.executable, "-c", _IMPORT_FRONT_DOOR], cwd=ROOT,
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_a_fleet_worker_with_no_device_needs_a_card(tmp_path):
    # the factory config names no device: the worker's engine needs a card,
    # so without one the worker exits non-zero before it publishes a port,
    # and the supervisor says so typed; nothing serves on the CPU
    if torch.cuda.is_available():
        return
    from paddle_tpu_torch.serving import (FleetSupervisor, FleetWorkerLost,
                                          FleetWorkerSpec)
    spec = FleetWorkerSpec(
        name="w", factory="torch_fleet_factory:make_engine",
        config={"name": "w"},
        pythonpath=[str(ROOT / "tests" / "workers"), str(ROOT)],
        env={"PYTHONPATH": str(ROOT)})
    sup = FleetSupervisor([spec], workdir=str(tmp_path), spawn_timeout_s=120,
                          poll_s=0.05)
    with pytest.raises(FleetWorkerLost, match="exited with status 1"):
        sup.start()
    assert sup.router is None and sup.worker_pids() == {}


def test_engine_under_a_watchdog_needs_a_card_unless_cpu_is_asked(
        monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_WATCHDOG_S", "0.3")
    cfg = dict(num_layers=1, num_heads=2, head_dim=8, max_len=32,
               page_size=16, max_replays=2, max_queue_wait_s=5.0)
    if not torch.cuda.is_available():
        with pytest.raises(NoDeviceError):
            Engine(lambda *a: None, lambda *a: None,
                   ServingConfig(**cfg, watchdog_s=0.25))
        with pytest.raises(NoDeviceError):
            Engine(lambda *a: None, lambda *a: None, ServingConfig(**cfg))
    eng = Engine(lambda *a: None, lambda *a: None,
                 ServingConfig(**cfg, device="cpu"))
    assert eng.config.watchdog_s == 0.3 and eng._watchdog is not None
    assert eng.stream is None
    off = ServingConfig(**cfg, watchdog_s=0, device="cpu")
    assert off.watchdog_s is None


def test_ernie_entry_points_need_a_card_unless_cpu_is_asked():
    cfg = ErnieConfig.tiny(vocab=16, hidden=16, layers=1, heads=2, inter=16,
                           max_pos=16)
    if torch.cuda.is_available():
        return
    for build in (lambda **kw: LayerNorm(4, **kw),
                  lambda **kw: Dropout(0.1, **kw),
                  lambda **kw: DropoutRNG(**kw),
                  lambda **kw: ErnieModel(cfg, **kw),
                  lambda **kw: ErnieForSequenceClassification(cfg, **kw)):
        with pytest.raises(NoDeviceError):
            build()
        assert build(device="cpu") is not None
    m = ErnieForSequenceClassification(cfg, device="cpu")
    assert all(p.device.type == "cpu" for p in m.parameters())
    assert m.ernie.rng.seed_t.device.type == "cpu"


def test_fmt_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        return
    for build in (lambda **kw: inn.FusedMultiTransformer(8, 2, 16,
                                                         num_layers=2, **kw),
                  lambda **kw: FMTStack(16, 8, 2, 16, 2, **kw)):
        with pytest.raises(NoDeviceError):
            build()
        assert all(p.device.type == "cpu"
                   for p in build(device="cpu").parameters())


def _meta_view(b=2, h=2, d=64, ps=16):
    return pa.PagedDecodeCache(
        pool=torch.empty(5, 2, 2, h, ps, d, device="meta"),
        tables=torch.zeros(b, 2, dtype=torch.int32, device="meta"),
        t=torch.zeros(b, dtype=torch.int32, device="meta"), page_size=ps)


def test_device_mmha_paged_never_takes_the_plain_version():
    # a non-CPU fused qkv over a paged view goes to the kernel or raises
    # (meta tensors stand in for a card's)
    x = torch.empty(2, 3 * 2 * 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        inn.functional.masked_multihead_attention(
            x, cache_kv=_meta_view().at_layer(0))


def test_fmt_paged_decode_launches_the_kernel_once_a_layer(monkeypatch):
    # the FMT's paged decode, with the CPU tensors sent down the kernel
    # route: each step calls the kernel wrapper once a layer and never the
    # plain version (the launch done here by the plain version's formula)
    dense = pa.paged_attention_dense
    calls = []

    def fake_kernel(fn, q, k_new, v_new, pool, scales, tables, t, layer, *,
                    page_size):
        calls.append(int(layer))
        return dense(q, k_new, v_new, pool, scales, tables, t, layer,
                     page_size)

    def no_plain(*a, **k):
        raise AssertionError("the plain paged version ran")
    monkeypatch.setattr(pa, "plain_path", lambda t: False)
    monkeypatch.setattr(pa, "_kernel", lambda: None)
    monkeypatch.setattr(pa, "call_kernel", fake_kernel)
    monkeypatch.setattr(pa, "paged_attention_dense", no_plain)
    f = inn.FusedMultiTransformer(128, 2, 32, num_layers=3, device="cpu")
    view = pa.PagedDecodeCache(pool=torch.zeros(5, 3, 2, 2, 16, 64),
                               tables=torch.tensor([[1, 2], [3, 4]],
                                                   dtype=torch.int32),
                               t=torch.tensor([3, 17], dtype=torch.int32),
                               page_size=16)
    with torch.no_grad():
        for step in range(2):
            out, got = f(torch.randn(2, 1, 128), caches=view,
                         time_step=view.t + step)
    assert got is view and out.shape == (2, 1, 128)
    assert calls == [0, 1, 2] * 2
    assert view.pool[4, :, :, :, 1].abs().sum() > 0   # t = 17: page 4


def test_device_tensors_never_take_the_plain_variant_path():
    # a non-CPU tensor with segment ids or dropout goes to a variant kernel
    # or raises: never a CPU detour (meta tensors stand in for a card's)
    q = torch.empty(1, 4, 2, 64, device="meta")
    segs = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    lse = torch.empty(1, 2, 4, device="meta")
    for call in (lambda: fa.flash_attention_fwd(q, q, q, True, None, segs,
                                                segs),
                 lambda: fa.flash_attention_lse(q, q, q, True, None, None,
                                                None, 0.1, 3),
                 lambda: fa.flash_attention_bwd(q, q, q, q, lse, q, True, None,
                                                segs, segs, 0.1, 3),
                 lambda: fa.flash_attention(q, q, q, 0.1,
                                            fixed_seed_offset=3)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("call", [
    lambda x, w, lab: nn_ops.rms_norm(x, w),
    lambda x, w, lab: nn_ops.rms_norm(x, w, residual=x),
    lambda x, w, lab: nn_ops.layer_norm(x, 64, w, w, residual=x),
    lambda x, w, lab: fn.fused_norm(x, w, spec=fn.NormSpec(
        "rms", 1e-6, torch.bfloat16, torch.bfloat16, weight=torch.bfloat16)),
    lambda x, w, lab: inn.functional.fused_rms_norm(x, w, residual=x),
    lambda x, w, lab: inn.functional.fused_layer_norm(x, w, w),
    lambda x, w, lab: rp.rope([x.view(2, 4, 2, 32)] * 2, w.view(2, 32),
                              w.view(2, 32)),
    lambda x, w, lab: inn.functional.fused_rotary_position_embedding(
        x.view(2, 4, 2, 32), x.view(2, 4, 2, 32)),
    lambda x, w, lab: sw.swiglu(x, x),
    lambda x, w, lab: inn.functional.swiglu(x),
    lambda x, w, lab: ce.softmax_cross_entropy(x, lab),
    lambda x, w, lab: ce.softmax_cross_entropy(x.view(2, 4, 64),
                                               lab.view(2, 4), shift=True),
    lambda x, w, lab: em.embedding(lab, x),
    lambda x, w, lab: nn_ops.embedding(lab, x, padding_idx=0),
    lambda x, w, lab: ba.bias_act(x, w, ba.ActSpec("gelu", x.dtype,
                                                   x.dtype)),
    lambda x, w, lab: nn_ops.linear(x, w.view(64, 1).expand(64, 64), w,
                                    activation="gelu"),
    lambda x, w, lab: nn_ops.gelu(x),
    lambda x, w, lab: nn_ops.relu(x),
    lambda x, w, lab: dr.dropout(x, 0.1, lab[0]),
    lambda x, w, lab: dr.dropout(x, 0.1, lab[0], residual=x),
    lambda x, w, lab: inn.functional.fused_dropout_add(
        x, x, 0.1, generator=torch.Generator()),
    lambda x, w, lab: sm.softmax_mask(x.view(2, 4, 64), x.view(2, 4, 64)),
    lambda x, w, lab: inn.functional.softmax_mask_fuse(
        x.view(1, 2, 4, 64), x.view(1, 2, 4, 64)[:, :1]),
    lambda x, w, lab: inn.functional.softmax_mask_fuse_upper_triangle(
        x.view(2, 4, 64)),
    lambda x, w, lab: inn.functional.fused_linear(x, w.view(64, 1).expand(
        64, 64), w),
], ids=["rms_norm", "rms_norm_residual", "layer_norm_residual", "fused_norm",
        "incubate_rms", "incubate_ln", "rope", "incubate_rope", "swiglu",
        "incubate_swiglu", "cross_entropy", "cross_entropy_shift",
        "embedding", "nn_embedding", "bias_act", "linear_gelu", "gelu",
        "relu", "dropout", "dropout_residual", "incubate_dropout_add",
        "softmax_mask", "incubate_softmax_mask",
        "incubate_softmax_mask_upper_triangle", "incubate_fused_linear"])
def test_device_tensors_never_take_a_fused_plain_version(call):
    # the fused small ops: a non-CPU tensor goes to the kernel or raises,
    # never to a *_reference (meta tensors stand in for a card's)
    x = torch.empty(8, 64, dtype=torch.bfloat16, device="meta")
    w = torch.empty(64, dtype=torch.bfloat16, device="meta")
    lab = torch.zeros(8, dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        call(x, w, lab)


def test_adamw_over_device_parameters_never_takes_the_plain_path():
    # a non-CPU parameter goes to the int8 kernel or raises: never a CPU
    # detour (meta tensors stand in for a card's here)
    p = torch.nn.Parameter(torch.empty(4096, device="meta"))
    p.grad = torch.empty(4096, device="meta")
    opt = AdamW(parameters=[p], moment_dtype="int8")
    with pytest.raises(ValueError, match="CUDA"):
        opt.step()


def test_multi_tensor_adamw_over_device_parameters_never_takes_the_plain_path():
    # the flat layout over non-CPU parameters goes to the kernel or raises
    ps = [torch.nn.Parameter(torch.empty(n, device="meta"))
          for n in (100, 4096)]
    opt = AdamW(parameters=ps, use_multi_tensor=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    for p in ps:
        p.grad = torch.empty_like(p)
    with pytest.raises(ValueError, match="CUDA"):
        opt.step()


def _meta_routes():
    return k9.Routes(ptr=torch.zeros(9, dtype=torch.int32, device="meta"),
                     slot=torch.zeros(16, dtype=torch.int32, device="meta"),
                     slot_route=torch.zeros(16, dtype=torch.int32,
                                            device="meta"),
                     route_token=torch.zeros(16, dtype=torch.int32,
                                             device="meta"),
                     experts=4, capacity=4)


@pytest.mark.parametrize("call", [
    lambda x, r: k9.moe_dispatch(x, r),
    lambda x, r: k9.moe_combine(x.repeat(2, 1), torch.empty(
        16, device="meta"), r),
    lambda x, r: k9.moe_combine(x.repeat(2, 1), torch.empty(
        16, device="meta"), r, bias=x[:4], spec=k9.CombineSpec(
            x.dtype, x.dtype, x.dtype, x.dtype)),
    lambda x, r: ba.bias_act(x.repeat(2, 1), x[:4], ba.ActSpec(
        "gelu_tanh", x.dtype, x.dtype), period=4),
], ids=["dispatch", "combine", "combine_bias", "bias_act_period"])
def test_device_tensors_never_take_a_moe_plain_version(call):
    # K9 and K6's bias period: a non-CPU tensor goes to the kernel or
    # raises, never to a *_reference (meta tensors stand in for a card's)
    x = torch.empty(8, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        call(x, _meta_routes())


def test_moe_layers_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the layers would build there")
    with pytest.raises(NoDeviceError):
        tmoe.NaiveGate(16, 4)
    with pytest.raises(NoDeviceError):
        tmoe.MoELayer(16, [torch.nn.Identity()] * 4)
    with pytest.raises(NoDeviceError):
        inn.FusedEcMoe(16, 32, 4)
    assert tmoe.MoELayer(16, [torch.nn.Identity()] * 4,
                         device="cpu").gate.gate_proj.weight.device.type \
        == "cpu"


def test_multi_tensor_tables_over_device_parameters_never_take_the_plain_path():
    # groups of LR scales and apply_decay_param_fun on the flat layout:
    # the kernel's per-tensor tables, or raise (never a CPU detour)
    ps = [torch.nn.Parameter(torch.empty(n, device="meta"))
          for n in (100, 4096)]
    for p, name in zip(ps, ("norm", "weight")):
        p.param_name = name
    opt = AdamW(parameters=[{"params": ps[:1], "learning_rate": 0.5},
                            {"params": ps[1:]}], use_multi_tensor=True,
                apply_decay_param_fun=lambda n: n != "norm")
    assert opt._flat is not None and opt._flat.tables is not None
    for p in ps:
        p.grad = torch.empty_like(p)
    with pytest.raises(ValueError, match="CUDA"):
        opt.step()


def test_captured_step_of_a_cpu_model_runs_eagerly(monkeypatch):
    # capture_step and the carried optimizer state need a card unless the
    # model is on the CPU: there the step runs eagerly (bypass "cpu")
    monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", "auto")
    cfg = ErnieConfig.tiny(vocab=16, hidden=16, layers=1, heads=2, inter=16,
                           max_pos=16)
    m = ErnieForSequenceClassification(cfg, device="cpu")
    sched = tlr.LinearWarmup(tlr.PolynomialDecay(1e-3, 4, end_lr=0.0), 2,
                             0.0, 1e-3)
    opt = AdamW(learning_rate=sched, parameters=m.parameters(),
                use_multi_tensor=True, grad_clip=ClipGradByGlobalNorm(1.0))
    assert opt._step_t.device.type == "cpu" and opt._lr_t.device.type == "cpu"
    ids = torch.randint(1, 16, (2, 8))
    labels = torch.randint(0, 2, (2,))

    def step(ids, labels):
        loss, _ = m(ids, labels=labels)
        loss.backward()
        return loss

    def update():
        opt.step()
        opt.clear_grad()
    cap = capture_step(step, update_fn=update, nan_gate=True)
    for _ in range(2):
        cap(ids, labels)
        sched.step()
    assert cap.stats == {"hits": 0, "retraces": 0, "bypasses": {"cpu": 2}}
    assert opt.t == 2 and cap.num_graphs == 0


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def _c_params(source: str, fn: str):
    text = (ROOT / "paddle_tpu_torch" / "csrc" / source).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)", text, re.S)
    assert m, f"{fn} not found in {source}"
    return [p.strip() for p in m.group(1).split(",")]


_ARGTYPES_OF = {"flash_fwd": "_ARGTYPES", "flash_fwd_lse": "_ARGTYPES_LSE",
                "flash_bwd_dq": "_ARGTYPES_BWD_DQ",
                "flash_bwd_dkv": "_ARGTYPES_BWD_DKV",
                "paged_decode": "_ARGTYPES", "q8_adam": "_ARGTYPES",
                "multi_tensor_adam": "_ARGTYPES",
                "fused_norm_fwd": "_ARGTYPES_FWD",
                "fused_norm_bwd": "_ARGTYPES_BWD", "rope": "_ARGTYPES",
                "swiglu_fwd": "_ARGTYPES_FWD", "swiglu_bwd": "_ARGTYPES_BWD",
                "ce_fwd": "_ARGTYPES_FWD", "ce_bwd": "_ARGTYPES_BWD"}


@pytest.mark.parametrize("mod,source,fn", [
    (fa, "flash_attention.cu", "flash_fwd"),
    (pa, "paged_attention.cu", "paged_decode"),
    (fa, "flash_attention.cu", "flash_fwd_lse"),
    (fa, "flash_attention.cu", "flash_bwd_dq"),
    (fa, "flash_attention.cu", "flash_bwd_dkv"),
    (q8, "q8_adam.cu", "q8_adam"),
    (fa, "flash_attention.cu", "flash_fwd_segdrop"),
    (fa, "flash_attention.cu", "flash_fwd_lse_segdrop"),
    (fa, "flash_attention.cu", "flash_bwd_dq_segdrop"),
    (fa, "flash_attention.cu", "flash_bwd_dkv_segdrop"),
    (mta, "multi_tensor_adam.cu", "multi_tensor_adam"),
    (fn, "fused_norm.cu", "fused_norm_fwd"),
    (fn, "fused_norm.cu", "fused_norm_bwd"),
    (rp, "rope.cu", "rope"),
    (sw, "swiglu.cu", "swiglu_fwd"),
    (sw, "swiglu.cu", "swiglu_bwd"),
    (ce, "softmax_cross_entropy.cu", "ce_fwd"),
    (ce, "softmax_cross_entropy.cu", "ce_bwd"),
    (em, "embedding.cu", "emb_fwd"),
    (em, "embedding.cu", "emb_bwd"),
    (ba, "bias_act.cu", "bias_act_fwd"),
    (ba, "bias_act.cu", "bias_act_bwd"),
    (dr, "dropout.cu", "dropout_fwd"),
    (dr, "dropout.cu", "dropout_bwd"),
    (sm, "softmax_mask.cu", "softmax_mask_fwd"),
    (sm, "softmax_mask.cu", "softmax_mask_bwd"),
    (k9, "moe.cu", "moe_gather_sum"),
    (k9, "moe.cu", "moe_slot_rows"),
])
def test_ctypes_bindings_match_c_signatures(mod, source, fn):
    params = _c_params(source, fn)
    # the segment-id / dropout variants are bound from the module's table
    argtypes = (getattr(mod, _ARGTYPES_OF[fn]) if fn in _ARGTYPES_OF
                else mod._ARGTYPES_OF[fn])
    assert len(params) == len(argtypes)
    for p, ty in zip(params, argtypes):
        if "*" in p:
            assert ty is ctypes.c_void_p, p
        elif p.startswith("int "):
            assert ty is ctypes.c_int, p
        elif p.startswith("long long "):
            assert ty is ctypes.c_longlong, p
        else:
            assert p.startswith("float ") and ty is ctypes.c_float, p
