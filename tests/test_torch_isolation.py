"""The port stands alone: importing every module of ``paddle_tpu_torch``
loads neither JAX nor ``paddle_tpu``; its entry points (model, engine,
layers) need a card unless the caller asks for the CPU, and device tensors
never take a plain CPU path; ``chip_smoke.py`` fails without a card or
without the package; the kernel bindings match their C entry points."""

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
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import q8_adam as q8
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import Engine, ServingConfig

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
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
    for layer in (lambda **kw: Linear(4, 4, **kw),
                  lambda **kw: Embedding(8, 4, **kw),
                  lambda **kw: RMSNorm(4, **kw)):
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
    assert m.ernie.rng.device.device.type == "cpu"


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


def test_adamw_over_device_parameters_never_takes_the_plain_path():
    # a non-CPU parameter goes to the int8 kernel or raises: never a CPU
    # detour (meta tensors stand in for a card's here)
    p = torch.nn.Parameter(torch.empty(4096, device="meta"))
    p.grad = torch.empty(4096, device="meta")
    opt = AdamW(parameters=[p], moment_dtype="int8")
    with pytest.raises(ValueError, match="CUDA"):
        opt.step()


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
                "paged_decode": "_ARGTYPES", "q8_adam": "_ARGTYPES"}


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
        else:
            assert p.startswith("float ") and ty is ctypes.c_float, p
