"""The port stands alone: importing every module of ``paddle_tpu_torch``
loads neither JAX nor ``paddle_tpu``; its entry points need a card unless
the caller asks for the CPU; ``chip_smoke.py`` fails without a card or
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

from paddle_tpu_torch import NoDeviceError, resolve_device
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
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
    assert resolve_device("cpu").type == "cpu"
    LlamaForCausalLM(cfg, device="cpu")


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


@pytest.mark.parametrize("mod,source,fn", [
    (fa, "flash_attention.cu", "flash_fwd"),
    (pa, "paged_attention.cu", "paged_decode"),
])
def test_ctypes_bindings_match_c_signatures(mod, source, fn):
    params = _c_params(source, fn)
    assert len(params) == len(mod._ARGTYPES)
    for p, ty in zip(params, mod._ARGTYPES):
        if "*" in p:
            assert ty is ctypes.c_void_p, p
        elif p.startswith("int "):
            assert ty is ctypes.c_int, p
        else:
            assert p.startswith("float ") and ty is ctypes.c_float, p
