"""The port's flash-attention forward (plain version on the CPU) against
``paddle_tpu.nn.functional.flash_attention``.

At tileable lengths (multiples of 128 here) the JAX side runs its Pallas
kernel under the interpreter, as its own tests do on the CPU; ragged
lengths run its XLA fallback. Same numpy inputs to both, fp32, atol 1e-5.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as PF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

D = 32

CASES = [  # b, lq, lk, h, h_kv, causal
    (1, 128, 128, 4, 4, True),    # Pallas kernel (interpret)
    (2, 128, 128, 4, 2, True),    # GQA
    (1, 128, 256, 4, 4, True),    # lq < lk: bottom-right causal
    (1, 128, 128, 4, 4, False),
    (2, 37, 53, 4, 2, True),      # ragged: XLA fallback on the JAX side
    (1, 100, 100, 2, 1, False),
]


def _inputs(b, lq, lk, h, hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, D)).astype(np.float32)
    k = rng.standard_normal((b, lk, hkv, D)).astype(np.float32)
    v = rng.standard_normal((b, lk, hkv, D)).astype(np.float32)
    return q, k, v


def _paddle_flash(q, k, v, causal):
    # GQA: the JAX surface repeats kv heads itself before its kernel
    out = PF.flash_attention(paddle.to_tensor(q), paddle.to_tensor(k),
                             paddle.to_tensor(v), causal=causal)
    return np.asarray(out._data)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_sdpa_matches_paddle_tpu_flash(case):
    b, lq, lk, h, hkv, causal = case
    q, k, v = _inputs(b, lq, lk, h, hkv)
    want = _paddle_flash(q, k, v, causal)
    got = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=causal)
    assert got.shape == (b, lq, h, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_fully_masked_rows_emit_zero():
    # lq > lk, causal bottom-right: the first lq - lk rows see no key
    q, k, v = _inputs(1, 8, 5, 2, 2, seed=1)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True)
    assert torch.equal(out[:, :3], torch.zeros_like(out[:, :3]))
    assert torch.isfinite(out).all() and out[:, 3:].abs().sum() > 0


def test_masked_sdpa_on_cpu_matches_paddle_tpu():
    q, k, v = _inputs(2, 16, 16, 4, 2, seed=2)
    mask = np.random.default_rng(3).random((2, 1, 16, 16)) > 0.3
    mask[..., 0] = True
    want = np.asarray(PF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(mask), training=False)._data)
    got = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_device_tensor_with_mask_raises():
    # a non-CPU tensor with a key-padding mask goes to the flash kernel,
    # which wants a CUDA tensor and raises (never a CPU detour); any other
    # mask takes the plain masked softmax on the tensor's own device, as the
    # JAX package's XLA path does
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TF.scaled_dot_product_attention(
            q, q, q, attn_mask=torch.ones(1, 1, 1, 4, dtype=torch.bool,
                                          device="meta"))
    out = TF.scaled_dot_product_attention(
        q, q, q, attn_mask=torch.ones(4, 4, dtype=torch.bool, device="meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q, causal=True)


def test_cpu_path_launches_nothing():
    q, k, v = _inputs(1, 4, 4, 2, 2)
    before = fa.launches.count
    fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v))
    assert fa.launches.count == before


@pytest.mark.parametrize("source,anchor", [
    pytest.param(n, a, id=a.strip()[:40])
    for n, a, _ in chip_smoke.PLANTED_FAULTS])
def test_planted_fault_anchor_occurs_once_in_the_source(source, anchor):
    # chip_smoke.py plants its faults into copies of each source by text
    # (a copy "<source>:<tag>" is another build of <source>.cu): a rewrite
    # that loses or repeats an anchor fails here, not after a build on the
    # card
    src = (ROOT / "paddle_tpu_torch" / "csrc"
           / f"{source.split(':')[0]}.cu").read_text()
    assert src.count(anchor) == 1


def test_build_phase_reads_each_forward_kernel(monkeypatch):
    # chip_smoke.py's build phase fails unless the SASS of all 24 bf16
    # flash instantiations (forward <D, LSE, SEGS, DROP>, dq and dk/dv <D,
    # SEGS, DROP>; dropout always with ids) holds wgmma (HGMMA) and TMA
    # (UTMALDG): its parser must keep them apart and pick up ptxas's
    # registers/spills
    pre = "_ZN51_GLOBAL__N__4af27cb8_18_flash_attention_cu_b294bfd0"
    flags = [(0, 0), (1, 0), (1, 1)]
    names = [f"{pre}22flash_fwd_wgmma_kernelILi{d}ELb{lse}ELb{sg}ELb{dr}EEEv"
             f"14CUtensorMap_stS1_S1_P13__nv_bfloat16PfiiiiifNS_7SegDropE"
             for d in (64, 128) for lse in (1, 0) for sg, dr in flags]
    names += [f"{pre}{len(k)}{k}ILi{d}ELb{sg}ELb{dr}EEEv14CUtensorMap_stS1_S1_"
              f"S1_PKfS3_P13__nv_bfloat16"
              f"{'S4_' if k.endswith('dkv_wgmma_kernel') else ''}"
              f"iiiiifNS_7SegDropE"
              for k in ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel")
              for d in (64, 128) for sg, dr in flags]
    other = "_ZN51_GLOBAL__N__x19flash_bwd_dq_kernelILi64EEEvPKfS3_"
    sass = "".join(f"\t\tFunction : {n}\n  /*0010*/ HGMMA.64x128x16.F32.BF16 R24, "
                   f"gdesc[UR4], RZ ;\n  /*0020*/ UTMALDG.4D [UR8], [UR4] ;\n"
                   for n in names) + f"\t\tFunction : {other}\n  FFMA R1 ;\n"
    log = "".join(f"ptxas info    : Function properties for {n}\n"
                  f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                  f"spill loads\nptxas info    : Used 168 registers, used 1 "
                  f"barriers\n" for n in names + [other])

    class Build:
        build_logs = {"flash_attention": log}

        @staticmethod
        def nvcc():
            return "/cuda/bin/nvcc"

        @staticmethod
        def library_path(name):
            return f"/build/lib{name}.so"

    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **k: type("Done", (), {"stdout": sass})())
    got = chip_smoke.wgmma_kernels(Build)
    assert sorted(got) == sorted(
        [f"flash_fwd_wgmma_kernel<{d}, {lse}, {sg}, {dr}>" for d in (128, 64)
         for lse in (0, 1) for sg, dr in flags]
        + [f"flash_bwd_{k}_wgmma_kernel<{d}, {sg}, {dr}>" for k in ("dq", "dkv")
           for d in (64, 128) for sg, dr in flags])
    assert len(got) == chip_smoke.N_WGMMA_KERNELS
    assert all(k == {"HGMMA": 1, "UTMALDG": 1, "spill_stores": 0,
                     "spill_loads": 0, "registers": 168}
               for k in got.values())


def test_ab_tool_needs_a_card(monkeypatch):
    # the A/B tool builds and times the kernels on a card only: without one
    # it exits 2 before it builds anything
    from paddle_tpu_torch.tools import ab_flash
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["ab_flash", "--other", "other.cu"])
    assert ab_flash.main() == 2
