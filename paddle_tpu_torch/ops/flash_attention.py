"""Flash-attention forward: the hand-written Hopper kernel
(``csrc/flash_attention.cu``, the port of ``_flash_fwd_kernel`` in
``paddle_tpu/ops/flash_attention.py``) and its plain PyTorch version.

Layout is paddle's flash-attention API: q ``(B, Lq, H, D)``, k/v
``(B, Lk, Hkv, D)`` with ``H % Hkv == 0`` (GQA), out ``(B, Lq, H, D)`` in
q's dtype. Causal masking is bottom-right aligned: query row ``i`` sees keys
``j <= i + Lk - Lq``, the KV-cache convention, so one call serves a prefill
(``Lq == Lk``) and a decode over a grown cache (``Lq < Lk``). A row that sees
no key emits 0.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_reference` only for CPU tensors. Segment ids and
dropout join with the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _native

__all__ = ["flash_attention", "flash_attention_reference", "launches"]

launches = _native.LaunchCounter("flash_attention_fwd")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# flash_fwd(q, k, v, o, B, Lq, Lk, H, Hkv, D, dtype, causal, sm_scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def _kernel():
    fn = _native.load("flash_attention").flash_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Plain version: materialised fp32 softmax attention, same masking and
    fully-masked-rows-emit-0 convention as the kernel."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    if hkv != h:
        kf = kf.repeat_interleave(h // hkv, dim=1)
        vf = vf.repeat_interleave(h // hkv, dim=1)
    logits = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(
            diagonal=lk - lq)
        p = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
        p = torch.where(keep.any(-1, keepdim=True), p, 0.0)
    else:
        p = torch.softmax(logits, dim=-1)
    return (p @ vf).transpose(1, 2).to(q.dtype)


def flash_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention forward through the flash kernel (CUDA) or its plain
    version (CPU)."""
    if query.dim() != 4 or key.dim() != 4 or key.shape != value.shape:
        raise ValueError(f"flash_attention wants q (B, Lq, H, D) and k/v "
                         f"(B, Lk, Hkv, D); got {tuple(query.shape)}, "
                         f"{tuple(key.shape)}, {tuple(value.shape)}")
    b, lq, h, d = query.shape
    lk, hkv = key.shape[1], key.shape[2]
    if key.shape[0] != b or key.shape[3] != d or h % hkv != 0:
        raise ValueError(f"incompatible q {tuple(query.shape)} and k/v "
                         f"{tuple(key.shape)}")
    if query.device.type == "cpu":
        return flash_attention_reference(query, key, value, causal, sm_scale)
    if query.device.type != "cuda" or key.device != query.device \
            or value.device != query.device:
        raise ValueError("flash_attention: q, k and v must share one CUDA "
                         "device")
    code = _DTYPE_CODES.get(query.dtype)
    if code is None or key.dtype != query.dtype or value.dtype != query.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {query.dtype}/{key.dtype}/"
                        f"{value.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of "
                         f"{_HEAD_DIMS}, got {d}")
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    q, k, v = query.contiguous(), key.contiguous(), value.contiguous()
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash kernel reads 16-byte vectors: q, k and v "
                         "must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if b == 0 or lq == 0:
        return out
    if lk == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, lq, lk, h, hkv, d, code,
                        int(causal), scale, stream)
    _native.check(err, "flash_attention kernel launch")
    launches.count += 1
    return out
