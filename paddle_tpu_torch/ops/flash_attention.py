"""Flash attention: the hand-written Hopper kernels of
``csrc/flash_attention.cu`` (the ports of ``_flash_fwd_kernel``,
``_flash_fwd_kernel_lse``, ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` in ``paddle_tpu/ops/flash_attention.py``) and
their plain PyTorch versions.

Layout is paddle's flash-attention API: q ``(B, Lq, H, D)``, k/v
``(B, Lk, Hkv, D)`` with ``H % Hkv == 0`` (GQA), out ``(B, Lq, H, D)`` in
q's dtype. Causal masking is bottom-right aligned: query row ``i`` sees keys
``j <= i + Lk - Lq``, the KV-cache convention, so one call serves a prefill
(``Lq == Lk``) and a decode over a grown cache (``Lq < Lk``). A row that sees
no key emits 0.

:func:`flash_attention` (forward only, the serving path),
:func:`flash_attention_lse` (forward that also returns the per-row
logsumexp of the scaled logits, ``(B, H, Lq)`` fp32, ``+1e30`` on a row
that sees no key) and :func:`flash_attention_bwd` (dq, then dk/dv, from
that lse) each launch their kernel for CUDA tensors and run their plain
version (``*_reference``) only for CPU tensors. :class:`FlashAttention` is
the ``torch.autograd.Function`` over the last two, the counterpart of the
JAX package's ``_flash_core`` custom VJP; GQA keeps K/V ungrouped and the
dk/dv kernel sums a group's query heads. Segment ids and dropout are not
ported.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import _native

__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_lse",
           "flash_attention_lse_reference", "flash_attention_reference",
           "launches", "launches_bwd_dkv", "launches_bwd_dq", "launches_lse"]

launches = _native.LaunchCounter("flash_attention_fwd")
launches_lse = _native.LaunchCounter("flash_attention_fwd_lse")
launches_bwd_dq = _native.LaunchCounter("flash_attention_bwd_dq")
launches_bwd_dkv = _native.LaunchCounter("flash_attention_bwd_dkv")

LSE_MASKED = 1e30   # lse of a row that sees no key
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_DIMS = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
# flash_fwd(q, k, v, o, B, Lq, Lk, H, Hkv, D, dtype, causal, sm_scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + _DIMS
# flash_fwd_lse(q, k, v, o, lse, <as flash_fwd>)
_ARGTYPES_LSE = [ctypes.c_void_p] * 5 + _DIMS
# flash_bwd_dq(q, k, v, dout, lse, delta, dq, <as flash_fwd>)
_ARGTYPES_BWD_DQ = [ctypes.c_void_p] * 7 + _DIMS
# flash_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, <as flash_fwd>)
_ARGTYPES_BWD_DKV = [ctypes.c_void_p] * 8 + _DIMS
_ARGTYPES_OF = {"flash_fwd": _ARGTYPES, "flash_fwd_lse": _ARGTYPES_LSE,
                 "flash_bwd_dq": _ARGTYPES_BWD_DQ,
                 "flash_bwd_dkv": _ARGTYPES_BWD_DKV}


@functools.cache
def _kernel(name: str):
    """The C entry point ``name``, bound once: a serving step launches the
    kernels thousands of times, and a lookup that sets ``argtypes`` on every
    launch is host time the card waits for."""
    fn = getattr(_native.load("flash_attention"), name)
    fn.argtypes = _ARGTYPES_OF[name]
    fn.restype = ctypes.c_int
    return fn


def _shapes(query, key, value):
    if query.dim() != 4 or key.dim() != 4 or key.shape != value.shape:
        raise ValueError(f"flash attention wants q (B, Lq, H, D) and k/v "
                         f"(B, Lk, Hkv, D); got {tuple(query.shape)}, "
                         f"{tuple(key.shape)}, {tuple(value.shape)}")
    b, lq, h, d = query.shape
    lk, hkv = key.shape[1], key.shape[2]
    if key.shape[0] != b or key.shape[3] != d or h % hkv != 0:
        raise ValueError(f"incompatible q {tuple(query.shape)} and k/v "
                         f"{tuple(key.shape)}")
    return b, lq, lk, h, hkv, d


def _kernel_inputs(*xs: torch.Tensor):
    """Check what the CUDA kernels take (one CUDA device, one dtype of
    float32 or bfloat16, a supported head_dim, 16-byte aligned) and return
    the tensors made contiguous and the dtype code."""
    dev, dt = xs[0].device, xs[0].dtype
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError("flash attention: inputs must share one CUDA device")
    code = _DTYPE_CODES.get(dt)
    if code is None or any(x.dtype != dt for x in xs):
        raise TypeError(f"flash kernels take float32 or bfloat16 inputs of "
                        f"one dtype, got {[x.dtype for x in xs]}")
    d = xs[0].shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of "
                         f"{_HEAD_DIMS}, got {d}")
    xs = tuple(x.contiguous() for x in xs)
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("flash kernels read 16-byte vectors: inputs must "
                         "start on a 16-byte boundary")
    return xs, code


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _heads_first(q, k, v):
    """(B, L, H, D) -> fp32 (B, H, L, D), K/V repeated to H heads."""
    h, hkv = q.shape[2], k.shape[2]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    if hkv != h:
        kf = kf.repeat_interleave(h // hkv, dim=1)
        vf = vf.repeat_interleave(h // hkv, dim=1)
    return qf, kf, vf


def _causal_keep(lq: int, lk: int, device) -> torch.Tensor:
    return torch.ones(lq, lk, dtype=torch.bool, device=device).tril(
        diagonal=lk - lq)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Plain version: materialised fp32 softmax attention, same masking and
    fully-masked-rows-emit-0 convention as the kernel."""
    lq, lk = q.shape[1], k.shape[1]
    qf, kf, vf = _heads_first(q, k, v)
    logits = (qf @ kf.transpose(-1, -2)) * _scale(q.shape[3], sm_scale)
    if causal:
        keep = _causal_keep(lq, lk, q.device)
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
    b, lq, lk, h, hkv, d = _shapes(query, key, value)
    if query.device.type == "cpu":
        return flash_attention_reference(query, key, value, causal, sm_scale)
    (q, k, v), code = _kernel_inputs(query, key, value)
    scale = _scale(d, sm_scale)
    out = torch.empty_like(q)
    if b == 0 or lq == 0:
        return out
    if lk == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel("flash_fwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), b, lq, lk, h, hkv, d, code,
                                   int(causal), scale, stream)
    _native.check(err, "flash_attention kernel launch")
    launches.count += 1
    return out


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool = False,
                                  sm_scale: Optional[float] = None):
    """Plain version of the forward with lse: materialised fp32 softmax.
    Returns ``(out (B, Lq, H, D) in q's dtype, lse (B, H, Lq) fp32)``; a row
    that sees no key gets out 0 and lse ``+1e30``."""
    lq, lk = q.shape[1], k.shape[1]
    qf, kf, vf = _heads_first(q, k, v)
    logits = (qf @ kf.transpose(-1, -2)) * _scale(q.shape[3], sm_scale)
    if causal:
        keep = _causal_keep(lq, lk, q.device)
        logits = logits.masked_fill(~keep, float("-inf"))
        seen = keep.any(-1)
    else:
        seen = torch.ones(lq, dtype=torch.bool, device=q.device)
    lse = torch.logsumexp(logits, dim=-1)
    lse = torch.where(seen, lse, torch.full_like(lse, LSE_MASKED))
    p = torch.exp(logits - lse[..., None])
    return (p @ vf).transpose(1, 2).to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                  causal: bool = False,
                                  sm_scale: Optional[float] = None):
    """Plain version of the backward: recomputes ``P = exp(S - lse)``
    densely in fp32 and returns ``(dq, dk, dv)`` in the inputs' dtypes
    (dk, dv summed over each GQA group)."""
    b, lq, lk, h, hkv, d = _shapes(q, k, v)
    scale = _scale(d, sm_scale)
    qf, kf, vf = _heads_first(q, k, v)
    dof = dout.float().transpose(1, 2)
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(lq, lk, q.device), 0.0)
    delta = (dof * out.float().transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    dv = p.transpose(-1, -2) @ dof
    if hkv != h:
        dk = dk.view(b, hkv, h // hkv, lk, d).sum(2)
        dv = dv.view(b, hkv, h // hkv, lk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def flash_attention_lse(query: torch.Tensor, key: torch.Tensor,
                        value: torch.Tensor, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Forward that also returns the lse: ``(out, lse (B, H, Lq) fp32)``,
    through the kernel (CUDA) or its plain version (CPU)."""
    b, lq, lk, h, hkv, d = _shapes(query, key, value)
    if query.device.type == "cpu":
        return flash_attention_lse_reference(query, key, value, causal,
                                             sm_scale)
    (q, k, v), code = _kernel_inputs(query, key, value)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if b == 0 or lq == 0:
        return out, lse
    if lk == 0:
        return out.zero_(), lse.fill_(LSE_MASKED)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel("flash_fwd_lse")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, lq, lk, h, hkv, d, code, int(causal),
            _scale(d, sm_scale), stream)
    _native.check(err, "flash_attention_lse kernel launch")
    launches_lse.count += 1
    return out, lse


def flash_attention_bwd(query, key, value, out, lse, dout,
                        causal: bool = False,
                        sm_scale: Optional[float] = None):
    """``(dq, dk, dv)`` of attention from the forward's ``out`` and ``lse``:
    the dq kernel, then the dk/dv kernel (CUDA), or the plain version (CPU).
    ``delta = rowsum(dout * out)`` is taken here in fp32, as the JAX package
    takes it outside its kernels."""
    b, lq, lk, h, hkv, d = _shapes(query, key, value)
    if out.shape != query.shape or dout.shape != query.shape \
            or lse.shape != (b, h, lq):
        raise ValueError(f"flash_attention_bwd: out/dout must be "
                         f"{tuple(query.shape)} and lse {(b, h, lq)}; got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    if query.device.type == "cpu":
        return flash_attention_bwd_reference(query, key, value, out, lse,
                                             dout, causal, sm_scale)
    (q, k, v, o, do), code = _kernel_inputs(query, key, value, out, dout)
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise TypeError("flash_attention_bwd: lse must be fp32 on q's device")
    lse = lse.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or lq == 0 or lk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scale = _scale(d, sm_scale)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dims = (b, lq, lk, h, hkv, d, code, int(causal), scale, stream)
    with torch.cuda.device(q.device):
        err = _kernel("flash_bwd_dq")(
            *ptrs, dq.data_ptr(), *dims)
        _native.check(err, "flash_attention_bwd dq kernel launch")
        launches_bwd_dq.count += 1
        err = _kernel("flash_bwd_dkv")(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *dims)
        _native.check(err, "flash_attention_bwd dk/dv kernel launch")
        launches_bwd_dkv.count += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a flash backward: the forward saves ``(q, k, v, out,
    lse)``; the backward runs the dq kernel, then the dk/dv kernel (their
    plain versions on the CPU). ``FlashAttention.apply(q, k, v, causal,
    sm_scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False,
                sm_scale: Optional[float] = None):
        out, lse = flash_attention_lse(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None
