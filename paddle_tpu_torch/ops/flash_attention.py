"""Flash attention: the hand-written Hopper kernels of
``csrc/flash_attention.cu`` (the ports of ``_flash_fwd_kernel``,
``_flash_fwd_kernel_lse``, ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` in ``paddle_tpu/ops/flash_attention.py``, with
their segment-id and dropout variants and ``_keep_tile``) and their plain
PyTorch versions.

Layout is paddle's flash-attention API: q ``(B, Lq, H, D)``, k/v
``(B, Lk, Hkv, D)`` with ``H % Hkv == 0`` (GQA), out ``(B, Lq, H, D)`` in
q's dtype: float32, bfloat16 or float16 (the kernels' dtype codes 0, 1,
2; the 16-bit ones run on wgmma). Causal masking is bottom-right aligned: query row ``i`` sees keys
``j <= i + Lk - Lq``, the KV-cache convention, so one call serves a prefill
(``Lq == Lk``) and a decode over a grown cache (``Lq < Lk``). A row that sees
no key emits 0.

The kernel wrappers :func:`flash_attention_fwd` (forward only, the serving
path), :func:`flash_attention_lse` (forward that also returns the per-row
logsumexp of the scaled logits, ``(B, H, Lq)`` fp32, ``+1e30`` on a row
that sees no key) and :func:`flash_attention_bwd` (dq, then dk/dv, from
that lse) each launch their kernel for CUDA tensors and run their plain
version (``*_reference``) only for CPU tensors. Each takes the variants of
the JAX kernels:

* segment ids ``q_segs (B, Lq)``, ``kv_segs (B, Lk)`` int: row ``i`` sees
  key ``j`` only where the ids are equal (and the causal rule allows);
* attention dropout ``dropout_p`` with a ``seed`` (an int, or a 0-d
  integer tensor whose low 32 bits the kernels read from device memory,
  so a captured graph draws each replay's own): the keep mask is
  :func:`keep_mask_reference`, the lowbias32 hash of ``(seed, b * H + h,
  row, col)`` that ``_keep_tile`` draws, bit for bit; kept probabilities
  are scaled by ``1 / (1 - p)``, the normaliser and the lse stay undropped.
  Dropout always runs with segment ids, zeros where none are given, as
  ``_flash_core_drop`` takes them: the kernels have a ``segs`` and a
  ``segs_drop`` variant, and no dropout-only one.

:class:`FlashAttention` is the ``torch.autograd.Function`` over the forward
with lse and the backward, the counterpart of the JAX package's
``_flash_core``, ``_flash_core_seg`` and ``_flash_core_drop`` custom VJPs;
GQA keeps K/V ungrouped and the dk/dv kernel sums a group's query heads.
:func:`flash_attention` and :func:`flash_attn_unpadded` are the paddle
functions of the JAX package: with dropout (training) the seed is
``fixed_seed_offset``, a draw from the caller's ``torch.Generator``, or
the next device-side seed of a ``DropoutRNG``, never from a global RNG.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import _native
from ._u32 import M32, mul32, seed_tensor, seed_term

__all__ = ["FlashAttention", "VARIANTS", "attention_cost", "attention_pairs",
           "dropout_constants", "dropout_seed",
           "seed_tensor",
           "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_fwd", "flash_attention_lse",
           "flash_attention_lse_reference", "flash_attention_reference",
           "flash_attn_unpadded", "keep_mask_reference", "launches",
           "launches_bwd_dkv", "launches_bwd_dq", "launches_lse",
           "launches_variant"]

launches = _native.LaunchCounter("flash_attention_fwd")
launches_lse = _native.LaunchCounter("flash_attention_fwd_lse")
launches_bwd_dq = _native.LaunchCounter("flash_attention_bwd_dq")
launches_bwd_dkv = _native.LaunchCounter("flash_attention_bwd_dkv")
# the segment-id / dropout instantiations, by (entry point, variant)
VARIANTS = ("segs", "segs_drop")
launches_variant = {
    (e, v): _native.LaunchCounter(f"flash_attention_{e}[{v}]")
    for e in ("fwd", "fwd_lse", "bwd_dq", "bwd_dkv") for v in VARIANTS}

LSE_MASKED = 1e30   # lse of a row that sees no key
# the ids flash_attn_unpadded gives tokens past cu_seqlens[-1]: they match
# nothing (paddle_tpu/ops/flash_attention.py:957-961)
TAIL_Q_SEG, TAIL_KV_SEG = 2147483646, 2147483647
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
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
# <entry>_segdrop(<as entry, without the stream>, q_segs, kv_segs, drop,
# seed (a device pointer to its 32 bits), keep_prob, inv_keep, stream)
_SEGDROP_TAIL = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                 ctypes.c_void_p]
_ARGTYPES_OF = {"flash_fwd": _ARGTYPES, "flash_fwd_lse": _ARGTYPES_LSE,
                "flash_bwd_dq": _ARGTYPES_BWD_DQ,
                "flash_bwd_dkv": _ARGTYPES_BWD_DKV}
_ARGTYPES_OF.update({f"{k}_segdrop": v[:-1] + _SEGDROP_TAIL
                     for k, v in list(_ARGTYPES_OF.items())})


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


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: ``lq * lk``, or where
    causal the pairs at or below the bottom-right diagonal (a row that sees
    no key counts none)."""
    if not causal:
        return lq * lk
    first = max(lk - lq + 1, 1)   # keys the first row that sees one sees
    return (lk * (lk + 1) - (first - 1) * first) // 2


# the cost functions of the four entry points: one launch's (flops, bytes)
# from its shapes. flops: 2 per multiply-add of the products the kernel
# does (QK^T and PV forward; dq adds dP and dS K, dk/dv dS^T Q and P^T dO)
# over the pairs it computes; bytes: q, k, v (and dO, the gradients) once,
# the lse (and delta) rows in fp32, and the segment ids a caller passed
_PRODUCTS = {"fwd": 2, "fwd_lse": 2, "bwd_dq": 3, "bwd_dkv": 4}


def attention_cost(entry: str, b: int, lq: int, lk: int, h: int, hkv: int,
                   d: int, item: int, causal: bool, segs: bool = False):
    """``(flops, bytes)`` of one launch of ``entry`` (``fwd``, ``fwd_lse``,
    ``bwd_dq``, ``bwd_dkv``) on ``item``-byte q, k, v."""
    flops = _PRODUCTS[entry] * 2.0 * b * h * d * attention_pairs(lq, lk,
                                                                  causal)
    q_rows, kv_rows = {"fwd": (2, 2), "fwd_lse": (2, 2), "bwd_dq": (3, 2),
                       "bwd_dkv": (2, 4)}[entry]
    nbytes = item * d * b * (q_rows * lq * h + kv_rows * lk * hkv)
    nbytes += {"fwd": 0, "fwd_lse": 1}.get(entry, 2) * b * h * lq * 4
    if segs:
        nbytes += b * (lq + lk) * 4
    return flops, float(nbytes)


def _launch_cost(entry: str, q, k, causal: bool, segs) -> tuple:
    b, lq, h, d = q.shape
    return attention_cost(entry, b, lq, k.shape[1], h, k.shape[2], d,
                          q.element_size(), causal, segs is not None)


def _kernel_inputs(*xs: torch.Tensor):
    """Check what the CUDA kernels take (one CUDA device, one dtype of
    float32, bfloat16 or float16, a supported head_dim, 16-byte aligned)
    and return the tensors made contiguous and the dtype code."""
    dev, dt = xs[0].device, xs[0].dtype
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError("flash attention: inputs must share one CUDA device")
    code = _DTYPE_CODES.get(dt)
    if code is None or any(x.dtype != dt for x in xs):
        raise TypeError(f"flash kernels take float32, bfloat16 or float16 "
                        f"inputs of one dtype, got {[x.dtype for x in xs]}")
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


def _f32(x: float) -> float:
    """``x`` rounded once to fp32."""
    return torch.tensor(x, dtype=torch.float64).float().item()


def dropout_constants(dropout_p: float):
    """``(keep_prob, inv_keep)``: ``1 - p`` and ``1 / (1 - p)`` taken in
    double and each rounded once to fp32, as JAX rounds the Python floats
    of ``_keep_tile``'s compare and the kernels' scale against fp32
    arrays."""
    if not 0.0 < dropout_p < 1.0:
        raise ValueError(f"dropout_p must lie in (0, 1), got {dropout_p}")
    return _f32(1.0 - dropout_p), _f32(1.0 / (1.0 - dropout_p))


def keep_mask_reference(seed, bh, rows, cols,
                        keep_prob: float) -> torch.Tensor:
    """B0, the plain version of ``_keep_tile``
    (``paddle_tpu/ops/flash_attention.py:47``): the lowbias32 hash of
    ``(seed, bh, row, col)`` (``bh = b * H + h``, rows and columns absolute),
    kept where its top 24 bits times 2^-24 are below ``keep_prob`` (fp32).
    ``seed`` is an int or a 0-d integer tensor (its low 32 bits).
    ``bh``, ``rows`` and ``cols`` are ints or integer tensors that
    broadcast; the result is a bool tensor of their broadcast shape, equal
    bit for bit to what ``_keep_tile`` and the kernels draw."""
    dev = next((x.device for x in (bh, rows, cols)
                if isinstance(x, torch.Tensor)), None)

    def u32(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev) & M32
    h = mul32(u32(rows), 0x9E3779B1) ^ mul32(u32(cols), 0x85EBCA77)
    h = h ^ seed_term(seed, 0xC2B2AE3D, h.device)
    h = h ^ mul32(u32(bh), 0x27D4EB2F)
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    u = (h >> 8).to(torch.float32) * (1.0 / 16777216.0)
    # a Python float compares in u's fp32 (it is one already): no host
    # tensor to copy, so a captured step can draw the mask
    return u < _f32(keep_prob)


def _variant(q_segs, kv_segs, dropout_p: float) -> Optional[str]:
    """The kernel variant a call takes. Dropout always runs with segment
    ids (zeros where none are given, as ``_flash_core_drop`` takes them),
    so there is no dropout-only variant."""
    if (q_segs is None) != (kv_segs is None):
        raise ValueError("pass both q_segs and kv_segs, or neither")
    if dropout_p > 0.0:
        return "segs_drop"
    return "segs" if q_segs is not None else None


def _plain_dtype(device) -> torch.dtype:
    """The plain versions' arithmetic: fp64 on the CPU, fp32 on a card.

    In fp32 a row's result could depend on which thread computed it:
    torch's OpenMP workers keep the floating-point environment of the
    thread that started them, and a worker started under a directed
    rounding mode moved the rows it computed by up to 7.5e-6 (the lse by
    2.9e-6) against the calling thread's. A larger per-row drift (about
    3e-5) once seen with two threads on a loaded host was not reproduced,
    so fp64 guards against this class of drift without being shown to
    cure that case. In fp64 the two threads agree bit for bit once rounded
    to fp32, under every rounding mode. On a card, where the plain
    versions are the kernels' yardstick at sizes whose fp64 intermediates
    would not fit, they stay fp32."""
    return torch.float64 if device.type == "cpu" else torch.float32


def _heads_first(q, k, v):
    """(B, L, H, D) -> (B, H, L, D) in :func:`_plain_dtype`, K/V repeated
    to H heads."""
    h, hkv = q.shape[2], k.shape[2]
    dt = _plain_dtype(q.device)
    qf, kf, vf = (x.to(dt).transpose(1, 2) for x in (q, k, v))
    if hkv != h:
        kf = kf.repeat_interleave(h // hkv, dim=1)
        vf = vf.repeat_interleave(h // hkv, dim=1)
    return qf, kf, vf


def _causal_keep(lq: int, lk: int, device) -> torch.Tensor:
    return torch.ones(lq, lk, dtype=torch.bool, device=device).tril(
        diagonal=lk - lq)


def _visible(lq: int, lk: int, causal: bool, q_segs, kv_segs, device):
    """The (query, key) pairs attention takes, broadcastable to (B, H, Lq,
    Lk): the causal rule and equal segment ids; None when all are."""
    keep = _causal_keep(lq, lk, device) if causal else None
    if q_segs is not None:
        seg = (q_segs.to(device)[:, None, :, None]
               == kv_segs.to(device)[:, None, None, :])
        keep = seg if keep is None else seg & keep
    return keep


def _drop_scale(b: int, h: int, lq: int, lk: int, dropout_p: float,
                seed: int, device) -> torch.Tensor:
    """(B, H, Lq, Lk) fp32: ``inv_keep`` where B0 keeps, 0 where it drops."""
    keep_prob, inv_keep = dropout_constants(dropout_p)
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    keep = keep_mask_reference(seed, ar(b * h).view(b, h, 1, 1),
                               ar(lq).view(1, 1, lq, 1),
                               ar(lk).view(1, 1, 1, lk), keep_prob)
    return keep.float() * inv_keep


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool = False,
                                  sm_scale: Optional[float] = None,
                                  q_segs=None, kv_segs=None,
                                  dropout_p: float = 0.0, seed: int = 0):
    """Plain version of the forward with lse: materialised softmax in
    :func:`_plain_dtype`, rounded once. Returns ``(out (B, Lq, H, D) in
    q's dtype, lse (B, H, Lq) fp32)``; a row that sees no key gets out 0
    and lse ``+1e30``. With dropout, out takes the dropped probabilities
    and the lse the undropped ones."""
    _variant(q_segs, kv_segs, dropout_p)
    b, lq, lk, h = q.shape[0], q.shape[1], k.shape[1], q.shape[2]
    qf, kf, vf = _heads_first(q, k, v)
    logits = (qf @ kf.transpose(-1, -2)) * _scale(q.shape[3], sm_scale)
    keep = _visible(lq, lk, causal, q_segs, kv_segs, q.device)
    if keep is not None:
        logits = logits.masked_fill(~keep, float("-inf"))
        seen = keep.any(-1)
    else:
        seen = torch.ones(lq, dtype=torch.bool, device=q.device)
    lse = torch.logsumexp(logits, dim=-1)
    lse = torch.where(seen, lse, torch.full_like(lse, LSE_MASKED))
    p = torch.exp(logits - lse[..., None])
    if dropout_p > 0.0:
        p = p * _drop_scale(b, h, lq, lk, dropout_p, seed, q.device)
    return (p @ vf).transpose(1, 2).to(q.dtype), lse.float()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              sm_scale: Optional[float] = None,
                              q_segs=None, kv_segs=None,
                              dropout_p: float = 0.0,
                              seed: int = 0) -> torch.Tensor:
    """Plain version: materialised softmax attention in
    :func:`_plain_dtype`, same masking and fully-masked-rows-emit-0
    convention as the kernel (the variants through
    :func:`flash_attention_lse_reference`)."""
    if _variant(q_segs, kv_segs, dropout_p) is not None:
        return flash_attention_lse_reference(q, k, v, causal, sm_scale, q_segs,
                                             kv_segs, dropout_p, seed)[0]
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


def flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                  causal: bool = False,
                                  sm_scale: Optional[float] = None,
                                  q_segs=None, kv_segs=None,
                                  dropout_p: float = 0.0, seed: int = 0):
    """Plain version of the backward: recomputes ``P = exp(S - lse)``
    densely in :func:`_plain_dtype` and returns ``(dq, dk, dv)`` in the
    inputs' dtypes (dk, dv summed over each GQA group). With dropout, dv
    takes the dropped P and dS the dropped dP, ``delta`` the (dropped)
    ``out``."""
    _variant(q_segs, kv_segs, dropout_p)
    b, lq, lk, h, hkv, d = _shapes(q, k, v)
    scale = _scale(d, sm_scale)
    qf, kf, vf = _heads_first(q, k, v)
    dof = dout.to(qf.dtype).transpose(1, 2)
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale
                  - lse.to(qf.dtype)[..., None])
    keep = _visible(lq, lk, causal, q_segs, kv_segs, q.device)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    delta = (dof * out.to(qf.dtype).transpose(1, 2)).sum(-1, keepdim=True)
    dp = dof @ vf.transpose(-1, -2)
    p_drop = p
    if dropout_p > 0.0:
        drop = _drop_scale(b, h, lq, lk, dropout_p, seed, q.device)
        p_drop, dp = p * drop, dp * drop
    ds = p * (dp - delta) * scale
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    dv = p_drop.transpose(-1, -2) @ dof
    if hkv != h:
        dk = dk.view(b, hkv, h // hkv, lk, d).sum(2)
        dv = dv.view(b, hkv, h // hkv, lk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _segdrop_args(q_segs, kv_segs, dropout_p, seed, b, lq, lk, dev):
    """The trailing C arguments of a ``*_segdrop`` entry point (the stream
    excepted) and the tensors they point into, the id tensors and then the
    seed (kept alive by the caller until the launch is queued)."""
    if q_segs is None:   # dropout alone: zeros, one segment, no masking
        q_segs = torch.zeros(b, lq, dtype=torch.int32, device=dev)
        kv_segs = torch.zeros(b, lk, dtype=torch.int32, device=dev)
    segs = tuple(s.to(device=dev, dtype=torch.int32).contiguous()
                 for s in (q_segs, kv_segs))
    if segs[0].shape != (b, lq) or segs[1].shape != (b, lk):
        raise ValueError(f"segment ids must be (B, Lq) = {(b, lq)} and "
                         f"(B, Lk) = {(b, lk)}; got "
                         f"{tuple(segs[0].shape)}, {tuple(segs[1].shape)}")
    keep_prob, inv_keep = (dropout_constants(dropout_p) if dropout_p > 0.0
                           else (1.0, 1.0))
    seed_t = seed_tensor(seed, dev)
    ptrs = tuple(s.data_ptr() for s in segs)
    return (*ptrs, int(dropout_p > 0.0), seed_t.data_ptr(), keep_prob,
            inv_keep), (*segs, seed_t)


def flash_attention_fwd(query: torch.Tensor, key: torch.Tensor,
                        value: torch.Tensor, causal: bool = False,
                        sm_scale: Optional[float] = None, q_segs=None,
                        kv_segs=None, dropout_p: float = 0.0,
                        seed: int = 0) -> torch.Tensor:
    """Attention forward through the flash kernel (CUDA) or its plain
    version (CPU)."""
    b, lq, lk, h, hkv, d = _shapes(query, key, value)
    variant = _variant(q_segs, kv_segs, dropout_p)
    if query.device.type == "cpu":
        return flash_attention_reference(query, key, value, causal, sm_scale,
                                         q_segs, kv_segs, dropout_p, seed)
    (q, k, v), code = _kernel_inputs(query, key, value)
    scale = _scale(d, sm_scale)
    out = torch.empty_like(q)
    if b == 0 or lq == 0:
        return out
    if lk == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if variant is None:
            err = _kernel("flash_fwd")(q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), out.data_ptr(), b, lq, lk,
                                       h, hkv, d, code, int(causal), scale,
                                       stream)
        else:
            extra, _segs = _segdrop_args(q_segs, kv_segs, dropout_p,
                                         seed, b, lq, lk, q.device)
            err = _kernel("flash_fwd_segdrop")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                lq, lk, h, hkv, d, code, int(causal), scale, *extra, stream)
    _native.check(err, "flash_attention kernel launch")
    (launches if variant is None
     else launches_variant["fwd", variant]).launched(
        1, _launch_cost, "fwd", q, k, causal, q_segs)
    return out


def flash_attention_lse(query: torch.Tensor, key: torch.Tensor,
                        value: torch.Tensor, causal: bool = False,
                        sm_scale: Optional[float] = None, q_segs=None,
                        kv_segs=None, dropout_p: float = 0.0, seed: int = 0):
    """Forward that also returns the lse: ``(out, lse (B, H, Lq) fp32)``,
    through the kernel (CUDA) or its plain version (CPU)."""
    b, lq, lk, h, hkv, d = _shapes(query, key, value)
    variant = _variant(q_segs, kv_segs, dropout_p)
    if query.device.type == "cpu":
        return flash_attention_lse_reference(query, key, value, causal,
                                             sm_scale, q_segs, kv_segs,
                                             dropout_p, seed)
    (q, k, v), code = _kernel_inputs(query, key, value)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if b == 0 or lq == 0:
        return out, lse
    if lk == 0:
        return out.zero_(), lse.fill_(LSE_MASKED)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, lq, lk, h, hkv, d, code, int(causal),
            _scale(d, sm_scale))
    with torch.cuda.device(q.device):
        if variant is None:
            err = _kernel("flash_fwd_lse")(*args, stream)
        else:
            extra, _segs = _segdrop_args(q_segs, kv_segs, dropout_p,
                                         seed, b, lq, lk, q.device)
            err = _kernel("flash_fwd_lse_segdrop")(*args, *extra, stream)
    _native.check(err, "flash_attention_lse kernel launch")
    (launches_lse if variant is None
     else launches_variant["fwd_lse", variant]).launched(
        1, _launch_cost, "fwd_lse", q, k, causal, q_segs)
    return out, lse


def flash_attention_bwd(query, key, value, out, lse, dout,
                        causal: bool = False,
                        sm_scale: Optional[float] = None, q_segs=None,
                        kv_segs=None, dropout_p: float = 0.0, seed: int = 0):
    """``(dq, dk, dv)`` of attention from the forward's ``out`` and ``lse``:
    the dq kernel, then the dk/dv kernel (CUDA), or the plain version (CPU).
    ``delta = rowsum(dout * out)`` is taken here in fp32, as the JAX package
    takes it outside its kernels. The variant arguments must be the
    forward's."""
    b, lq, lk, h, hkv, d = _shapes(query, key, value)
    variant = _variant(q_segs, kv_segs, dropout_p)
    if out.shape != query.shape or dout.shape != query.shape \
            or lse.shape != (b, h, lq):
        raise ValueError(f"flash_attention_bwd: out/dout must be "
                         f"{tuple(query.shape)} and lse {(b, h, lq)}; got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    if query.device.type == "cpu":
        return flash_attention_bwd_reference(query, key, value, out, lse,
                                             dout, causal, sm_scale, q_segs,
                                             kv_segs, dropout_p, seed)
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
    dims = (b, lq, lk, h, hkv, d, code, int(causal), scale)
    extra, suffix = (), ""
    if variant is not None:
        extra, _segs = _segdrop_args(q_segs, kv_segs, dropout_p,
                                     seed, b, lq, lk, q.device)
        suffix = "_segdrop"
    counters = ((launches_bwd_dq, launches_bwd_dkv) if variant is None else
                (launches_variant["bwd_dq", variant],
                 launches_variant["bwd_dkv", variant]))
    with torch.cuda.device(q.device):
        err = _kernel("flash_bwd_dq" + suffix)(
            *ptrs, dq.data_ptr(), *dims, *extra, stream)
        _native.check(err, "flash_attention_bwd dq kernel launch")
        counters[0].launched(1, _launch_cost, "bwd_dq", q, k, causal,
                             q_segs)
        err = _kernel("flash_bwd_dkv" + suffix)(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, *extra, stream)
        _native.check(err, "flash_attention_bwd dk/dv kernel launch")
        counters[1].launched(1, _launch_cost, "bwd_dkv", q, k, causal,
                             q_segs)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a flash backward: the forward saves ``(q, k, v, out,
    lse)`` (and the segment ids; the seed, an int or a device tensor that
    the backward reads again); the backward runs the
    dq kernel, then the dk/dv kernel (their plain versions on the CPU).
    ``FlashAttention.apply(q, k, v, causal, sm_scale[, q_segs, kv_segs,
    dropout_p, seed])``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False,
                sm_scale: Optional[float] = None, q_segs=None, kv_segs=None,
                dropout_p: float = 0.0, seed: int = 0):
        out, lse = flash_attention_lse(q, k, v, causal, sm_scale, q_segs,
                                       kv_segs, dropout_p, seed)
        segs = (q_segs, kv_segs) if q_segs is not None else ()
        ctx.save_for_backward(q, k, v, out, lse, *segs)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.dropout_p, ctx.seed = dropout_p, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, *segs = ctx.saved_tensors
        q_segs, kv_segs = segs if segs else (None, None)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.causal, ctx.sm_scale, q_segs,
                                         kv_segs, ctx.dropout_p, ctx.seed)
        return dq, dk, dv, None, None, None, None, None, None


def dropout_seed(fixed_seed_offset, generator):
    """The dropout seed, the counterpart of ``_dropout_seed``
    (``paddle_tpu/ops/flash_attention.py:561``): ``fixed_seed_offset`` when
    given (an int, or a one-element tensor kept as a tensor: no host
    read), else the next device-side seed of a ``DropoutRNG``
    (``generator.next_seed()``: a 0-d tensor, no host read, what a
    captured step needs), else one draw from a ``torch.Generator`` (an
    int; a CPU generator draws without a device sync)."""
    if fixed_seed_offset is not None:
        if isinstance(fixed_seed_offset, torch.Tensor):
            return fixed_seed_offset.reshape(-1)[0].to(torch.int64) & M32
        return int(fixed_seed_offset)
    if generator is None:
        raise ValueError("attention dropout needs fixed_seed_offset or a "
                         "torch.Generator / DropoutRNG: the port never "
                         "draws from a global RNG")
    if hasattr(generator, "next_seed"):
        return generator.next_seed()
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device))


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    fixed_seed_offset=None, rng_name: str = "",
                    training: bool = True, q_segment_ids=None,
                    kv_segment_ids=None, name=None, *,
                    sm_scale: Optional[float] = None,
                    generator=None):
    """``paddle.nn.functional.flash_attention`` with the JAX package's
    signature (``paddle_tpu/ops/flash_attention.py:833``). Inputs ``(B, L,
    H, D)``; ``q_segment_ids`` / ``kv_segment_ids`` ``(B, L)`` restrict
    row ``i`` to the keys of its own segment. With ``dropout > 0`` and
    ``training`` the probabilities are dropped in the kernels (B0), always
    with segment ids, zeros where none are given, as ``_flash_core_drop``
    takes them; the seed is ``fixed_seed_offset`` or comes from
    ``generator``, a ``DropoutRNG`` or a ``torch.Generator`` (port
    extension, like ``sm_scale``; see :func:`dropout_seed`). When autograd
    records the call it goes through :class:`FlashAttention`, otherwise to
    the forward-only kernel."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or "
                         "neither")
    q_segs, kv_segs = q_segment_ids, kv_segment_ids
    p = float(dropout) if dropout > 0.0 and training else 0.0
    seed = 0
    if p > 0.0:
        seed = dropout_seed(fixed_seed_offset, generator)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (query, key, value)):
        out = FlashAttention.apply(query, key, value, causal, sm_scale,
                                   q_segs, kv_segs, p, seed)
    else:
        out = flash_attention_fwd(query, key, value, causal, sm_scale, q_segs,
                                  kv_segs, p, seed)
    return (out, None) if return_softmax else out


def _unpadded_seg_ids(cu_seqlens: torch.Tensor, total: int,
                      tail: int) -> torch.Tensor:
    """(1, total) int32: token ``i`` belongs to sequence
    ``searchsorted(cu[1:], i, right)``; tokens at or past ``cu[-1]`` get
    ``tail``. On the device, with no host read."""
    cu = cu_seqlens.to(torch.int64)
    ids = torch.arange(total, device=cu.device)
    seg = torch.searchsorted(cu[1:], ids, right=True)
    seg = torch.where(ids < cu[-1], seg, tail)
    return seg.to(torch.int32)[None]


def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                        max_seqlen_k, scale=None, dropout: float = 0.0,
                        causal: bool = False, return_softmax: bool = False,
                        fixed_seed_offset=None, rng_name: str = "",
                        training: bool = True, name=None, *,
                        generator=None):
    """``paddle.nn.functional.flash_attn_unpadded`` as the JAX package runs
    it (``paddle_tpu/ops/flash_attention.py:917``): the packed ``(total, H,
    D)`` tokens are one batch row whose segment ids come from
    ``cu_seqlens`` on the device; ``causal`` applies within each sequence.
    ``max_seqlen_*`` are unused. Returns ``(total_q, H, D)``."""
    total_q, total_k = q.shape[0], k.shape[0]
    qs = _unpadded_seg_ids(cu_seqlens_q.to(q.device), total_q, TAIL_Q_SEG)
    ks = _unpadded_seg_ids(cu_seqlens_k.to(q.device), total_k, TAIL_KV_SEG)
    out = flash_attention(q[None], k[None], v[None], dropout, causal, False,
                          fixed_seed_offset, rng_name, training, qs, ks,
                          sm_scale=float(scale) if scale else None,
                          generator=generator)[0]
    return (out, None) if return_softmax else out
