"""Fused int8-state AdamW update: the hand-written Hopper kernel
(``csrc/q8_adam.cu``, the port of ``_kernel`` in
``paddle_tpu/ops/q8_adam_pallas.py``) and its plain PyTorch version, with
the port's copies of the JAX optimizer's int8 helpers (``_q8_quantize``,
``_q8_dequantize``, ``_stochastic_round_bf16`` in
``paddle_tpu/optimizer/__init__.py``).

State layout (the JAX package's): per parameter of ``n`` elements,
``nb = ceil(n / 2048)`` blocks; codes ``m_q``, ``v_q`` int8 ``(nb, 2048)``
(``v_q`` holds sqrt(v)), scales ``m_s``, ``v_s`` fp32 ``(nb,)``, each the
block's absmax / 127 (1 where the block is 0). The update works in place
on the codes, the scales and ``base`` (the parameter or its fp32 master).

Stochastic rounding of a bf16 ``base`` adds 16 bits to the fp32 result
below the bf16 mantissa and truncates (the JAX rule). The JAX kernel drew
the bits from the TPU's on-core PRNG; here they are :func:`sr_bits`, a
counter-based hash of ``(seed, element index)`` that the CUDA source
computes identically, so the plain version reproduces the kernel bit for
bit.

:func:`q8_adam_update` launches the kernel for CUDA tensors and runs
:func:`q8_adam_update_reference` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import _native

__all__ = ["Q8_BLOCK", "launches", "q8_adam_update",
           "q8_adam_update_reference", "q8_dequantize", "q8_quantize",
           "sr_bits", "stochastic_round_bf16"]

Q8_BLOCK = 2048
launches = _native.LaunchCounter("q8_adam")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF
# q8_adam(m_q, m_s, v_q, v_s, base, grad, n, nb, base_dtype, grad_dtype,
#         lr, decay, c1, c2, eps, b1, b2, omb1, omb2, has_wd, use_sr, seed,
#         stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 9 \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.cache
def _kernel():
    fn = _native.load("q8_adam").q8_adam
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def q8_quantize(x32: torch.Tensor, block: int = Q8_BLOCK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax int8 quantization of an fp32 tensor (zero-padded to
    whole blocks): ``(q int8 (nb, block), scale fp32 (nb,))``."""
    flat = x32.reshape(-1).float()
    n = flat.numel()
    nb = -(-n // block)
    blocks = torch.nn.functional.pad(flat, (0, nb * block - n)).view(nb, block)
    scale = blocks.abs().amax(dim=1) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(blocks / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def q8_dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = math.prod(int(s) for s in shape)
    return (q.float() * scale[:, None]).reshape(-1)[:n].reshape(shape)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for ``h`` in [0, 2^32) held in int64, in two
    16-bit halves of ``c`` so that no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def sr_bits(seed: int, n: int, device=None) -> torch.Tensor:
    """The 16 rounding bits of elements ``0 .. n-1`` under ``seed``: the
    lowbias32 finalizer over ``idx * 0x9E3779B1 ^ seed * 0xC2B2AE3D``, top
    16 bits (``csrc/q8_adam.cu: sr_bits``). int64 values in [0, 2^16)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    h = _mul32(idx, 0x9E3779B1) ^ ((int(seed) * 0xC2B2AE3D) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h >> 16


def stochastic_round_bf16(x32: torch.Tensor, bits: torch.Tensor
                          ) -> torch.Tensor:
    """Round fp32 to bf16 stochastically: add the low 16 of ``bits`` (any
    integer tensor of x's shape, read as uint32) to x's bit pattern,
    truncate to the bf16 mantissa, pass non-finite values through (inf
    stays inf, NaN becomes the quiet NaN ``0x7FC0`` with x's sign, as
    XLA's cast gives it). The rule of
    ``paddle_tpu.optimizer._stochastic_round_bf16`` with its random bits
    given, computed on bit patterns so that the CUDA kernel matches it bit
    for bit."""
    x32 = x32.float().contiguous()
    xb = x32.view(torch.int32).to(torch.int64) & _M32
    hi = ((xb + (bits.to(torch.int64) & 0xFFFF)) & _M32) >> 16
    hi = torch.where(torch.isinf(x32), xb >> 16, hi)
    hi = torch.where(torch.isnan(x32), (xb >> 16) & 0x8000 | 0x7FC0, hi)
    hi = torch.where(hi >= 2 ** 15, hi - 2 ** 16, hi)
    return hi.to(torch.int16).view(torch.bfloat16)


def _scalar(x: float, device) -> torch.Tensor:
    # a 0-dim tensor on the data's device: each op then divides and
    # multiplies exactly as the kernel's round-to-nearest intrinsics do (a
    # Python scalar divisor may become a reciprocal product on the card)
    return torch.tensor(x, dtype=torch.float32, device=device)


def q8_adam_update_reference(m_q, m_s, v_q, v_s, base, grad, *, lr: float,
                             c1: float, c2: float, eps: float, beta1: float,
                             beta2: float, decay: Optional[float] = None,
                             seed: int = 0, use_sr: bool = False) -> None:
    """Plain version of the int8 AdamW step, in place, with the kernel's
    operations in the kernel's order. ``decay`` is ``1 - lr * wd`` (None:
    no weight decay); ``c1 = 1 - beta1^t``, ``c2 = 1 - beta2^t``."""
    dev = base.device
    s = lambda x: _scalar(x, dev)  # noqa: E731
    nb = m_q.shape[0]
    n = base.numel()
    g = torch.zeros(nb * Q8_BLOCK, dtype=torch.float32, device=dev)
    g[:n] = grad.reshape(-1).float()
    g = g.view(nb, Q8_BLOCK)
    m32 = m_q.float() * m_s[:, None]
    sv = v_q.float() * v_s[:, None]
    v32 = sv * sv
    nm = s(beta1) * m32 + s(1.0 - beta1) * g
    nv = s(beta2) * v32 + s(1.0 - beta2) * g * g
    sq = torch.sqrt(nv)
    one, c127 = s(1.0), s(127.0)
    msc = nm.abs().amax(dim=1) / c127
    msc = torch.where(msc == 0, one, msc)
    vsc = sq.amax(dim=1) / c127
    vsc = torch.where(vsc == 0, one, vsc)
    m_q.copy_(torch.round(nm / msc[:, None]).clamp(-127, 127).to(torch.int8))
    v_q.copy_(torch.round(sq / vsc[:, None]).clamp(-127, 127).to(torch.int8))
    m_s.copy_(msc)
    v_s.copy_(vsc)
    nm, nv = nm.view(-1)[:n], nv.view(-1)[:n]
    upd = base.reshape(-1).float()
    if decay is not None:
        upd = upd * s(decay)
    upd = upd - s(lr) * (nm / s(c1)) / (torch.sqrt(nv / s(c2)) + s(eps))
    flat = base.view(-1)
    if use_sr:
        flat.copy_(stochastic_round_bf16(upd, sr_bits(seed, n, dev)))
    else:
        flat.copy_(upd)


def q8_adam_update(m_q, m_s, v_q, v_s, base, grad, *, lr: float, c1: float,
                   c2: float, eps: float, beta1: float, beta2: float,
                   decay: Optional[float] = None, seed: int = 0,
                   use_sr: bool = False) -> None:
    """One int8 AdamW step in place: the kernel (CUDA) or its plain
    version (CPU). ``base`` and ``grad`` are contiguous with ``n`` elements
    each (fp32 or bf16), ``m_q``/``v_q`` int8 ``(ceil(n / 2048), 2048)``,
    ``m_s``/``v_s`` fp32; ``use_sr`` needs a bf16 ``base``."""
    n = base.numel()
    nb = -(-n // Q8_BLOCK)
    if grad.numel() != n or n == 0:
        raise ValueError(f"q8_adam_update: base has {n} elements, grad "
                         f"{grad.numel()}")
    for name, t, dt, shape in (("m_q", m_q, torch.int8, (nb, Q8_BLOCK)),
                               ("v_q", v_q, torch.int8, (nb, Q8_BLOCK)),
                               ("m_s", m_s, torch.float32, (nb,)),
                               ("v_s", v_s, torch.float32, (nb,))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"q8_adam_update: {name} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if use_sr and base.dtype != torch.bfloat16:
        raise TypeError("q8_adam_update: stochastic rounding writes a "
                        "bfloat16 base")
    scalars = dict(lr=lr, c1=c1, c2=c2, eps=eps, beta1=beta1, beta2=beta2,
                   decay=decay, seed=seed, use_sr=use_sr)
    if base.device.type == "cpu":
        q8_adam_update_reference(m_q, m_s, v_q, v_s, base, grad, **scalars)
        return
    xs = (m_q, m_s, v_q, v_s, base, grad)
    if base.device.type != "cuda" or any(t.device != base.device for t in xs):
        raise ValueError("q8_adam_update: all tensors must share one CUDA "
                         "device")
    bcode, gcode = _DTYPE_CODES.get(base.dtype), _DTYPE_CODES.get(grad.dtype)
    if bcode is None or gcode is None:
        raise TypeError(f"q8 kernel takes float32 or bfloat16 base and grad, "
                        f"got {base.dtype}, {grad.dtype}")
    if not all(t.is_contiguous() for t in xs):
        raise ValueError("q8_adam_update: tensors must be contiguous (the "
                         "update is in place)")
    if any(t.data_ptr() % 16 for t in xs):
        raise ValueError("q8 kernel reads 16-byte vectors: tensors must "
                         "start on a 16-byte boundary")
    stream = torch.cuda.current_stream(base.device).cuda_stream
    with torch.cuda.device(base.device):
        err = _kernel()(
            m_q.data_ptr(), m_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
            base.data_ptr(), grad.data_ptr(), n, nb, bcode, gcode,
            lr, 1.0 if decay is None else decay, c1, c2, eps, beta1, beta2,
            1.0 - beta1, 1.0 - beta2, int(decay is not None),
            int(use_sr), int(seed), stream)
    _native.check(err, "q8_adam kernel launch")
    launches.count += 1
