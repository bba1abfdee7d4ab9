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

The step's scalars, lr, ``decay = 1 - lr * wd``, the bias corrections
``c1``, ``c2`` and the NaN gate, are a block of fp32 on the device
(:func:`scalar_block`, layout ``SCALARS``) that the kernel reads from
memory, as it reads the rounding seed (a 0-d integer tensor): the
optimizer fills the block each step from its step-count and LR tensors, so
a captured CUDA graph reads each replay's own values. Where the gate is 0
the update writes nothing. A caller with plain floats builds the block
with :func:`scalar_block`.

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
from ._u32 import M32, mul32, seed_tensor, seed_term

__all__ = ["Q8_BLOCK", "SCALARS", "launches", "q8_adam_cost", "q8_adam_update",
           "q8_adam_update_reference", "q8_dequantize", "q8_quantize",
           "scalar_block", "sqrt_rn", "sr_bits", "stochastic_round_bf16"]

Q8_BLOCK = 2048
launches = _native.LaunchCounter("q8_adam")

# the device scalar block of an AdamW step, in this order: this kernel
# reads the first five, the multi-tensor one (ops/multi_tensor_adam.py) all
SCALARS = ("lr", "decay", "c1", "c2", "gate", "grad_scale")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# q8_adam(m_q, m_s, v_q, v_s, base, grad, n, nb, base_dtype, grad_dtype,
#         scalars, eps, b1, b2, omb1, omb2, has_wd, use_sr, seed, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] \
    + [ctypes.c_float] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


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


def sr_bits(seed, n: int, device=None, base: int = 0) -> torch.Tensor:
    """The 16 rounding bits of elements ``base .. base + n - 1`` under
    ``seed`` (an int or a 0-d integer tensor, its low 32 bits): the
    lowbias32 finalizer over ``lo * 0x9E3779B1 ^ hi * 0x85EBCA77 ^ seed *
    0xC2B2AE3D``, ``lo`` and ``hi`` the 64-bit index's words, top 16 bits
    (``csrc/q8_adam.cu: sr_bits``, whose indices stay below 2^32, and
    ``csrc/multi_tensor_adam.cu: flat_sr_bits``, of flat indices). int64
    values in [0, 2^16)."""
    idx = torch.arange(n, dtype=torch.int64, device=device) + int(base)
    h = mul32(idx & M32, 0x9E3779B1) ^ mul32(idx >> 32, 0x85EBCA77) \
        ^ seed_term(seed, 0xC2B2AE3D, device)
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul32(h, 0x846CA68B)
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
    xb = x32.view(torch.int32).to(torch.int64) & M32
    hi = ((xb + (bits.to(torch.int64) & 0xFFFF)) & M32) >> 16
    hi = torch.where(torch.isinf(x32), xb >> 16, hi)
    hi = torch.where(torch.isnan(x32), (xb >> 16) & 0x8000 | 0x7FC0, hi)
    hi = torch.where(hi >= 2 ** 15, hi - 2 ** 16, hi)
    return hi.to(torch.int16).view(torch.bfloat16)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``sqrt`` rounded to nearest, as the kernels' ``__fsqrt_rn``
    and XLA give it. A CPU tensor's is taken in fp64 and rounded once:
    PyTorch's fp32 ``sqrt`` on the CPU goes through MKL, whose AVX-512 path
    is an ulp off on some inputs, and not on every process alike."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _scalar(x: float, device) -> torch.Tensor:
    # a 0-dim tensor on the data's device: each op then divides and
    # multiplies exactly as the kernel's round-to-nearest intrinsics do (a
    # Python scalar divisor may become a reciprocal product on the card)
    return torch.tensor(x, dtype=torch.float32, device=device)


def scalar_block(lr: float, c1: float, c2: float,
                 decay: Optional[float] = None, gate: float = 1.0,
                 grad_scale: float = 1.0, device=None) -> torch.Tensor:
    """The device scalar block (``SCALARS`` order) of plain floats, each
    rounded once to fp32 (``decay`` None: 1, unused without weight
    decay)."""
    return torch.tensor([lr, 1.0 if decay is None else decay, c1, c2, gate,
                         grad_scale], dtype=torch.float32, device=device)


def _check_scalars(scalars: torch.Tensor, device) -> torch.Tensor:
    if scalars.dtype != torch.float32 or scalars.numel() < 5:
        raise ValueError(f"q8_adam_update: scalars must be fp32 with the "
                         f"{SCALARS[:5]} at least, got {scalars.dtype} "
                         f"{tuple(scalars.shape)}")
    return scalars.to(device)


def q8_adam_update_reference(m_q, m_s, v_q, v_s, base, grad, *,
                             scalars: torch.Tensor, has_wd: bool, eps: float,
                             beta1: float, beta2: float, seed=0,
                             use_sr: bool = False) -> None:
    """Plain version of the int8 AdamW step, in place, with the kernel's
    operations in the kernel's order. The step's scalars are the block
    ``scalars`` (``SCALARS`` order: ``lr``, ``decay = 1 - lr * wd``, read
    only where ``has_wd``, ``c1 = 1 - beta1^t``, ``c2 = 1 - beta2^t``, the
    gate). Where the gate is 0 nothing changes (decided on the device)."""
    dev = base.device
    sc = _check_scalars(scalars, dev)
    lr_t, decay_t, c1_t, c2_t = sc[0], sc[1], sc[2], sc[3]
    keep = sc[4] == 0.0
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
    for dst, new in (
            (m_q, torch.round(nm / msc[:, None]).clamp(-127, 127)
             .to(torch.int8)),
            (v_q, torch.round(sq / vsc[:, None]).clamp(-127, 127)
             .to(torch.int8)),
            (m_s, msc), (v_s, vsc)):
        dst.copy_(torch.where(keep, dst, new))
    nm, nv = nm.view(-1)[:n], nv.view(-1)[:n]
    upd = base.reshape(-1).float()
    if has_wd:
        upd = upd * decay_t
    upd = upd - lr_t * (nm / c1_t) / (torch.sqrt(nv / c2_t) + s(eps))
    flat = base.view(-1)
    if use_sr:
        new = stochastic_round_bf16(upd, sr_bits(seed, n, dev))
    else:
        new = upd.to(flat.dtype)
    flat.copy_(torch.where(keep, flat, new))


def q8_adam_cost(base, grad) -> tuple:
    """One launch's ``(flops, bytes)``: 25 fp32 operations an element; the
    base read and written, the gradient read, both int8 codes read and
    written, and both fp32 scales of each block read and written."""
    n = base.numel()
    nb = -(-n // Q8_BLOCK)
    return 25.0 * n, float(n * (2 * base.element_size() + grad.element_size()
                                + 4) + 16 * nb)


def q8_adam_update(m_q, m_s, v_q, v_s, base, grad, *,
                   scalars: torch.Tensor, has_wd: bool, eps: float,
                   beta1: float, beta2: float, seed=0,
                   use_sr: bool = False) -> None:
    """One int8 AdamW step in place: the kernel (CUDA) or its plain
    version (CPU). ``base`` and ``grad`` are contiguous with ``n`` elements
    each (fp32 or bf16), ``m_q``/``v_q`` int8 ``(ceil(n / 2048), 2048)``,
    ``m_s``/``v_s`` fp32; ``use_sr`` needs a bf16 ``base``. The scalars
    and ``seed`` (an int or a 0-d integer tensor) as for
    :func:`q8_adam_update_reference`."""
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
    sc = _check_scalars(scalars, base.device)
    hp = dict(eps=eps, beta1=beta1, beta2=beta2, scalars=sc,
              has_wd=bool(has_wd), seed=seed, use_sr=use_sr)
    if base.device.type == "cpu":
        q8_adam_update_reference(m_q, m_s, v_q, v_s, base, grad, **hp)
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
    seed_t = seed_tensor(seed, base.device)
    stream = torch.cuda.current_stream(base.device).cuda_stream
    with torch.cuda.device(base.device):
        err = _kernel()(
            m_q.data_ptr(), m_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
            base.data_ptr(), grad.data_ptr(), n, nb, bcode, gcode,
            sc.data_ptr(), eps, beta1, beta2, 1.0 - beta1, 1.0 - beta2,
            int(has_wd), int(use_sr), seed_t.data_ptr(), stream)
    _native.check(err, "q8_adam kernel launch")
    launches.launched(1, q8_adam_cost, base, grad)
