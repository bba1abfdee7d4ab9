"""The multi-tensor AdamW update: the hand-written Hopper kernel
(``csrc/multi_tensor_adam.cu``, one launch over the flat buffers of every
parameter) and its plain PyTorch version. It is the port's own kernel: the
JAX package's ``Adam._fused_step`` (``paddle_tpu/optimizer/__init__.py``,
``use_multi_tensor=True``) is XLA-fused jnp, no Pallas function.

Per element, in place and in ``_fused_step``'s order::

    g  = grad (fp32), clipped to [lo, hi] or times the global-norm scale
    m' = b1 m + (1 - b1) g            v' = b2 v + ((1 - b2) g) g
    w' = w * decay - (lr * (m' / c1)) / (sqrt(v' / c2) + eps)
    m, v  <- m', v' in the moments' dtype (round to nearest)
    w     <- w' in the storage's dtype
    param <- w' in the parameter's dtype (round to nearest)

The math is fp32 whatever the buffers hold, and the update uses the
unrounded ``m'`` and ``v'``. ``master`` is the storage ``w``: the fp32
master, or in the master-free layout the bf16 flat parameters themselves
(then ``param`` is None and ``grad`` bf16), written rounded stochastically
(``stochastic_rounding``, the rule of :func:`ops.q8_adam.
stochastic_round_bf16`) or to nearest. ``m`` and ``v`` are fp32, bf16 or
fp16; ``grad`` and ``param`` fp32, bf16 or fp16 (``param`` None where the
parameters are views of the master itself). The rounding bits of flat
element ``base + i`` are ``ops/q8_adam.py``'s :func:`sr_bits` of that
index under ``seed`` (a 0-d
integer tensor on the device, its low 32 bits; the optimizer derives one a
step there): an element draws the same bits whichever run or launch
updates it. The step's scalars are the device block of
``ops/q8_adam.py`` (``SCALARS``: lr, decay = 1 - lr wd, c1, c2, gate,
grad_scale), read from memory so that a captured graph reads each replay's
own; where the gate is 0 nothing is written. With ``tables = (ends,
scale, decays)`` (per tensor: the end of its slice in the flat buffers,
its LR scale, 1 where it decays) each tensor's elements take ``lr *
scale`` and ``decay = 1 - lr * scale * wd``, or no decay where its flag is
0: parameter groups' LR scales, AdamW's ``lr_ratio`` and
``apply_decay_param_fun``; ``base`` is the flat index of the buffers'
element 0.

:func:`multi_tensor_adam_update` launches the kernel for CUDA tensors and
runs :func:`multi_tensor_adam_update_reference` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _native
from ._u32 import seed_tensor
from .q8_adam import (SCALARS, _scalar, sqrt_rn, sr_bits,
                      stochastic_round_bf16)

__all__ = ["launches", "multi_tensor_adam_cost", "multi_tensor_adam_update",
           "multi_tensor_adam_update_reference"]

launches = _native.LaunchCounter("multi_tensor_adam")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the plain version works through the buffers in pieces of this many
# elements (the same operations on each element, so the same bits): its
# fp32 and int64 temporaries stay a few hundred MB at any size
_REF_CHUNK = 1 << 25
# multi_tensor_adam(w, m, v, param, grad, n, w_dtype, moment_dtype,
#                   param_dtype, grad_dtype, scalars, seed, use_sr, eps, b1,
#                   b2, omb1, omb2, has_wd, grad_scale, clip_value, lo, hi,
#                   seg_end, scale, decays, n_seg, base, wd, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_float] * 5 \
    + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3 \
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _kernel():
    fn = _native.load("multi_tensor_adam").multi_tensor_adam
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(master, m, v, param, grad, scalars, stochastic_rounding, seed):
    n = master.numel()
    if master.dtype not in (torch.float32, torch.bfloat16) \
            or grad.numel() != n:
        raise ValueError(f"multi_tensor_adam: master must be fp32 or bf16 "
                         f"and grad of its {n} elements, got {master.dtype}, "
                         f"grad {grad.numel()}")
    if m.dtype != v.dtype or m.dtype not in _DTYPE_CODES or \
            m.numel() != n or v.numel() != n:
        raise ValueError(f"multi_tensor_adam: m and v must be fp32, bf16 or "
                         f"fp16 of one dtype and {n} elements, got "
                         f"{m.dtype} {m.numel()}, {v.dtype} {v.numel()}")
    for name, t in (("grad", grad), ("param", param)):
        if t is not None and (t.dtype not in _DTYPE_CODES or t.numel() != n):
            raise ValueError(f"multi_tensor_adam: {name} must be fp32, "
                             f"bf16 or fp16 of {n} elements, got {t.dtype} "
                             f"{t.numel()}")
    if master.dtype == torch.bfloat16 and (param is not None
                                           or grad.dtype != torch.bfloat16):
        raise ValueError("multi_tensor_adam: a bf16 master (the master-free "
                         "layout) takes a bf16 grad and no param")
    if stochastic_rounding and (master.dtype != torch.bfloat16
                                or seed is None):
        raise ValueError("multi_tensor_adam: stochastic rounding writes a "
                         "bf16 master and needs a seed")
    if scalars.dtype != torch.float32 or scalars.numel() != len(SCALARS):
        raise ValueError(f"multi_tensor_adam: scalars must be fp32 "
                         f"{SCALARS}, got {scalars.dtype} "
                         f"{tuple(scalars.shape)}")


def _reference_piece(master, m, v, param, grad, sc, keep, *, eps, beta1,
                     beta2, has_wd, grad_scale, clip_value, tables, base,
                     wd, seed, stochastic_rounding) -> None:
    dev = master.device
    lr, decay, c1, c2, gs = sc[0], sc[1], sc[2], sc[3], sc[5]
    s = lambda x: _scalar(x, dev)  # noqa: E731
    decays = None
    if tables is not None:
        ends, scale, flags = (t.to(dev) for t in tables)
        j = torch.searchsorted(ends, torch.arange(
            master.numel(), device=dev) + base, right=True)
        lr = lr * scale[j]
        decay = 1.0 - lr * s(wd)
        decays = flags[j] != 0.0
    g = grad.float()
    if clip_value is not None:
        g = torch.clamp(g, s(clip_value[0]), s(clip_value[1]))
    if grad_scale:
        g = g * gs
    nm = s(beta1) * m.float() + s(1.0 - beta1) * g
    nv = s(beta2) * v.float() + s(1.0 - beta2) * g * g
    mh, vh = nm / c1, nv / c2
    w = master.float()
    u = w * decay if has_wd else w
    if has_wd and decays is not None:
        u = torch.where(decays, u, w)
    upd = u - (lr * mh) / (sqrt_rn(vh) + s(eps))
    m.copy_(torch.where(keep, m, nm.to(m.dtype)))
    v.copy_(torch.where(keep, v, nv.to(v.dtype)))
    if param is not None:
        param.copy_(torch.where(keep, param, upd.to(param.dtype)))
    if stochastic_rounding:
        new = stochastic_round_bf16(upd, sr_bits(seed, upd.numel(), dev,
                                                 base))
    else:
        new = upd.to(master.dtype)
    master.copy_(torch.where(keep, master, new))


def multi_tensor_adam_update_reference(
        master, m, v, param, grad, *, scalars: torch.Tensor, eps: float,
        beta1: float, beta2: float, has_wd: bool, grad_scale: bool = False,
        clip_value: Optional[Tuple[float, float]] = None,
        tables: Optional[tuple] = None, base: int = 0,
        wd: float = 0.0, seed=None,
        stochastic_rounding: bool = False) -> None:
    """Plain version of the update, in place, with the kernel's operations
    in the kernel's order; the gate decided on the device."""
    _check(master, m, v, param, grad, scalars, stochastic_rounding, seed)
    dev = master.device
    sc = scalars.to(dev)
    keep = sc[4] == 0.0
    if stochastic_rounding:
        seed = seed_tensor(seed, dev)
    n = master.numel()
    for a in range(0, n, _REF_CHUNK):
        b = min(n, a + _REF_CHUNK)
        _reference_piece(
            master[a:b], m[a:b], v[a:b], None if param is None
            else param[a:b], grad[a:b], sc, keep, eps=eps, beta1=beta1,
            beta2=beta2, has_wd=has_wd, grad_scale=grad_scale,
            clip_value=clip_value, tables=tables, base=base + a, wd=wd,
            seed=seed, stochastic_rounding=stochastic_rounding)


def multi_tensor_adam_cost(master, m, v, param, grad) -> tuple:
    """One launch's ``(flops, bytes)``: 18 fp32 operations an element (clip
    scale 1, m 3, v 4, two bias divisions, decay 1, lr 1, sqrt, eps add,
    division, subtraction); the gradient read, the storage, m and v read
    and written, the low-precision parameter copy written."""
    n = master.numel()
    item = (grad.element_size() + 2 * (master.element_size()
            + m.element_size() + v.element_size())
            + (0 if param is None else param.element_size()))
    return 18.0 * n, float(item * n)


def multi_tensor_adam_update(
        master, m, v, param, grad, *, scalars: torch.Tensor, eps: float,
        beta1: float, beta2: float, has_wd: bool, grad_scale: bool = False,
        clip_value: Optional[Tuple[float, float]] = None,
        tables: Optional[tuple] = None, base: int = 0,
        wd: float = 0.0, seed=None,
        stochastic_rounding: bool = False) -> None:
    """One multi-tensor AdamW step in place over flat 1-D buffers of ``n``
    elements: the kernel (CUDA) or its plain version (CPU). ``scalars`` is
    the device block (``SCALARS``); ``grad_scale`` multiplies g by its
    ``grad_scale`` entry (the global-norm clip), ``clip_value = (lo, hi)``
    clips g (the by-value clip); ``tables``, ``base`` and ``wd``: the
    per-tensor LR scales and decay flags; ``stochastic_rounding`` and
    ``seed``: how a bf16 ``master`` is written (see the module
    docstring)."""
    kw = dict(scalars=scalars, eps=eps, beta1=beta1, beta2=beta2,
              has_wd=has_wd, grad_scale=grad_scale, clip_value=clip_value,
              tables=tables, base=base, wd=wd, seed=seed,
              stochastic_rounding=stochastic_rounding)
    if master.device.type == "cpu":
        multi_tensor_adam_update_reference(master, m, v, param, grad, **kw)
        return
    _check(master, m, v, param, grad, scalars, stochastic_rounding, seed)
    xs = [t for t in (master, m, v, param, grad, scalars) if t is not None]
    if master.device.type != "cuda" or any(t.device != master.device
                                           for t in xs):
        raise ValueError("multi_tensor_adam: all tensors must share one "
                         "CUDA device")
    if not all(t.is_contiguous() for t in xs) or any(
            t.data_ptr() % 16 for t in xs[:-1]):
        raise ValueError("multi_tensor_adam: buffers must be contiguous and "
                         "start on a 16-byte boundary")
    lo, hi = clip_value if clip_value is not None else (0.0, 0.0)
    if tables is not None:
        ends, scale, flags = tables
        if ends.dtype != torch.int64 or any(
                t.device != master.device or not t.is_contiguous()
                for t in tables) or not (ends.numel() == scale.numel()
                                         == flags.numel() > 0):
            raise ValueError("multi_tensor_adam: tables must be contiguous "
                             "int64 ends and fp32 scales and flags of one "
                             "length on the buffers' device")
    seed_t = seed_tensor(seed, master.device) if stochastic_rounding \
        else None
    stream = torch.cuda.current_stream(master.device).cuda_stream
    with torch.cuda.device(master.device):
        err = _kernel()(
            master.data_ptr(), m.data_ptr(), v.data_ptr(),
            None if param is None else param.data_ptr(), grad.data_ptr(),
            master.numel(), _DTYPE_CODES[master.dtype], _DTYPE_CODES[m.dtype],
            -1 if param is None else _DTYPE_CODES[param.dtype],
            _DTYPE_CODES[grad.dtype], scalars.data_ptr(),
            None if seed_t is None else seed_t.data_ptr(),
            int(stochastic_rounding), eps, beta1, beta2, 1.0 - beta1,
            1.0 - beta2, int(has_wd), int(grad_scale),
            int(clip_value is not None), lo, hi,
            *([None] * 3 if tables is None else
              [t.data_ptr() for t in tables]),
            0 if tables is None else tables[0].numel(), base, wd, stream)
    _native.check(err, "multi_tensor_adam kernel launch")
    launches.launched(1, multi_tensor_adam_cost, master, m, v, param, grad)
