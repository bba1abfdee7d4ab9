"""The multi-tensor AdamW update: the hand-written Hopper kernel
(``csrc/multi_tensor_adam.cu``, one launch over the flat buffers of every
parameter) and its plain PyTorch version. It is the port's own kernel: the
JAX package's ``Adam._fused_step`` (``paddle_tpu/optimizer/__init__.py``,
``use_multi_tensor=True``) is XLA-fused jnp, no Pallas function.

Per element, in place and in ``_fused_step``'s order::

    g  = grad (fp32), clipped to [lo, hi] or times the global-norm scale
    m' = b1 m + (1 - b1) g            v' = b2 v + ((1 - b2) g) g
    master' = master * decay - (lr * (m' / c1)) / (sqrt(v' / c2) + eps)
    param'  = master' in the parameter's dtype (round to nearest)

``master``, ``m`` and ``v`` are fp32; ``grad`` and ``param`` fp32, bf16 or
fp16, the parameter rounded to nearest from the new master (``param`` None
where the parameters are views of the master itself). The
step's scalars are the device block of ``ops/q8_adam.py`` (``SCALARS``:
lr, decay = 1 - lr wd, c1, c2, gate, grad_scale), read from memory so that
a captured graph reads each replay's own; where the gate is 0 nothing is
written. With ``tables = (ends, scale, decays)`` (per tensor: the end of
its slice in the flat buffers, its LR scale, 1 where it decays) each
tensor's elements take ``lr * scale`` and ``decay = 1 - lr * scale * wd``,
or no decay where its flag is 0: parameter groups' LR scales, AdamW's
``lr_ratio`` and ``apply_decay_param_fun``; ``base`` is the flat index of
the buffers' element 0.

:func:`multi_tensor_adam_update` launches the kernel for CUDA tensors and
runs :func:`multi_tensor_adam_update_reference` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _native
from .q8_adam import SCALARS, _scalar

__all__ = ["launches", "multi_tensor_adam_update",
           "multi_tensor_adam_update_reference"]

launches = _native.LaunchCounter("multi_tensor_adam")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# multi_tensor_adam(master, m, v, param, grad, n, param_dtype, grad_dtype,
#                   scalars, eps, b1, b2, omb1, omb2, has_wd, grad_scale,
#                   clip_value, lo, hi, seg_end, scale, decays, n_seg, base,
#                   wd, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p] + [ctypes.c_float] * 5 + [ctypes.c_int] * 3 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                      ctypes.c_longlong,
                                                      ctypes.c_float,
                                                      ctypes.c_void_p]


@functools.cache
def _kernel():
    fn = _native.load("multi_tensor_adam").multi_tensor_adam
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(master, m, v, param, grad, scalars):
    n = master.numel()
    for name, t in (("m", m), ("v", v), ("master", master)):
        if t.dtype != torch.float32 or t.numel() != n:
            raise ValueError(f"multi_tensor_adam: {name} must be fp32 of "
                             f"{n} elements, got {t.dtype} {t.numel()}")
    for name, t in (("grad", grad), ("param", param)):
        if t is not None and (t.dtype not in _DTYPE_CODES or t.numel() != n):
            raise ValueError(f"multi_tensor_adam: {name} must be fp32, "
                             f"bf16 or fp16 of {n} elements, got {t.dtype} "
                             f"{t.numel()}")
    if scalars.dtype != torch.float32 or scalars.numel() != len(SCALARS):
        raise ValueError(f"multi_tensor_adam: scalars must be fp32 "
                         f"{SCALARS}, got {scalars.dtype} "
                         f"{tuple(scalars.shape)}")


def multi_tensor_adam_update_reference(
        master, m, v, param, grad, *, scalars: torch.Tensor, eps: float,
        beta1: float, beta2: float, has_wd: bool, grad_scale: bool = False,
        clip_value: Optional[Tuple[float, float]] = None,
        tables: Optional[tuple] = None, base: int = 0,
        wd: float = 0.0) -> None:
    """Plain version of the update, in place, with the kernel's operations
    in the kernel's order; the gate decided on the device."""
    _check(master, m, v, param, grad, scalars)
    dev = master.device
    sc = scalars.to(dev)
    lr, decay, c1, c2, gs = sc[0], sc[1], sc[2], sc[3], sc[5]
    keep = sc[4] == 0.0
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
    nm = s(beta1) * m + s(1.0 - beta1) * g
    nv = s(beta2) * v + s(1.0 - beta2) * g * g
    mh, vh = nm / c1, nv / c2
    u = master * decay if has_wd else master
    if has_wd and decays is not None:
        u = torch.where(decays, u, master)
    upd = u - (lr * mh) / (torch.sqrt(vh) + s(eps))
    m.copy_(torch.where(keep, m, nm))
    v.copy_(torch.where(keep, v, nv))
    if param is not None:
        param.copy_(torch.where(keep, param, upd.to(param.dtype)))
    master.copy_(torch.where(keep, master, upd))


def multi_tensor_adam_update(
        master, m, v, param, grad, *, scalars: torch.Tensor, eps: float,
        beta1: float, beta2: float, has_wd: bool, grad_scale: bool = False,
        clip_value: Optional[Tuple[float, float]] = None,
        tables: Optional[tuple] = None, base: int = 0,
        wd: float = 0.0) -> None:
    """One multi-tensor AdamW step in place over flat 1-D buffers of ``n``
    elements: the kernel (CUDA) or its plain version (CPU). ``scalars`` is
    the device block (``SCALARS``); ``grad_scale`` multiplies g by its
    ``grad_scale`` entry (the global-norm clip), ``clip_value = (lo, hi)``
    clips g (the by-value clip); ``tables``, ``base`` and ``wd``: the
    per-tensor LR scales and decay flags (see the module docstring)."""
    kw = dict(scalars=scalars, eps=eps, beta1=beta1, beta2=beta2,
              has_wd=has_wd, grad_scale=grad_scale, clip_value=clip_value,
              tables=tables, base=base, wd=wd)
    if master.device.type == "cpu":
        multi_tensor_adam_update_reference(master, m, v, param, grad, **kw)
        return
    _check(master, m, v, param, grad, scalars)
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
    stream = torch.cuda.current_stream(master.device).cuda_stream
    with torch.cuda.device(master.device):
        err = _kernel()(
            master.data_ptr(), m.data_ptr(), v.data_ptr(),
            None if param is None else param.data_ptr(), grad.data_ptr(),
            master.numel(), -1 if param is None else _DTYPE_CODES[param.dtype],
            _DTYPE_CODES[grad.dtype], scalars.data_ptr(), eps, beta1, beta2,
            1.0 - beta1, 1.0 - beta2, int(has_wd), int(grad_scale),
            int(clip_value is not None), lo, hi,
            *([None] * 3 if tables is None else
              [t.data_ptr() for t in tables]),
            0 if tables is None else tables[0].numel(), base, wd, stream)
    _native.check(err, "multi_tensor_adam kernel launch")
    launches.launched()
