"""``act(y + b)``, a linear layer's bias add and activation: the
hand-written Hopper kernel (``csrc/bias_act.cu``, forward and backward) and
its plain PyTorch version. The port's own kernel: the JAX package leaves
matmul + bias + activation to XLA's fusion (``paddle_tpu/incubate/
nn_functional.py:212`` ``fused_linear_activation``, the encoder layer's
``linear1`` -> activation), no Pallas function.

``act`` is ``"none"`` (identity), ``"relu"``, ``"gelu"`` (erf form) or
``"gelu_tanh"``. The casts are the plain ops' under ``amp.auto_cast``, held
in :class:`ActSpec`: the add's result dtype ``h`` (``y + b`` promoted) and
the activation's dtype ``a`` (its input cast and its output). The kernel
rounds where the plain ops round: the add to ``h``, the cast to ``a``, the
activation to ``a`` (torch computes each op in fp32 and rounds once; the
JAX package rounds GELU's erf form after each primitive, ROADMAP Queue C).
Its backward reads the saved ``y`` and ``b`` and recomputes the
pre-activation (no activation is saved); the bias gradient is summed in
fp32 per block of 16 rows and the partials folded in a fixed order, so
every launch gives the same bits. With ``period=P`` the bias holds one row
for each P rows (the expert-choice MoE's ``(E, 1, I)`` bias over ``E x C``
rows: P = C), one launch for all of them; the bias gradient has a row for
each.

:func:`bias_act` runs :func:`bias_act_reference` for CPU tensors (gradients
by autograd) and the kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from .. import _native
from ._fused_io import (aligned16, cuda_device, dtype_code, plain_path,
                        ptr, stream)

__all__ = ["ACTS", "ActSpec", "bias_act", "bias_act_bwd_reference",
           "bias_act_reference", "launches"]

launches = _native.LaunchCounter("bias_act")
ACTS = {"none": 0, "relu": 1, "gelu": 2, "gelu_tanh": 3}
ROWS = 16   # rows a backward block sums into one partial (csrc ROWS)

_ARGTYPES_OF = {
    "bias_act_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "bias_act_bwd": [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}


def bind(lib) -> dict:
    """The C entry points of a built ``bias_act`` library, typed."""
    fns = {}
    for name, types in _ARGTYPES_OF.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("bias_act"))


@dataclass(frozen=True)
class ActSpec:
    """The activation and the plain ops' dtypes: ``h`` of ``y + b``, ``a``
    of the activation's input cast and output."""
    act: str
    h: torch.dtype
    a: torch.dtype


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(h)
    if act in ("gelu", "gelu_tanh"):
        return torch.nn.functional.gelu(
            h, approximate="tanh" if act == "gelu_tanh" else "none")
    if act != "none":
        raise ValueError(f"activation must be one of {sorted(ACTS)}, got "
                         f"{act!r}")
    return h


def _add_bias(y: torch.Tensor, b: torch.Tensor,
              period: Optional[int]) -> torch.Tensor:
    if not period:
        return y + b
    n = y.shape[-1]
    return (y.reshape(-1, period, n) + b.reshape(-1, 1, n)).view(y.shape)


def bias_act_reference(y: torch.Tensor, b: Optional[torch.Tensor],
                       spec: ActSpec,
                       period: Optional[int] = None) -> torch.Tensor:
    """Plain version: ``act((y + b).to(a))``, each op rounding as torch's
    does; with ``period`` row r adds bias row ``r // period``."""
    h = y if b is None else _add_bias(y, b, period)
    return _act(h.to(spec.a), spec.act)


def bias_act_bwd_reference(y, b, dy, spec: ActSpec,
                           period: Optional[int] = None):
    """``(dy_y, db)`` of the plain version, by autograd (db None without
    b)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (y, b)
                  if t is not None]
        out = bias_act_reference(leaves[0], leaves[1] if b is not None
                                 else None, spec, period)
        grads = torch.autograd.grad(out, leaves, dy)
    return grads[0], grads[1] if b is not None else None


def _flat(y: torch.Tensor):
    n = y.shape[-1]
    return y.contiguous(), (y.numel() // n if n else 0), n


def _vec(n: int, *ts) -> int:
    return 8 if n % 8 == 0 and aligned16(*ts) else 1


def _bias_rows(b, rows: int, n: int, period: Optional[int]) -> int:
    """How many bias rows b must hold, checked against its size."""
    want = rows // period if period else 1
    if period and rows % period:
        raise ValueError(f"bias_act: {rows} rows are not a multiple of the "
                         f"bias period {period}")
    if b is not None and b.numel() != want * n:
        raise ValueError(f"bias_act: bias of {b.numel()} for {want} bias "
                         f"rows of {n}")
    return want


def _launch_fwd(y, b, spec: ActSpec, period: Optional[int] = None,
                fns=None):
    dev = cuda_device("bias_act", y, b)
    y, rows, n = _flat(y)
    b = None if b is None else b.contiguous()
    _bias_rows(b, rows, n, period)
    out = torch.empty(y.shape, dtype=spec.a, device=dev)
    if rows and n:
        c = functools.partial(dtype_code, what="bias_act")
        with torch.cuda.device(dev):
            err = (fns or _kernels())["bias_act_fwd"](
                ptr(y), ptr(b), ptr(out), rows, period or 0, n,
                ACTS[spec.act], c(y.dtype),
                c(None if b is None else b.dtype), c(spec.h), c(spec.a),
                _vec(n, y, b, out), stream(dev))
        _native.check(err, "bias_act forward kernel launch")
        launches.count += 1
    return out


def _launch_bwd(y, b, dy, spec: ActSpec, period: Optional[int] = None,
                fns=None):
    """``(dy_y, db)``: the gradients of y and of the bias (None without)."""
    dev = cuda_device("bias_act", y, b, dy)
    y, rows, n = _flat(y)
    dy = dy.contiguous()
    b = None if b is None else b.contiguous()
    bias_rows = _bias_rows(b, rows, n, period)
    p = period or rows
    dyy = torch.empty(y.shape, dtype=y.dtype, device=dev)
    db = None if b is None else torch.empty(bias_rows * n, dtype=b.dtype,
                                            device=dev)
    part = None if b is None else torch.empty(
        (bias_rows * ((p + ROWS - 1) // ROWS), n), dtype=torch.float32,
        device=dev)
    if rows and n:
        c = functools.partial(dtype_code, what="bias_act")
        with torch.cuda.device(dev):
            err = (fns or _kernels())["bias_act_bwd"](
                ptr(y), ptr(b), ptr(dy), ptr(dyy), ptr(part), ptr(db), rows,
                period or 0, n, ACTS[spec.act], c(y.dtype),
                c(None if b is None else b.dtype), c(spec.h), c(spec.a),
                _vec(n, y, b, dy, dyy), stream(dev))
        _native.check(err, "bias_act backward kernel launch")
        launches.count += 1
    elif db is not None:
        db.zero_()
    return dyy, None if db is None else db.view(b.shape)


class BiasAct(torch.autograd.Function):
    """The kernel with its backward kernel; saves y and b only."""

    @staticmethod
    def forward(ctx, y, b, spec, period):
        ctx.save_for_backward(y, b)
        ctx.spec, ctx.period = spec, period
        return _launch_fwd(y, b, spec, period)

    @staticmethod
    def backward(ctx, dy):
        y, b = ctx.saved_tensors
        dyy, db = _launch_bwd(y, b, dy, ctx.spec, ctx.period)
        return dyy, db, None, None


def bias_act(y: torch.Tensor, b: Optional[torch.Tensor],
             spec: ActSpec, period: Optional[int] = None) -> torch.Tensor:
    """``act(y + b)`` over y's last axis (b of that length, or None; with
    ``period``, one bias row for each ``period`` rows of y): the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if spec.act not in ACTS:
        raise ValueError(f"activation must be one of {sorted(ACTS)}, got "
                         f"{spec.act!r}")
    if plain_path(y):
        return bias_act_reference(y, b, spec, period)
    return BiasAct.apply(y, b, spec, period)
