"""SwiGLU, ``silu(g) * u``: the hand-written Hopper kernel
(``csrc/swiglu.cu``, forward and backward) and its plain PyTorch version.
The port's own kernel: the JAX package's ``silu(gate) * up``
(``paddle_tpu/models/llama.py`` ``LlamaMLP``) and ``swiglu``
(``paddle_tpu/incubate/nn_functional.py:170-178``) are XLA-fused jnp, no
Pallas function.

The kernel rounds as the plain version does: ``silu(g)`` once to g's
dtype, the product once to the result's (so it gives the plain version's
bits where the two compute ``exp`` alike), and its backward recomputes
``silu`` from g (nothing else is saved). With ``u`` None, g's last axis
is split in half and both halves are read where they lie.

:func:`swiglu` runs :func:`swiglu_reference` for CPU tensors (gradients
by autograd) and the kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .. import _native
from ._fused_io import (aligned16, as_int32, cuda_device, divider,
                        dtype_code, plain_path, ptr, stream)

__all__ = ["LaunchPlan", "divider", "launch_plan", "launches", "swiglu",
           "swiglu_reference"]

launches = _native.LaunchCounter("swiglu")

_ARGTYPES_FWD = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 \
    + [ctypes.c_void_p]
_ARGTYPES_BWD = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 \
    + [ctypes.c_void_p]

MAX_THREADS = 256
INDEX_LIMIT = 2 ** 31


class LaunchPlan(NamedTuple):
    """One launch: ``grid`` CTAs of ``threads``, a vector of ``vec``
    elements a thread, ``vecs`` in all; rows at a stride (``strided``) find
    the row of vector v as ``(v * magic) >> (31 + shift)``."""
    grid: int
    threads: int
    vecs: int
    strided: bool
    magic: int
    shift: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def launch_plan(rows: int, d: int, vec: int, sms: int, *,
                strided: bool = False) -> LaunchPlan:
    """The launch over ``rows`` rows of ``d`` elements in vectors of
    ``vec`` (8 or 1), on a card of ``sms`` SMs: a vector a thread, in CTAs
    of 256 threads, or of 128 where there are fewer vectors than 256 an SM
    (decode: the work spread over more SMs)."""
    vecs = rows * (d // vec)
    threads = MAX_THREADS if vecs >= MAX_THREADS * sms else MAX_THREADS // 2
    magic, shift = divider(d // vec) if strided else (0, 0)
    return LaunchPlan(max(1, _ceil(vecs, threads)), threads, vecs, strided,
                      magic, shift)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_args(plan: LaunchPlan) -> tuple:
    return (plan.grid, plan.threads, int(plan.strided), as_int32(plan.magic),
            plan.shift)


def _check_size(what: str, *ts) -> None:
    if any(t.numel() >= INDEX_LIMIT for t in ts):
        raise ValueError(f"swiglu: the kernel indexes tensors of fewer than "
                         f"2^31 elements, got {what} "
                         f"{[tuple(t.shape) for t in ts]}")


def bind(lib) -> dict:
    """The C entry points of a built ``swiglu`` library, typed."""
    fns = {}
    for name, types in (("swiglu_fwd", _ARGTYPES_FWD),
                        ("swiglu_bwd", _ARGTYPES_BWD)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("swiglu"))


def _split(x: torch.Tensor):
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


def swiglu_reference(g: torch.Tensor,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``silu(g) * u`` (u None: g's halves)."""
    if u is None:
        g, u = _split(g)
    return torch.nn.functional.silu(g) * u


def _launch_fwd(g, u, packed: bool, fns=None):
    dev = cuda_device("swiglu", g, u)
    if packed:
        g = g.contiguous()
        d = g.shape[-1] // 2
        if g.shape[-1] != 2 * d:
            raise ValueError(f"swiglu: one argument splits an even last "
                             f"axis, got {g.shape[-1]}")
        gv, uv = _split(g)
        rows, rs = g.numel() // (2 * d) if d else 0, 2 * d
        g_rs = u_rs = rs
        shape = gv.shape
    else:
        if g.shape != u.shape:
            raise ValueError(f"swiglu: g {tuple(g.shape)} and u "
                             f"{tuple(u.shape)} must have one shape")
        gv, uv = g.contiguous(), u.contiguous()
        d = g.shape[-1]
        rows, g_rs, u_rs = gv.numel() // d if d else 0, d, d
        shape = g.shape
    out_dtype = torch.promote_types(gv.dtype, uv.dtype)
    y = torch.empty(shape, dtype=out_dtype, device=dev)
    _check_size("g", g if packed else gv)
    vec = 8 if d % 8 == 0 and aligned16(gv, uv, y) else 1
    if rows:
        c = functools.partial(dtype_code, what="swiglu")
        plan = launch_plan(rows, d, vec, _sm_count(dev.index),
                           strided=g_rs != d or u_rs != d)
        with torch.cuda.device(dev):
            err = (fns or _kernels())["swiglu_fwd"](
                ptr(gv), ptr(uv), ptr(y), plan.vecs, d, g_rs, u_rs,
                c(gv.dtype), c(uv.dtype), c(out_dtype), vec,
                *_plan_args(plan), stream(dev))
        _native.check(err, "swiglu forward kernel launch")
        launches.launched(1, _native.io_cost, gv, uv, y)
    return y


def _launch_bwd(g, u, dy, packed: bool, fns=None):
    """``(dg, du)``, or with ``packed`` the gradient of the packed input."""
    dev = cuda_device("swiglu", g, u, dy)
    dy = dy.contiguous()
    if packed:
        d = g.shape[-1] // 2
        gv, uv = _split(g)
        dx = torch.empty(g.shape, dtype=g.dtype, device=dev)
        dg, du = _split(dx)
        rs = [2 * d] * 4
        outs = (dx,)
    else:
        gv, uv = g, u
        d = g.shape[-1]
        dg = torch.empty(g.shape, dtype=g.dtype, device=dev)
        du = torch.empty(u.shape, dtype=u.dtype, device=dev)
        rs = [d] * 4
        outs = (dg, du)
    rows = dy.numel() // d if d else 0
    _check_size("g", g)
    vec = 8 if d % 8 == 0 and aligned16(gv, uv, dy, dg, du) else 1
    if rows:
        c = functools.partial(dtype_code, what="swiglu")
        plan = launch_plan(rows, d, vec, _sm_count(dev.index),
                           strided=rs[0] != d)
        with torch.cuda.device(dev):
            err = (fns or _kernels())["swiglu_bwd"](
                ptr(gv), ptr(uv), ptr(dy), ptr(dg), ptr(du), plan.vecs, d,
                *rs, c(gv.dtype), c(uv.dtype), c(dy.dtype), vec,
                *_plan_args(plan), stream(dev))
        _native.check(err, "swiglu backward kernel launch")
        launches.launched(1, _native.io_cost, gv, uv, dy, dg, du)
    return outs


class SwiGLU(torch.autograd.Function):
    """The kernel with its backward kernel; ``u`` None: g's halves."""

    @staticmethod
    def forward(ctx, g, u):
        packed = u is None
        g = g.contiguous()
        u = None if packed else u.contiguous()
        ctx.save_for_backward(g, u)
        ctx.packed = packed
        return _launch_fwd(g, u, packed)

    @staticmethod
    def backward(ctx, dy):
        g, u = ctx.saved_tensors
        grads = _launch_bwd(g, u, dy, ctx.packed)
        return grads if not ctx.packed else (grads[0], None)


def swiglu(g: torch.Tensor, u: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """``silu(g) * u`` (u None: g's last axis split in half): the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if plain_path(g):
        return swiglu_reference(g, u)
    return SwiGLU.apply(g, u)
