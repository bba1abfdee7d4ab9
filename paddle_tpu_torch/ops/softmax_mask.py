"""``softmax(x + mask)`` over the last axis and its upper-triangle (causal)
variant, paddle.incubate's ``softmax_mask_fuse`` and
``softmax_mask_fuse_upper_triangle``: the hand-written Hopper kernel
(``csrc/softmax_mask.cu``, forward and backward; CUDA, as every kernel of
the port) and its plain PyTorch version. The port's own kernel: the JAX
package computes both with XLA-fused jnp (``paddle_tpu/incubate/
nn_functional.py:283, :411-430``), no Pallas function.

Statistics in fp32, the output in x's dtype; the upper triangle masks key
``j > i + (Lk - Lq)`` of query row ``i`` with ``-1e30`` (bottom-right, as
the JAX package's ``jnp.tril(.., k - q)``). The backward reads the saved
output: ``dx = y * (dy - sum(dy * y))`` in fp32, rounded to x's dtype. The
mask takes no gradient (it is an input of the fused op, as upstream).
:func:`softmax_mask` runs :func:`softmax_mask_reference` for CPU tensors
(gradients by autograd) and the kernel for CUDA tensors; any other device
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .. import _native
from ._fused_io import (as_int32, cuda_device, divider, dtype_code,
                        plain_path, ptr, stream)

__all__ = ["LaunchPlan", "launch_plan", "launches", "softmax_mask",
           "softmax_mask_bwd_reference", "softmax_mask_reference"]

launches = _native.LaunchCounter("softmax_mask")

_ARGTYPES_OF = {
    "softmax_mask_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 20
    + [ctypes.c_void_p],
    "softmax_mask_bwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
}

# keys a lane holds in registers (a row of up to 32 x that many keys); a
# longer row takes the looping kernel (elems 0)
ELEMS = (4, 8, 16, 32)
# rows a warp that csrc/softmax_mask.cu builds for each, and the plan's
# choice for a forward with a mask: on an H100 four rows a warp were 12.8%
# faster than one at ERNIE's scores, where the backward and the upper
# triangle were 16-25% faster at one (PERF.md §6, K8)
RPW_CHOICES = {4: (1, 2, 4), 8: (1, 2), 16: (1,), 32: (1,), 0: (1,)}
RPW = {4: 4, 8: 2, 16: 1, 32: 1, 0: 1}
THREADS = 128
MAX_THREADS = 256
INDEX_LIMIT = 2 ** 31


class LaunchPlan(NamedTuple):
    """One launch: ``grid`` CTAs of ``threads``, a warp an item of ``rpw``
    rows, each lane holding keys ``lane + 32 k`` for ``k < elems`` of each
    (``elems`` 0: the looping kernel, a row a warp, keys ``lane + 32 t``
    for every t); ``head_major``: an item's rows are one (b, q) over
    ``rpw`` consecutive heads (their broadcast mask row read once), else
    ``rpw`` consecutive rows."""
    elems: int
    rpw: int
    head_major: bool
    items: int
    grid: int
    threads: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def launch_plan(rows: int, lk: int, heads: int = 1, *,
                masked: bool = True, shared_mask: bool = False,
                backward: bool = False, rpw: Optional[int] = None,
                threads: int = THREADS,
                head_major: Optional[bool] = None) -> LaunchPlan:
    """The launch over ``rows`` rows of ``lk`` keys (``heads`` the rows'
    head count; ``masked``: a forward that reads a mask, not the upper
    triangle; ``shared_mask``: one mask row serves all heads of a (b, q)).
    A masked forward takes :data:`RPW` rows a warp, the backward and the
    upper triangle one. ``rpw``, ``threads`` and ``head_major`` override
    the plan's choices (the variants tool measures them)."""
    elems = next((e for e in ELEMS if lk <= 32 * e), 0)
    r = rpw or (RPW[elems] if masked and not backward else 1)
    if r not in RPW_CHOICES[elems]:
        raise ValueError(f"softmax_mask: {r} rows a warp is not built for "
                         f"{elems} keys a lane")
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"softmax_mask: {threads} threads a CTA")
    if head_major is None:
        head_major = shared_mask and r > 1 and heads % r == 0
    if head_major and (backward or elems == 0 or heads % r):
        raise ValueError("softmax_mask: head-major rows need a forward "
                         "row in registers and heads a multiple of the "
                         "rows a warp")
    items = rows // r if head_major else _ceil(rows, r)
    return LaunchPlan(elems, r, bool(head_major), items,
                      max(1, _ceil(items, threads // 32)), threads)


def _plan_args(plan: LaunchPlan) -> tuple:
    return (plan.items, plan.elems, plan.rpw, plan.grid, plan.threads)


def _check_size(what: str, *ts) -> None:
    """The kernel indexes with 32 bits: every tensor's extent (its largest
    element offset, strides and all) must be below 2^31."""
    for t in ts:
        if t is None:
            continue
        extent = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride())
                         if n)
        if t.numel() >= INDEX_LIMIT or extent >= INDEX_LIMIT:
            raise ValueError(f"softmax_mask: the kernel indexes tensors of "
                             f"fewer than 2^31 elements, got {what} "
                             f"{tuple(t.shape)}")


def bind(lib) -> dict:
    """The C entry points of a built ``softmax_mask`` library, typed."""
    fns = {}
    for name, types in _ARGTYPES_OF.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("softmax_mask"))


def softmax_mask_reference(x: torch.Tensor, mask: Optional[torch.Tensor],
                           causal: bool = False) -> torch.Tensor:
    """Plain version: ``softmax(x + mask)`` (``causal``: keys above the
    bottom-right diagonal set to -1e30, no mask) in fp32, cast to x's
    dtype."""
    logits = x.float()
    if causal:
        q, k = x.shape[-2], x.shape[-1]
        keep = torch.ones(q, k, dtype=torch.bool,
                          device=x.device).tril(diagonal=k - q)
        logits = torch.where(keep, logits, -1e30)
    else:
        logits = logits + mask.float()
    return torch.softmax(logits, dim=-1).to(x.dtype)


def softmax_mask_bwd_reference(y: torch.Tensor,
                               dy: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward from the output: ``y * (dy -
    sum(dy * y))`` in fp32, in y's dtype."""
    yf, gf = y.float(), dy.float()
    return (yf * (gf - (gf * yf).sum(-1, keepdim=True))).to(y.dtype)


def _as4d(t: torch.Tensor) -> torch.Tensor:
    """(.., Lq, Lk) as (B, H, Lq, Lk), the leading axes as H."""
    if t.dim() == 4:
        return t
    return t.reshape(1, -1, *t.shape[-2:]) if t.dim() > 1 \
        else t.reshape(1, 1, 1, -1)


def _launch_fwd(x, mask, causal: bool, fns=None, plan=None):
    """``plan``: a :func:`launch_plan` in place of the wrapper's own (the
    variants tool)."""
    dev = cuda_device("softmax_mask", x, mask)
    x4 = _as4d(x.contiguous())
    _, heads, lq, lk = x4.shape
    m4, strides = None, (0, 0, 0)
    if not causal:
        m4 = _as4d(mask.expand(x.shape))
        if m4.stride(-1) != 1:
            m4 = m4.contiguous()
        strides = m4.stride()[:3]
    _check_size("x and the mask", x4, m4)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    rows = x4.numel() // lk if lk else 0
    if rows:
        c = functools.partial(dtype_code, what="softmax_mask")
        plan = plan or launch_plan(rows, lk, heads, masked=not causal,
                                   shared_mask=not causal and strides[1] == 0)
        (lq_m, lq_s), (h_m, h_s) = divider(lq), divider(heads)
        with torch.cuda.device(dev):
            err = (fns or _kernels())["softmax_mask_fwd"](
                ptr(x4), ptr(m4), ptr(out), rows, lk, lq, heads, *strides,
                int(causal), c(x.dtype), c(None if m4 is None else m4.dtype),
                as_int32(lq_m), lq_s, as_int32(h_m), h_s, plan.items,
                plan.elems, plan.rpw, int(plan.head_major), plan.grid,
                plan.threads, stream(dev))
        _native.check(err, "softmax_mask forward kernel launch")
        # the mask as given: a mask broadcast over heads is read once
        launches.launched(1, _native.io_cost, x, None if causal else mask,
                          out)
    return out


def _launch_bwd(y, dy, fns=None, plan=None):
    dev = cuda_device("softmax_mask", y, dy)
    dy = dy.to(y.dtype).contiguous()
    _check_size("y", y)
    dx = torch.empty(y.shape, dtype=y.dtype, device=dev)
    lk = y.shape[-1]
    rows = y.numel() // lk if lk else 0
    if rows:
        plan = plan or launch_plan(rows, lk, backward=True)
        with torch.cuda.device(dev):
            err = (fns or _kernels())["softmax_mask_bwd"](
                ptr(y), ptr(dy), ptr(dx), rows, lk,
                dtype_code(y.dtype, "softmax_mask"), *_plan_args(plan),
                stream(dev))
        _native.check(err, "softmax_mask backward kernel launch")
        launches.launched(1, _native.io_cost, y, dy, dx)
    return dx


class SoftmaxMask(torch.autograd.Function):
    """The kernel with its backward kernel; saves the output."""

    @staticmethod
    def forward(ctx, x, mask, causal):
        y = _launch_fwd(x, mask, causal)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return _launch_bwd(y, dy), None, None


def softmax_mask(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 causal: bool = False) -> torch.Tensor:
    """``softmax(x + mask)`` over the last axis (``causal``: the upper
    triangle masked instead, no mask), x at least 2-D with the mask
    broadcasting to it: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if not causal and mask is None:
        raise ValueError("softmax_mask: pass a mask, or causal=True")
    if x.dim() < 2 and causal:
        raise ValueError("softmax_mask: the upper triangle needs (.., Lq, "
                         "Lk)")
    if plain_path(x):
        return softmax_mask_reference(x, mask, causal)
    return SoftmaxMask.apply(x, None if causal else mask, causal)
