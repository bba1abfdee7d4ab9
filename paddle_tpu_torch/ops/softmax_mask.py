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
from typing import Optional

import torch

from .. import _native
from ._fused_io import cuda_device, dtype_code, plain_path, ptr, stream

__all__ = ["launches", "softmax_mask", "softmax_mask_bwd_reference",
           "softmax_mask_reference"]

launches = _native.LaunchCounter("softmax_mask")

_ARGTYPES_OF = {
    "softmax_mask_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "softmax_mask_bwd": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


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


def _launch_fwd(x, mask, causal: bool, fns=None):
    dev = cuda_device("softmax_mask", x, mask)
    x4 = _as4d(x.contiguous())
    _, heads, lq, lk = x4.shape
    m4, strides = None, (0, 0, 0)
    if not causal:
        m4 = _as4d(mask.expand(x.shape))
        if m4.stride(-1) != 1:
            m4 = m4.contiguous()
        strides = m4.stride()[:3]
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    rows = x4.numel() // lk if lk else 0
    if rows:
        c = functools.partial(dtype_code, what="softmax_mask")
        with torch.cuda.device(dev):
            err = (fns or _kernels())["softmax_mask_fwd"](
                ptr(x4), ptr(m4), ptr(out), rows, lk, lq, heads, *strides,
                int(causal), c(x.dtype), c(None if m4 is None else m4.dtype),
                stream(dev))
        _native.check(err, "softmax_mask forward kernel launch")
        launches.count += 1
    return out


def _launch_bwd(y, dy, fns=None):
    dev = cuda_device("softmax_mask", y, dy)
    dy = dy.to(y.dtype).contiguous()
    dx = torch.empty(y.shape, dtype=y.dtype, device=dev)
    lk = y.shape[-1]
    rows = y.numel() // lk if lk else 0
    if rows:
        with torch.cuda.device(dev):
            err = (fns or _kernels())["softmax_mask_bwd"](
                ptr(y), ptr(dy), ptr(dx), rows, lk,
                dtype_code(y.dtype, "softmax_mask"), stream(dev))
        _native.check(err, "softmax_mask backward kernel launch")
        launches.count += 1
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
