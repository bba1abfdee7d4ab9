"""Hidden dropout, paddle's ``upscale_in_train`` and ``downscale_in_infer``
modes with an optional residual add: the hand-written Hopper kernel
(``csrc/dropout.cu``, forward and backward) and its plain PyTorch version.
The port's own kernel: the JAX package draws these masks with
``jax.random`` inside XLA-fused jnp (``paddle_tpu/incubate/
nn_functional.py:130-142``), no Pallas function.

The mask is a counter-based hash, never stored: element ``i`` of x (its
flat row-major index) is kept where B0's lowbias32 hash
(``flash_attention.keep_mask_reference``) of ``(seed, STREAM, i >> 32,
i mod 2^32)`` falls below ``1 - p`` (fp32). The seed is a 0-d int64 tensor
read on the device (its low 32 bits), so a captured step draws a fresh seed
each replay with no host read, and the backward regenerates the mask. The
plain version computes the same hash, so CPU and card draw the same masks
from the same seed; the masks differ from ``jax.random``'s by design.

Kept elements are multiplied by ``inv_keep``, ``1 / (1 - p)`` rounded once
to fp32 (``flash_attention.dropout_constants``), and rounded to x's dtype;
with a residual, ``out = d + residual`` in the promoted dtype.
:func:`dropout` runs :func:`dropout_reference` for CPU tensors (gradients by
autograd) and the kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _native
from ._fused_io import (aligned16, cuda_device, dtype_code, plain_path,
                        ptr, stream)
from ._u32 import M32, seed_tensor
from .flash_attention import dropout_constants, keep_mask_reference

__all__ = ["STREAM", "draw_seed", "dropout", "dropout_reference", "launches"]

launches = _native.LaunchCounter("dropout")
# the bh term of the hidden-dropout hash ("HIDD"; csrc/dropout.cu STREAM)
STREAM = 0x48494444

_ARGTYPES_OF = {
    "dropout_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "dropout_bwd": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def bind(lib) -> dict:
    """The C entry points of a built ``dropout`` library, typed."""
    fns = {}
    for name, types in _ARGTYPES_OF.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("dropout"))


def draw_seed(generator, device) -> torch.Tensor:
    """A dropout seed, a 0-d int64 tensor on ``device``: the next
    device-side seed of a ``DropoutRNG`` (``generator.next_seed()``, no host
    read), or one 32-bit draw from a ``torch.Generator`` on its own device
    (moved to ``device`` if it lies elsewhere)."""
    if generator is None:
        raise ValueError("dropout draws from the caller's DropoutRNG or "
                         "torch.Generator: pass generator=")
    if hasattr(generator, "next_seed"):
        seed = generator.next_seed()
    else:
        seed = torch.randint(0, M32 + 1, (), dtype=torch.int64,
                             generator=generator, device=generator.device)
    return seed.to(device)


def keep_mask(seed, shape, p: float, device=None) -> torch.Tensor:
    """The kernel's keep mask of a tensor of ``shape``, as a bool tensor."""
    keep_prob, _ = dropout_constants(p)
    i = torch.arange(int(torch.Size(shape).numel()), dtype=torch.int64,
                     device=device).view(shape)
    return keep_mask_reference(seed, STREAM, i >> 32, i & M32, keep_prob)


def dropout_reference(x: torch.Tensor, seed, p: float, *,
                      residual: Optional[torch.Tensor] = None,
                      upscale: bool = True) -> torch.Tensor:
    """Plain version: ``where(keep, x * inv_keep (upscale) or x, 0)`` in x's
    dtype, then ``+ residual`` when given."""
    _, inv = dropout_constants(p)
    keep = keep_mask(seed, x.shape, p, x.device)
    d = torch.where(keep, x * inv if upscale else x, 0.0)
    return d if residual is None else d + residual


def _launch_fwd(x, residual, seed_t, p, upscale, fns=None):
    dev = cuda_device("dropout", x, residual, seed_t)
    x = x.contiguous()
    if residual is not None:
        if residual.shape != x.shape:
            residual = residual.expand(x.shape)
        residual = residual.contiguous()
    out_dtype = x.dtype if residual is None else \
        torch.promote_types(x.dtype, residual.dtype)
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    n = x.numel()
    vec = 8 if n % 8 == 0 and aligned16(x, residual, out) else 1
    keep_prob, inv = dropout_constants(p)
    if n:
        c = functools.partial(dtype_code, what="dropout")
        with torch.cuda.device(dev):
            err = (fns or _kernels())["dropout_fwd"](
                ptr(x), ptr(residual), ptr(out), ptr(seed_t), n, keep_prob,
                inv, int(upscale), c(x.dtype),
                c(None if residual is None else residual.dtype),
                c(out_dtype), vec, stream(dev))
        _native.check(err, "dropout forward kernel launch")
        launches.launched(1, _native.io_cost, x, residual, out)
    return out


def _launch_bwd(dy, seed_t, p, upscale, x_dtype, fns=None):
    dev = cuda_device("dropout", dy, seed_t)
    dy = dy.contiguous()
    dx = torch.empty(dy.shape, dtype=x_dtype, device=dev)
    n = dy.numel()
    vec = 8 if n % 8 == 0 and aligned16(dy, dx) else 1
    keep_prob, inv = dropout_constants(p)
    if n:
        c = functools.partial(dtype_code, what="dropout")
        with torch.cuda.device(dev):
            err = (fns or _kernels())["dropout_bwd"](
                ptr(dy), ptr(dx), ptr(seed_t), n, keep_prob, inv,
                int(upscale), c(x_dtype), c(dy.dtype), vec, stream(dev))
        _native.check(err, "dropout backward kernel launch")
        launches.launched(1, _native.io_cost, dy, dx)
    return dx


class Dropout(torch.autograd.Function):
    """The kernel with its backward kernel, which regenerates the mask from
    the saved seed."""

    @staticmethod
    def forward(ctx, x, residual, seed_t, p, upscale):
        ctx.save_for_backward(seed_t)
        ctx.p, ctx.upscale, ctx.x_dtype = p, upscale, x.dtype
        ctx.res_dtype = None if residual is None else residual.dtype
        return _launch_fwd(x, residual, seed_t, p, upscale)

    @staticmethod
    def backward(ctx, dy):
        (seed_t,) = ctx.saved_tensors
        dx = _launch_bwd(dy, seed_t, ctx.p, ctx.upscale, ctx.x_dtype) \
            if ctx.needs_input_grad[0] else None
        dres = None if ctx.res_dtype is None else dy.to(ctx.res_dtype)
        return dx, dres, None, None, None


def dropout(x: torch.Tensor, p: float, seed, *,
            residual: Optional[torch.Tensor] = None,
            upscale: bool = True) -> torch.Tensor:
    """Dropout of x with probability ``p`` in (0, 1) under ``seed`` (an int
    or a 0-d integer tensor), then ``+ residual``: the plain version for
    CPU tensors, the kernel for CUDA tensors. A residual that broadcasts to
    x is expanded; its gradient is summed back by autograd."""
    if plain_path(x):
        return dropout_reference(x, seed, p, residual=residual,
                                 upscale=upscale)
    seed_t = seed_tensor(seed, x.device)
    if residual is not None and residual.shape != x.shape:
        residual = residual.expand(x.shape)
    return Dropout.apply(x, residual, seed_t, p, upscale)
