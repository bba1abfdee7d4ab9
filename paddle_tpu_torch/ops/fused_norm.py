"""RMSNorm and LayerNorm with the pre-norm residual (and bias) add: the
hand-written Hopper kernel (``csrc/fused_norm.cu``, forward and backward)
and its plain PyTorch version. The port's own kernel: the JAX package's
``rms_norm`` / ``layer_norm`` (``paddle_tpu/ops/nn_ops.py``) and
``fused_rms_norm`` / ``fused_layer_norm``
(``paddle_tpu/incubate/nn_functional.py:23-91``) are XLA-fused jnp, no
Pallas function.

A :class:`NormSpec` says what is computed: the kind, epsilon, the dtype
of the add (``add``; None: no add), the dtype the norm's input is cast to
(``norm``), the weight's and bias's cast dtypes and the output dtype, and
the order of the weight multiply. The plain order (``fused=False``, the
port's ``rms_norm`` and ``layer_norm``) rounds the normalised value to
``norm`` before the weight; the fused order (``incubate``'s
``fused_rms_norm`` / ``fused_layer_norm``) multiplies by the weight in
fp32 and rounds once. The statistics are fp32 in both.

:func:`fused_norm` runs :func:`fused_norm_reference` for CPU tensors (its
gradients by autograd) and the kernel, through an autograd function whose
backward is the kernel's backward, for CUDA tensors; any other device
raises. The backward's weight, bias and pre-bias gradients are per-block
partial sums folded in a fixed order by a second kernel: no atomics, so
launches on the same inputs agree bit for bit, inside a CUDA graph too.
:func:`fused_norm_bwd_reference` is the backward's plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import _native
from ._fused_io import (aligned16, cuda_device, dtype_code, plain_path,
                        ptr, stream)

__all__ = ["NormSpec", "fused_norm", "fused_norm_bwd_reference",
           "fused_norm_reference", "launches"]

launches = _native.LaunchCounter("fused_norm")

# blocks of the backward at most (each writes one partial sum a column)
NBLK = 1024
# the backward keeps five fp32 rows in shared memory (227 KB a block)
MAX_COLS = 11264

_ARGTYPES_FWD = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 14 + [ctypes.c_float, ctypes.c_void_p]
_ARGTYPES_BWD = [ctypes.c_void_p] * 13 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 19 + [ctypes.c_void_p]


@dataclass(frozen=True)
class NormSpec:
    kind: str                             # "rms" or "ln"
    eps: float
    norm: torch.dtype                     # the norm's input is cast to it
    out: torch.dtype
    add: Optional[torch.dtype] = None     # the pre-norm add's dtype
    weight: Optional[torch.dtype] = None  # the weight's cast dtype
    bias: Optional[torch.dtype] = None    # the bias's cast dtype
    fused: bool = False                   # weight before the rounding
    naxes: int = 1                        # trailing axes normalised


def bind(lib) -> dict:
    """The C entry points of a built ``fused_norm`` library, typed."""
    fns = {}
    for name, types in (("fused_norm_fwd", _ARGTYPES_FWD),
                        ("fused_norm_bwd", _ARGTYPES_BWD)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("fused_norm"))


def _stats(hf: torch.Tensor, spec: NormSpec):
    dims = tuple(range(hf.dim() - spec.naxes, hf.dim()))
    if spec.kind == "rms":
        r = torch.rsqrt(hf.square().mean(dim=dims, keepdim=True) + spec.eps)
        return hf * r, r
    mu = hf.mean(dim=dims, keepdim=True)
    var = hf.var(dim=dims, unbiased=False, keepdim=True)
    r = torch.rsqrt(var + spec.eps)
    return (hf - mu) * r, r


def fused_norm_reference(x, weight=None, bias=None, residual=None,
                         pre_bias=None, *, spec: NormSpec):
    """Plain version: ``(out, h)``, ``h`` the add's result (None without
    an add), in the ops of the port's ``rms_norm`` / ``layer_norm`` (plain
    order) or of the JAX package's ``fused_*_norm`` (fused order)."""
    h = None
    if spec.add is not None:
        h = x.to(spec.add)
        if pre_bias is not None:
            h = h + pre_bias.to(spec.add)
        if residual is not None:
            h = h + residual.to(spec.add)
    xn = (x if h is None else h).to(spec.norm)
    w = None if weight is None else weight.to(spec.weight)
    b = None if bias is None else bias.to(spec.bias)
    n, _ = _stats(xn.float(), spec)
    if spec.fused:
        out = n
        if w is not None:
            out = out * w.float()
        if b is not None:
            out = out + b.float()
        return out.to(spec.out), h
    out = n.to(spec.norm)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out, h


def fused_norm_bwd_reference(dy, dres, h, weight=None, *, spec: NormSpec,
                             dx_dtype: torch.dtype, bias_dtype=None,
                             pre_bias_dtype=None):
    """Plain version of the backward, in the kernel's operations: from the
    output's gradient ``dy``, the add result's ``dres`` (or None) and the
    norm's saved input ``h`` (the add's result, else x), returns ``(dx,
    dweight, dbias, dpre_bias)`` (None where there is no such input; dx in
    ``dx_dtype``, the others in their inputs' dtypes)."""
    cols = math.prod(h.shape[h.dim() - spec.naxes:])
    hn = h.to(spec.norm).float().reshape(-1, cols)
    g = dy.float().reshape(-1, cols)
    n, r = _stats(hn, NormSpec(spec.kind, spec.eps, spec.norm, spec.out))
    w = None if weight is None else \
        weight.to(spec.weight).float().reshape(cols)
    dw = db = dpb = None
    if spec.fused:
        gn = g if w is None else g * w
        if w is not None:
            dw = (g * n).sum(0)
    else:
        gn = (g if w is None else (g * w).to(spec.out).float()) \
            .to(spec.norm).float()
        if w is not None:
            dw = (g * n.to(spec.norm).float()).to(spec.out).float().sum(0) \
                .to(spec.out)
    if bias_dtype is not None:
        db = g.sum(0) if spec.fused else g.sum(0).to(spec.out)
        db = db.to(spec.bias).to(bias_dtype)
    if dw is not None:
        dw = dw.to(spec.weight).to(weight.dtype)
    ma = (gn * n).mean(-1, keepdim=True)
    t = gn - n * ma
    if spec.kind == "ln":
        t = t - gn.mean(-1, keepdim=True)
    v = (r * t).to(spec.norm).float()
    if spec.add is not None:
        v = v.to(spec.add).float()
        if dres is not None:
            v = (v + dres.float().reshape(-1, cols)).to(spec.add).float()
        if pre_bias_dtype is not None:
            dpb = v.sum(0).to(spec.add).to(pre_bias_dtype)
    return v.to(dx_dtype).reshape(h.shape), dw, db, dpb


def _vec(cols: int, *ts) -> int:
    return 8 if cols % 8 == 0 and aligned16(*ts) else 1


def _cols(x: torch.Tensor, spec: NormSpec) -> int:
    cols = math.prod(x.shape[x.dim() - spec.naxes:])
    if not 0 < cols <= MAX_COLS:
        raise ValueError(f"fused_norm: the kernel normalises rows of 1 to "
                         f"{MAX_COLS} elements, got {cols}")
    return cols


def _launch_fwd(x, weight, bias, residual, pre_bias, spec, fns=None):
    """The forward kernel: ``(out, res_out, mean, rstd)``."""
    dev = cuda_device("fused_norm", x, weight, bias, residual, pre_bias)
    cols = _cols(x, spec)
    x = x.contiguous()
    if residual is not None:
        if residual.shape != x.shape:
            raise ValueError(f"fused_norm: residual {tuple(residual.shape)} "
                             f"must have x's shape {tuple(x.shape)}")
        residual = residual.contiguous()
    vecs = [t if t is None else t.contiguous()
            for t in (weight, bias, pre_bias)]
    for t in vecs:
        if t is not None and t.numel() != cols:
            raise ValueError(f"fused_norm: weights and biases must have "
                             f"{cols} elements, got {t.numel()}")
    weight, bias, pre_bias = vecs
    rows = x.numel() // cols
    out = torch.empty(x.shape, dtype=spec.out, device=dev)
    has_add = spec.add is not None
    res_out = torch.empty(x.shape, dtype=spec.add, device=dev) \
        if has_add else None
    mean = torch.empty(rows, dtype=torch.float32, device=dev) \
        if spec.kind == "ln" else None
    rstd = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows:
        fn = (fns or _kernels())["fused_norm_fwd"]
        with torch.cuda.device(dev):
            err = fn(ptr(x), ptr(residual), ptr(pre_bias), ptr(weight),
                     ptr(bias), ptr(out), ptr(res_out), ptr(mean), ptr(rstd),
                     rows, cols, dtype_code(x.dtype, "fused_norm"),
                     dtype_code(None if residual is None else residual.dtype,
                                "fused_norm"),
                     dtype_code(None if pre_bias is None else pre_bias.dtype,
                                "fused_norm"),
                     dtype_code(None if weight is None else weight.dtype,
                                "fused_norm"),
                     dtype_code(spec.weight, "fused_norm"),
                     dtype_code(None if bias is None else bias.dtype,
                                "fused_norm"),
                     dtype_code(spec.bias, "fused_norm"),
                     dtype_code(spec.out, "fused_norm"),
                     dtype_code(spec.add, "fused_norm"),
                     dtype_code(spec.norm, "fused_norm"),
                     int(spec.kind == "ln"), int(spec.fused),
                     _vec(cols, x, residual, pre_bias, weight, bias, out,
                          res_out),
                     spec.eps, stream(dev))
        _native.check(err, "fused_norm forward kernel launch")
        launches.count += 1
    return out, res_out, mean, rstd


def _launch_bwd(dy, dres, h, mean, rstd, weight, spec, *, dx_dtype,
                want_w, bias_dtype, pre_bias_dtype, fns=None):
    """The backward kernel: ``(dx, dw, db, dpb)``; dw, db and dpb are
    None where not asked for (``want_w``, ``bias_dtype``,
    ``pre_bias_dtype``)."""
    dev = cuda_device("fused_norm", dy, dres, h, weight)
    cols = _cols(h, spec)
    dy, h = dy.contiguous(), h.contiguous()
    dres = None if dres is None else dres.contiguous()
    weight = None if weight is None else weight.contiguous()
    rows = h.numel() // cols
    nblk = max(1, min(rows, NBLK))
    dx = torch.empty(h.shape, dtype=dx_dtype, device=dev)

    def part(on):
        return torch.empty(nblk, cols, dtype=torch.float32, device=dev) \
            if on else None
    want_b, want_pb = bias_dtype is not None, pre_bias_dtype is not None
    pw, pb, ppb = part(want_w), part(want_b), part(want_pb)
    dw = torch.empty(cols, dtype=weight.dtype, device=dev) if want_w else None
    db = torch.empty(cols, dtype=bias_dtype, device=dev) if want_b else None
    dpb = torch.empty(cols, dtype=pre_bias_dtype, device=dev) \
        if want_pb else None
    if rows:
        fn = (fns or _kernels())["fused_norm_bwd"]
        c = functools.partial(dtype_code, what="fused_norm")
        with torch.cuda.device(dev):
            err = fn(ptr(dy), ptr(dres), ptr(h), ptr(mean), ptr(rstd),
                     ptr(weight), ptr(dx), ptr(pw), ptr(pb), ptr(ppb),
                     ptr(dw), ptr(db), ptr(dpb), rows, cols, nblk,
                     c(dy.dtype), c(None if dres is None else dres.dtype),
                     c(h.dtype), c(None if weight is None else weight.dtype),
                     c(spec.weight), c(dx_dtype), c(spec.bias),
                     c(bias_dtype), c(spec.add), c(pre_bias_dtype),
                     c(spec.out), c(spec.add), c(spec.norm),
                     int(spec.add is not None), int(spec.kind == "ln"),
                     int(spec.fused), _vec(cols, dy, dres, h, weight, dx),
                     stream(dev))
        _native.check(err, "fused_norm backward kernel launch")
        launches.count += 1
    if dw is not None and weight.shape != dw.shape:
        dw = dw.reshape(weight.shape)
    return dx, dw, db, dpb


class FusedNorm(torch.autograd.Function):
    """The kernel with its backward kernel; outputs ``out`` or, with an
    add, ``(out, h)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, pre_bias, spec):
        ctx.set_materialize_grads(False)
        out, h, mean, rstd = _launch_fwd(x, weight, bias, residual,
                                         pre_bias, spec)
        ctx.save_for_backward(x if h is None else h, mean, rstd, weight)
        ctx.spec = spec
        ctx.dtypes = (x.dtype, None if bias is None else bias.dtype,
                      None if pre_bias is None else pre_bias.dtype)
        ctx.shapes = tuple(None if t is None else t.shape
                           for t in (weight, bias, pre_bias))
        return out if h is None else (out, h)

    @staticmethod
    def backward(ctx, dy, dres=None):
        h, mean, rstd, weight = ctx.saved_tensors
        spec = ctx.spec
        x_dtype, b_dtype, pb_dtype = ctx.dtypes
        need = ctx.needs_input_grad
        if dy is None:
            dy = torch.zeros(h.shape, dtype=spec.out, device=h.device)
        dx, dw, db, dpb = _launch_bwd(
            dy, dres, h, mean, rstd, weight, spec,
            dx_dtype=x_dtype if spec.add is None else spec.add,
            want_w=weight is not None and need[1],
            bias_dtype=b_dtype if need[2] else None,
            pre_bias_dtype=pb_dtype if need[4] else None)
        shapes = ctx.shapes
        if db is not None:
            db = db.reshape(shapes[1])
        if dpb is not None:
            dpb = dpb.reshape(shapes[2])
        return dx, dw, db, dx if need[3] else None, dpb, None


def fused_norm(x, weight=None, bias=None, residual=None, pre_bias=None, *,
               spec: NormSpec) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(out, h)`` as :func:`fused_norm_reference` computes it (``h``:
    None without an add): the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if plain_path(x):
        return fused_norm_reference(x, weight, bias, residual, pre_bias,
                                    spec=spec)
    out = FusedNorm.apply(x, weight, bias, residual, pre_bias, spec)
    return out if spec.add is not None else (out, None)
