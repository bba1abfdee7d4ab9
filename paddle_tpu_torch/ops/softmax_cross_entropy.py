"""Hard-label softmax cross-entropy over the last axis: the hand-written
Hopper kernel (``csrc/softmax_cross_entropy.cu``, forward and backward)
and its plain PyTorch version. The port's own kernel: the JAX package's
``cross_entropy`` (``paddle_tpu/ops/loss_ops.py``) is XLA-fused jnp, no
Pallas function.

The kernel reads bf16, fp16 or fp32 logits where they lie, at their row
strides, and does the op's cast (``dtype``: fp32 under AMP) as it loads
them; with ``shift`` it reads rows ``l < L - 1`` of ``(B, L, V)`` logits
against labels ``[:, 1:]`` (the causal LM loss) and writes the gradient of
the whole logits, 0 in the last row, so neither the slice nor its backward
copies anything. It keeps each row's max and log-sum-exp (fp32) for the
backward; the mean over the rows that count (``ignore_index`` is honoured
when it is >= 0; the count is clamped at 1), or the sum, and the count are
folded on the device in a fixed order (``reduction="none"`` returns the
per-row losses), and the backward reads the loss's gradient there, so
nothing is read on the host and launches agree bit for bit.

``label_smoothing`` and a class ``weight`` follow the JAX package's
``cross_entropy``: the target is ``one_hot(y) * (1 - eps) + eps / V``, a
label outside ``[0, V)`` one-hots to zeros (its row scores ``eps`` times the
smoothing term, 0 without smoothing, and still counts), and ``w[y]`` is read
as ``jnp.take`` reads it (labels in ``[-V, 0)`` wrap, others give NaN).

:func:`softmax_cross_entropy` runs :func:`softmax_cross_entropy_reference`
for CPU tensors (gradients by autograd) and the kernel for CUDA tensors;
any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _native
from ._fused_io import (aligned16, cuda_device, dtype_code, plain_path,
                        ptr, stream)

__all__ = ["cross_entropy_cost", "launches", "reduce_loss",
           "softmax_cross_entropy", "softmax_cross_entropy_reference",
           "take_weight"]

launches = _native.LaunchCounter("softmax_cross_entropy")

_ARGTYPES_FWD = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 4 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_ARGTYPES_BWD = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 4 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# the kernels' reduction codes
REDUCTIONS = {"none": 0, "sum": 1, "mean": 2}


def bind(lib) -> dict:
    """The C entry points of a built ``softmax_cross_entropy`` library."""
    fns = {}
    for name, types in (("ce_fwd", _ARGTYPES_FWD), ("ce_bwd", _ARGTYPES_BWD)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("softmax_cross_entropy"))


def _flat_labels(label: torch.Tensor, ndim: int) -> torch.Tensor:
    li = label
    if li.dim() == ndim and li.shape[-1] == 1:
        li = li.squeeze(-1)
    return li


def take_weight(weight: torch.Tensor, li: torch.Tensor) -> torch.Tensor:
    """``jnp.take(weight, li)`` in its default fill mode: labels in ``[-V,
    0)`` wrap, labels outside ``[-V, V)`` read NaN."""
    v = weight.shape[0]
    inside = (li >= -v) & (li < v)
    got = weight[torch.where(inside, li, 0)]
    return torch.where(inside, got, torch.nan)


def softmax_cross_entropy_reference(logits, label, ignore_index: int = -100,
                                    *, dtype: Optional[torch.dtype] = None,
                                    shift: bool = False, weight=None,
                                    label_smoothing: float = 0.0,
                                    reduction: str = "mean") -> torch.Tensor:
    """Plain version, in the ops of the port's former ``cross_entropy``:
    log-softmax in fp32, the label's entry (0 for a label outside the
    vocabulary), the smoothing term and the class weight as the JAX
    package's ``cross_entropy`` has them, then the reduction (``mean``: over
    the rows that count)."""
    if shift:
        v = logits.shape[-1]
        logits = logits[:, :-1, :].reshape(-1, v)
        label = label[:, 1:].reshape(-1)
    x = logits if dtype is None else logits.to(dtype)
    logp = torch.log_softmax(x.float(), dim=-1)
    v = logp.shape[-1]
    li = _flat_labels(label.long(), logp.dim())
    inside = (li >= 0) & (li < v)
    loss = -logp.gather(-1, torch.where(inside, li, 0).unsqueeze(-1)) \
        .squeeze(-1)
    # a weighted row outside the vocabulary scores 0 * sum(logp): JAX's
    # zero target, whose gradient is NaN where w[y] is
    loss = torch.where(inside, loss,
                       0.0 if weight is None else logp.sum(-1) * 0.0)
    if label_smoothing > 0.0:
        loss = loss * (1.0 - label_smoothing) \
            - logp.sum(-1) * (label_smoothing / v)
    if weight is not None:
        loss = loss * take_weight(weight.float(), li)
    valid = li != ignore_index if ignore_index >= 0 else None
    if valid is None:
        return reduce_loss(loss, reduction)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp(min=1.0)
    return reduce_loss(loss, reduction)


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    """The JAX package's ``_reduce``: ``mean``, ``sum`` or the losses."""
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _as_3d(logits: torch.Tensor) -> torch.Tensor:
    """``(B, L, V)`` view of logits ``(..., V)`` with a contiguous last
    axis (a copy only where no such view exists)."""
    if logits.stride(-1) != 1:
        logits = logits.contiguous()
    if logits.dim() == 1:
        return logits.view(1, 1, -1)
    if logits.dim() == 2:
        return logits.unsqueeze(0)
    if logits.dim() == 3:
        return logits
    try:
        return logits.view(-1, logits.shape[-2], logits.shape[-1])
    except RuntimeError:
        return logits.contiguous().view(-1, logits.shape[-2],
                                        logits.shape[-1])


def _labels_2d(label: torch.Tensor, shape) -> torch.Tensor:
    if label.dtype not in (torch.int32, torch.int64):
        label = label.long()
    return label.reshape(shape)


def cross_entropy_cost(x3, lab2, l_used: int, dx=None, weight=None,
                       rows_out: bool = False) -> tuple:
    """A launch's ``(flops, bytes)``: the logits of the rows it scores
    (``l_used`` of each sequence, read in place), the labels, the class
    weights the rows read (one a row, at most the table), the per-row
    losses (``rows_out``: the forward's result under ``reduction="none"``,
    the backward's per-row gradient) and the backward's gradient of the
    whole (B, L, V) logits; the per-row fp32 statistics (12 bytes a row)
    are left out."""
    nb, _, v = x3.shape
    rows = nb * l_used
    extra = 4 * (min(rows, weight.shape[0]) if weight is not None else 0) \
        + (4 * rows if rows_out else 0)
    return 0.0, float(rows * v * x3.element_size()
                      + _native.tensor_bytes(lab2, dx) + extra)


def _launch_fwd(x3, lab2, l_used: int, ignore: int, x_cast, fns=None, *,
                weight=None, eps: float = 0.0, reduction: str = "mean"):
    """``(out, m, logs, valid)``: ``out`` is ``[mean or sum, count]``, or
    the per-row losses under ``reduction="none"``."""
    dev = cuda_device("softmax_cross_entropy", x3, lab2,
                      *(() if weight is None else (weight,)))
    nb, _, v = x3.shape
    n = nb * l_used
    red = REDUCTIONS[reduction]
    f32 = dict(dtype=torch.float32, device=dev)
    m, logs, loss, valid = (torch.empty(n, **f32) for _ in range(4))
    out = torch.empty(2, **f32)
    sb, sl = x3.stride(0), x3.stride(1)
    vec = 8 if v % 8 == 0 and sb % 8 == 0 and sl % 8 == 0 and \
        aligned16(x3) else 1
    c = functools.partial(dtype_code, what="softmax_cross_entropy")
    with torch.cuda.device(dev):
        err = (fns or _kernels())["ce_fwd"](
            ptr(x3), ptr(lab2), _weight_ptr(weight, v), ptr(m), ptr(logs),
            ptr(loss), ptr(valid), ptr(out), nb, l_used, v, sb, sl,
            lab2.stride(0), lab2.stride(1), ignore, c(x3.dtype), c(x_cast),
            int(lab2.dtype == torch.int64), vec, float(eps), red,
            stream(dev))
    _native.check(err, "softmax_cross_entropy forward kernel launch")
    launches.launched(1, cross_entropy_cost, x3, lab2, l_used, None, weight,
                      red == 0)
    return (loss if red == 0 else out), m, logs, valid


def _weight_ptr(weight, v: int):
    """The class weights' address: fp32, contiguous, ``(V,)``; None for
    none."""
    if weight is None:
        return None
    if weight.dtype != torch.float32 or weight.shape != (v,) \
            or not weight.is_contiguous():
        raise ValueError(f"softmax_cross_entropy: the class weight must be "
                         f"a contiguous fp32 ({v},), got {weight.dtype} "
                         f"{tuple(weight.shape)}")
    return ptr(weight)


def _launch_bwd(x3, lab2, l_used: int, ignore: int, x_cast, m, logs, valid,
                out, g, fns=None, *, weight=None, eps: float = 0.0,
                reduction: str = "mean"):
    """The gradient of the (B, L, V) logits, contiguous."""
    dev = cuda_device("softmax_cross_entropy", x3, lab2, g)
    nb, length, v = x3.shape
    red = REDUCTIONS[reduction]
    dx = torch.empty(x3.shape, dtype=x3.dtype, device=dev)
    sb, sl = x3.stride(0), x3.stride(1)
    vec = 8 if v % 8 == 0 and sb % 8 == 0 and sl % 8 == 0 and \
        aligned16(x3, dx) else 1
    g = g.float().contiguous()
    c = functools.partial(dtype_code, what="softmax_cross_entropy")
    with torch.cuda.device(dev):
        err = (fns or _kernels())["ce_bwd"](
            ptr(x3), ptr(lab2), _weight_ptr(weight, v), ptr(m), ptr(logs),
            ptr(valid), ptr(out), ptr(g), ptr(dx), nb, length, l_used, v, sb,
            sl, lab2.stride(0), lab2.stride(1), ignore, c(x3.dtype),
            c(x_cast), int(lab2.dtype == torch.int64), vec, float(eps), red,
            stream(dev))
    _native.check(err, "softmax_cross_entropy backward kernel launch")
    launches.launched(1, cross_entropy_cost, x3, lab2, l_used, dx, weight,
                      red == 0)
    return dx


class SoftmaxCrossEntropy(torch.autograd.Function):
    """The kernel on ``(B, L, V)`` logits and ``(B, L_used)`` labels with
    its backward kernel; returns the mean or sum (a 0-d fp32 tensor), or
    the ``(B * L_used,)`` per-row losses under ``reduction="none"``."""

    @staticmethod
    def forward(ctx, x3, lab2, l_used: int, ignore: int, x_cast,
                weight=None, eps: float = 0.0, reduction: str = "mean"):
        opts = dict(weight=weight, eps=eps, reduction=reduction)
        out, m, logs, valid = _launch_fwd(x3, lab2, l_used, ignore, x_cast,
                                          **opts)
        ctx.save_for_backward(x3, lab2, m, logs, valid, out)
        ctx.args = (l_used, ignore, x_cast, opts)
        return out if reduction == "none" else out[0]

    @staticmethod
    def backward(ctx, g):
        x3, lab2, m, logs, valid, out = ctx.saved_tensors
        l_used, ignore, x_cast, opts = ctx.args
        dx = _launch_bwd(x3, lab2, l_used, ignore, x_cast, m, logs, valid,
                         out, g, **opts)
        return dx, None, None, None, None, None, None, None


def softmax_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                          ignore_index: int = -100, *,
                          dtype: Optional[torch.dtype] = None,
                          shift: bool = False, weight=None,
                          label_smoothing: float = 0.0,
                          reduction: str = "mean") -> torch.Tensor:
    """The hard-label cross-entropy over ``logits``' last axis, labels of
    ``logits.shape[:-1]`` (or with a trailing 1), reduced by ``reduction``
    (``"none"``: the labels' shape); ``shift``: token ``l + 1`` of ``(B,
    L)`` labels against row ``l < L - 1`` of ``(B, L, V)`` logits.
    ``dtype``: what the op casts the logits to; ``weight``: class weights
    ``(V,)``; ``label_smoothing``: eps. The plain version for CPU tensors,
    the kernel for CUDA tensors."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"reduction must be one of {sorted(REDUCTIONS)}, "
                         f"got {reduction!r}")
    if plain_path(logits):
        return softmax_cross_entropy_reference(
            logits, label, ignore_index, dtype=dtype, shift=shift,
            weight=weight, label_smoothing=label_smoothing,
            reduction=reduction)
    x_cast = dtype or logits.dtype
    opts = (None if weight is None else weight.detach().float().contiguous(),
            float(label_smoothing), reduction)
    if shift:
        if logits.dim() != 3 or label.shape != logits.shape[:2]:
            raise ValueError(f"softmax_cross_entropy(shift=True) wants "
                             f"(B, L, V) logits and (B, L) labels, got "
                             f"{tuple(logits.shape)}, {tuple(label.shape)}")
        x3 = _as_3d(logits)
        lab2 = _labels_2d(label, label.shape)[:, 1:]
        return SoftmaxCrossEntropy.apply(x3, lab2, x3.shape[1] - 1,
                                         ignore_index, x_cast, *opts)
    label = _flat_labels(label, logits.dim())
    if label.shape != logits.shape[:-1]:
        raise ValueError(f"softmax_cross_entropy: labels "
                         f"{tuple(label.shape)} must have the logits' leading "
                         f"shape {tuple(logits.shape[:-1])}")
    x3 = _as_3d(logits)
    lab2 = _labels_2d(label, x3.shape[:2])
    loss = SoftmaxCrossEntropy.apply(x3, lab2, x3.shape[1], ignore_index,
                                     x_cast, *opts)
    return loss.view(label.shape) if reduction == "none" else loss
