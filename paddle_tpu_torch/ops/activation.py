"""Activation functions, the port of ``paddle_tpu/ops/activation.py``
(``paddle.nn.functional``'s activations) as functions on tensors. Each
casts its input as the active ``amp.auto_cast`` says for the JAX op of its
name (``cast_inputs``); ``relu``, ``gelu`` and ``silu`` are
``ops/nn_ops.py``'s (ReLU and GELU on the epilogue kernel K6 on a card).
The formulas are the JAX package's (``jax.nn``'s where it calls them);
``gumbel_softmax`` draws its noise from the caller's ``torch.Generator``
(the JAX package from its global key), so the two agree in distribution,
not in bits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as TF

from ..amp import cast_inputs
from .nn_ops import gelu, relu, silu

__all__ = ["celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink",
           "hardsigmoid", "hardswish", "hardtanh", "leaky_relu",
           "log_sigmoid", "log_softmax", "maxout", "mish", "prelu", "relu",
           "relu6", "selu", "sigmoid", "silu", "softmax", "softplus",
           "softshrink", "softsign", "swish", "tanhshrink",
           "thresholded_relu"]


def _unary(op: str, fn):
    def f(x, name=None):
        (x,) = cast_inputs(op, x)
        return fn(x)
    f.__name__ = op
    f.__doc__ = f"``{op}`` (``paddle_tpu/ops/activation.py``)."
    return f


relu6 = _unary("relu6", TF.relu6)
swish = _unary("swish", TF.silu)
softsign = _unary("softsign", lambda x: x / (x.abs() + 1))
tanhshrink = _unary("tanhshrink", lambda x: x - torch.tanh(x))
mish = _unary("mish", lambda x: x * torch.tanh(TF.softplus(x)))
hardswish = _unary("hardswish", lambda x: x * TF.relu6(x + 3.0) / 6.0)
log_sigmoid = _unary("log_sigmoid", TF.logsigmoid)
sigmoid = _unary("sigmoid", torch.sigmoid)


def hardsigmoid(x, slope: float = 0.1666667, offset: float = 0.5,
                name=None):
    """``max(0, min(1, slope * x + offset))``."""
    (x,) = cast_inputs("hardsigmoid", x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def _to(x, dtype):
    return x if dtype is None else x.to(dtype)


def softmax(x, axis: int = -1, dtype=None, name=None):
    (x,) = cast_inputs("softmax", x)
    return torch.softmax(_to(x, dtype), dim=axis)


def log_softmax(x, axis: int = -1, dtype=None, name=None):
    (x,) = cast_inputs("log_softmax", x)
    return torch.log_softmax(_to(x, dtype), dim=axis)


def softplus(x, beta: float = 1.0, threshold: float = 20.0, name=None):
    """``x`` where ``beta x > threshold``, else ``log1p(exp(beta x)) /
    beta``."""
    (x,) = cast_inputs("softplus", x)
    return TF.softplus(x, beta, threshold)


def leaky_relu(x, negative_slope: float = 0.01, name=None):
    (x,) = cast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha: float = 1.0, name=None):
    (x,) = cast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale: float = 1.0507009873554805,
         alpha: float = 1.6732632423543772, name=None):
    (x,) = cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha: float = 1.0, name=None):
    """``max(x, 0) + alpha * expm1(min(x, 0) / alpha)`` (``jax.nn.celu``)."""
    (x,) = cast_inputs("celu", x)
    return torch.clamp_min(x, 0) + alpha * torch.expm1(
        torch.clamp_max(x, 0) / alpha)


def prelu(x, weight, data_format: str = "NCHW", name=None):
    """``x`` where positive, else ``weight * x``; a weight of more than one
    element lies along the channel axis (1, or the last for channels-last
    formats)."""
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x > 0, x, weight * x)


def hardtanh(x, min: float = -1.0, max: float = 1.0, name=None):
    (x,) = cast_inputs("hardtanh", x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold: float = 0.5, name=None):
    (x,) = cast_inputs("hardshrink", x)
    return torch.where(x.abs() > threshold, x, 0.0)


def softshrink(x, threshold: float = 0.5, name=None):
    (x,) = cast_inputs("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def thresholded_relu(x, threshold: float = 1.0, value: float = 0.0,
                     name=None):
    (x,) = cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, value)


def glu(x, axis: int = -1, name=None):
    """The first half along ``axis`` times the sigmoid of the second."""
    (x,) = cast_inputs("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups: int, axis: int = 1, name=None):
    """The maximum over each run of ``groups`` consecutive channels."""
    (x,) = cast_inputs("maxout", x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1, name=None, *,
                   generator: Optional[torch.Generator] = None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g`` drawn from
    ``generator`` (the default generator of x's device without one); with
    ``hard``, the one-hot of the argmax with the soft gradient
    (straight-through)."""
    (x,) = cast_inputs("gumbel_softmax", x)
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log((-torch.log(u.clamp_min(tiny))).clamp_min(tiny))
    g = g.to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y
