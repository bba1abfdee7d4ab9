"""Weight initializers, the port of ``paddle_tpu/nn/initializer.py``
(``paddle.nn.initializer``): ``Constant``, ``Normal``,
``TruncatedNormal``, ``Uniform``, Xavier and Kaiming, each normal and
uniform, ``Assign``, ``Orthogonal``, ``Dirac``, ``calculate_gain`` and
``set_global_initializer``.

An initializer is a callable ``(shape, dtype, device, generator)`` that
returns a new tensor, drawing from ``generator`` (a ``torch.Generator``
on ``device``; the device's default generator when None). The bits
cannot match ``jax.random``'s: the distributions, bounds and fans are the
JAX package's. Fans follow paddle's layouts: a 2-D weight is ``(in,
out)``, a convolution's ``(out, in / groups, *k)`` with the receptive
field's size in both fans.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["Assign", "Constant", "Dirac", "Initializer", "KaimingNormal",
           "KaimingUniform", "Normal", "Orthogonal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "calculate_gain",
           "set_global_initializer"]


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """``init(shape, dtype, device=None, generator=None)`` makes a tensor;
    ``init.init_(param)`` fills an existing one in place."""

    def __call__(self, shape, dtype, device=None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        self._fill(out, generator)
        return out.to(dtype)

    def _fill(self, out: torch.Tensor, generator) -> None:
        raise NotImplementedError

    def init_(self, param: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            param.copy_(self(param.shape, param.dtype, param.device,
                             generator))
        return param


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, out, generator):
        out.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _fill(self, out, generator):
        out.normal_(0.0, 1.0, generator=generator).mul_(self.std).add_(
            self.mean)


class TruncatedNormal(Initializer):
    """A standard normal truncated to ``[a, b]``, then ``* std + mean``."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _fill(self, out, generator):
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, self.a, self.b,
                                    generator=generator)
        out.mul_(self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _fill(self, out, generator):
        out.uniform_(self.low, self.high, generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, out, generator):
        fi, fo = _fans(out.shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        out.normal_(0.0, std, generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, out, generator):
        fi, fo = _fans(out.shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        out.uniform_(-limit, limit, generator=generator)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain_over_root_fan(self, shape) -> float:
        fi = self.fan_in or _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope) \
            if self.nonlinearity == "leaky_relu" \
            else calculate_gain(self.nonlinearity)
        return gain / math.sqrt(fi)


class KaimingNormal(_Kaiming):
    def _fill(self, out, generator):
        out.normal_(0.0, self._gain_over_root_fan(out.shape),
                    generator=generator)


class KaimingUniform(_Kaiming):
    def _fill(self, out, generator):
        limit = math.sqrt(3.0) * self._gain_over_root_fan(out.shape)
        out.uniform_(-limit, limit, generator=generator)


class Assign(Initializer):
    """The given value (a tensor, an array or a list), reshaped to the
    shape asked for."""

    def __init__(self, value, name=None):
        self.value = value

    def _fill(self, out, generator):
        v = torch.as_tensor(np.asarray(self.value) if not isinstance(
            self.value, torch.Tensor) else self.value)
        out.copy_(v.reshape(out.shape))


class Orthogonal(Initializer):
    """The Q of a QR of normal draws (signs fixed by R's diagonal), rows
    and columns flattened past the first axis, times ``gain``."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _fill(self, out, generator):
        rows = out.shape[0]
        cols = int(np.prod(out.shape[1:]))
        flat = torch.empty(max(rows, cols), min(rows, cols),
                           dtype=torch.float32, device=out.device)
        flat.normal_(generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        out.copy_((self.gain * q[:rows, :cols]).reshape(out.shape))


class Dirac(Initializer):
    """1 at the kernel's centre of output channel ``i`` and input channel
    ``i mod in``, for the first ``min(out, in * groups)`` outputs."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _fill(self, out, generator):
        out.zero_()
        oc, ic = out.shape[0], out.shape[1]
        centers = tuple(s // 2 for s in out.shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + centers] = 1.0


def _to_initializer(init):
    if callable(init):
        return init
    raise TypeError(f"cannot use {init!r} as an initializer")


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None) -> None:
    """Default initializers of parameters made from now on (an explicit
    ``ParamAttr`` initializer still wins); None resets."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def _global_default(is_bias: bool):
    return _global_bias_init if is_bias else _global_weight_init
