"""Activation layers, the port of ``paddle_tpu/nn/activation.py``: each
calls its function of ``ops/activation.py``; ``PReLU`` holds its
``weight``."""

from __future__ import annotations

from ..ops import activation as F
from ..ops.nn_ops import tanh
from .initializer import Constant
from .layer import Layer

__all__ = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "PReLU", "ReLU", "ReLU6", "SELU", "Sigmoid",
           "SiLU", "Silu", "Softmax", "Softmax2D", "Softplus", "Softshrink",
           "Softsign", "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU"]


def _simple(cls_name: str, fn):
    def __init__(self, name=None):
        Layer.__init__(self)

    def forward(self, x):
        return fn(x)

    return type(cls_name, (Layer,), {"__init__": __init__,
                                     "forward": forward,
                                     "__doc__": f"``{fn.__name__}``."})


ReLU = _simple("ReLU", F.relu)
ReLU6 = _simple("ReLU6", F.relu6)
Sigmoid = _simple("Sigmoid", F.sigmoid)
Tanh = _simple("Tanh", tanh)
SiLU = _simple("SiLU", F.silu)
Swish = _simple("Swish", F.swish)
Mish = _simple("Mish", F.mish)
Hardswish = _simple("Hardswish", F.hardswish)
Hardsigmoid = _simple("Hardsigmoid", F.hardsigmoid)
Softsign = _simple("Softsign", F.softsign)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
LogSigmoid = _simple("LogSigmoid", F.log_sigmoid)
Silu = SiLU


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class Softmax2D(Layer):
    """Softmax across the channels of each (C, H, W) position."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softmax(x, axis=-3)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self.threshold, self.value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold, self.value)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)


class PReLU(Layer):
    """``weight`` of ``num_parameters`` elements, ``init`` each."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)
