"""Convolution layers, the port of ``paddle_tpu/nn/conv.py``: ``Conv1D``,
``Conv2D``, ``Conv3D`` with the weight ``(out, in / groups, *k)`` and the
transposes with ``(in, out / groups, *k)``, each weight drawn by
``KaimingUniform(fan_in)`` (``in / groups`` times the kernel's size, or
``in`` times it for the transposes), the bias zero; ``bias_attr=False``
makes none. ``padding_mode`` is kept and not read, as in the JAX
package. ``Conv1DTranspose`` holds a ``Conv2DTranspose`` under
``conv2dt``, as there."""

from __future__ import annotations

import numpy as np

from ..ops import conv_pool as F
from ..ops.manipulation import squeeze, unsqueeze
from .initializer import KaimingUniform
from .layer import Layer

__all__ = ["Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose",
           "Conv3D", "Conv3DTranspose"]


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    _FN = None

    def __init__(self, in_channels, out_channels, kernel_size, spatial,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW"):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, spatial)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups) + self.kernel_size,
            attr=weight_attr,
            default_initializer=KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter((out_channels,), attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return type(self)._FN(x, self.weight, self.bias, self.stride,
                              self.padding, self.dilation, self.groups,
                              self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class Conv1D(_ConvNd):
    _FN = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv2D(_ConvNd):
    _FN = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv3D(_ConvNd):
    _FN = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class _ConvTransposeNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, spatial,
                 stride, padding, output_padding, dilation, groups,
                 weight_attr, bias_attr, data_format):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, spatial)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        fan_in = in_channels * int(np.prod(self.kernel_size))
        self.weight = self.create_parameter(
            (in_channels, out_channels // groups) + self.kernel_size,
            attr=weight_attr,
            default_initializer=KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter((out_channels,), attr=bias_attr,
                                          is_bias=True)


class Conv2DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation,
                                  self.data_format, output_size)


class Conv3DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation,
                                  self.data_format, output_size)


class Conv1DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__()
        self.conv2dt = Conv2DTranspose(
            in_channels, out_channels, (1, kernel_size), (1, stride),
            (0, padding), (0, output_padding), (1, dilation), groups,
            weight_attr, bias_attr)

    def forward(self, x):
        return squeeze(self.conv2dt(unsqueeze(x, 2)), 2)
