"""Pooling layers, the port of ``paddle_tpu/nn/pooling.py``, with the JAX
package's positional signatures (upstream's own: ``MaxPool*`` put
``return_mask`` before ``ceil_mode``, ``AvgPool1D`` ``exclusive`` before
``ceil_mode``, ``AvgPool2D/3D`` ``ceil_mode`` first), over the functions
of ``ops/conv_pool.py``; ``LPPool1D/2D`` as ``(sum of x^p)^(1/p)`` from an
average pool that divides by the full window."""

from __future__ import annotations

from ..ops import conv_pool as F
from .layer import Layer

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "LPPool1D", "LPPool2D",
           "MaxPool1D", "MaxPool2D", "MaxPool3D"]


class _Pool(Layer):
    _DEFAULT_FORMAT = "NCHW"

    def _store(self, kernel_size, stride, padding, ceil_mode, data_format):
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format or self._DEFAULT_FORMAT


class _MaxPool(_Pool):
    _FN = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format=None,
                 name=None):
        super().__init__()
        self._store(kernel_size, stride, padding, ceil_mode, data_format)
        self.return_mask = return_mask

    def forward(self, x):
        return type(self)._FN(x, self.kernel_size, self.stride, self.padding,
                              return_mask=self.return_mask,
                              ceil_mode=self.ceil_mode,
                              data_format=self.data_format)


class MaxPool1D(_MaxPool):
    _DEFAULT_FORMAT = "NCL"
    _FN = staticmethod(F.max_pool1d)


class MaxPool2D(_MaxPool):
    _FN = staticmethod(F.max_pool2d)


class MaxPool3D(_MaxPool):
    _DEFAULT_FORMAT = "NCDHW"
    _FN = staticmethod(F.max_pool3d)


class AvgPool1D(_Pool):
    _DEFAULT_FORMAT = "NCL"

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, data_format=None, name=None):
        super().__init__()
        self._store(kernel_size, stride, padding, ceil_mode, data_format)
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            exclusive=self.exclusive,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format)


class _AvgPoolNd(_Pool):
    _FN = None

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format=None,
                 name=None):
        super().__init__()
        self._store(kernel_size, stride, padding, ceil_mode, data_format)
        self.exclusive = exclusive
        self.divisor_override = divisor_override

    def forward(self, x):
        return type(self)._FN(x, self.kernel_size, self.stride, self.padding,
                              ceil_mode=self.ceil_mode,
                              exclusive=self.exclusive,
                              divisor_override=self.divisor_override,
                              data_format=self.data_format)


class AvgPool2D(_AvgPoolNd):
    _FN = staticmethod(F.avg_pool2d)


class AvgPool3D(_AvgPoolNd):
    _DEFAULT_FORMAT = "NCDHW"
    _FN = staticmethod(F.avg_pool3d)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class _AdaptiveMax(Layer):
    _FN = None

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return type(self)._FN(x, self.output_size,
                              return_mask=self.return_mask)


class AdaptiveMaxPool1D(_AdaptiveMax):
    _FN = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptiveMax):
    _FN = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptiveMax):
    _FN = staticmethod(F.adaptive_max_pool3d)


class _LPPool(Layer):
    """``(sum over the window of x^p)^(1/p)`` with signed ``x^p``:
    ``avg_pool(x^p, exclusive=False)`` times the window's size."""

    _ND = 2

    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format=None, name=None):
        super().__init__()
        self.norm_type = float(norm_type)
        if self.norm_type == 0:
            raise ValueError("norm_type must be non-zero")
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format or ("NCL" if self._ND == 1
                                           else "NCHW")

    def _window_count(self) -> int:
        k = self.kernel_size
        if isinstance(k, int):
            return k ** self._ND
        out = 1
        for v in k:
            out *= v
        return out

    def forward(self, x):
        p = self.norm_type
        pool = F.avg_pool1d if self._ND == 1 else F.avg_pool2d
        avg = pool(x ** p, self.kernel_size, self.stride, self.padding,
                   exclusive=False, ceil_mode=self.ceil_mode,
                   data_format=self.data_format)
        return (avg * float(self._window_count())) ** (1.0 / p)


class LPPool1D(_LPPool):
    _ND = 1


class LPPool2D(_LPPool):
    _ND = 2
