"""``RMSNorm`` and ``LayerNorm`` (paddle's layers; keys ``weight`` and
``bias``), and the rest of ``paddle_tpu/nn/norm.py``: ``BatchNorm``,
``BatchNorm1D/2D/3D`` (weight 1, bias 0, fp32 buffers ``_mean`` 0 and
``_variance`` 1, momentum 0.9, epsilon 1e-5; on K10 on a card, with the
fused ``residual`` / ``act`` tails of ``ops/batch_norm.py``: ReLU or
swish),
``GroupNorm``, ``InstanceNorm1D/2D/3D`` and ``LocalResponseNorm``.
``SyncBatchNorm`` and ``SpectralNorm`` are not ported (ROADMAP.md)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_ops
from .initializer import Constant
from .layer import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LayerNorm", "LocalResponseNorm", "RMSNorm"]


class RMSNorm(nn.Module):
    """Built on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, device=None,
                 dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size,
                                              device=resolve_device(device),
                                              dtype=dtype))

    def forward(self, x: torch.Tensor, residual=None):
        """``rms_norm(x)``; with ``residual``, ``(rms_norm(h), h)`` for ``h
        = add(x, residual)`` (one kernel on a card)."""
        return nn_ops.rms_norm(x, self.weight, self.epsilon, residual)


class LayerNorm(nn.Module):
    """``paddle.nn.LayerNorm`` (``paddle_tpu/nn/norm.py:93``): weight 1 and
    bias 0 over ``normalized_shape``; ``device`` as for :class:`RMSNorm`."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5, device=None,
                 dtype=None):
        super().__init__()
        shape = [normalized_shape] if isinstance(normalized_shape, int) \
            else list(normalized_shape)
        self.normalized_shape, self.epsilon = shape, epsilon
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(shape, device=dev, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(shape, device=dev, dtype=dtype))

    def forward(self, x: torch.Tensor, residual=None):
        """``layer_norm(x)``; with ``residual``, ``(layer_norm(h), h)`` for
        ``h = add(x, residual)`` (one kernel on a card)."""
        return nn_ops.layer_norm(x, self.normalized_shape, self.weight,
                                 self.bias, self.epsilon, residual)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter((num_features,), attr=bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean", self.create_buffer(
            torch.zeros(num_features, dtype=torch.float32)))
        self.register_buffer("_variance", self.create_buffer(
            torch.ones(num_features, dtype=torch.float32)))

    def forward(self, x, residual=None, act=None):
        """``batch_norm`` of x; the port's ``act`` (``"relu"`` or
        ``"swish"``) and ``residual`` fuse the tail ``act(add(bn(x),
        residual))`` into K10."""
        return nn_ops.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats, residual=residual,
            act=act)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         "NCHW" if data_format == "NCL" else data_format,
                         use_global_stats, name)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         "NCHW" if data_format == "NCDHW" else data_format,
                         use_global_stats, name)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_channels,), attr=weight_attr,
                                  default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_channels,), attr=bias_attr, is_bias=True)

    def forward(self, x):
        return nn_ops.group_norm(x, self.num_groups, self.epsilon,
                                 self.weight, self.bias, self.data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_features = num_features
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight = self.bias = None
        else:
            self.weight = self.create_parameter(
                (num_features,), attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter((num_features,),
                                              attr=bias_attr, is_bias=True)

    def forward(self, x):
        return nn_ops.instance_norm(x, weight=self.weight, bias=self.bias,
                                    eps=self.epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.local_response_norm(x, self.size, self.alpha,
                                          self.beta, self.k,
                                          self.data_format)
