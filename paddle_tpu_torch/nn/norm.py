"""``RMSNorm`` and ``LayerNorm`` (paddle's layers; keys ``weight`` and
``bias``)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_ops

__all__ = ["LayerNorm", "RMSNorm"]


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
