"""``RMSNorm`` (paddle's layer; weight key ``weight``)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_ops

__all__ = ["RMSNorm"]


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.rms_norm(x, self.weight, self.epsilon)
