"""``Linear`` and ``Embedding`` with paddle's parameter layouts, so a
``paddle_tpu`` state dict loads key for key and shape for shape."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_ops

__all__ = ["Linear", "Embedding"]


class Linear(nn.Module):
    """``y = x @ W (+ b)`` with ``W`` of shape ``(in_features,
    out_features)`` (paddle's layout, not ``torch.nn.Linear``'s). Built on
    ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias_attr: bool = True, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias: Optional[nn.Parameter] = nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype)) if bias_attr else None

    def reset_parameters(self, generator: torch.Generator,
                         std: float = 0.02) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Lookup table ``(num_embeddings, embedding_dim)``; ``device`` as for
    :class:`Linear`."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None,
                 dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def reset_parameters(self, generator: torch.Generator,
                         std: float = 0.02) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.embedding(x, self.weight)
