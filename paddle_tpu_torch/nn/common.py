"""``Linear``, ``Embedding`` and ``Dropout`` with paddle's parameter
layouts, so a ``paddle_tpu`` state dict loads key for key and shape for
shape; ``DropoutRNG``, the random streams a model hands its dropouts."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_ops

__all__ = ["Dropout", "DropoutRNG", "Embedding", "Linear"]


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
    :class:`Linear`. With ``padding_idx`` that row starts at 0 and its
    lookups give 0 (so it takes no gradient), as in the JAX package."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx].zero_()

    def reset_parameters(self, generator: torch.Generator,
                         std: float = 0.02) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.padding_idx is not None:
                self.weight[self.padding_idx].zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.embedding(x, self.weight, self.padding_idx)


class DropoutRNG:
    """The random streams of one model's dropouts, both seeded with
    ``seed``: ``device``, a generator on the model's device, draws the
    element masks of :class:`Dropout`; ``host``, a CPU generator, draws the
    int seeds of attention dropout (the keep mask B0 in the flash kernels)
    with no device sync. The counterpart of the JAX package's global
    generator, owned by the model instead."""

    def __init__(self, device=None, seed: int = 0):
        self.device = torch.Generator(
            device=resolve_device(device)).manual_seed(seed)
        self.host = torch.Generator().manual_seed(seed)


class Dropout(nn.Module):
    """``paddle.nn.Dropout`` (``upscale_in_train``): ``nn_ops.dropout`` in
    training mode, the identity in eval mode; masks drawn from
    ``rng.device`` (a model's
    ``DropoutRNG``; by default one of its own on ``device``, which is
    ``cuda`` unless ``device="cpu"``)."""

    def __init__(self, p: float = 0.5, rng: Optional[DropoutRNG] = None,
                 device=None):
        super().__init__()
        self.p = p
        self.rng = rng if rng is not None else DropoutRNG(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.dropout(x, self.p, self.training,
                              generator=self.rng.device)

    def extra_repr(self) -> str:
        return f"p={self.p}"
