"""``paddle.incubate.nn``: the layers ``FusedDropoutAdd`` and
``FusedBiasDropoutResidualLayerNorm`` (``paddle_tpu/incubate/nn.py:165-180,
247-273``; the same parameter keys), over ``incubate.nn.functional``. A
layer draws its dropout masks from ``rng`` (a model's ``DropoutRNG``, by
default one of its own on ``device``, which is ``cuda`` unless
``device="cpu"``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn.common import DropoutRNG
from . import nn_functional as functional

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedDropoutAdd",
           "functional"]


class FusedDropoutAdd(nn.Module):
    """y = dropout(x) + residual as one layer."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None, *,
                 rng: Optional[DropoutRNG] = None, device=None):
        super().__init__()
        self.p = p
        self.mode = mode
        self.rng = rng if rng is not None else DropoutRNG(device)

    def forward(self, x, y):
        if self.training and self.p > 0.0:
            self.rng.note_draw()
        return functional.fused_dropout_add(
            x, y, p=self.p, training=self.training, mode=self.mode,
            generator=self.rng.device)


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """out = layer_norm(residual + dropout(x + bias)) as one layer, with
    its own ``linear_bias`` (zeros; none with ``bias_attr=False``),
    ``ln_scale`` (ones) and ``ln_bias`` (zeros)."""

    def __init__(self, embed_dim, dropout_rate=0.5, bias_attr=None,
                 epsilon=1e-5, name=None, *, rng: Optional[DropoutRNG] = None,
                 device=None, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        kw = dict(device=dev, dtype=dtype)
        self.linear_bias = None if bias_attr is False else \
            nn.Parameter(torch.zeros(embed_dim, **kw))
        self.ln_scale = nn.Parameter(torch.ones(embed_dim, **kw))
        self.ln_bias = nn.Parameter(torch.zeros(embed_dim, **kw))
        self.rng = rng if rng is not None else DropoutRNG(dev)

    def forward(self, x, residual):
        if self.training and self.dropout_rate > 0.0:
            self.rng.note_draw()
        return functional.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self.dropout_rate,
            ln_epsilon=self.epsilon, training=self.training,
            generator=self.rng.device)
