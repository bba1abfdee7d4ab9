"""Transformer encoder layers, the port of ``paddle_tpu/nn/transformer.py``
(``MultiHeadAttention``, ``TransformerEncoderLayer``,
``TransformerEncoder``) with its parameter names (``self_attn.q_proj``,
``linear1``, ``norm1``, ...), so a ``paddle_tpu`` state dict loads key for
key. Attention runs through ``nn.functional.scaled_dot_product_attention``
(the flash kernels, with dropout in them while training); every op casts as
the JAX package's op of the same name does under ``amp.auto_cast``.
Dropout draws from the :class:`~.common.DropoutRNG` the layers are given.
The decoder layers, attention caches and ``need_weights`` are not
ported.
"""

from __future__ import annotations

import copy
from typing import Optional

from torch import nn

from ..ops import nn_ops
from .common import Dropout, DropoutRNG, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]

_ACTIVATIONS = {"gelu": nn_ops.gelu, "relu": nn_ops.relu}


class MultiHeadAttention(nn.Module):
    """Self or cross attention over ``(B, L, E)`` with ``num_heads`` heads;
    ``dropout`` is the attention-probability dropout, drawn in the flash
    kernels with seeds from ``rng.host`` (a model's ``DropoutRNG``, by
    default one of its own on ``device``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim=None, vdim=None, bias_attr=None, device=None,
                 dtype=None, rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.rng = rng if rng is not None else DropoutRNG(device)
        self.head_dim = embed_dim // num_heads
        kw = dict(bias_attr=bias_attr is not False, device=device,
                  dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = query if value is None else value
        b, lq = query.shape[0], query.shape[1]
        heads = (self.num_heads, self.head_dim)
        q = self.q_proj(query).reshape(b, lq, *heads)
        k = self.k_proj(key).reshape(b, key.shape[1], *heads)
        v = self.v_proj(value).reshape(b, value.shape[1], *heads)
        out = nn_ops.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training,
            generator=self.rng.host)
        return self.out_proj(out.reshape(b, lq, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Attention then feed-forward, each with dropout on its output and a
    residual add, normalised after (``normalize_before=False``, BERT and
    ERNIE) or before each block."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout=None, act_dropout=None,
                 normalize_before: bool = False, bias_attr=None,
                 layer_norm_eps: float = 1e-5, device=None, dtype=None,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.normalize_before = normalize_before
        rng = rng if rng is not None else DropoutRNG(device)
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            bias_attr=bias_attr, rng=rng, **kw)
        lin = dict(bias_attr=bias_attr is not False, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **lin)
        self.linear2 = Linear(dim_feedforward, d_model, **lin)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout, rng=rng)
        self.dropout2 = Dropout(dropout, rng=rng)
        self.act_dropout = Dropout(
            act_dropout if act_dropout is not None else dropout, rng=rng)
        self.activation = _ACTIVATIONS[activation]

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        src = nn_ops.add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = nn_ops.add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (keys ``layers.<i>``),
    then ``norm`` if given. The copies share the layer's ``DropoutRNG``;
    their weights are the prototype's until the model draws them anew."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        shared = {id(m.rng): m.rng for m in encoder_layer.modules()
                  if getattr(m, "rng", None) is not None}
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer, dict(shared))
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        return out if self.norm is None else self.norm(out)
