"""Transformer layers, the port of ``paddle_tpu/nn/transformer.py``
(``MultiHeadAttention`` with its ``cache`` / ``gen_cache``,
``TransformerEncoderLayer``, ``TransformerEncoder``,
``TransformerDecoderLayer``, ``TransformerDecoder``, ``Transformer``) with
its parameter names (``self_attn.q_proj``, ``cross_attn.k_proj``,
``linear1``, ``norm1``-``norm3``, ``encoder.layers.<i>``,
``decoder.layers.<i>``, ...), so a ``paddle_tpu`` state dict loads key for
key. Attention runs through ``nn.functional.scaled_dot_product_attention``
(the flash kernels, with dropout in them while training; a key-padding
``(B, 1, 1, L)`` bool mask as their segment ids; a float mask such as
:meth:`Transformer.generate_square_subsequent_mask` on the masked path, as
in the JAX package); ``linear1``'s bias add and activation run in the
epilogue kernel (``ops/bias_act.py``), the dropouts in the hashed-mask
kernel (``ops/dropout.py``) and post-norm's residual add in the norm
kernel; every op casts as the JAX package's op of the same name does under
``amp.auto_cast``. Dropout seeds come from the :class:`~.common.DropoutRNG`
the layers are given.

As in the JAX package, ``need_weights`` is stored and no attention weights
are returned, and ``TransformerDecoderLayer`` takes a ``cache`` argument
and ignores it (its self attention always runs over the whole ``tgt``).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..ops import nn_ops
from .common import Dropout, DropoutRNG, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]


class MultiHeadAttention(nn.Module):
    """Self or cross attention over ``(B, L, E)`` with ``num_heads`` heads;
    ``dropout`` is the attention-probability dropout, drawn in the flash
    kernels with seeds from ``rng.next_seed()`` (a model's ``DropoutRNG``,
    by default one of its own on ``device``). A ``cache`` ``(k, v)`` of
    ``(B, L_past, H, D)`` is put before this call's keys and values, and the
    call returns ``(out, (k, v))``; :meth:`gen_cache` makes an empty one."""

    Cache = tuple

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim=None, vdim=None, need_weights: bool = False,
                 bias_attr=None, device=None, dtype=None,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.rng = rng if rng is not None else DropoutRNG(device)
        self.head_dim = embed_dim // num_heads
        kw = dict(bias_attr=bias_attr is not False, device=device,
                  dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        b, lq = query.shape[0], query.shape[1]
        heads = (self.num_heads, self.head_dim)
        q = self.q_proj(query).reshape(b, lq, *heads)
        k = self.k_proj(key).reshape(b, key.shape[1], *heads)
        v = self.v_proj(value).reshape(b, value.shape[1], *heads)
        if cache is not None:
            pk, pv = cache
            k = torch.cat([pk, k], dim=1)
            v = torch.cat([pv, v], dim=1)
        out = nn_ops.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training,
            generator=self.rng)
        out = self.out_proj(out.reshape(b, lq, self.embed_dim))
        if cache is not None:
            return out, (k, v)
        return out

    def gen_cache(self, key, value=None, type=None):
        """An empty cache ``(k, v)``, each ``(B, 0, H, D)`` zeros of
        ``key``'s dtype and device (``value`` and ``type`` are ignored, as
        in the JAX package)."""
        z = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                        dtype=key.dtype, device=key.device)
        return (z, z.clone())


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
        self.activation = _check_activation(activation)

    def forward(self, src, src_mask=None, cache=None):
        """The layer's output; with ``cache`` (the self attention's ``(k,
        v)``), ``(output, new_cache)``."""
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is not None:
            src, new_cache = self.self_attn(src, src, src, src_mask, cache)
        else:
            src = self.self_attn(src, src, src, src_mask)
        if self.normalize_before:
            src = nn_ops.add(residual, self.dropout1(src))
        else:   # norm(add(residual, dropout(src))): the add in the norm
            src, _ = self.norm1(self.dropout1(src), residual)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = _feed_forward(self, src)
        if self.normalize_before:
            src = nn_ops.add(residual, self.dropout2(src))
        else:
            src, _ = self.norm2(self.dropout2(src), residual)
        return (src, new_cache) if cache is not None else src


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (keys ``layers.<i>``),
    then ``norm`` if given. The copies share the layer's ``DropoutRNG``;
    their weights are the prototype's until the model draws them anew."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = _copies(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        return out if self.norm is None else self.norm(out)


def _copies(layer: nn.Module, n: int) -> nn.ModuleList:
    """``layer`` and ``n - 1`` deep copies of it, each with parameters of
    its own and all sharing ``layer``'s ``DropoutRNG``."""
    shared = {id(m.rng): m.rng for m in layer.modules()
              if getattr(m, "rng", None) is not None}
    return nn.ModuleList([layer] + [copy.deepcopy(layer, dict(shared))
                                    for _ in range(n - 1)])


def _feed_forward(layer: nn.Module, x):
    """``linear2(act_dropout(act(linear1(x))))``, the bias and activation
    of ``linear1`` in the epilogue kernel."""
    return layer.linear2(layer.act_dropout(nn_ops.linear(
        x, layer.linear1.weight, layer.linear1.bias,
        activation=layer.activation)))


def _check_activation(activation: str) -> str:
    if activation not in ("gelu", "relu"):
        raise ValueError(f"activation must be 'gelu' or 'relu', got "
                         f"{activation!r}")
    return activation


class TransformerDecoderLayer(nn.Module):
    """Self attention over ``tgt``, cross attention over ``memory``, then
    the feed-forward, each with dropout on its output (``dropout1``-
    ``dropout3``) and a residual add, normalised (``norm1``-``norm3``) after
    each block (``normalize_before=False``) or before it. ``cache`` is
    accepted and ignored, as in the JAX package."""

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
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                            bias_attr=bias_attr, rng=rng,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                             bias_attr=bias_attr, rng=rng,
                                             **kw)
        lin = dict(bias_attr=bias_attr is not False, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **lin)
        self.linear2 = Linear(dim_feedforward, d_model, **lin)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout, rng=rng)
        self.dropout2 = Dropout(dropout, rng=rng)
        self.dropout3 = Dropout(dropout, rng=rng)
        self.act_dropout = Dropout(
            act_dropout if act_dropout is not None else dropout, rng=rng)
        self.activation = _check_activation(activation)

    def _block(self, residual, x, norm, dropout):
        """The residual add after a block: pre-norm adds, post-norm adds in
        the norm kernel and normalises."""
        if self.normalize_before:
            return nn_ops.add(residual, dropout(x))
        return norm(dropout(x), residual)[0]

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self._block(residual, self.self_attn(tgt, tgt, tgt, tgt_mask),
                          self.norm1, self.dropout1)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self._block(residual,
                          self.cross_attn(tgt, memory, memory, memory_mask),
                          self.norm2, self.dropout2)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        return self._block(residual, _feed_forward(self, tgt), self.norm3,
                           self.dropout3)


class TransformerDecoder(nn.Module):
    """``num_layers`` copies of ``decoder_layer`` (keys ``layers.<i>``),
    each over the same ``memory``, then ``norm`` if given; copies as in
    :class:`TransformerEncoder`."""

    def __init__(self, decoder_layer: TransformerDecoderLayer,
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = _copies(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask, memory_mask)
        return out if self.norm is None else self.norm(out)


class Transformer(nn.Module):
    """The encoder-decoder of "Attention Is All You Need"; the defaults are
    its base model (6 + 6 layers, d_model 512, 8 heads, d_ff 2048, dropout
    0.1, post-norm). Pre-norm (``normalize_before``) ends each stack with a
    ``LayerNorm``. ``custom_encoder`` / ``custom_decoder`` replace a stack.
    One ``DropoutRNG`` (``rng``, else one of its own on ``device``) seeds
    every dropout of both stacks."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", attn_dropout=None,
                 act_dropout=None, normalize_before: bool = False,
                 weight_attr=None, bias_attr=None, custom_encoder=None,
                 custom_decoder=None, device=None, dtype=None,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        if weight_attr is not None:
            raise NotImplementedError(
                "Transformer: weight_attr is not ported; draw the weights "
                "with each Linear's reset_parameters")
        self.rng = rng if rng is not None else DropoutRNG(device)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, bias_attr)
        kw = dict(device=device, dtype=dtype)

        def final_norm():
            return LayerNorm(d_model, **kw) if normalize_before else None
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, rng=self.rng, **kw),
                num_encoder_layers, final_norm())
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, rng=self.rng, **kw),
                num_decoder_layers, final_norm())
        self.d_model, self.nhead = d_model, nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length: int) -> torch.Tensor:
        """``(length, length)`` fp32: -inf above the diagonal, 0 on and
        below it, on the model's device."""
        dev = next(self.parameters()).device
        return torch.full((length, length), float("-inf"),
                          device=dev).triu(1)
