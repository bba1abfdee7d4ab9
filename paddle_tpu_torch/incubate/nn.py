"""``paddle.incubate.nn``: the fused layers of ``paddle_tpu/incubate/nn.py``
with the same parameter keys, over ``incubate.nn.functional``:
``FusedMultiHeadAttention`` (``:31``), ``FusedFeedForward`` (``:86``),
``FusedLinear`` (``:123``), ``FusedTransformerEncoderLayer`` (``:128``),
``FusedDropoutAdd`` (``:165``) and ``FusedBiasDropoutResidualLayerNorm``
(``:247``). A layer draws its dropout seeds from ``rng`` (a model's
``DropoutRNG``, by default one of its own on ``device``, which is ``cuda``
unless ``device="cpu"``); its linear weights start Xavier-uniform
(paddle's default initializer) from ``generator`` (by default one seeded
with 0 on that device), biases 0, norms 1 and 0.
``FusedMultiTransformer`` and the MoE layers are not ported (ROADMAP
Queue A)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn.common import Dropout, DropoutRNG, Linear
from ..nn.norm import LayerNorm
from ..nn.transformer import TransformerEncoderLayer
from ..ops import nn_ops
from . import nn_functional as functional
from .nn_functional import memory_efficient_attention

def _init_linears(module: nn.Module, device,
                  generator: Optional[torch.Generator]) -> None:
    """Xavier-uniform weights and zero biases for every ``Linear`` of
    ``module`` (paddle's default initializer for its ``(in, out)``
    layout)."""
    g = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Linear):
                fan_in, fan_out = m.weight.shape
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    m.bias.zero_()


__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedDropoutAdd",
           "FusedFeedForward", "FusedLinear", "FusedMultiHeadAttention",
           "FusedTransformerEncoderLayer", "functional",
           "memory_efficient_attention"]


class FusedMultiHeadAttention(nn.Module):
    """Self-attention block with the JAX layer's parameters: ``qkv``
    (``(E, 3E)`` Linear), ``out_proj``, ``pre_ln`` and ``ln``; attention
    through the port's SDPA (the flash kernels without a mask, attention
    dropout in them), then dropout, the residual add and, post-norm, the
    layer norm (the add in the dropout kernel pre-norm, in the norm's
    kernel post-norm). ``cache=`` raises, as in the JAX package; ``*_attr``
    other than ``False`` for a bias is ignored."""

    def __init__(self, embed_dim, num_heads, dropout_rate: float = 0.5,
                 attn_dropout_rate: float = 0.5, kdim=None, vdim=None,
                 normalize_before: bool = False, need_weights: bool = False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon: float = 1e-5,
                 nranks: int = 1, ring_id: int = -1, name=None, *,
                 rng: Optional[DropoutRNG] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"num_heads ({num_heads}) must divide embed_dim "
                             f"({embed_dim})")
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.rng = rng if rng is not None else DropoutRNG(dev)
        self.qkv = Linear(embed_dim, 3 * embed_dim,
                          bias_attr=qkv_bias_attr is not False, **kw)
        self.out_proj = Linear(embed_dim, embed_dim,
                               bias_attr=linear_bias_attr is not False, **kw)
        self.pre_ln = LayerNorm(embed_dim, epsilon=epsilon, **kw)
        self.ln = LayerNorm(embed_dim, epsilon=epsilon, **kw)
        self.dropout = Dropout(dropout_rate, rng=self.rng)
        _init_linears(self, dev, generator)

    def forward(self, x, attn_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(
                "FusedMultiHeadAttention KV-cache decode is not implemented; "
                "use models.llama's cached attention path for decoding")
        residual = x
        if self.normalize_before:
            x = self.pre_ln(x)
        b, s, _ = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        out = nn_ops.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate, training=self.training,
            generator=self.rng)
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if self.normalize_before:
            return nn_ops.dropout(out, self.dropout_rate, self.training,
                                  generator=self.rng, residual=residual)
        out, _ = self.ln(self.dropout(out), residual)
        return out


class FusedFeedForward(nn.Module):
    """The feed-forward block with the JAX layer's parameters: ``linear1``,
    ``linear2`` and one ``ln`` (before the block or after it), run by
    ``functional.fused_feedforward``: ``activation`` (``relu`` or ``gelu``,
    erf form) with ``linear1``'s bias in the epilogue kernel, ``act_dropout``
    and ``dropout`` in the dropout kernel. ``*_attr`` other than ``False``
    for a bias is ignored."""

    def __init__(self, d_model, dim_feedforward, dropout_rate: float = 0.1,
                 epsilon: float = 1e-5, activation: str = "relu",
                 act_dropout_rate: Optional[float] = None,
                 normalize_before: bool = False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks: int = 1, ring_id: int = -1, name=None, *,
                 rng: Optional[DropoutRNG] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.normalize_before = normalize_before
        self.activation = activation
        self.epsilon = epsilon
        self.rng = rng if rng is not None else DropoutRNG(dev)
        self.linear1 = Linear(d_model, dim_feedforward,
                              bias_attr=linear1_bias_attr is not False, **kw)
        self.linear2 = Linear(dim_feedforward, d_model,
                              bias_attr=linear2_bias_attr is not False, **kw)
        self.ln = LayerNorm(d_model, epsilon=epsilon, **kw)
        self.dropout = Dropout(dropout_rate, rng=self.rng)
        self.act_dropout = Dropout(
            dropout_rate if act_dropout_rate is None else act_dropout_rate,
            rng=self.rng)
        _init_linears(self, dev, generator)

    def forward(self, x):
        return functional.fused_feedforward(
            x, self.linear1.weight, self.linear2.weight, self.linear1.bias,
            self.linear2.bias, self.ln.weight, self.ln.bias, self.ln.weight,
            self.ln.bias, dropout1_rate=self.act_dropout.p,
            dropout2_rate=self.dropout.p, activation=self.activation,
            ln1_epsilon=self.epsilon, ln2_epsilon=self.epsilon,
            pre_layer_norm=self.normalize_before, training=self.training,
            generator=self.rng)


class FusedLinear(Linear):
    """``y = x @ W + b`` with the bias add in the epilogue kernel
    (``functional.fused_linear``); the JAX layer's ``weight`` ``(in,
    out)`` and ``bias``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        super().__init__(in_features, out_features,
                         bias_attr=bias_attr is not False, device=device,
                         dtype=dtype)
        _init_linears(self, device, generator)

    def forward(self, x):
        return functional.fused_linear(x, self.weight, self.bias)


class FusedTransformerEncoderLayer(nn.Module):
    """The fused encoder block: ``inner``, the port's
    ``TransformerEncoderLayer`` (the JAX layer's keys,
    ``inner.self_attn.q_proj.weight``, ...), on the flash, epilogue,
    dropout and norm kernels."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", act_dropout_rate=None,
                 attn_dropout_rate=None, normalize_before=False, *,
                 rng: Optional[DropoutRNG] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.inner = TransformerEncoderLayer(
            d_model, nhead, dim_feedforward, dropout=dropout_rate,
            activation=activation, act_dropout=act_dropout_rate,
            attn_dropout=attn_dropout_rate,
            normalize_before=normalize_before, device=dev, dtype=dtype,
            rng=rng if rng is not None else DropoutRNG(dev))
        _init_linears(self, dev, generator)

    def forward(self, src, src_mask=None):
        return self.inner(src, src_mask)


class FusedDropoutAdd(nn.Module):
    """y = dropout(x) + residual as one layer (one launch of the dropout
    kernel)."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None, *,
                 rng: Optional[DropoutRNG] = None, device=None):
        super().__init__()
        self.p = p
        self.mode = mode
        self.rng = rng if rng is not None else DropoutRNG(device)

    def forward(self, x, y):
        return functional.fused_dropout_add(
            x, y, p=self.p, training=self.training, mode=self.mode,
            generator=self.rng)


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
        return functional.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self.dropout_rate,
            ln_epsilon=self.epsilon, training=self.training,
            generator=self.rng)
