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
``FusedMultiTransformer`` (``:274``) is the pre-LN decoder stack of the
fused inference path: prefill on the flash kernels, decode over a list of
caches, a stacked dense cache or the paged pool (the paged decode kernel).
``FusedEcMoe`` (``:181``) is the expert-choice MoE over
``functional.fused_ec_moe``; ``FusedMoELayer`` (``:147``) builds
``incubate.moe.MoELayer`` as the reference does, which raises the
reference's ``TypeError`` (``MoELayer`` wants ``experts``)."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn.common import Dropout, DropoutRNG, Linear
from ..nn.norm import LayerNorm
from ..nn.transformer import TransformerEncoderLayer
from ..ops import nn_ops
from ..ops.paged_attention import PagedDecodeCache
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
           "FusedEcMoe", "FusedFeedForward", "FusedLinear",
           "FusedMoELayer", "FusedMultiHeadAttention",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer",
           "functional", "memory_efficient_attention"]


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


# the per-layer parameters of FusedMultiTransformer, in the JAX layer's
# order: state-dict key ``l{i}_{tag}``
_FMT_TAGS = ("ln_scale", "ln_bias", "qkv_w", "qkv_b", "out_w", "out_b",
             "ffn_ln_scale", "ffn_ln_bias", "ffn1_w", "ffn1_b", "ffn2_w",
             "ffn2_b")


class FusedMoELayer(nn.Module):
    """Parity: ``incubate.nn.FusedMoELayer``. As in the reference, it
    hands ``MoELayer`` ``hidden_size`` and ``num_experts`` where that wants
    ``experts``: construction raises ``TypeError``."""

    def __init__(self, d_model, dim_feedforward, num_experts, top_k=2,
                 **kwargs):
        super().__init__()
        from .moe import MoELayer
        self.inner = MoELayer(d_model=d_model, hidden_size=dim_feedforward,
                              num_experts=num_experts, top_k=top_k)

    def forward(self, x):
        return self.inner(x)


class FusedEcMoe(nn.Module):
    """Expert-choice MoE layer (``forward(x, gate)``: the caller's gate
    LOGITS ``(B, S, E)``; the layer owns the expert weights ``w0`` ``(E,
    H, I)``, ``b0`` ``(E, 1, I)``, ``w1`` ``(E, I, H)``, ``b1`` ``(E, 1,
    H)``), over ``functional.fused_ec_moe``. Weights start Xavier-uniform
    over each expert's ``(in, out)`` from ``generator`` (by default one
    seeded with 0) on ``device``, biases 0. ``act_type`` other than
    ``gelu`` / ``relu``, or ``weight_attr`` / ``bias_attr`` False, raise
    ``ValueError`` as in the reference."""

    def __init__(self, hidden_size, inter_size, num_experts, act_type="gelu",
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if act_type not in ("gelu", "relu"):
            raise ValueError("act_type must be gelu or relu")
        if weight_attr is False or bias_attr is False:
            raise ValueError(
                "FusedEcMoe requires its expert weights and biases "
                "(attr=False is not supported)")
        dev = resolve_device(device)
        self.num_experts = num_experts
        self.act_type = act_type
        kw = dict(device=dev, dtype=dtype)
        e, h, i = num_experts, hidden_size, inter_size
        self.w0 = nn.Parameter(torch.empty(e, h, i, **kw))
        self.b0 = nn.Parameter(torch.zeros(e, 1, i, **kw))
        self.w1 = nn.Parameter(torch.empty(e, i, h, **kw))
        self.b1 = nn.Parameter(torch.zeros(e, 1, h, **kw))
        g = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        bound = (6.0 / (h + i)) ** 0.5
        with torch.no_grad():
            for w in (self.w0, self.w1):
                w.uniform_(-bound, bound, generator=g)

    def forward(self, x, gate):
        return functional.fused_ec_moe(x, gate, self.w0, self.b0, self.w1,
                                       self.b1, self.act_type)


class FusedMultiTransformer(nn.Module):
    """``num_layers`` fused pre-LN decoder layers with the JAX layer's
    parameters: per layer ``l{i}_qkv_w`` ``(3, H, D, E)`` (``trans_qkvw``)
    and ``l{i}_qkv_b`` ``(3, H, D)``, ``l{i}_out_w`` ``(E, E)``,
    ``l{i}_ffn1_w`` ``(E, F)``, ``l{i}_ffn2_w`` ``(F, E)`` with their
    biases, and the two LayerNorms' ``l{i}_ln_*`` and ``l{i}_ffn_ln_*``.
    Weights start Xavier-uniform from ``generator`` (by default one seeded
    with 0 on ``device``), biases 0, norm scales 1.

    ``forward(src (B, S, E), ...)``:

    * ``time_step`` given (an int, or a ``(B,)`` / scalar int tensor, read
      on the device): one decode step of ``src (B, 1, E)`` through
      ``functional.masked_multihead_attention`` on every layer, over a
      list of ``(2, B, H, max_len, D)`` caches, a stacked ``(L, 2, B, H,
      max_len, D)`` cache (layer ``i`` decodes on the view ``caches[i]``)
      or a ``PagedDecodeCache`` (layer ``i`` on ``caches.at_layer(i)``,
      whose ``t`` is ``time_step``). Caches are written in place; returns
      ``(out, caches)``;
    * otherwise a prefill over the whole sequence: bidirectional, or
      ``attn_mask`` when given (SDPA: the flash kernels without a mask);
      each layer's K/V written into the caches at ``[0, S)`` when caches
      are given. With ``seq_offset`` (a stacked cache only) it is causal
      and resumable: ``src`` holds positions ``[off, off + S)``, attends
      the cache's resident ``[0, off)`` and itself (the flash kernel at
      ``Lq < Lk``, bottom-right causal), and its K/V land at ``[off, off
      + S)``. Returns ``out``, or ``(out, caches)`` with caches.

    Dropout (``dropout_rate``, in training) draws from ``rng``. The
    post-LN form, ``trans_qkvw=False``, ``rotary_embs``, ``pre_caches``
    and ``seq_lens`` raise, as in the JAX package."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None,
                 qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None,
                 epsilon=1e-5, num_layers=-1, nranks=1, trans_qkvw=True,
                 ring_id=-1, name=None, *, rng: Optional[DropoutRNG] = None,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError(
                "FusedMultiTransformer supports the pre-LN form only "
                "(normalize_before=True), as the reference kernel does")
        if not trans_qkvw:
            raise NotImplementedError("trans_qkvw=False layout unsupported")
        if num_layers == -1:
            num_layers = len(qkv_weight_attrs) if isinstance(
                qkv_weight_attrs, (list, tuple)) else 1
        dev = resolve_device(device)
        self.num_layers = num_layers
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dim_feedforward = dim_feedforward
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.epsilon = epsilon
        self.rng = rng if rng is not None else DropoutRNG(dev)
        E, H, D, F = embed_dim, num_heads, self.head_dim, dim_feedforward
        shapes = {"ln_scale": (E,), "ln_bias": (E,), "qkv_w": (3, H, D, E),
                  "qkv_b": (3, H, D), "out_w": (E, E), "out_b": (E,),
                  "ffn_ln_scale": (E,), "ffn_ln_bias": (E,),
                  "ffn1_w": (E, F), "ffn1_b": (F,), "ffn2_w": (F, E),
                  "ffn2_b": (E,)}
        fans = {"qkv_w": (E, 3 * E), "out_w": (E, E), "ffn1_w": (E, F),
                "ffn2_w": (F, E)}
        g = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        for i in range(num_layers):
            for tag in _FMT_TAGS:
                p = torch.empty(shapes[tag], device=dev, dtype=dtype)
                with torch.no_grad():
                    if tag in fans:
                        bound = (6.0 / sum(fans[tag])) ** 0.5
                        p.uniform_(-bound, bound, generator=g)
                    elif tag.endswith("scale"):
                        p.fill_(1.0)
                    else:
                        p.zero_()
                self.register_parameter(f"l{i}_{tag}", nn.Parameter(p))

    def _w(self, i: int, tag: str) -> torch.Tensor:
        return getattr(self, f"l{i}_{tag}")

    def prepare_decode(self):
        """Kept for the JAX layer's API; builds nothing and returns self.
        The JAX package stacks the weights for its scan over layers; the
        port decodes in a loop over the layers' own weights, so there is
        no stack to build or to invalidate."""
        return self

    def _dropout(self, x, residual):
        """``residual + dropout(x)`` (the dropout kernel's add in
        training)."""
        return nn_ops.dropout(x, self.dropout_rate, self.training,
                              generator=self.rng, residual=residual)

    def _ln(self, x, i: int, ffn: bool):
        pre = "ffn_ln" if ffn else "ln"
        return nn_ops.layer_norm(x, self.embed_dim, self._w(i, f"{pre}_scale"),
                                 self._w(i, f"{pre}_bias"), self.epsilon)

    def _qkv(self, h, i: int):
        """The fused qkv ``(rows, 3E)`` of the normed ``h (rows, E)``."""
        E = self.embed_dim
        qkv = functional.fused_linear(h, self._w(i, "qkv_w").reshape(3 * E, E),
                                      transpose_weight=True)
        return qkv + self._w(i, "qkv_b").reshape(3 * E)

    def _ffn(self, h, i: int):
        """linear1 with its bias and activation in the epilogue kernel,
        dropout, linear2 with its bias."""
        h = functional.fused_linear_activation(
            h, self._w(i, "ffn1_w"), bias=self._w(i, "ffn1_b"),
            activation=self.activation)
        h = nn_ops.dropout(h, self.dropout_rate, self.training,
                           generator=self.rng)
        return functional.fused_linear(h, self._w(i, "ffn2_w"),
                                       bias=self._w(i, "ffn2_b"))

    def _decode_layer(self, x, steps, attn_mask, i: int, cache):
        """Layer ``i``'s one-token decode step; every cache kind takes
        this one body, so the decode paths cannot drift apart."""
        b = x.shape[0]
        qkv = self._qkv(self._ln(x, i, False).reshape(b, self.embed_dim), i)
        attn, cache = functional.masked_multihead_attention(
            qkv, cache_kv=cache, sequence_lengths=steps, src_mask=attn_mask)
        attn = functional.fused_linear(attn.reshape(b, 1, self.embed_dim),
                                       self._w(i, "out_w"),
                                       bias=self._w(i, "out_b"))
        x = self._dropout(attn, x)
        return self._dropout(self._ffn(self._ln(x, i, True), i), x), cache

    def _decode(self, src, caches, time_step, attn_mask):
        if isinstance(time_step, torch.Tensor):
            steps = time_step.to(device=src.device, dtype=torch.int32)
        else:
            steps = torch.full((src.shape[0],), int(time_step),
                               dtype=torch.int32, device=src.device)
        x = src
        if isinstance(caches, PagedDecodeCache):
            if attn_mask is not None:
                raise NotImplementedError(
                    "FusedMultiTransformer: attn_mask is not supported on "
                    "the paged decode path (span masking to <= t is the "
                    "decode contract; use a dense cache for additive "
                    "masks)")
            view = replace(caches, t=steps.reshape(-1).expand(src.shape[0]))
            for i in range(self.num_layers):
                x, _ = self._decode_layer(x, None, None, i, view.at_layer(i))
            return x, caches
        for i in range(self.num_layers):
            x, _ = self._decode_layer(x, steps, attn_mask, i, caches[i])
        return x, caches

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, seq_lens=None,
                time_step=None, seq_offset=None):
        for unsupported, label in ((rotary_embs, "rotary_embs"),
                                   (pre_caches, "pre_caches"),
                                   (seq_lens, "seq_lens")):
            if unsupported is not None:
                raise NotImplementedError(
                    f"FusedMultiTransformer: {label} is not supported on "
                    "this path (apply RoPE via "
                    "fused_rotary_position_embedding before the stack)")
        stacked = isinstance(caches, torch.Tensor)
        if seq_offset is not None and time_step is not None:
            raise ValueError(
                "FusedMultiTransformer: seq_offset is a prefill-only "
                "contract (time_step must be None)")
        if seq_offset is not None and not stacked:
            raise ValueError(
                "FusedMultiTransformer: seq_offset needs the STACKED "
                "cache (L, 2, B, H, max_len, D)")
        if time_step is not None:
            if caches is None:
                raise ValueError("FusedMultiTransformer: a decode step "
                                 "(time_step) needs caches")
            return self._decode(src, caches, time_step, attn_mask)
        causal = seq_offset is not None
        off = int(seq_offset) if causal else 0
        b, s = src.shape[0], src.shape[1]
        E, nh, hd = self.embed_dim, self.num_heads, self.head_dim
        x = src
        for i in range(self.num_layers):
            qkv = self._qkv(self._ln(x, i, False).reshape(b * s, E), i)
            qkv = qkv.reshape(b, s, 3, nh, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            k_in, v_in = k, v
            if off:
                # the resident prefix's K/V lead the keys and values
                pre = caches[i, :, :, :, :off].transpose(2, 3)
                k_in = torch.cat([pre[0].to(k.dtype), k], dim=1)
                v_in = torch.cat([pre[1].to(v.dtype), v], dim=1)
            attn = nn_ops.scaled_dot_product_attention(
                q, k_in, v_in, attn_mask=attn_mask,
                dropout_p=self.dropout_rate if self.training else 0.0,
                is_causal=causal and attn_mask is None,
                training=self.training, generator=self.rng)
            attn = functional.fused_linear(attn.reshape(b, s, E),
                                           self._w(i, "out_w"),
                                           bias=self._w(i, "out_b"))
            if caches is not None:
                c = caches[i]
                c[0, :, :, off:off + s] = k.transpose(1, 2).to(c.dtype)
                c[1, :, :, off:off + s] = v.transpose(1, 2).to(c.dtype)
            x = self._dropout(attn, x)
            x = self._dropout(self._ffn(self._ln(x, i, True), i), x)
        return x if caches is None else (x, caches)
