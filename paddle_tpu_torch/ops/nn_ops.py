"""Functional nn ops of the Llama and ERNIE paths: linear, embedding,
rms_norm, layer_norm, silu, relu, gelu, tanh, add, dropout and
scaled_dot_product_attention, and the norms of A7: batch_norm (K10,
``ops/batch_norm.py``, with ResNet's fused tails), instance_norm,
group_norm and local_response_norm (paddle's signatures and layouts). Each
casts its inputs as the active ``amp.auto_cast`` says (see ``amp``), by the
JAX package's op name. The small ops run the port's fused kernels on a
card, which do those casts as they load their inputs: ``rms_norm`` and
``layer_norm`` the norm kernel (``ops/fused_norm.py``, with the residual
add before the norm), ``embedding`` the gather and its deterministic
backward (``ops/embedding.py``), ``gelu``, ``relu`` and ``linear(...,
activation=)``'s bias add and activation the epilogue kernel
(``ops/bias_act.py``), ``dropout`` the hashed-mask kernel
(``ops/dropout.py``).

``linear`` keeps paddle's weight layout ``(in_features, out_features)``,
``y = x @ W``, so a ``paddle_tpu`` state dict loads without a transpose.

``scaled_dot_product_attention`` routes as the JAX package's does on its
accelerator (``paddle_tpu/ops/nn_ops.py:388-441``), on the CPU and on the
card alike: a mask-free call goes to :func:`~.flash_attention.flash_attention`
(dropout in the kernels while training); a boolean key-padding mask of
shape ``(B, 1, Lk)`` or ``(B, 1, 1, Lk)`` goes there too, as segment ids;
every other mask (ERNIE's additive float mask among them) takes the plain
materialised softmax, the counterpart of the JAX package's XLA path, which
is no Pallas kernel either.

Randomness comes from the caller: ``dropout`` and attention dropout take
their seeds from ``generator``, a model's ``DropoutRNG`` (a seed derived
on the device, no host read) or a ``torch.Generator`` (one draw), for the
hashed keep masks of ``ops/dropout.py`` and of B0 in
``ops/flash_attention.py``, which the plain paths compute too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..amp import cast_dtype, cast_inputs
from . import dropout as _dropout
from .batch_norm import batch_norm
from .bias_act import ActSpec, bias_act
from .embedding import embedding as _embedding
from .flash_attention import (dropout_seed, flash_attention,
                              keep_mask_reference)
from .fused_norm import NormSpec, fused_norm

__all__ = ["add", "batch_norm", "dropout", "embedding", "gelu",
           "group_norm", "instance_norm", "layer_norm", "linear",
           "local_response_norm", "relu", "rms_norm",
           "scaled_dot_product_attention", "silu", "tanh"]


# activation name -> (the bias_act kernel's act, the JAX op name it casts as)
_ACTS = {"gelu": ("gelu", "gelu"), "gelu_tanh": ("gelu_tanh", "gelu"),
         "relu": ("relu", "relu"), "none": ("none", None)}


def act_spec(activation: str, dtype: torch.dtype) -> ActSpec:
    """The bias_act spec of ``activation`` applied to a tensor of
    ``dtype``: the kernel casts as the op of that name does."""
    if activation not in _ACTS:
        raise ValueError(f"activation must be one of {sorted(_ACTS)}, got "
                         f"{activation!r}")
    act, op = _ACTS[activation]
    return ActSpec(act, dtype, dtype if op is None else cast_dtype(op, dtype))


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           activation: Optional[str] = None) -> torch.Tensor:
    """``y = x @ W + b`` with W stored ``(in_features, out_features)``.
    With ``activation`` (``"gelu"``, ``"gelu_tanh"``, ``"relu"`` or
    ``"none"``), ``act(x @ W + b)`` with the bias add and the activation in
    the epilogue kernel (``ops/bias_act.py``), cast as the ``gelu`` or
    ``relu`` op would cast the sum."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    if activation is None:
        return y if bias is None else y + bias
    h = y.dtype if bias is None else torch.promote_types(y.dtype, bias.dtype)
    return bias_act(y, bias, act_spec(activation, h))


def embedding(x: torch.Tensor, weight: torch.Tensor,
              padding_idx: Optional[int] = None) -> torch.Tensor:
    """Rows of ``weight``; ids equal to ``padding_idx`` give 0. The gather
    and its deterministic backward kernel (``ops/embedding.py``) on a
    card."""
    (weight,) = cast_inputs("embedding", weight)
    return _embedding(x, weight, padding_idx)


def silu(x: torch.Tensor) -> torch.Tensor:
    (x,) = cast_inputs("silu", x)
    return torch.nn.functional.silu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU, on the epilogue kernel (no bias) on a card."""
    return bias_act(x, None, act_spec("relu", x.dtype))


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU: erf form by default, the tanh form with ``approximate``; on
    the epilogue kernel (no bias) on a card."""
    return bias_act(x, None, act_spec("gelu_tanh" if approximate else "gelu",
                                      x.dtype))


def tanh(x: torch.Tensor) -> torch.Tensor:
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` under the casts of the JAX package's ``add`` op (under O2
    both go to the low dtype, so an fp32 ``layer_norm`` output added to a
    bf16 branch gives bf16, as there)."""
    x, y = cast_inputs("add", x, y)
    return x + y


def _norm_spec(op: str, kind: str, x, weight, bias, residual, epsilon,
               naxes: int) -> NormSpec:
    """The casts of the plain ``rms_norm`` / ``layer_norm``: the residual
    add as the port's ``add`` op, the norm's inputs as ``op``'s."""
    add = None
    if residual is not None:
        add = torch.promote_types(cast_dtype("add", x.dtype),
                                  cast_dtype("add", residual.dtype))
    norm = cast_dtype(op, add or x.dtype)
    wd = None if weight is None else cast_dtype(op, weight.dtype)
    bd = None if bias is None else cast_dtype(op, bias.dtype)
    out = norm
    for d in (wd, bd):
        if d is not None:
            out = torch.promote_types(out, d)
    return NormSpec(kind, float(epsilon), norm, out, add, wd, bd, False,
                    naxes)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6, residual: Optional[torch.Tensor] = None):
    """Normalise in fp32, cast back to x's dtype, then scale by the weight
    (the order of the JAX reference). With ``residual`` (the port's
    pre-norm fusion), ``h = add(x, residual)`` is normalised and ``(out,
    h)`` returned. The kernel ``ops/fused_norm.py`` on a card."""
    spec = _norm_spec("rms_norm", "rms", x, weight, None, residual, epsilon,
                      1)
    out, h = fused_norm(x, weight, residual=residual, spec=spec)
    return out if residual is None else (out, h)


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5,
               residual: Optional[torch.Tensor] = None):
    """Mean and (population) variance over the trailing
    ``normalized_shape`` axes in fp32, the normalised value cast back to
    x's dtype, then ``* weight + bias`` (the JAX package's order). On the
    AMP black list: fp32 in and out under O2. With ``residual``, ``h =
    add(x, residual)`` is normalised and ``(out, h)`` returned (post-LN's
    ``norm(add(residual, dropout(src)))`` in one kernel on a card)."""
    n = 1 if isinstance(normalized_shape, int) else len(normalized_shape)
    spec = _norm_spec("layer_norm", "ln", x, weight, bias, residual,
                      epsilon, n)
    out, h = fused_norm(x, weight, bias, residual=residual, spec=spec)
    return out if residual is None else (out, h)


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True, *,
            generator=None, residual: Optional[torch.Tensor] = None,
            upscale: bool = True) -> torch.Tensor:
    """``paddle.nn.functional.dropout`` in its ``upscale_in_train`` mode
    (``upscale=False``: ``downscale_in_infer``'s training step, kept values
    unscaled): outside training or at ``p == 0`` the input; else each
    element is kept with probability ``1 - p`` and multiplied by ``1 / (1 -
    p)`` (fp32), by the hashed mask of ``ops/dropout.py`` under one seed
    from ``generator`` (a ``DropoutRNG``: ``next_seed()``, no host read; a
    ``torch.Generator``: one draw on its device). With ``residual`` (port
    extension, ``fused_dropout_add``): ``add(dropout(x), residual)`` in the
    same kernel, cast as the ``add`` op."""
    (x,) = cast_inputs("dropout", x)
    if residual is not None:
        (residual,) = cast_inputs("add", residual)
    if not training or p == 0.0:
        return x if residual is None else x + residual
    if p >= 1.0:
        d = torch.where(torch.zeros_like(x, dtype=torch.bool), x, 0.0)
        return d if residual is None else d + residual
    seed = _dropout.draw_seed(generator, x.device)
    return _dropout.dropout(x, p, seed, residual=residual, upscale=upscale)


def _key_padding(mask: torch.Tensor) -> Optional[torch.Tensor]:
    """``(B, Lk)`` of a boolean mask constant across query rows and heads,
    ``(B, 1, Lk)`` or ``(B, 1, 1, Lk)``; None for any other mask."""
    if mask.dtype != torch.bool:
        return None
    if mask.dim() == 3 and mask.shape[1] == 1:
        return mask[:, 0, :]
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        return mask[:, 0, 0, :]
    return None


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None, *,
                                 generator=None) -> torch.Tensor:
    """Paddle SDPA over ``(B, L, H, D)`` q and ``(B, L, H_kv, D)`` k/v,
    routed as the module docstring says. ``generator`` (port extension, a
    ``DropoutRNG`` or a ``torch.Generator``) gives attention dropout its
    seeds."""
    query, key, value, attn_mask = cast_inputs(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    p = dropout_p if training else 0.0
    if attn_mask is None:
        return flash_attention(query, key, value, dropout=p,
                               causal=is_causal, training=training,
                               generator=generator)
    kv_valid = _key_padding(attn_mask)
    if kv_valid is not None:
        b, lq = query.shape[0], query.shape[1]
        q_segs = torch.ones(b, lq, dtype=torch.int32, device=query.device)
        return flash_attention(query, key, value, dropout=p,
                               causal=is_causal, training=training,
                               q_segment_ids=q_segs,
                               kv_segment_ids=kv_valid.to(torch.int32),
                               generator=generator)
    qh, kh, vh = (x.transpose(1, 2) for x in (query, key, value))
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    fill = torch.finfo(logits.dtype).min
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=logits.device).tril(diagonal=kl - ql)
        logits = logits.masked_fill(~keep, fill)
    if attn_mask.dtype == torch.bool:
        logits = logits.masked_fill(~attn_mask, fill)
    else:
        logits = logits + attn_mask
    probs = torch.softmax(logits.float(), dim=-1).to(qh.dtype)
    if p > 0.0:
        b, h, lq, lk = probs.shape
        ar = lambda n: torch.arange(n, device=probs.device)  # noqa: E731
        keep = keep_mask_reference(
            dropout_seed(None, generator), ar(b * h).view(b, h, 1, 1),
            ar(lq).view(1, 1, lq, 1), ar(lk).view(1, 1, 1, lk), 1.0 - p)
        probs = torch.where(keep, probs / (1.0 - p), 0.0).to(qh.dtype)
    return (probs @ vh).transpose(1, 2)


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.view(shape)
    if bias is not None:
        out = out + bias.view(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats: bool = True,
                  momentum: float = 0.9, eps: float = 1e-5,
                  data_format: str = "NCHW", name=None):
    """Each (sample, channel) normalised over its spatial axes in fp32, cast
    back to x's dtype, then ``* weight + bias`` (``paddle_tpu/ops/
    nn_ops.py:271``: the running buffers, ``use_input_stats`` and
    ``data_format`` are taken and not read, as there)."""
    x, weight, bias = cast_inputs("instance_norm", x, weight, bias)
    axes = tuple(range(2, x.dim()))
    x32 = x.float()
    mu = x32.mean(axes, keepdim=True)
    var = (x32 - mu).square().mean(axes, keepdim=True)
    out = ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return _affine(out, weight, bias, [1, -1] + [1] * (x.dim() - 2))


def group_norm(x, num_groups: int, epsilon: float = 1e-5, weight=None,
               bias=None, data_format: str = "NCHW", name=None):
    """Channels in ``num_groups`` groups, each (sample, group) normalised in
    fp32 over its channels and spatial axes, cast back, then ``* weight +
    bias`` (``paddle_tpu/ops/nn_ops.py:302``; channels first, as there)."""
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape(n, num_groups, c // num_groups, *x.shape[2:]).float()
    axes = tuple(range(2, xg.dim()))
    mu = xg.mean(axes, keepdim=True)
    var = (xg - mu).square().mean(axes, keepdim=True)
    out = ((xg - mu) * torch.rsqrt(var + epsilon)).reshape(x.shape).to(
        x.dtype)
    return _affine(out, weight, bias, [1, c] + [1] * (x.dim() - 2))


def local_response_norm(x, size: int, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0,
                        data_format: str = "NCHW", name=None):
    """``x / (k + alpha * sum of x^2 over size neighbouring channels)^beta``
    with the window's zero padding split ``size // 2`` before and the rest
    after (``paddle_tpu/ops/nn_ops.py:335``; axis 1, as there)."""
    (x,) = cast_inputs("local_response_norm", x)
    half = size // 2
    sq = x.square().movedim(1, -1)
    sq = torch.nn.functional.pad(sq, (half, size - half - 1))
    s = sq.unfold(-1, size, 1).sum(-1).movedim(-1, 1)
    return x / torch.pow(k + alpha * s, beta)
