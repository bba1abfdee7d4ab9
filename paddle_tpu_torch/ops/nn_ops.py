"""Functional nn ops of the Llama and ERNIE paths: linear, embedding,
rms_norm, layer_norm, silu, relu, gelu, tanh, add, dropout and
scaled_dot_product_attention (paddle's signatures and layouts). Each
casts its inputs as the active ``amp.auto_cast`` says (see ``amp``), by the
JAX package's op name.

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

Randomness comes from the caller: ``dropout`` draws its mask from a
``torch.Generator`` on the tensor's device, and attention dropout draws
an int seed from ``generator`` (a CPU generator draws without a device
sync) for the keep mask B0 of ``ops/flash_attention.py``, which the plain
path applies too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..amp import cast_inputs
from .flash_attention import (dropout_seed, flash_attention,
                              keep_mask_reference)

__all__ = ["add", "dropout", "embedding", "gelu", "layer_norm", "linear",
           "relu", "rms_norm", "scaled_dot_product_attention", "silu",
           "tanh"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = x @ W + b`` with W stored ``(in_features, out_features)``."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x: torch.Tensor, weight: torch.Tensor,
              padding_idx: Optional[int] = None) -> torch.Tensor:
    """Rows of ``weight``; ids equal to ``padding_idx`` give 0."""
    (weight,) = cast_inputs("embedding", weight)
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def silu(x: torch.Tensor) -> torch.Tensor:
    (x,) = cast_inputs("silu", x)
    return torch.nn.functional.silu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    (x,) = cast_inputs("relu", x)
    return torch.relu(x)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU: erf form by default, the tanh form with ``approximate``."""
    (x,) = cast_inputs("gelu", x)
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate
                                    else "none")


def tanh(x: torch.Tensor) -> torch.Tensor:
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` under the casts of the JAX package's ``add`` op (under O2
    both go to the low dtype, so an fp32 ``layer_norm`` output added to a
    bf16 branch gives bf16, as there)."""
    x, y = cast_inputs("add", x, y)
    return x + y


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32, cast back to x's dtype, then scale by the weight
    (the order of the JAX reference)."""
    x, weight = cast_inputs("rms_norm", x, weight)
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """Mean and (population) variance over the trailing
    ``normalized_shape`` axes in fp32, the normalised value cast back to
    x's dtype, then ``* weight + bias`` (the JAX package's order). On the
    AMP black list: fp32 in and out under O2."""
    n = 1 if isinstance(normalized_shape, int) else len(normalized_shape)
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    dims = tuple(range(x.dim() - n, x.dim()))
    xf = x.float()
    mu = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, unbiased=False, keepdim=True)
    out = ((xf - mu) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out if bias is None else out + bias


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True, *,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``paddle.nn.functional.dropout`` in its ``upscale_in_train`` mode,
    as the JAX package computes it: outside training or at ``p == 0`` the
    input; else each element is kept with probability ``1 - p``, drawn from
    ``generator`` (on x's device), and divided by ``1 - p``."""
    (x,) = cast_inputs("dropout", x)
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout draws from the caller's torch.Generator: "
                         "pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


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
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """Paddle SDPA over ``(B, L, H, D)`` q and ``(B, L, H_kv, D)`` k/v,
    routed as the module docstring says. ``generator`` (port extension)
    gives attention dropout its seeds."""
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
