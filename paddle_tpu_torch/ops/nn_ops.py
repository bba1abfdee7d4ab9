"""Functional nn ops of the Llama path: linear, embedding, rms_norm, silu
and scaled_dot_product_attention (paddle's signatures and layouts). Each
casts its inputs as the active ``amp.auto_cast`` says (see ``amp``).

``linear`` keeps paddle's weight layout ``(in_features, out_features)``,
``y = x @ W``, so a ``paddle_tpu`` state dict loads without a transpose.

``scaled_dot_product_attention`` routes like the JAX package's: a
mask-free call goes to the flash kernels (``ops/flash_attention.py``):
when autograd records it (grad mode on and an input requiring grad) to
the :class:`FlashAttention` function (forward with lse, flash backward),
otherwise to the forward-only kernel. On a CUDA tensor any mask raises
``NotImplementedError`` (no path of the port passes one); on a CPU tensor
a masked call runs the plain masked softmax.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..amp import cast_inputs
from .flash_attention import FlashAttention, flash_attention

__all__ = ["linear", "embedding", "rms_norm", "scaled_dot_product_attention",
           "silu"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = x @ W + b`` with W stored ``(in_features, out_features)``."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    (weight,) = cast_inputs("embedding", weight)
    return weight[x.long()]


def silu(x: torch.Tensor) -> torch.Tensor:
    (x,) = cast_inputs("silu", x)
    return torch.nn.functional.silu(x)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32, cast back to x's dtype, then scale by the weight
    (the order of the JAX reference)."""
    x, weight = cast_inputs("rms_norm", x, weight)
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 is_causal: bool = False) -> torch.Tensor:
    """Paddle SDPA over ``(B, L, H, D)`` q and ``(B, L, H_kv, D)`` k/v."""
    query, key, value = cast_inputs("scaled_dot_product_attention", query,
                                    key, value)
    if attn_mask is None:
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (query, key, value)):
            return FlashAttention.apply(query, key, value, is_causal, None)
        return flash_attention(query, key, value, causal=is_causal)
    if query.device.type != "cpu":
        raise NotImplementedError(
            "scaled_dot_product_attention with a mask has no CUDA kernel in "
            "the port yet; the serving path calls it mask-free")
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
    return (probs @ vh).transpose(1, 2)
