"""Functional nn ops of the serving path: linear, embedding, rms_norm and
scaled_dot_product_attention (paddle's signatures and layouts).

``linear`` keeps paddle's weight layout ``(in_features, out_features)``,
``y = x @ W``, so a ``paddle_tpu`` state dict loads without a transpose.

``scaled_dot_product_attention`` routes like the JAX package's: a
mask-free call goes to the flash kernel (``ops/flash_attention.py``). On a
CUDA tensor any mask raises ``NotImplementedError`` (the serving path
passes none; masked attention joins with the training slice); on a CPU
tensor a masked call runs the plain masked softmax.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention

__all__ = ["linear", "embedding", "rms_norm", "scaled_dot_product_attention"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = x @ W + b`` with W stored ``(in_features, out_features)``."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return weight[x.long()]


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32, cast back to x's dtype, then scale by the weight
    (the order of the JAX reference)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 is_causal: bool = False) -> torch.Tensor:
    """Paddle SDPA over ``(B, L, H, D)`` q and ``(B, L, H_kv, D)`` k/v."""
    if attn_mask is None:
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
