"""Greedy autoregressive decoding over a KV cache (reference surface:
PaddleNLP GenerationMixin.generate with do_sample=False; finished rows
frozen to eos). Sampling joins in a later slice.

The model supplies ``step(x, caches) -> (hidden, caches)`` and
``logits(hidden_last)``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["kv_cache_generate"]


@torch.no_grad()
def kv_cache_generate(step, logits_fn, input_ids: torch.Tensor, caches,
                      max_new_tokens: int = 32,
                      eos_token_id: Optional[int] = None) -> torch.Tensor:
    """Prefill the prompt, then decode one cached token at a time."""
    b = input_ids.shape[0]
    tokens = [input_ids]
    x = input_ids
    finished = torch.zeros(b, dtype=torch.bool, device=input_ids.device)
    for _ in range(max_new_tokens):
        h, caches = step(x, caches)
        nxt = logits_fn(h[:, -1]).float().argmax(dim=-1)
        if eos_token_id is not None:
            nxt = torch.where(finished, torch.full_like(nxt, eos_token_id),
                              nxt)
            finished = finished | (nxt == eos_token_id)
        x = nxt[:, None].to(input_ids.dtype)
        tokens.append(x)
        if eos_token_id is not None and bool(finished.all()):
            break
    return torch.cat(tokens, dim=1)
