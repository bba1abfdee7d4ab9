"""Autoregressive decoding over a KV cache (reference surface: PaddleNLP
GenerationMixin.generate: greedy by default, temperature/top-k/top-p
sampling, finished rows frozen to eos), the port of
``paddle_tpu/models/generation.py``.

The model supplies ``step(x, caches) -> (hidden, caches)`` and
``logits(hidden_last)``.

Sampling follows the JAX package's ``sample_token`` step by step, on fp32
``(B, V)`` logits: divide by the temperature; top-k keeps every logit not
below the k-th largest (ties at it survive, so more than k can); top-p
sorts the result descending, takes the softmax's running sum and keeps
every logit not below the sorted value at ``sum(cdf < top_p)``. Out of
range, as in the JAX package and without raising: ``top_k > V`` keeps
every token (JAX's index clamps to the smallest), and a ``top_p`` that
every ``cdf`` stays under keeps every token (JAX's ``take_along_axis``
gives NaN there, and nothing is below NaN). The draw is
``argmax(logits + gumbel)``, as ``jax.random.categorical``; the Gumbel
noise is ``-log(-log(u))`` with ``u`` from ``torch.rand`` on an explicit
``torch.Generator``, kept off 0 as JAX's ``gumbel`` keeps it. Its bits
differ from JAX's by design (the port draws from a torch generator, as its
dropout does); a test passes JAX's noise to :func:`draw` to hold the rest
bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["draw", "filter_logits", "gumbel_noise", "kv_cache_generate",
           "sample_token"]

_TINY = torch.finfo(torch.float32).tiny


def filter_logits(arr: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """The temperature, top-k and top-p filters on fp32 logits ``(B, V)``:
    the logits to draw from, those filtered out at ``-inf``."""
    if temperature != 1.0:
        arr = arr / temperature
    if not top_k and top_p >= 1.0:
        return arr
    v = arr.shape[-1]
    # one descending sort serves both filters: top-k's survivors sort to
    # the front unchanged, so the filtered logits' sort is this one with
    # the tail below the k-th value at -inf
    srt = torch.sort(arr, dim=-1, descending=True).values
    if top_k:
        kth = srt[..., min(int(top_k), v) - 1:min(int(top_k), v)]
        arr = arr.masked_fill(arr < kth, float("-inf"))
        srt = srt.masked_fill(srt < kth, float("-inf"))
    if top_p < 1.0:
        cdf = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        cut_idx = (cdf < top_p).sum(dim=-1, keepdim=True)
        cut = srt.gather(-1, cut_idx.clamp(max=v - 1))
        # every cdf under top_p: JAX's index past the end reads NaN, and
        # no logit is below NaN
        drop = (arr < cut) & (cut_idx < v)
        arr = arr.masked_fill(drop, float("-inf"))
    return arr


def gumbel_noise(shape, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` in fp32 from ``generator`` (on
    its device unless ``device`` is given): ``-log(-log(u))``, ``u`` kept
    off 0."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device if device is not None else generator.device)
    return -torch.log(-torch.log(u.clamp_min(_TINY)))


def draw(arr: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The categorical draw from filtered logits and Gumbel noise of their
    shape: ``argmax(arr + noise)`` (``jax.random.categorical``)."""
    return torch.argmax(arr + noise, dim=-1)


def _check_generator(do_sample: bool, temperature: float,
                     generator: Optional[torch.Generator]) -> None:
    if do_sample and temperature != 0 and generator is None:
        raise ValueError(
            "sampling (do_sample=True with a temperature other than 0) "
            "needs generator=torch.Generator(device=...): the port never "
            "draws from a global RNG")


def sample_token(arr: torch.Tensor, do_sample: bool, temperature: float,
                 top_k: int, top_p: float,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Pick next-token ids from fp32 logits ``(B, V)``: greedy argmax when
    ``do_sample`` is false or the temperature 0, else a draw from the
    filtered logits on ``generator``."""
    if not do_sample or temperature == 0:
        return torch.argmax(arr, dim=-1)
    _check_generator(do_sample, temperature, generator)
    arr = filter_logits(arr, temperature, top_k, top_p)
    return draw(arr, gumbel_noise(arr.shape, generator, arr.device))


@torch.no_grad()
def kv_cache_generate(step, logits_fn, input_ids: torch.Tensor, caches,
                      max_new_tokens: int = 32, temperature: float = 1.0,
                      top_k: int = 0, top_p: float = 1.0,
                      do_sample: bool = False,
                      eos_token_id: Optional[int] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Prefill the prompt, then decode one cached token at a time.

    ``step(x, caches) -> (hidden, caches)``; ``logits_fn(hidden_last)``
    maps the final hidden state (B, H) to logits (B, V). Sampling draws
    from ``generator``, which it needs (``ValueError`` without)."""
    _check_generator(do_sample, temperature, generator)
    b = input_ids.shape[0]
    tokens = [input_ids]
    x = input_ids
    finished = torch.zeros(b, dtype=torch.bool, device=input_ids.device)
    for _ in range(max_new_tokens):
        h, caches = step(x, caches)
        nxt = sample_token(logits_fn(h[:, -1]).float(), do_sample,
                           temperature, top_k, top_p, generator)
        if eos_token_id is not None:
            # rows already finished keep emitting eos (the reference
            # generate freezes finished sequences to eos/pad)
            nxt = torch.where(finished, torch.full_like(nxt, eos_token_id),
                              nxt)
            finished = finished | (nxt == eos_token_id)
        x = nxt[:, None].to(input_ids.dtype)
        tokens.append(x)
        if eos_token_id is not None and bool(finished.all()):
            break
    return torch.cat(tokens, dim=1)
