"""The serving stack around ``FusedMultiTransformer``: embedding, the
decoder stack, a final LayerNorm and a bias-free LM head with greedy
argmax, the port of the stack that ``benchmarks/bench_generation.py``
builds for its ``--serving`` leg (``lm_step``, ``prefill_raw`` and
``prefill_causal_raw``). A bench-side tool, not package API: the JAX
package has no such class either.

``FMTStack(...).serving_callables()`` gives ``(prefill_fn, step_fn)`` in
the serving engine's contract (``serving/engine.py``):

* ``prefill_fn(ids (1, n), cache (L, 2, 1, H, M, D))`` fills ``[0, n)``
  with the bidirectional prefill (the bench's ``prefill_raw``);
  ``causal=True`` gives ``prefill_fn(ids, cache, start=0)``, the causal
  prefill resumable at ``start`` (``prefill_causal_raw``), so the engine
  can share prompt prefixes;
* ``step_fn(tok (B, 1), cache, t (B,))`` decodes one token per row over a
  ``PagedDecodeCache`` (the paged decode kernel on a card) or a stacked
  dense cache ``(L, 2, B, H, M, D)``, written in place at each row's
  ``t``: the layout of the engine's dense tier (``paged_attention="off"``),
  so both tiers serve the stack.

:meth:`FMTStack.reference` is the bench's parity oracle: one request at
batch 1, prefill, then a per-token loop over a stacked dense cache, whose
attention is ``masked_multihead_attention``'s dense branch.
:meth:`FMTStack.reference_logits` runs the same loop fed a given
transcript (teacher forcing) and returns the logits of every step.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..incubate.nn import FusedMultiTransformer
from ..nn.common import Embedding, Linear
from ..nn.norm import LayerNorm

__all__ = ["FMTStack"]


class FMTStack(nn.Module):
    """``embed`` -> ``fmt`` -> ``final_ln`` -> ``head``, built on
    ``device`` (``cuda`` unless ``device="cpu"``) in ``dtype``, in eval
    mode. Weights are random from ``seed`` (the embedding and head normal
    with std 0.02, the stack as :class:`FusedMultiTransformer` initialises
    it); load converted weights with ``load_state_dict``
    (``convert.fmt_state_dict_from_paddle_tpu``)."""

    def __init__(self, vocab: int, hidden: int, heads: int, inter: int,
                 layers: int, *, dtype=torch.float32, device=None,
                 seed: int = 0, activation: str = "gelu"):
        super().__init__()
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(device=dev, dtype=dtype)
        self.embed = Embedding(vocab, hidden, **kw)
        self.fmt = FusedMultiTransformer(hidden, heads, inter,
                                         num_layers=layers,
                                         activation=activation,
                                         generator=g, **kw)
        self.final_ln = LayerNorm(hidden, **kw)
        self.head = Linear(hidden, vocab, bias_attr=False, **kw)
        self.embed.reset_parameters(g)
        self.head.reset_parameters(g)
        self.eval()
        self.device = dev

    @property
    def cache_shape(self):
        """``(L, 2, H, D)``: the stacked cache is ``(L, 2, B, H, M, D)``."""
        f = self.fmt
        return f.num_layers, 2, f.num_heads, f.head_dim

    def logits(self, x) -> torch.Tensor:
        """The head's logits of hidden states ``x``, after the final
        LayerNorm."""
        return self.head(self.final_ln(x))

    def step_logits(self, tok, cache, t):
        """One decode step: ``(logits (B, 1, V), cache)``."""
        x, cache = self.fmt(self.embed(tok), caches=cache, time_step=t)
        return self.logits(x), cache

    def prefill_logits(self, ids, cache, start=None):
        """The prefill of ``ids (1, n)`` into ``cache``: bidirectional when
        ``start`` is None, else causal at positions ``[start, start + n)``
        over the resident ``cache[..., :start]``. Returns ``(logits of the
        last position (1, 1, V), cache)``."""
        x, cache = self.fmt(self.embed(ids), caches=cache, seq_offset=start)
        return self.logits(x[:, -1:]), cache

    @staticmethod
    def greedy(logits) -> torch.Tensor:
        """Greedy next tokens ``(B, 1)`` int32."""
        return logits.argmax(dim=-1).to(torch.int32)

    def step(self, tok, cache, t):
        """One decode step: ``(next (B, 1) int32, cache)``."""
        logits, cache = self.step_logits(tok, cache, t)
        return self.greedy(logits), cache

    def prefill(self, ids, cache):
        """Bidirectional prefill of ``ids (1, n)`` into ``cache[..., :n]``:
        ``(first token (1, 1) int32, cache)``."""
        logits, cache = self.prefill_logits(ids, cache)
        return self.greedy(logits), cache

    def prefill_causal(self, ids, cache, start: int = 0):
        """Causal prefill of positions ``[start, start + n)`` over the
        resident ``cache[..., :start]``."""
        logits, cache = self.prefill_logits(ids, cache, start)
        return self.greedy(logits), cache

    def serving_callables(self, causal: bool = False):
        """``(prefill_fn, step_fn)`` for ``serving.Engine`` (wire up with
        ``ServingConfig(num_layers=L, num_heads=H, head_dim=D, ...)``)."""
        if causal:
            def prefill_fn(ids, cache, start=0):
                return self.prefill_causal(ids, cache, start)
        else:
            def prefill_fn(ids, cache):
                return self.prefill(ids, cache)
        return prefill_fn, self.step

    @torch.no_grad()
    def _loop(self, prompt: np.ndarray, n: int, max_len: int, causal: bool,
              feed=None):
        """The bs=1 loop over a dense stacked cache of ``max_len``
        positions: the prefill's logits, then ``n - 1`` steps', each step
        reading the previous pick, or ``feed``'s token when given."""
        L, two, H, D = self.cache_shape
        cache = torch.zeros((L, two, 1, H, max_len, D),
                            dtype=self.embed.weight.dtype, device=self.device)
        ids = torch.as_tensor(np.asarray(prompt)[None], dtype=torch.int64,
                              device=self.device)
        logits, _ = self.prefill_logits(ids, cache, 0 if causal else None)
        out = [logits]
        for i, t in enumerate(range(ids.shape[1], ids.shape[1] + n - 1)):
            tok = (self.greedy(logits) if feed is None else
                   torch.tensor([[int(feed[i])]], dtype=torch.int32,
                                device=self.device))
            logits, _ = self.step_logits(tok, cache, t)
            out.append(logits)
        return out

    def reference(self, prompt: np.ndarray, n_new: int, max_len: int,
                  causal: bool = False) -> List[int]:
        """The bs=1 per-token greedy loop over a dense stacked cache of
        ``max_len`` positions: ``n_new`` tokens, the first from the
        prefill."""
        return [int(self.greedy(lg).reshape(-1)[0])
                for lg in self._loop(prompt, n_new, max_len, causal)]

    def reference_logits(self, prompt: np.ndarray, tokens, max_len: int,
                         causal: bool = False) -> torch.Tensor:
        """The reference loop fed ``tokens`` in place of its own picks
        (teacher forcing): ``(len(tokens), V)`` fp32, row ``i`` the logits
        that ``tokens[i]`` was to be picked from, at the context
        ``prompt + tokens[:i]`` (row 0 from the prefill)."""
        out = self._loop(prompt, len(tokens), max_len, causal, feed=tokens)
        return torch.cat([lg.reshape(1, -1) for lg in out]).float()
