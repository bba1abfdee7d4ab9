"""Llama-2 family, the port of ``paddle_tpu/models/llama.py``.

State-dict keys and parameter layouts are those of ``paddle_tpu``
(``Linear`` weights ``(in, out)``), so ``convert.state_dict_from_paddle_tpu``
carries a JAX checkpoint across by copying (a ``scan_layers=True`` one
through ``convert.scan_to_layered_state_dict``). Attention runs through
``nn.functional.scaled_dot_product_attention``: on a card the flash
kernels, with the flash backward when autograd records; cached decode in
the serving engine runs the paged kernel (``serving_callables``). RoPE is
the half-split form, computed in fp32 from cos/sin in the dtype that
``amp.auto_cast`` gives the op (bf16 under O2, as in the JAX package) and
cast back to the activations' dtype.

Training: ``forward(input_ids, labels=ids)`` returns ``(loss, logits)``
with shifted labels; ``config.recompute`` checkpoints each decoder layer
(``torch.utils.checkpoint``, non-reentrant, the forward's ``auto_cast``
state carried into the recomputation). ``config.scan_layers`` is accepted
so that a JAX package config carries across, and ignored: the port always
runs its per-layer modules in a loop (PyTorch has no ``scan``), and a scan
checkpoint's stacked weights load through
``convert.scan_to_layered_state_dict``.

Left for later slices: sampling in ``generate`` and the dense
stacked-cache decode tier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..amp import cast_inputs, recompute_context
from ..device import resolve_device
from ..nn import Embedding, Linear, RMSNorm
from ..nn import functional as F
from ..ops.paged_attention import PagedDecodeCache, paged_decode_attention

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "apply_rotary"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    # checkpoint each decoder layer (recomputed in the backward)
    recompute: bool = False
    # accepted for the JAX package's configs and ignored: the port runs its
    # per-layer modules in a loop either way (see the module docstring)
    scan_layers: bool = False

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, inter=128,
             max_pos=128) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                           num_hidden_layers=layers, num_attention_heads=heads,
                           num_key_value_heads=kv_heads, intermediate_size=inter,
                           max_position_embeddings=max_pos)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{self.dtype!r}")
        return _DTYPES[self.dtype]


def _rope_cache(max_len: int, head_dim: int, theta: float):
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(max_len, dtype=np.float32)
    freqs = np.outer(t, inv)  # (L, D/2)
    return np.cos(freqs), np.sin(freqs)


def _rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 position_offset: int = 0) -> torch.Tensor:
    """x: (B, L, H, D) at positions [offset, offset + L). cos/sin:
    (max_len, D/2) fp32."""
    n = x.shape[1]
    x, cos, sin = cast_inputs("rope", x, cos, sin)
    c = cos[position_offset:position_offset + n][None, :, None, :]
    s = sin[position_offset:position_offset + n][None, :, None, :]
    return _rotate(x, c, s)


def _rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Rotary at per-row positions: x (B, H, D), t (B,)."""
    idx = t.long()
    return _rotate(x, cos[idx][:, None, :], sin[idx][:, None, :])


KVPair = Tuple[torch.Tensor, torch.Tensor]


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h, nh, nkv = (config.hidden_size, config.num_attention_heads,
                      config.num_key_value_heads)
        self.head_dim = h // nh
        self.num_heads = nh
        self.num_kv_heads = nkv
        self.q_proj = Linear(h, nh * self.head_dim, bias_attr=False, **kw)
        self.k_proj = Linear(h, nkv * self.head_dim, bias_attr=False, **kw)
        self.v_proj = Linear(h, nkv * self.head_dim, bias_attr=False, **kw)
        self.o_proj = Linear(nh * self.head_dim, h, bias_attr=False, **kw)

    def forward(self, x, cos, sin, cache: Optional[KVPair] = None):
        b, n = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(b, n, -1, self.head_dim)
        k = self.k_proj(x).reshape(b, n, -1, self.head_dim)
        v = self.v_proj(x).reshape(b, n, -1, self.head_dim)
        offset = 0 if cache is None else cache[0].shape[1]
        q = apply_rotary(q, cos, sin, offset)
        k = apply_rotary(k, cos, sin, offset)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        out = self.o_proj(out.reshape(b, n, -1))
        if cache is not None:
            return out, (k, v)
        return out


class LlamaMLP(nn.Module):
    """SwiGLU."""

    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, i, bias_attr=False, **kw)
        self.up_proj = Linear(h, i, bias_attr=False, **kw)
        self.down_proj = Linear(i, h, bias_attr=False, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, cos, sin, cache: Optional[KVPair] = None):
        h = self.self_attn(self.input_layernorm(x), cos, sin, cache)
        if cache is not None:
            h, new_cache = h
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        if cache is not None:
            return x, new_cache
        return x


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **kw)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        cos, sin = _rope_cache(config.max_position_embeddings,
                               config.head_dim, config.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(kw["device"]),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(kw["device"]),
                             persistent=False)

    def forward(self, input_ids, caches: Optional[List[KVPair]] = None):
        x = self.embed_tokens(input_ids)
        if caches is None:
            remat = self.config.recompute and torch.is_grad_enabled()
            for layer in self.layers:
                if remat:
                    x = checkpoint(layer, x, self.rope_cos, self.rope_sin,
                                   use_reentrant=False,
                                   context_fn=recompute_context)
                else:
                    x = layer(x, self.rope_cos, self.rope_sin)
            return self.norm(x)
        new_caches = []
        for layer, c in zip(self.layers, caches):
            x, nc = layer(x, self.rope_cos, self.rope_sin, cache=c)
            new_caches.append(nc)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    """Llama with an LM head. Built on ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``) in ``config.dtype``, weights
    drawn from ``generator`` (default: a generator on that device seeded
    with 0): N(0, 0.02) for embeddings and projections, ones for norms.
    Parameters train (``requires_grad``)."""

    def __init__(self, config: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=config.torch_dtype)
        self.model = LlamaModel(config, **kw)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias_attr=False, **kw)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        for m in self.modules():
            if isinstance(m, (Linear, Embedding)):
                m.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def forward(self, input_ids, labels=None):
        """Logits ``(B, L, V)``; with ``labels`` ``(loss, logits)``, the loss
        the mean cross entropy of token ``i + 1`` given tokens ``<= i``."""
        logits = self._logits(self.model(input_ids))
        if labels is None:
            return logits
        v = self.config.vocab_size
        loss = F.cross_entropy(logits[:, :-1, :].reshape(-1, v),
                               labels[:, 1:].reshape(-1))
        return loss, logits

    def _logits(self, h):
        if self.lm_head is not None:
            return self.lm_head(h)
        return F.linear(h, self.model.embed_tokens.weight.t())

    def _empty_caches(self, batch: int) -> List[KVPair]:
        cfg = self.config
        empty = torch.zeros((batch, 0, cfg.num_key_value_heads, cfg.head_dim),
                            dtype=self.model.embed_tokens.weight.dtype,
                            device=self.device)
        return [(empty, empty) for _ in range(cfg.num_hidden_layers)]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None):
        """Greedy decode over a concat KV cache (reference surface:
        PaddleNLP GenerationMixin.generate with do_sample=False). Returns
        ``(B, L + new)`` token ids."""
        from .generation import kv_cache_generate
        return kv_cache_generate(
            lambda x, c: self.model(x, caches=c), self._logits, input_ids,
            self._empty_caches(input_ids.shape[0]),
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id)

    def serving_callables(self, max_len: int):
        """``(prefill_fn, step_fn)`` over the serving engine's cache
        contract.

        * ``prefill_fn(ids (1, Lp), cache (L, 2, 1, H_kv, M, D))`` with
          ``M >= Lp`` runs the full-sequence forward (flash prefill) and
          writes each layer's K/V into ``cache`` at positions ``[0, Lp)``,
          in place; returns ``(first_token (1, 1) int32, cache)``.
        * ``step_fn(tok (B, 1), cache, t (B,))`` decodes one token per row.
          ``cache`` is a ``PagedDecodeCache``: every layer's attention runs
          the paged decode kernel and writes position ``t`` into its page,
          in place. Returns ``(next_token (B, 1) int32, cache)``.

        Greedy (argmax) next token. Wire up with ``ServingConfig(
        num_layers=L, num_heads=num_key_value_heads, head_dim=D,
        max_len=max_len)``: the pool stores KV heads."""
        cfg = self.config
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len {max_len} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        model = self.model
        layers = list(model.layers)
        nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)

        def step_fn(tok, cache, t):
            if not isinstance(cache, PagedDecodeCache):
                raise TypeError("step_fn decodes over a PagedDecodeCache; the "
                                "dense stacked-cache tier is not ported")
            b = int(tok.shape[0])
            x = model.embed_tokens(tok)                  # (B, 1, E)
            for i, layer in enumerate(layers):
                res = x
                h = layer.input_layernorm(x)
                att = layer.self_attn
                q = att.q_proj(h).reshape(b, nh, hd)
                k = att.k_proj(h).reshape(b, nkv, hd)
                v = att.v_proj(h).reshape(b, nkv, hd)
                q = _rope_rows(q, model.rope_cos, model.rope_sin, t)
                k = _rope_rows(k, model.rope_cos, model.rope_sin, t)
                out, cache = paged_decode_attention(q, k, v,
                                                    cache.at_layer(i))
                x = res + att.o_proj(out.reshape(b, 1, nh * hd))
                x = x + layer.mlp(layer.post_attention_layernorm(x))
            nxt = self._logits(model.norm(x)).argmax(dim=-1)
            return nxt.to(torch.int32), cache

        def prefill_fn(ids, cache):
            lp = int(ids.shape[1])
            h, new_caches = model(ids, caches=self._empty_caches(1))
            nxt = self._logits(h[:, -1:]).argmax(dim=-1)
            for i, (k, v) in enumerate(new_caches):
                cache[i, 0, :, :, :lp] = k.transpose(1, 2).to(cache.dtype)
                cache[i, 1, :, :, :lp] = v.transpose(1, 2).to(cache.dtype)
            return nxt.to(torch.int32), cache

        return prefill_fn, step_fn

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs per token: 6N plus the attention
        products (the JAX package's formula)."""
        c = self.config
        return 6.0 * self.num_params() + \
            12 * c.num_hidden_layers * c.hidden_size * seq_len
