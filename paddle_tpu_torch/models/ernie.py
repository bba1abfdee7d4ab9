"""ERNIE 3.0, the port of ``paddle_tpu/models/ernie.py``: ``ErnieConfig``,
``ErnieEmbeddings`` (word, position, token-type and task-type tables),
``ErniePooler``, ``ErnieModel`` and ``ErnieForSequenceClassification``.

State-dict keys and layouts are the JAX package's (``Linear`` weights
``(in, out)``), so ``convert.state_dict_from_paddle_tpu`` carries a JAX
checkpoint across key for key. The trunk is ``nn.TransformerEncoder``
(post-norm, GELU): its attention runs the flash kernels, and while
training their dropout variant (segment ids and the keep mask B0 in the
kernels, ``attention_probs_dropout_prob``); the embedding tables, each
layer's ``linear1`` bias and GELU and the hidden dropouts run on the
port's embedding, epilogue and dropout kernels (``ops/embedding.py``,
``ops/bias_act.py``, ``ops/dropout.py``), every dropout seed drawn from
the model's ``DropoutRNG`` (``seed``). A 2-D ``attention_mask`` (B, L) of 1s
and 0s becomes the additive ``(1 - m) * -1e4`` mask of the JAX package,
which takes the plain masked softmax, as there. The token-classification,
question-answering and masked-LM heads are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import (Dropout, DropoutRNG, Embedding, LayerNorm, Linear,
                  TransformerEncoder, TransformerEncoderLayer)
from ..nn import functional as F
from ..ops import nn_ops

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieForSequenceClassification",
           "ErnieModel", "ErniePooler"]

@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    task_type_vocab_size: int = 3
    use_task_id: bool = True
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    @staticmethod
    def ernie3_base() -> "ErnieConfig":
        """ernie-3.0-base-zh trunk dims (PaddleNLP model card)."""
        return ErnieConfig()

    @staticmethod
    def ernie3_medium() -> "ErnieConfig":
        return ErnieConfig(num_hidden_layers=6)

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, inter=128,
             max_pos=64) -> "ErnieConfig":
        return ErnieConfig(vocab_size=vocab, hidden_size=hidden,
                           num_hidden_layers=layers, num_attention_heads=heads,
                           intermediate_size=inter,
                           max_position_embeddings=max_pos)


class ErnieEmbeddings(nn.Module):
    """Word + position + token-type (+ task-type) embeddings, layer norm,
    dropout."""

    def __init__(self, config: ErnieConfig, rng: DropoutRNG, **kw):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h,
                                         padding_idx=config.pad_token_id, **kw)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h, **kw)
        self.use_task_id = config.use_task_id
        if config.use_task_id:
            self.task_type_embeddings = Embedding(
                config.task_type_vocab_size, h, **kw)
        self.layer_norm = LayerNorm(h, epsilon=config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob, rng=rng)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = nn_ops.add(self.word_embeddings(input_ids),
                       self.position_embeddings(position_ids))
        last = self.token_type_embeddings(token_type_ids)
        if self.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            x = nn_ops.add(x, last)
            last = self.task_type_embeddings(task_type_ids)
        # the last add is the norm's residual add (one kernel on a card)
        out, _ = self.layer_norm(last, x)
        return self.dropout(out)


class ErniePooler(nn.Module):
    def __init__(self, hidden_size: int, **kw):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, **kw)

    def forward(self, hidden_states):
        return F.tanh(self.dense(hidden_states[:, 0]))


def _init(model: nn.Module, generator: torch.Generator) -> None:
    """N(0, 0.02) for every Linear and Embedding (padding rows 0), biases
    0; LayerNorms keep weight 1 and bias 0."""
    for m in model.modules():
        if isinstance(m, (Linear, Embedding)):
            m.reset_parameters(generator)


class ErnieModel(nn.Module):
    """Trunk: embeddings, ``TransformerEncoder``, pooler; returns
    ``(sequence_output, pooled)``. Built in fp32 on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``; ``amp.decorate``
    casts for O2), weights drawn from ``generator`` (default: one on that device seeded
    with 0), dropout from a ``DropoutRNG`` seeded with ``seed`` (or
    ``rng``, a head's)."""

    def __init__(self, config: ErnieConfig, device=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.rng = rng if rng is not None else DropoutRNG(dev, seed)
        kw = dict(device=dev)
        self.embeddings = ErnieEmbeddings(config, self.rng, **kw)
        layer = TransformerEncoderLayer(
            d_model=config.hidden_size, nhead=config.num_attention_heads,
            dim_feedforward=config.intermediate_size,
            dropout=config.hidden_dropout_prob, activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            act_dropout=0.0, normalize_before=False,
            layer_norm_eps=config.layer_norm_eps, rng=self.rng, **kw)
        self.encoder = TransformerEncoder(layer, config.num_hidden_layers)
        self.pooler = ErniePooler(config.hidden_size, **kw)
        if rng is None:
            _init(self, generator if generator is not None
                  else torch.Generator(device=dev).manual_seed(0))

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            # (B, L) padding mask -> additive (B, 1, 1, L)
            m = attention_mask[:, None, None, :].float()
            attention_mask = (1.0 - m) * -1e4
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        seq = self.encoder(x, src_mask=attention_mask)
        return seq, self.pooler(seq)


class ErnieForSequenceClassification(nn.Module):
    """ERNIE with a classifier over the pooled output; with ``labels``
    ``forward`` returns ``(loss, logits)``. ``device``, ``generator`` and
    ``seed`` as for :class:`ErnieModel`."""

    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 dropout: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        rng = DropoutRNG(dev, seed)
        self.config = config
        self.ernie = ErnieModel(config, device=dev, rng=rng)
        self.dropout = Dropout(dropout if dropout is not None
                               else config.hidden_dropout_prob, rng=rng)
        self.classifier = Linear(config.hidden_size, num_classes, device=dev)
        _init(self, generator if generator is not None
              else torch.Generator(device=dev).manual_seed(0))

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None, labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask, task_type_ids)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels), logits
        return logits

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs per token: 6 times the parameters that
        multiply (the embedding tables only gather) plus the attention
        products, 12 * layers * hidden * seq_len (the Llama port's formula
        otherwise)."""
        c = self.config
        tables = sum(p.numel() for p in self.ernie.embeddings.parameters()
                     if p.dim() == 2)
        return 6.0 * (self.num_params() - tables) + \
            12 * c.num_hidden_layers * c.hidden_size * seq_len
