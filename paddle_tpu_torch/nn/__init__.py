"""Layers of the port with paddle's parameter names and layouts, and the
gradient clips (``paddle.nn.ClipGradBy*``, from ``optimizer``)."""

from . import functional
from .common import Dropout, DropoutRNG, Embedding, Linear
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from ..optimizer import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: E402
                         ClipGradByValue)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "DropoutRNG", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "RMSNorm", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer", "functional"]
