"""Layers of the port with paddle's parameter names and layouts."""

from . import functional
from .common import Dropout, DropoutRNG, Embedding, Linear
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Dropout", "DropoutRNG", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "RMSNorm", "TransformerEncoder",
           "TransformerEncoderLayer", "functional"]
