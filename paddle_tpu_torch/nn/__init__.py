"""Layers of the port with paddle's parameter names and layouts."""

from . import functional
from .common import Embedding, Linear
from .norm import RMSNorm

__all__ = ["Embedding", "Linear", "RMSNorm", "functional"]
