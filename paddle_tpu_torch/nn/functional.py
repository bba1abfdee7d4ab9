"""``paddle.nn.functional`` names of the port's ops."""

from ..ops.flash_attention import flash_attention, flash_attn_unpadded
from ..ops.loss_ops import cross_entropy
from ..ops.nn_ops import (dropout, embedding, gelu, layer_norm, linear, relu,
                          rms_norm, scaled_dot_product_attention, silu, tanh)

__all__ = ["cross_entropy", "dropout", "embedding", "flash_attention",
           "flash_attn_unpadded", "gelu", "layer_norm", "linear", "relu",
           "rms_norm", "scaled_dot_product_attention", "silu", "tanh"]
