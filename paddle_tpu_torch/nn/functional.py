"""``paddle.nn.functional`` names of the port's ops."""

from ..ops.flash_attention import flash_attention
from ..ops.loss_ops import cross_entropy
from ..ops.nn_ops import (embedding, linear, rms_norm,
                          scaled_dot_product_attention, silu)

__all__ = ["cross_entropy", "embedding", "flash_attention", "linear",
           "rms_norm", "scaled_dot_product_attention", "silu"]
