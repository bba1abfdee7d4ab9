"""``paddle.nn.functional`` names of the port's ops."""

from ..ops.flash_attention import flash_attention, flash_attn_unpadded
from ..ops.loss_ops import (binary_cross_entropy,
                            binary_cross_entropy_with_logits,
                            cosine_embedding_loss, cross_entropy,
                            hinge_embedding_loss, kl_div, l1_loss, log_loss,
                            margin_ranking_loss, mse_loss, nll_loss,
                            sigmoid_focal_loss, smooth_l1_loss,
                            softmax_with_cross_entropy, square_error_cost,
                            triplet_margin_loss)
from ..ops.nn_ops import (dropout, embedding, gelu, layer_norm, linear, relu,
                          rms_norm, scaled_dot_product_attention, silu, tanh)

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cosine_embedding_loss", "cross_entropy", "dropout", "embedding",
           "flash_attention", "flash_attn_unpadded", "gelu",
           "hinge_embedding_loss", "kl_div", "l1_loss", "layer_norm",
           "linear", "log_loss", "margin_ranking_loss", "mse_loss",
           "nll_loss", "relu", "rms_norm", "scaled_dot_product_attention",
           "sigmoid_focal_loss", "silu", "smooth_l1_loss",
           "softmax_with_cross_entropy", "square_error_cost", "tanh",
           "triplet_margin_loss"]
