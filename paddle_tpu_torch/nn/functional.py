"""``paddle.nn.functional`` names of the port's ops (the JAX package's
``paddle_tpu/nn/functional.py`` as far as the port has them)."""

from ..ops.activation import (celu, elu, gelu, glu, gumbel_softmax,
                              hardshrink, hardsigmoid, hardswish, hardtanh,
                              leaky_relu, log_sigmoid, log_softmax, maxout,
                              mish, prelu, relu, relu6, selu, sigmoid, silu,
                              softmax, softplus, softshrink, softsign, swish,
                              tanhshrink, thresholded_relu)
from ..ops.conv_pool import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                             adaptive_avg_pool3d, adaptive_max_pool1d,
                             adaptive_max_pool2d, adaptive_max_pool3d,
                             avg_pool1d, avg_pool2d, avg_pool3d,
                             channel_shuffle, conv1d, conv2d,
                             conv2d_transpose, conv3d, conv3d_transpose,
                             fold, interpolate, max_pool1d, max_pool2d,
                             max_pool3d, pixel_shuffle, pixel_unshuffle,
                             unfold, upsample)
from ..ops.flash_attention import flash_attention, flash_attn_unpadded
from ..ops.loss_ops import (binary_cross_entropy,
                            binary_cross_entropy_with_logits,
                            cosine_embedding_loss, cross_entropy,
                            hinge_embedding_loss, kl_div, l1_loss, log_loss,
                            margin_ranking_loss, mse_loss, nll_loss,
                            sigmoid_focal_loss, smooth_l1_loss,
                            softmax_with_cross_entropy, square_error_cost,
                            triplet_margin_loss)
from ..ops.manipulation import pad
from ..ops.nn_ops import (batch_norm, dropout, embedding, group_norm,
                          instance_norm, layer_norm, linear,
                          local_response_norm, rms_norm,
                          scaled_dot_product_attention, tanh)

__all__ = [
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "batch_norm",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "celu",
    "channel_shuffle", "conv1d", "conv2d", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "cosine_embedding_loss", "cross_entropy", "dropout",
    "elu", "embedding", "flash_attention", "flash_attn_unpadded", "fold",
    "gelu", "glu", "group_norm", "gumbel_softmax", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "hinge_embedding_loss",
    "instance_norm", "interpolate", "kl_div", "l1_loss", "layer_norm",
    "leaky_relu", "linear", "local_response_norm", "log_loss",
    "log_sigmoid", "log_softmax", "margin_ranking_loss", "max_pool1d",
    "max_pool2d", "max_pool3d", "maxout", "mish", "mse_loss", "nll_loss",
    "pad", "pixel_shuffle", "pixel_unshuffle", "prelu", "relu", "relu6",
    "rms_norm", "scaled_dot_product_attention", "selu", "sigmoid",
    "sigmoid_focal_loss", "silu", "smooth_l1_loss", "softmax",
    "softmax_with_cross_entropy", "softplus", "softshrink", "softsign",
    "square_error_cost", "swish", "tanh", "tanhshrink", "thresholded_relu",
    "triplet_margin_loss", "unfold", "upsample"]
