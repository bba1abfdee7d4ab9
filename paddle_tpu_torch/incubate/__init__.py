"""``paddle.incubate``, the port of ``paddle_tpu/incubate``: the fused-op
functions (``nn.functional``: ``fused_rms_norm``, ``fused_layer_norm``,
``fused_rotary_position_embedding``, ``swiglu``, ``fused_dropout_add``,
``fused_bias_dropout_residual_layer_norm``) and the layers
``FusedDropoutAdd`` and ``FusedBiasDropoutResidualLayerNorm``, on the
port's fused kernels. The rest of the JAX package's ``incubate`` is not
ported (ROADMAP)."""

from . import nn

__all__ = ["nn"]
