"""``paddle.incubate``, the port of ``paddle_tpu/incubate``: the fused-op
functions (``nn.functional``: the norms, RoPE, SwiGLU, the dropout adds,
the fused linears, ``fused_feedforward``, ``fused_multi_head_attention``,
the memory-efficient attentions, the masked softmaxes, ``identity_loss``,
``blha_get_max_len``) and the layers ``FusedMultiHeadAttention``,
``FusedFeedForward``, ``FusedLinear``, ``FusedTransformerEncoderLayer``,
``FusedDropoutAdd`` and ``FusedBiasDropoutResidualLayerNorm``, on the
port's fused kernels. The decode path (``masked_multihead_attention``,
``FusedMultiTransformer``), the MoE ops and the rest of the JAX package's
``incubate`` are not ported (ROADMAP)."""

from . import nn

__all__ = ["nn"]
