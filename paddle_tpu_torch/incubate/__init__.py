"""``paddle.incubate``, the port of ``paddle_tpu/incubate``: the fused-op
functions (``nn.functional``: the norms, RoPE, SwiGLU, the dropout adds,
the fused linears, ``fused_feedforward``, ``fused_multi_head_attention``,
the memory-efficient attentions, the masked softmaxes, ``identity_loss``,
``blha_get_max_len`` and the decode attention
``masked_multihead_attention``) and the layers ``FusedMultiHeadAttention``,
``FusedFeedForward``, ``FusedLinear``, ``FusedTransformerEncoderLayer``,
``FusedDropoutAdd``, ``FusedBiasDropoutResidualLayerNorm`` and the fused
inference stack ``FusedMultiTransformer``, on the port's kernels. The MoE
ops and the rest of the JAX package's ``incubate`` are not ported
(ROADMAP)."""

from . import nn
from .nn import FusedMultiTransformer
from .nn_functional import masked_multihead_attention

__all__ = ["FusedMultiTransformer", "masked_multihead_attention", "nn"]
