"""``paddle.incubate``, the port of ``paddle_tpu/incubate``: the fused-op
functions (``nn.functional``: the norms, RoPE, SwiGLU, the dropout adds,
the fused linears, ``fused_feedforward``, ``fused_multi_head_attention``,
the memory-efficient attentions, the masked softmaxes, ``identity_loss``,
``blha_get_max_len`` and the decode attention
``masked_multihead_attention``) and the layers ``FusedMultiHeadAttention``,
``FusedFeedForward``, ``FusedLinear``, ``FusedTransformerEncoderLayer``,
``FusedDropoutAdd``, ``FusedBiasDropoutResidualLayerNorm`` and the fused
inference stack ``FusedMultiTransformer``, on the port's kernels; the
Mixture-of-Experts layers (``moe``: ``MoELayer`` and its gates;
``nn.FusedEcMoe`` and ``nn.functional.fused_ec_moe``) on the routing
kernel. The rest of the JAX package's ``incubate`` is not ported
(ROADMAP)."""

from . import moe, nn
from .moe import GShardGate, MoELayer, NaiveGate, SwitchGate
from .nn import FusedMultiTransformer
from .nn_functional import masked_multihead_attention

__all__ = ["FusedMultiTransformer", "GShardGate", "MoELayer", "NaiveGate",
           "SwitchGate", "masked_multihead_attention", "moe", "nn"]
