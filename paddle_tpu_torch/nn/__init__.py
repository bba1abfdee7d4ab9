"""Layers of the port with paddle's parameter names and layouts, and the
gradient clips (``paddle.nn.ClipGradBy*``, from ``optimizer``). ``Layer``
(``nn/layer.py``) is paddle's module surface on ``torch.nn.Module``; the
layers of the Llama, ERNIE and Transformer paths (``common.py``,
``norm.py``'s ``LayerNorm`` and ``RMSNorm``, ``transformer.py``) are plain
``nn.Module`` s with a ``device`` argument."""

from . import functional, initializer
from .activation import (CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, SELU,
                         Sigmoid, SiLU, Silu, Softmax, Softmax2D, Softplus,
                         Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                         ThresholdedReLU)
from .common import Dropout, DropoutRNG, Embedding, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .layer import Layer, ParamAttr, build_scope
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss,
                   MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LayerNorm, LocalResponseNorm, RMSNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, LPPool1D, LPPool2D, MaxPool1D,
                      MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from ..optimizer import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: E402
                         ClipGradByValue)

__all__ = [
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "BCELoss", "BCEWithLogitsLoss",
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "CELU",
    "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "Conv1D",
    "Conv1DTranspose", "Conv2D", "Conv2DTranspose", "Conv3D",
    "Conv3DTranspose", "CosineEmbeddingLoss", "CrossEntropyLoss", "Dropout",
    "DropoutRNG", "ELU", "Embedding", "GELU", "GLU", "GroupNorm",
    "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh",
    "HingeEmbeddingLoss", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "KLDivLoss", "L1Loss", "LPPool1D", "LPPool2D", "Layer",
    "LayerDict", "LayerList", "LayerNorm", "LeakyReLU", "Linear",
    "LocalResponseNorm", "LogSigmoid", "LogSoftmax", "MSELoss",
    "MarginRankingLoss", "MaxPool1D", "MaxPool2D", "MaxPool3D", "Maxout",
    "Mish", "MultiHeadAttention", "NLLLoss", "PReLU", "ParamAttr",
    "ParameterList", "RMSNorm", "ReLU", "ReLU6", "SELU", "Sequential",
    "SiLU", "Sigmoid", "Silu", "SmoothL1Loss", "Softmax", "Softmax2D",
    "Softplus", "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
    "ThresholdedReLU", "Transformer", "TransformerDecoder",
    "TransformerDecoderLayer", "TransformerEncoder",
    "TransformerEncoderLayer", "TripletMarginLoss", "build_scope",
    "functional", "initializer"]
