"""Loss ops, the port of ``paddle_tpu/ops/loss_ops.py``: ``cross_entropy``
over hard labels (paddle semantics: log-softmax in fp32 over the last
axis, ``ignore_index`` honoured when it is >= 0, the mean over the rows
that count). On a card it runs the kernel of
``ops/softmax_cross_entropy.py``, which reads the logits where they lie."""

from __future__ import annotations

import torch

from ..amp import cast_dtype
from .softmax_cross_entropy import softmax_cross_entropy

__all__ = ["cross_entropy"]


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True, label_smoothing: float = 0.0,
                  name=None) -> torch.Tensor:
    """``paddle.nn.functional.cross_entropy`` for integer labels of shape
    ``input.shape[:-1]`` (or with a trailing 1), ``reduction="mean"``.
    Returns fp32. Class weights, soft labels, label smoothing, another
    axis or reduction and ``use_softmax=False`` are not ported and
    raise."""
    if (weight is not None or soft_label or label_smoothing
            or not use_softmax or axis not in (-1, input.dim() - 1)
            or reduction != "mean"):
        raise NotImplementedError(
            "cross_entropy: the port covers the mean over hard labels on the "
            "last axis with softmax, no class weights, no label smoothing")
    return softmax_cross_entropy(input, label, ignore_index,
                                 dtype=cast_dtype("cross_entropy",
                                                  input.dtype))
