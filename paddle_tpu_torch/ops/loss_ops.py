"""Loss ops, the port of ``paddle_tpu/ops/loss_ops.py``: ``cross_entropy``
over hard labels (paddle semantics: log-softmax in fp32 over the last
axis, ``ignore_index`` honoured when it is >= 0, the mean over the rows
that count)."""

from __future__ import annotations

import torch

from ..amp import cast_inputs

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
    (input,) = cast_inputs("cross_entropy", input)
    logp = torch.log_softmax(input.float(), dim=-1)
    li = label.long()
    if li.dim() == logp.dim() and li.shape[-1] == 1:
        li = li.squeeze(-1)
    valid = li != ignore_index if ignore_index >= 0 else None
    idx = li if valid is None else torch.where(valid, li, 0)
    loss = -logp.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    if valid is None:
        return loss.mean()
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().float().clamp(min=1.0)
