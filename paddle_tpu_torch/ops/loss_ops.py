"""Loss ops, the port of ``paddle_tpu/ops/loss_ops.py``, with its semantics
line by line (paddle's surface; where the JAX package departs from upstream
Paddle, the port follows the JAX package):

* ``cross_entropy`` over hard or soft labels, on any axis, with class
  weights, label smoothing, ``use_softmax=False`` and every reduction. A
  hard label outside ``[0, V)`` one-hots to a zero target (its row still
  counts); ``ignore_index`` is honoured only when it is >= 0, and only then
  is the mean taken over the rows that count; with class weights and
  ``ignore_index < 0`` the mean is the plain mean of the weighted losses.
  Hard labels on the last axis with softmax run the kernel of
  ``ops/softmax_cross_entropy.py`` on a card (it reads the logits where they
  lie); every other form is plain PyTorch ops, as the JAX package computes
  all of them with ``jnp`` outside any Pallas kernel.
* ``softmax_with_cross_entropy``, ``nll_loss``, ``mse_loss``, ``l1_loss``,
  ``smooth_l1_loss``, ``binary_cross_entropy``,
  ``binary_cross_entropy_with_logits``, ``kl_div``,
  ``hinge_embedding_loss``, ``margin_ranking_loss``,
  ``cosine_embedding_loss``, ``triplet_margin_loss``,
  ``square_error_cost``, ``log_loss`` and ``sigmoid_focal_loss``: plain
  PyTorch ops.

Every op casts its float inputs under ``amp.auto_cast`` as the JAX op of
the same name does. ``jnp.take`` / ``jnp.take_along_axis`` read an index
outside ``[-n, n)`` as NaN (their default fill mode); the port's gathers do
the same (:func:`~.softmax_cross_entropy.take_weight`)."""

from __future__ import annotations

import torch

from ..amp import cast_dtype, cast_inputs
from .softmax_cross_entropy import (reduce_loss, softmax_cross_entropy,
                                    take_weight)

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cosine_embedding_loss", "cross_entropy", "hinge_embedding_loss",
           "kl_div", "l1_loss", "log_loss", "margin_ranking_loss",
           "mse_loss", "nll_loss", "sigmoid_focal_loss", "smooth_l1_loss",
           "softmax_with_cross_entropy", "square_error_cost",
           "triplet_margin_loss"]


def _one_hot(li: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """``jax.nn.one_hot(li, n, axis=axis)`` in fp32: rows of labels outside
    ``[0, n)`` are zero."""
    hot = (li.unsqueeze(-1) == torch.arange(n, device=li.device)).float()
    return hot.movedim(-1, axis % (li.dim() + 1))


def _take_along_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx, axis=-1)``: indices in ``[-n, 0)``
    wrap, others outside ``[0, n)`` read NaN."""
    n = x.shape[-1]
    inside = (idx >= -n) & (idx < n)
    got = x.gather(-1, torch.where(inside, idx % n, 0))
    return torch.where(inside, got, torch.nan)


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True, label_smoothing: float = 0.0,
                  name=None) -> torch.Tensor:
    """``paddle.nn.functional.cross_entropy`` (module docstring). Returns
    fp32."""
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be 'none', 'sum' or 'mean', got "
                         f"{reduction!r}")
    eps = float(label_smoothing) if label_smoothing > 0.0 else 0.0
    if not soft_label and use_softmax and axis in (-1, input.dim() - 1):
        if weight is not None:
            (weight,) = cast_inputs("cross_entropy", weight)
        return softmax_cross_entropy(
            input, label, ignore_index,
            dtype=cast_dtype("cross_entropy", input.dtype), weight=weight,
            label_smoothing=eps, reduction=reduction)
    input, label, weight = cast_inputs("cross_entropy", input, label, weight)
    x = input.float()
    logp = torch.log_softmax(x, dim=axis) if use_softmax \
        else torch.log(torch.clamp(x, min=1e-30))
    n = input.shape[axis]
    li = None
    if soft_label:
        target = label.float()
    else:
        li = label.long()
        if li.dim() == logp.dim() and li.shape[axis] == 1:
            li = li.squeeze(axis)
        target = _one_hot(li, n, axis)
    if eps > 0.0:
        target = target * (1.0 - eps) + eps / n
    loss = -(target * logp).sum(axis)
    if weight is not None:
        w = weight.float()
        if soft_label:
            cw = (target * w.reshape((1,) * (target.dim() - 1) + (-1,))) \
                .sum(axis)
        else:
            cw = take_weight(w, li)
        loss = loss * cw
    if not soft_label and ignore_index >= 0:
        valid = li != ignore_index
        loss = torch.where(valid, loss, 0.0)
        if reduction == "mean":
            return loss.sum() / valid.sum().float().clamp(min=1.0)
    return reduce_loss(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    """Per-row losses with the class axis kept as a 1 (paddle's shape), and
    with ``return_softmax`` the softmax over ``axis``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = loss.unsqueeze(axis)
    if return_softmax:
        (x,) = cast_inputs("softmax", logits)
        return loss, torch.softmax(x, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean", name=None):
    """The negated log-probability at each label; class weights read as
    ``jnp.take`` reads them; the mean over the rows that count when
    ``ignore_index >= 0``."""
    input, label, weight = cast_inputs("nll_loss", input, label, weight)
    li = label.long()
    idx = li[..., None] if input.dim() == li.dim() + 1 else li[:, None]
    picked = -_take_along_last(input, idx)[..., 0]
    if weight is not None:
        picked = picked * take_weight(weight, li)
    if ignore_index >= 0:
        valid = li != ignore_index
        picked = torch.where(valid, picked, 0.0)
        if reduction == "mean":
            return picked.sum() / valid.sum().float().clamp(min=1.0)
    return reduce_loss(picked, reduction)


def mse_loss(input, label, reduction: str = "mean", name=None):
    a, b = cast_inputs("mse_loss", input, label)
    return reduce_loss(torch.square(a - b), reduction)


def l1_loss(input, label, reduction: str = "mean", name=None):
    a, b = cast_inputs("l1_loss", input, label)
    return reduce_loss(torch.abs(a - b), reduction)


def smooth_l1_loss(input, label, reduction: str = "mean", delta: float = 1.0,
                   name=None):
    a, b = cast_inputs("smooth_l1_loss", input, label)
    d = a - b
    ad = torch.abs(d)
    loss = torch.where(ad < delta, 0.5 * d * d / delta, ad - 0.5 * delta)
    return reduce_loss(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction: str = "mean",
                         name=None):
    p, y, w = cast_inputs("binary_cross_entropy", input, label, weight)
    p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
    loss = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
    if w is not None:
        loss = loss * w
    return reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None, name=None):
    """The stable form: ``max(z, 0) - z y + log1p(exp(-|z|))``, or with
    ``pos_weight`` ``(1 - y) z + (1 + (pw - 1) y)(log1p(exp(-|z|)) +
    max(-z, 0))``."""
    z, y, w, pw = cast_inputs("binary_cross_entropy_with_logits", logit,
                              label, weight, pos_weight)
    neg_abs = -torch.abs(z)
    if pw is not None:
        log_w = (pw - 1.0) * y + 1.0
        loss = (1.0 - y) * z + log_w * (torch.log1p(torch.exp(neg_abs))
                                        + torch.clamp(-z, min=0.0))
    else:
        loss = torch.clamp(z, min=0.0) - z * y \
            + torch.log1p(torch.exp(neg_abs))
    if w is not None:
        loss = loss * w
    return reduce_loss(loss, reduction)


def kl_div(input, label, reduction: str = "mean", log_target: bool = False,
           name=None):
    """``y (log y - logp)`` (``exp(y) (y - logp)`` with ``log_target``);
    ``"batchmean"`` divides the sum by the leading dimension."""
    logp, y = cast_inputs("kl_div", input, label)
    if log_target:
        loss = torch.exp(y) * (y - logp)
    else:
        loss = y * (torch.log(torch.clamp(y, min=1e-12)) - logp)
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return reduce_loss(loss, reduction)


def hinge_embedding_loss(input, label, margin: float = 1.0,
                         reduction: str = "mean", name=None):
    a, y = cast_inputs("hinge_embedding_loss", input, label)
    loss = torch.where(y == 1.0, a, torch.clamp(margin - a, min=0.0))
    return reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin: float = 0.0,
                        reduction: str = "mean", name=None):
    a, b, y = cast_inputs("margin_ranking_loss", input, other, label)
    return reduce_loss(torch.clamp(-y * (a - b) + margin, min=0.0), reduction)


def cosine_embedding_loss(input1, input2, label, margin: float = 0.0,
                          reduction: str = "mean", name=None):
    a, b, y = cast_inputs("cosine_embedding_loss", input1, input2, label)
    cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                             * torch.linalg.vector_norm(b, dim=-1) + 1e-12)
    loss = torch.where(y == 1, 1.0 - cos, torch.clamp(cos - margin, min=0.0))
    return reduce_loss(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin: float = 1.0,
                        p: float = 2.0, epsilon: float = 1e-6,
                        swap: bool = False, reduction: str = "mean",
                        name=None):
    a, pos, neg = cast_inputs("triplet_margin_loss", input, positive,
                              negative)
    dist = lambda u, v: torch.linalg.vector_norm(  # noqa: E731
        u - v + epsilon, ord=p, dim=-1)
    dp, dn = dist(a, pos), dist(a, neg)
    if swap:
        dn = torch.minimum(dn, dist(pos, neg))
    return reduce_loss(torch.clamp(dp - dn + margin, min=0.0), reduction)


def square_error_cost(input, label):
    a, b = cast_inputs("square_error_cost", input, label)
    return torch.square(a - b)


def log_loss(input, label, epsilon: float = 1e-4, name=None):
    p, y = cast_inputs("log_loss", input, label)
    return -y * torch.log(p + epsilon) \
        - (1.0 - y) * torch.log(1.0 - p + epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha: float = 0.25,
                       gamma: float = 2.0, reduction: str = "sum",
                       name=None):
    """``a_t (1 - p_t)^gamma ce`` over the stable logits form of ``ce``,
    divided by ``normalizer`` when given."""
    z, y, nrm = cast_inputs("sigmoid_focal_loss", logit, label, normalizer)
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    p_t = p * y + (1.0 - p) * (1.0 - y)
    a_t = alpha * y + (1.0 - alpha) * (1.0 - y)
    loss = a_t * torch.pow(1.0 - p_t, gamma) * ce
    if nrm is not None:
        loss = loss / nrm
    return reduce_loss(loss, reduction)
