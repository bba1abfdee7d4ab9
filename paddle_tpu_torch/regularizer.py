"""``paddle.regularizer``, the port of ``paddle_tpu/regularizer.py``: the
weight-decay coefficients ``L1Decay`` and ``L2Decay``, attached to a
parameter (its ``regularizer`` attribute) or given to an optimizer as its
``weight_decay``. The decay itself is applied by ``optimizer``, as the
JAX package applies it: a parameter's ``L1Decay(c)`` adds ``c * sign(p)``
to its gradient and ``L2Decay(c)`` adds ``c * p``; an optimizer-level
``weight_decay`` of either adds ``c * p``."""

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    """``coeff * sign(p)`` added to a parameter's gradient."""

    _l2 = False

    def __init__(self, coeff=0.0):
        self.coeff = coeff


class L2Decay:
    """``coeff * p`` added to a parameter's gradient."""

    _l2 = True

    def __init__(self, coeff=0.0):
        self.coeff = coeff
