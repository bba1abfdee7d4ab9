"""Automatic mixed precision, the port of ``paddle_tpu/amp/__init__.py``:
``decorate`` and the ``auto_cast`` context.

``auto_cast`` casts the float inputs of the port's ops as the JAX package
does (``core/tensor.py::_autocast_targets``): under ``O2`` every op takes
the low dtype except those on the black list, which take fp32; under
``O1`` only white-listed ops go low and black-listed ops go fp32. The ops
of the Llama and ERNIE paths ask :func:`cast_inputs` by their JAX op names
(``linear``, ``embedding``, ``rope``, ``silu``, ``gelu``, ``relu``,
``tanh``, ``add``, ``dropout``, ``scaled_dot_product_attention``,
``rms_norm``, ``layer_norm``, ``cross_entropy``), so under O2 ``rms_norm``,
``layer_norm`` and ``cross_entropy`` run and return fp32, every other op
(the residual adds and dropout included) runs bf16, and RoPE rotates with
bf16 cos/sin, as in the JAX package. The state is per thread and is carried into
activation recomputation (:func:`recompute_context`).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import FrozenSet, Optional

import torch

__all__ = ["auto_cast", "cast_inputs", "decorate", "recompute_context"]

# the JAX package's lists (paddle_tpu/amp/__init__.py)
WHITE_LIST = frozenset({
    "matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "addmm", "mv",
    "scaled_dot_product_attention", "flash_attention",
})
BLACK_LIST = frozenset({
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "mean", "sum", "norm", "layer_norm", "batch_norm", "batch_norm_stats",
    "group_norm", "instance_norm", "rms_norm", "cumsum", "logsumexp",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "nll_loss",
    "kl_div", "mse_loss", "l1_loss", "smooth_l1_loss", "sigmoid_focal_loss",
})

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class AmpState:
    dtype: torch.dtype
    level: str
    white: FrozenSet[str]
    black: FrozenSet[str]


_local = threading.local()


def _current() -> Optional[AmpState]:
    return getattr(_local, "state", None)


@contextlib.contextmanager
def _using(state: Optional[AmpState]):
    prev = _current()
    _local.state = state
    try:
        yield
    finally:
        _local.state = prev


def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16", use_promote: bool = True):
    """``paddle.amp.auto_cast``: a context in which the port's ops cast
    their float inputs (see the module docstring)."""
    if level not in ("O1", "O2"):
        raise ValueError(f"level must be 'O1' or 'O2', got {level!r}")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                         f"{dtype!r}")
    if not enable:
        return _using(None)
    wl, bl = set(WHITE_LIST), set(BLACK_LIST)
    if custom_white_list:
        wl |= set(custom_white_list)
        bl -= set(custom_white_list)
    if custom_black_list:
        bl |= set(custom_black_list)
        wl -= set(custom_black_list)
    return _using(AmpState(_DTYPES[dtype], level, frozenset(wl),
                           frozenset(bl)))


def cast_inputs(op_name: str, *xs):
    """``xs`` cast as op ``op_name`` takes them under the active
    ``auto_cast`` (unchanged outside one; ``None`` and non-float tensors
    pass through)."""
    st = _current()
    if st is None:
        return xs
    if st.level == "O2":
        target = torch.float32 if op_name in st.black else st.dtype
    elif op_name in st.white:
        target = st.dtype
    elif op_name in st.black:
        target = torch.float32
    else:
        return xs
    return tuple(x.to(target) if x is not None and x.is_floating_point()
                 else x for x in xs)


def recompute_context():
    """``context_fn`` for ``torch.utils.checkpoint``: the recomputation in
    the backward runs under the ``auto_cast`` state of the forward."""
    return contextlib.nullcontext(), _using(_current())


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight: Optional[bool] = None,
             save_dtype: Optional[str] = None):
    """``paddle.amp.decorate``: under O2 cast every float parameter to
    ``dtype`` in place (the parameter objects stay, so an optimizer built
    over them keeps them); set each optimizer's master-weight mode
    (``None``: fp32 masters for low-precision parameters; ``False``: none,
    bf16 written back with stochastic rounding) and rebuild its state for
    the new dtypes."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                         f"{dtype!r}")
    is_list = isinstance(models, (list, tuple))
    model_list = list(models) if is_list else [models]
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(_DTYPES[dtype])
    if optimizers is None:
        return models if is_list else model_list[0]
    opt_list = optimizers if isinstance(optimizers, (list, tuple)) \
        else [optimizers]
    for o in opt_list:
        if master_weight is not None:
            o._use_master_weights = bool(master_weight)
        o._on_params_cast()
    return (models if is_list else model_list[0]), optimizers
