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

:class:`GradScaler` is dynamic loss scaling (``paddle_tpu/amp/__init__.py:
106-201``) with its state on the device: the scale, the good and bad step
counts and the found-inf flag are 0-d tensors, ``unscale_`` decides
found-inf on the device, ``step`` runs the optimizer under a device-side
gate (``core.step_capture.gated``: a step with a non-finite gradient
writes nothing and leaves the step count where it was) and ``update``
moves the scale with ``torch.where``. No call reads the device, so a
scaled step can be captured as one graph (``jit.capture_step``).
``get_loss_scaling`` and ``state_dict`` read the state to the host.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import FrozenSet, Optional

import torch

__all__ = ["GradScaler", "auto_cast", "cast_dtype", "cast_inputs",
           "decorate", "recompute_context"]

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


def _target(op_name: str) -> Optional[torch.dtype]:
    st = _current()
    if st is None:
        return None
    if st.level == "O2":
        return torch.float32 if op_name in st.black else st.dtype
    if op_name in st.white:
        return st.dtype
    if op_name in st.black:
        return torch.float32
    return None


def cast_inputs(op_name: str, *xs):
    """``xs`` cast as op ``op_name`` takes them under the active
    ``auto_cast`` (unchanged outside one; ``None`` and non-float tensors
    pass through)."""
    target = _target(op_name)
    if target is None:
        return xs
    return tuple(x.to(target) if x is not None and x.is_floating_point()
                 else x for x in xs)


def cast_dtype(op_name: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype :func:`cast_inputs` gives a float tensor of ``dtype`` for
    op ``op_name``: the fused kernels take their inputs as they lie and do
    the cast as they load them."""
    target = _target(op_name)
    return dtype if target is None or not dtype.is_floating_point \
        else target


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
    the new dtypes. A multi-tensor optimizer keeps its flat fp32 master
    (built from the values before the cast) and makes the cast parameters
    views of one flat buffer rounded from it."""
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


class GradScaler:
    """Dynamic loss scaling (parity: ``paddle.amp.GradScaler``), its state
    on the device (see the module docstring). The state tensors are made on
    the device of the first loss :meth:`scale` sees."""

    def __init__(self, enable: bool = True, init_loss_scaling: float = 65536.0,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._init = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._scale: Optional[torch.Tensor] = None    # fp32
        self._good: Optional[torch.Tensor] = None     # int32
        self._bad: Optional[torch.Tensor] = None      # int32
        self._found_inf: Optional[torch.Tensor] = None  # bool
        self._counts = (0, 0)   # good, bad steps before the state exists
        self._unscaled = False

    def _state(self, device) -> None:
        if self._scale is None:
            self._scale = torch.tensor(self._init, dtype=torch.float32,
                                       device=device)
            self._good, self._bad = (
                torch.tensor(n, dtype=torch.int32, device=device)
                for n in self._counts)
            self._found_inf = torch.zeros((), dtype=torch.bool,
                                          device=device)

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        """The current scale (a host read)."""
        return self._init if self._scale is None else float(self._scale)

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return loss
        self._state(loss.device)
        return loss * self._scale

    @torch.no_grad()
    def _unscale_grads(self, optimizer) -> None:
        grads = [p.grad for p in optimizer._params if p.grad is not None]
        if grads:
            self._state(grads[0].device)
            torch._foreach_mul_(grads, 1.0 / self._scale)
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
            self._found_inf.copy_(~finite.all())
        elif self._found_inf is not None:
            self._found_inf.fill_(False)
        self._unscaled = True

    def unscale_(self, optimizer) -> None:
        if self._enable and not self._unscaled:
            self._unscale_grads(optimizer)

    def step(self, optimizer) -> None:
        """Unscale (once a step) and run ``optimizer.step()`` gated on a
        finite gradient, decided on the device."""
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self._unscale_grads(optimizer)
        if self._found_inf is None:      # no gradient at all
            optimizer.step()
        else:
            from ..core import step_capture
            outer = step_capture.current_gate()
            ok = ~self._found_inf
            with step_capture.gated(ok if outer is None else outer & ok):
                optimizer.step()
        self._unscaled = False

    @torch.no_grad()
    def update(self) -> None:
        if not (self._enable and self._dynamic) or self._scale is None:
            return
        found = self._found_inf
        bad = torch.where(found, self._bad + 1, 0)
        good = torch.where(found, 0, self._good + 1)
        dec = found & (bad >= self._decr_every)
        inc = ~found & (good >= self._incr_every)
        self._scale.copy_(torch.where(
            dec, torch.clamp(self._scale * self._decr_ratio, min=1.0),
            torch.where(inc, self._scale * self._incr_ratio, self._scale)))
        self._bad.copy_(torch.where(dec, 0, bad))
        self._good.copy_(torch.where(inc, 0, good))

    def minimize(self, optimizer, scaled_loss) -> None:
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def state_dict(self) -> dict:
        """The JAX package's keys, read to the host."""
        good, bad = self._counts if self._scale is None else (
            int(self._good), int(self._bad))
        return {"scale": self.get_loss_scaling(),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": good, "bad_steps": bad}

    def load_state_dict(self, state: dict) -> None:
        scale = float(state.get("scale", self.get_loss_scaling()))
        counts = (int(state.get("good_steps", 0)),
                  int(state.get("bad_steps", 0)))
        if self._scale is None:
            self._init, self._counts = scale, counts
            return
        self._scale.fill_(scale)
        self._good.fill_(counts[0])
        self._bad.fill_(counts[1])
