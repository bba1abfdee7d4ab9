"""``Layer``, paddle's module surface on ``torch.nn.Module``: the port of
``paddle_tpu/nn/layer.py``.

A ``Layer`` is an ``nn.Module`` (its parameters are ``nn.Parameter`` s,
its hooks, ``train()`` / ``eval()`` and ``state_dict()`` torch's) with
paddle's names beside torch's: ``create_parameter`` with a
:class:`ParamAttr` (``bias_attr=False``: no parameter, None returned;
``trainable=False``: no gradient; its ``learning_rate``, ``regularizer``
and ``need_clip`` set on the parameter, where the port's optimizers read
them), ``register_buffer(name, tensor, persistable=)`` (a persistable
buffer is in the state dict under its structured name, as in the JAX
package: ``bn1._mean``), ``set_state_dict`` (numpy arrays or tensors; a
shape mismatch raises; returns the missing and unexpected keys),
``parameters()`` as a list, ``sublayers()``, ``add_sublayer``,
``add_parameter``, ``register_forward_post_hook`` and ``full_name()``.

Where parameters and buffers are made: a layer built inside
:func:`build_scope` makes them on the scope's device, drawing initial
values from its generator; outside one, on ``cuda`` (raising without a
card) from the device's default generator. A model's entry point (for
example ``vision.models.resnet50(device=, seed=)``) opens the scope.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.manipulation import _DTYPES
from .initializer import (Constant, Initializer, XavierUniform,
                          _global_default, _to_initializer)

__all__ = ["Layer", "ParamAttr", "build_scope"]

_scope = threading.local()


@contextlib.contextmanager
def build_scope(device=None, seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
    """Layers built in this region (on this thread) make their parameters
    and buffers on ``device`` (``cuda`` unless ``"cpu"``), with initial
    values drawn from ``generator``, or from a new ``torch.Generator`` on
    the device seeded with ``seed`` (the device's default generator when
    neither is given)."""
    dev = resolve_device(device)
    if generator is None and seed is not None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    prev = getattr(_scope, "state", None)
    _scope.state = (dev, generator)
    try:
        yield dev
    finally:
        _scope.state = prev


def scope_state() -> Tuple[torch.device, Optional[torch.Generator]]:
    """The device and generator layers built now use."""
    state = getattr(_scope, "state", None)
    return state if state is not None else (resolve_device(None), None)


def _dtype_of(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


class ParamAttr:
    """``paddle.ParamAttr``: a parameter's name, initializer, learning-rate
    scale, regularizer, whether it trains and whether a gradient clip
    sees it."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None or True: the default attribute; False: no parameter; a
        string: its name; an initializer: its initializer."""
        if attr is None or attr is True:
            return ParamAttr()
        if isinstance(attr, ParamAttr) or attr is False:
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


class Layer(nn.Module):
    """paddle's ``nn.Layer`` on ``torch.nn.Module`` (module docstring)."""

    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        super().__init__()
        self._dtype = _dtype_of(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False, default_initializer=None
                         ) -> Optional[nn.Parameter]:
        """A new parameter of ``shape`` on the build scope's device. Its
        initializer, first found: the attribute's, the global one
        (``set_global_initializer``), ``default_initializer``, else zeros
        for a bias and Xavier-uniform for a weight."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = _dtype_of(dtype) or self._dtype
        init = attr.initializer or _global_default(is_bias) \
            or default_initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        init = _to_initializer(init)
        dev, gen = scope_state()
        shape = tuple(int(s) for s in shape)
        if isinstance(init, Initializer):
            data = init(shape, dtype, dev, gen)
        else:
            data = torch.as_tensor(np.asarray(init(shape, dtype))).to(
                device=dev, dtype=dtype)
        p = nn.Parameter(data, requires_grad=bool(attr.trainable))
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        if attr.name is not None:
            p.param_name = attr.name
        return p

    def create_buffer(self, data) -> torch.Tensor:
        """A tensor of ``data`` on the build scope's device."""
        return torch.as_tensor(data).to(scope_state()[0])

    def register_buffer(self, name: str, tensor,
                        persistable: bool = True) -> None:
        """A buffer; a persistable one is in the state dict."""
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(name, tensor, persistent=persistable)

    def add_parameter(self, name: str, parameter) -> Optional[nn.Parameter]:
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer: nn.Module) -> nn.Module:
        self.add_module(name, sublayer)
        return sublayer

    def parameters(self, include_sublayers: bool = True
                   ) -> List[nn.Parameter]:
        return list(super().parameters(recurse=include_sublayers))

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for m in self.modules() if include_self or m is not self]

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after each forward; returns a
        handle whose ``remove()`` takes it off."""
        return self.register_forward_hook(hook)

    def full_name(self) -> str:
        return self._name_scope

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy each entry (a tensor or a numpy array, bf16 included) into
        the parameter or buffer of its key, cast to its dtype and device;
        raises ``ValueError`` on a shape mismatch. Returns ``(missing,
        unexpected)`` keys."""
        from ..convert import _to_tensor
        own = self.state_dict(keep_vars=True)
        unexpected = []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            tgt = own[k]
            src = v if isinstance(v, torch.Tensor) else _to_tensor(v)
            if tuple(src.shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch for {k}: checkpoint "
                                 f"{tuple(src.shape)} vs model "
                                 f"{tuple(tgt.shape)}")
            tgt.copy_(src.to(device=tgt.device, dtype=tgt.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected
