"""``flops``: per-layer FLOPs profiler, the port of
``paddle_tpu/flops_counter.py`` (``paddle.flops``; reference:
python/paddle/hapi/dynamic_flops.py): forward hooks count multiply-adds
per registered layer type, summed over one forward of zeros.

Counted, with the JAX package's rules: the port's ``Linear`` (output
elements x (in features + 1 with a bias)), ``LayerNorm`` (2 per input
element), and the activations of ``torch.nn`` the port's models use
(``ReLU``, ``ReLU6``, ``Sigmoid``, ``Hardswish``, ``Hardsigmoid``: 1 per
output element). The port's own additions: ``RMSNorm`` counts as a norm (2
per input element; the JAX package counts none) and ``GELU``, ``SiLU`` and
``Tanh`` as activations; ``Embedding`` is listed with 0 (a lookup). Each
call files its total with the program cost registry as an ``analytic``
record (:func:`observability.cost.record_analytic`) when it is installed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn as tnn

from . import nn

__all__ = ["flops"]


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _count_linear(layer, x, y) -> int:
    in_f = int(layer.weight.shape[0])   # paddle's (in, out) layout
    bias_ops = 1 if getattr(layer, "bias", None) is not None else 0
    return _prod(y.shape) * (in_f + bias_ops)


def _count_norm(layer, x, y) -> int:
    return 2 * _prod(x.shape)


def _count_act(layer, x, y) -> int:
    return _prod(y.shape)


def _count_none(layer, x, y) -> int:
    return 0


_COUNTERS = {
    nn.Linear: _count_linear, nn.Embedding: _count_none,
    nn.LayerNorm: _count_norm, nn.RMSNorm: _count_norm,
    tnn.ReLU: _count_act, tnn.ReLU6: _count_act, tnn.Sigmoid: _count_act,
    tnn.Hardswish: _count_act, tnn.Hardsigmoid: _count_act,
    tnn.GELU: _count_act, tnn.SiLU: _count_act, tnn.Tanh: _count_act,
}


def flops(net: tnn.Module, input_size: List[int],
          custom_ops: Optional[Dict] = None,
          print_detail: bool = False) -> int:
    """Total FLOPs of one forward at ``input_size`` (an fp32 tensor of
    zeros on the net's device): ``paddle.flops`` parity, multiply-adds for
    the linears, elementwise counts for the norms and activations."""
    counters = dict(_COUNTERS)
    if custom_ops:
        counters.update(custom_ops)

    totals: Dict[int, int] = {}
    names: Dict[int, str] = {}
    handles = []

    def make_hook(fn, name):
        def hook(lyr, inputs, output):
            x = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
            y = output[0] if isinstance(output, (tuple, list)) else output
            totals[id(lyr)] = totals.get(id(lyr), 0) + int(fn(lyr, x, y))
            names[id(lyr)] = name
        return hook

    for name, sub in net.named_modules():
        fn = counters.get(type(sub))
        if fn is not None:
            handles.append(sub.register_forward_hook(make_hook(fn, name)))

    param = next(net.parameters(), None)
    device = param.device if param is not None else torch.device("cpu")
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(torch.zeros(input_size, dtype=torch.float32, device=device))
    finally:
        for h in handles:
            h.remove()
        if was_training:
            net.train()

    total = sum(totals.values())
    from .observability import cost as _cost
    if _cost.installed():
        _cost.record_analytic(type(net).__name__, total)
    if print_detail:
        print(f"{'Layer':<40}{'FLOPs':>16}")
        for lid, v in totals.items():
            print(f"{names[lid]:<40}{v:>16,}")
        print(f"{'Total':<40}{total:>16,}")
    else:
        print(f"Total Flops: {total}     Total Params: {_num_params(net)}")
    return total


def _num_params(net: tnn.Module) -> int:
    return sum(_prod(p.shape) for p in net.parameters())
