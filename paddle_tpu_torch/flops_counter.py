"""``flops``: per-layer FLOPs profiler, the port of
``paddle_tpu/flops_counter.py`` (``paddle.flops``; reference:
python/paddle/hapi/dynamic_flops.py): forward hooks count multiply-adds
per registered layer type, summed over one forward of zeros.

Counted, with the JAX package's rules: the port's ``Linear`` (output
elements x (in features + 1 with a bias)), ``Conv1D/2D/3D`` (output
elements x (kernel size x in channels a group + 1 with a bias)),
``LayerNorm`` and ``BatchNorm1D/2D/3D`` (2 per input element), the pools
``AvgPool2D``, ``MaxPool2D``, ``AdaptiveAvgPool2D`` and
``AdaptiveMaxPool2D`` (1 per output element), and the activations
``ReLU``, ``ReLU6``, ``Sigmoid``, ``Hardswish``, ``Hardsigmoid`` (1 per
output element; the port's layers and ``torch.nn``'s). A batch norm called
with the port's fused ReLU tail (``act="relu"``) also counts that ReLU, 1
per output element, as the JAX package's hook on the ``ReLU`` it calls
there does (its residual add, like the JAX package's, is not counted).
The port's own additions: a batch norm called with the fused swish tail
(``act="swish"``, PP-YOLOE's blocks) counts the swish, 1 per output
element, which the JAX package's hooks do not see (its ``F.swish`` is a
function, not a layer; its nearest upsample, a copy, counts 0 in both);
``RMSNorm`` counts as a norm (2 per input element; the JAX package counts
none) and ``GELU``, ``SiLU`` and ``Tanh`` as activations; ``Embedding`` is listed with 0 (a lookup). Each
call files its total with the program cost registry as an ``analytic``
record (:func:`observability.cost.record_analytic`) when it is installed.
"""

from __future__ import annotations

import inspect
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


def _count_conv(layer, x, y) -> int:
    kernel_ops = _prod(layer.weight.shape[2:]) * int(layer.weight.shape[1])
    bias_ops = 1 if getattr(layer, "bias", None) is not None else 0
    return _prod(y.shape) * (kernel_ops + bias_ops)


def _count_batch_norm(layer, args, kwargs, output) -> int:
    fused_act = _prod(output.shape) if kwargs.get("act") in ("relu", "swish") \
        else 0
    return 2 * _prod(args[0].shape) + fused_act


def _count_act(layer, x, y) -> int:
    return _prod(y.shape)


def _count_none(*call) -> int:
    return 0


def _count_attention(layer, args, kwargs, output) -> int:
    query = args[0]
    if isinstance(output, tuple):       # with a cache: (out, (k, v))
        lk = output[1][0].shape[1]
    else:
        key = args[1] if len(args) > 1 and args[1] is not None \
            else kwargs.get("key")
        lk = (query if key is None else key).shape[1]
    b, lq = query.shape[0], query.shape[1]
    return 2 * b * lq * int(lk) * layer.num_heads * layer.head_dim


def _count_feed_forward_in(layer, args, kwargs, output) -> int:
    w = layer.linear1.weight            # (in, out)
    rows = _prod(args[0].shape[:-1])
    bias_ops = 1 if layer.linear1.bias is not None else 0
    return rows * int(w.shape[1]) * (int(w.shape[0]) + bias_ops)


def _on_first(fn):
    """A counter of ``(layer, x, y)``, the form ``custom_ops`` takes as in
    paddle, as one of the whole call: ``x`` its first input, ``y`` its
    first output."""
    def count(layer, args, kwargs, output):
        y = output[0] if isinstance(output, (tuple, list)) else output
        return fn(layer, args[0], y)
    return count


# each counter takes the call: (layer, args, kwargs, output)
_COUNTERS = {
    nn.Linear: _on_first(_count_linear), nn.Embedding: _count_none,
    nn.LayerNorm: _on_first(_count_norm), nn.RMSNorm: _on_first(_count_norm),
    **{t: _on_first(_count_act) for t in (
        tnn.ReLU, tnn.ReLU6, tnn.Sigmoid, tnn.Hardswish, tnn.Hardsigmoid,
        tnn.GELU, tnn.SiLU, tnn.Tanh, nn.ReLU, nn.ReLU6, nn.Sigmoid,
        nn.Hardswish, nn.Hardsigmoid)},
    **{t: _on_first(_count_conv) for t in (nn.Conv1D, nn.Conv2D,
                                           nn.Conv3D)},
    **{t: _count_batch_norm for t in (nn.BatchNorm1D, nn.BatchNorm2D,
                                      nn.BatchNorm3D)},
    **{t: _on_first(_count_act) for t in (nn.AvgPool2D, nn.MaxPool2D,
                                          nn.AdaptiveAvgPool2D,
                                          nn.AdaptiveMaxPool2D)},
    nn.MultiHeadAttention: _count_attention,
    nn.TransformerEncoderLayer: _count_feed_forward_in,
    nn.TransformerDecoderLayer: _count_feed_forward_in,
}


def flops(net: tnn.Module, input_size: List[int],
          custom_ops: Optional[Dict] = None,
          print_detail: bool = False) -> int:
    """Total FLOPs of one forward at ``input_size`` (an fp32 tensor of
    zeros on the net's device): ``paddle.flops`` parity, multiply-adds for
    the linears, elementwise counts for the norms and activations."""
    counters = dict(_COUNTERS)
    if custom_ops:
        counters.update((t, _on_first(fn)) for t, fn in custom_ops.items())

    totals: Dict[int, int] = {}
    names: Dict[int, str] = {}
    handles = []

    def make_hook(fn, name):
        def hook(lyr, args, kwargs, output):
            totals[id(lyr)] = totals.get(id(lyr), 0) + int(
                fn(lyr, args, kwargs, output))
            names[id(lyr)] = name
        return hook

    for name, sub in net.named_modules():
        fn = counters.get(type(sub))
        if fn is not None:
            handles.append(sub.register_forward_hook(make_hook(fn, name),
                                                     with_kwargs=True))

    param = next(iter(net.parameters()), None)
    device = param.device if param is not None else torch.device("cpu")
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            x = torch.zeros(input_size, dtype=torch.float32, device=device)
            net(*[x] * _required_inputs(net))
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


def _required_inputs(net: tnn.Module) -> int:
    """How many positional inputs without a default ``net``'s forward
    takes (at least 1)."""
    params = inspect.signature(net.forward).parameters.values()
    return max(1, sum(1 for p in params
                      if p.kind in (p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD)
                      and p.default is p.empty))


def _num_params(net: tnn.Module) -> int:
    return sum(_prod(p.shape) for p in net.parameters())
