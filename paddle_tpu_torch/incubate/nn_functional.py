"""``paddle.incubate.nn.functional``, the port of the fused-op surface of
``paddle_tpu/incubate/nn_functional.py:23-197``: the same signatures,
casts by the same op names under ``amp.auto_cast``, on the port's kernels
where the JAX package leaves the fusion to XLA (upstream Paddle backs
these with CUDA kernels of its own, ``paddle/phi/kernels/fusion/``):

* ``fused_rms_norm`` / ``fused_layer_norm``: the fused norm kernel
  (``ops/fused_norm.py``) in its fused order: the pre-norm bias and
  residual add, then the statistics in fp32, the weight and bias applied
  in fp32 and one rounding to x's dtype; ``(out, residual_out)`` when a
  residual is given;
* ``fused_rotary_position_embedding``: the RoPE kernel
  (``ops/rope.py``), q, k and v in one launch, each pair turned in fp32
  and rounded once (the JAX package rounds each product in the tensors'
  dtype);
* ``swiglu``: the SwiGLU kernel (``ops/swiglu.py``), silu rounded once and
  the product once;
* ``fused_dropout_add`` and ``fused_bias_dropout_residual_layer_norm``:
  dropout drawn from the caller's ``torch.Generator`` (``generator=``, as
  the port's ``dropout``; the JAX package draws from its global key, so
  the masks differ by design), then the add, or the add fused into the
  layer norm.

The CPU runs the kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..amp import cast_dtype, cast_inputs
from ..ops import nn_ops
from ..ops.fused_norm import NormSpec, fused_norm
from ..ops.rope import rope
from ..ops.swiglu import swiglu as _swiglu

__all__ = ["fused_bias_dropout_residual_layer_norm", "fused_dropout_add",
           "fused_layer_norm", "fused_rms_norm",
           "fused_rotary_position_embedding", "swiglu"]


def _fused_norm(op: str, kind: str, x, norm_weight, norm_bias, epsilon,
                begin_norm_axis, bias, residual):
    naxes = x.dim() - begin_norm_axis % x.dim()
    xd = cast_dtype(op, x.dtype)
    add = None
    if bias is not None or residual is not None:
        add = xd
        for t in (bias, residual):
            if t is not None:
                add = torch.promote_types(add, cast_dtype(op, t.dtype))
    spec = NormSpec(
        kind, float(epsilon), norm=add or xd, out=xd, add=add,
        weight=None if norm_weight is None else cast_dtype(op,
                                                           norm_weight.dtype),
        bias=None if norm_bias is None else cast_dtype(op, norm_bias.dtype),
        fused=True, naxes=naxes)
    out, h = fused_norm(x, norm_weight, norm_bias, residual, bias, spec=spec)
    return (out, h) if residual is not None else out


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0, name=None):
    """RMSNorm with optional pre-norm bias/residual add. Returns
    (out, residual_out) when ``residual`` is given, else out. The quant
    arguments are accepted and ignored, as in the JAX package."""
    return _fused_norm("fused_rms_norm", "rms", x, norm_weight, norm_bias,
                       epsilon, begin_norm_axis, bias, residual)


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None,
                     quant_scale=-1, name=None):
    """LayerNorm with optional pre-norm bias/residual add, as
    :func:`fused_rms_norm`."""
    return _fused_norm("fused_layer_norm", "ln", x, norm_weight, norm_bias,
                       epsilon, begin_norm_axis, bias, residual)


def _rope_tables(s: int, d: int, base: float, neox: bool, device):
    inv = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float32) / d))
    freqs = np.outer(np.arange(s, dtype=np.float32), inv)
    emb = np.concatenate([freqs, freqs], axis=-1) if neox \
        else np.repeat(freqs, 2, axis=-1)
    return (torch.from_numpy(np.cos(emb)).to(device),
            torch.from_numpy(np.sin(emb)).to(device))


def _table(t: torch.Tensor) -> torch.Tensor:
    """(S, D) of a (S, D) or (1, S, 1, D) table."""
    return t if t.dim() == 2 else t.reshape(t.shape[1], t.shape[3])


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False, rotary_emb_base=10000.0,
                                    name=None):
    """Apply RoPE to q (and k, v when given), (B, S, H, D) (``time_major``:
    (S, B, H, D)). ``sin``/``cos``: (1, S, 1, D) or (S, D); generated from
    ``rotary_emb_base`` when omitted. Returns ``(q, k, v)``, None where a
    tensor was not given."""
    given = [t for t in (q, k, v) if t is not None]
    if time_major:
        given = [t.transpose(0, 1) for t in given]
    s, d = given[0].shape[1], given[0].shape[3]
    if cos is None or sin is None:
        cos, sin = _rope_tables(s, d, rotary_emb_base,
                                use_neox_rotary_style, given[0].device)
    cos, sin = _table(cos), _table(sin)
    dt = cast_dtype("fused_rope", given[0].dtype)
    outs = list(rope(given, cos, sin, positions=position_ids,
                     neox=use_neox_rotary_style, dtype=dt, table_dtype=dt))
    if time_major:
        outs = [t.transpose(0, 1) for t in outs]
    return tuple(outs.pop(0) if t is not None else None for t in (q, k, v))


def swiglu(x, y=None, name=None):
    """silu(x) * y; when y is None, x is split in half on the last axis."""
    x, y = cast_inputs("swiglu", x, y)
    return _swiglu(x, y)


def _dropout(x, p: float, training: bool, mode: str,
             generator: Optional[torch.Generator]):
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if mode == "upscale_in_train" or not training or p == 0.0:
        return nn_ops.dropout(x, p, training, generator=generator)
    (x,) = cast_inputs("dropout", x)
    if generator is None:
        raise ValueError("dropout draws from the caller's torch.Generator: "
                         "pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x, 0.0).to(x.dtype)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None, *, generator=None):
    """dropout(x) + y, the mask drawn from ``generator`` (a
    ``torch.Generator`` on x's device)."""
    return nn_ops.add(_dropout(x, p, training, mode, generator), y)


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True, name=None, *,
                                           generator=None):
    """layer_norm(residual + dropout(x + bias)): the residual add runs in
    the layer norm's kernel."""
    h = x if bias is None else nn_ops.add(x, bias)
    h = nn_ops.dropout(h, dropout_rate, training, generator=generator)
    out, _ = nn_ops.layer_norm(h, h.shape[-1:], ln_scale, ln_bias,
                               ln_epsilon, residual)
    return out
