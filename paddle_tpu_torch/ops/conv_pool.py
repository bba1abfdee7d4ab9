"""Convolution, pooling and resizing, the port of
``paddle_tpu/ops/conv_pool.py`` (``paddle.nn.functional``'s conv and pool
functions).

Convolutions are ``torch.nn.functional.conv{1,2,3}d`` (cuDNN on a card),
the plain products that the JAX package leaves to
``lax.conv_general_dilated`` outside any Pallas kernel; the weight layout
is paddle's ``(out, in / groups, *k)``, transposed convolutions take
``(in, out / groups, *k)`` and are computed as the JAX package computes
them, a convolution of the stride-dilated input with the flipped kernel.
Padding keeps the JAX package's forms: an int, one per spatial axis, a
``(before, after)`` pair per axis flattened, or ``"SAME"`` / ``"VALID"``
with ``lax``'s rule (``SAME``: the output is ``ceil(in / stride)`` and the
padding's odd element goes after). A bias is added after the product, as
there. Channels-last formats (``NLC``, ``NHWC``, ``NDHWC``) are moved to
channels-first around the call.

Pools keep ``lax.reduce_window``'s semantics: max pools pad with -inf
(the first maximum of a window takes the gradient), average pools sum and
divide by the kernel's size or, with ``exclusive`` (paddle's default) and
any padding, by the window's count of input elements; ``ceil_mode`` adds
the last partial window where it starts inside the input and its left
padding. Adaptive pools take bins ``[floor(i L / out), ceil((i + 1) L /
out))`` (``torch.nn.functional.adaptive_*_pool*d``, the same bins).
``interpolate`` is ``jax.image.resize``'s: half-pixel centres, linear
and Keys-cubic kernels normalised over the samples inside the input,
antialiased when downsampling, ``nearest`` at ``floor((i + 0.5) in /
out)``; ``align_corners`` and ``align_mode`` are taken and not read, as
there. Each function casts as the active ``amp.auto_cast`` says for the
JAX op of its name (``conv2d`` white, so bf16 under O1 and O2).
"""

from __future__ import annotations

import math
from typing import List, Tuple, Union

import torch
import torch.nn.functional as TF

from ..amp import cast_inputs

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool1d",
           "adaptive_max_pool2d", "adaptive_max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "channel_shuffle", "conv1d", "conv2d",
           "conv2d_transpose", "conv3d", "conv3d_transpose", "fold",
           "interpolate", "max_pool1d", "max_pool2d", "max_pool3d",
           "pixel_shuffle", "pixel_unshuffle", "unfold", "upsample"]

Pads = Union[str, List[Tuple[int, int]]]
_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_MAXPOOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}


def _pair(v, n: int) -> Tuple[int, ...]:
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _channels_first(data_format: str) -> bool:
    return data_format in ("NCHW", "NCL", "NCDHW")


def _to_cf(x, cf: bool):
    return x if cf else x.movedim(-1, 1)


def _from_cf(x, cf: bool):
    return x if cf else x.movedim(1, -1)


def _conv_padding(padding, spatial: int) -> Pads:
    """Paddle's padding spec as ``"SAME"`` / ``"VALID"`` or (before, after)
    pairs, one per spatial axis."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * spatial
    padding = [int(p) for p in padding]
    if len(padding) == spatial:
        return [(p, p) for p in padding]
    if len(padding) == 2 * spatial:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(spatial)]
    raise ValueError(f"bad padding {padding}")


def _same_pads(sizes, windows, strides) -> List[Tuple[int, int]]:
    """``lax.padtype_to_pads(..., "SAME")``: output ``ceil(in / stride)``,
    the padding's odd element after."""
    out = []
    for n, k, s in zip(sizes, windows, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _resolve(pads: Pads, sizes, windows, strides) -> List[Tuple[int, int]]:
    if pads == "SAME":
        return _same_pads(sizes, windows, strides)
    if pads == "VALID":
        return [(0, 0)] * len(sizes)
    if isinstance(pads, str):
        raise ValueError(f"padding {pads!r}: use SAME or VALID")
    return list(pads)


def _pad(x, pairs, value: float = 0.0):
    """Pad the trailing ``len(pairs)`` axes (negative pads crop)."""
    if all(p == (0, 0) for p in pairs):
        return x
    flat = [v for pr in reversed(pairs) for v in pr]
    return TF.pad(x, flat, value=value)


def _bias(out, bias):
    return out if bias is None else out + bias.view(
        [1, -1] + [1] * (out.dim() - 2))


def _conv(x, weight, bias, stride, padding, dilation, groups, spatial: int,
          data_format: str, op: str):
    x, weight, bias = cast_inputs(op, x, weight, bias)
    cf = _channels_first(data_format)
    x = _to_cf(x, cf)
    strides, dil = _pair(stride, spatial), _pair(dilation, spatial)
    k_eff = [d * (k - 1) + 1 for d, k in zip(dil, weight.shape[2:])]
    pairs = _resolve(_conv_padding(padding, spatial), x.shape[2:], k_eff,
                     strides)
    if all(lo == hi for lo, hi in pairs):
        out = _CONV[spatial](x, weight, None, strides,
                             tuple(lo for lo, _ in pairs), dil, groups)
    else:
        out = _CONV[spatial](_pad(x, pairs), weight, None, strides, 0, dil,
                             groups)
    return _from_cf(_bias(out, bias), cf)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format, "conv3d")


def _conv_transpose(x, weight, bias, strides, pads: Pads, opad, groups, dil,
                    spatial: int):
    """The JAX package's transposed convolution: the input dilated by the
    stride (zeros between), padded by ``dil (k - 1) - pad`` before and that
    plus ``output_padding`` after (string padding raises, as there),
    convolved with the kernel flipped and its in / out axes
    swapped within each group."""
    cin, cout_g, ks = weight.shape[0], weight.shape[1], weight.shape[2:]
    wt = weight.reshape(groups, cin // groups, cout_g, *ks).transpose(1, 2)
    wt = wt.reshape(groups * cout_g, cin // groups, *ks)
    wt = wt.flip(dims=tuple(range(2, 2 + spatial)))
    if any(s > 1 for s in strides):
        shape = [(n - 1) * s + 1 for n, s in zip(x.shape[2:], strides)]
        xd = x.new_zeros(*x.shape[:2], *shape)
        xd[(slice(None), slice(None))
           + tuple(slice(None, None, s) for s in strides)] = x
        x = xd
    if isinstance(pads, str):
        raise ValueError("string padding is not implemented for a "
                         "transposed convolution (as in the JAX package): "
                         "give the padding in numbers")
    pairs = [(d * (k - 1) - lo, d * (k - 1) - hi + o)
             for d, k, (lo, hi), o in zip(dil, ks, pads, opad)]
    out = _CONV[spatial](_pad(x, pairs), wt, None, 1, 0, dil, groups)
    return _bias(out, bias)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    """``output_size`` is taken and not read, as in the JAX package (its
    3-D form reads it)."""
    x, weight, bias = cast_inputs("conv2d_transpose", x, weight, bias)
    return _conv_transpose(x, weight, bias, _pair(stride, 2),
                           _conv_padding(padding, 2),
                           _pair(output_padding, 2), groups,
                           _pair(dilation, 2), 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    """As :func:`conv2d_transpose` in 3-D; ``output_size`` sets the
    output padding (raises where no output padding below the stride
    reaches it)."""
    if data_format != "NCDHW":
        raise NotImplementedError("conv3d_transpose supports NCDHW only")
    x, weight, bias = cast_inputs("conv3d_transpose", x, weight, bias)
    strides, dil = _pair(stride, 3), _pair(dilation, 3)
    pads = _conv_padding(padding, 3)
    opad = _pair(output_padding, 3)
    if output_size is not None and not isinstance(pads, str):
        outs = [int(v) for v in (output_size if isinstance(
            output_size, (list, tuple)) else [output_size] * 3)][-3:]
        opad = tuple(
            outs[i] - ((int(x.shape[2 + i]) - 1) * strides[i] - pads[i][0]
                       - pads[i][1] + dil[i] * (int(weight.shape[2 + i]) - 1)
                       + 1) for i in range(3))
        if any(o < 0 or o >= strides[i] for i, o in enumerate(opad)):
            raise ValueError(
                f"conv3d_transpose: output_size {outs} unreachable with "
                f"stride {strides} / padding {padding}")
    return _conv_transpose(x, weight, bias, strides, pads, opad, groups, dil,
                           3)


def _windows(x, k, s):
    """``(N, C, out..., k...)``: the windows of the trailing spatial axes."""
    sp = len(k)
    for i in range(sp):
        x = x.unfold(2 + i, k[i], s[i])
    return x


def _window_sum(x, k, s):
    w = _windows(x, k, s)
    return w.sum(dim=tuple(range(w.dim() - len(k), w.dim())))


def _pool(x, op: str, kernel_size, stride, padding, spatial: int,
          reducer: str, ceil_mode: bool = False, data_format: str = "NCHW",
          exclusive: bool = True, divisor_override=None):
    (x,) = cast_inputs(op, x)
    cf = _channels_first(data_format)
    x = _to_cf(x, cf)
    k = _pair(kernel_size, spatial)
    s = _pair(stride if stride is not None else kernel_size, spatial)
    sizes = [int(n) for n in x.shape[2:]]
    if isinstance(padding, str):
        pairs = _resolve(padding.upper(), sizes, k, s)
        user = None
    else:
        p = _pair(padding, spatial)
        pairs = [(pp, pp) for pp in p]
        user = list(pairs)
    ceil_extra = False
    if ceil_mode and user is not None:
        for j in range(spatial):
            eff = sizes[j] + 2 * p[j] - k[j]
            if eff % s[j] != 0:
                out_ceil = -(-eff // s[j]) + 1
                if (out_ceil - 1) * s[j] >= sizes[j] + p[j]:
                    continue   # would start entirely in padding: dropped
                hi_extra = (out_ceil - 1) * s[j] + k[j] - (sizes[j] + 2 * p[j])
                pairs[j] = (pairs[j][0], pairs[j][1] + hi_extra)
                ceil_extra = True
    if reducer == "max":
        if all(lo == hi <= kk // 2 for (lo, hi), kk in zip(pairs, k)):
            # torch's own padding is -inf too (ResNet's 3x3 / 2, pad 1)
            out = _MAXPOOL[spatial](x, k, s, tuple(lo for lo, _ in pairs))
        else:
            out = _MAXPOOL[spatial](_pad(x, pairs, -math.inf), k, s)
        return _from_cf(out, cf)
    summed = _window_sum(_pad(x, pairs), k, s)
    ones = torch.ones((1, 1, *sizes), dtype=x.dtype, device=x.device)
    if divisor_override is not None:
        out = summed / float(divisor_override)
    elif user is None:
        out = summed / _window_sum(_pad(ones, pairs), k, s)
    elif not exclusive:
        if not ceil_extra:
            out = summed / float(math.prod(k))
        else:
            ones_up = _pad(ones, user, 1.0)
            extras = [(f[0] - u[0], f[1] - u[1]) for f, u in zip(pairs, user)]
            out = summed / _window_sum(_pad(ones_up, extras), k, s)
    elif not ceil_extra and all(pp == (0, 0) for pp in pairs):
        out = summed / float(math.prod(k))
    else:
        out = summed / _window_sum(_pad(ones, pairs), k, s)
    return _from_cf(out, cf)


def _mask_supported(ok: bool, what: str, layout: str) -> None:
    if not ok:
        raise NotImplementedError(f"{what}(return_mask=True) supports "
                                  f"{layout}, ceil_mode=False, numeric "
                                  "padding")


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    """With ``return_mask``, also each maximum's index in its row (int32,
    the first maximum of a window; NCL, numeric padding, no ceil)."""
    if return_mask:
        _mask_supported(not ceil_mode and data_format == "NCL"
                        and not isinstance(padding, str), "max_pool1d",
                        "NCL")
        (x,) = cast_inputs("max_pool1d_with_index", x)
        k = _pair(kernel_size, 1)[0]
        s = k if stride is None else _pair(stride, 1)[0]
        out, idx = TF.max_pool1d(x, k, s, _pair(padding, 1)[0],
                                 return_indices=True)
        return out, idx.to(torch.int32)
    return _pool(x, "max_pool1d", kernel_size, stride, padding, 1, "max",
                 ceil_mode, data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """With ``return_mask``, also each maximum's flat index in its (H, W)
    plane (int32, the first maximum of a window; NCHW, numeric padding, no
    ceil)."""
    if return_mask:
        _mask_supported(not ceil_mode and data_format == "NCHW"
                        and not isinstance(padding, str), "max_pool2d",
                        "NCHW")
        (x,) = cast_inputs("max_pool2d_with_index", x)
        k = _pair(kernel_size, 2)
        s = k if stride is None else _pair(stride, 2)
        out, idx = TF.max_pool2d(x, k, s, _pair(padding, 2),
                                 return_indices=True)
        return out, idx.to(torch.int32)
    return _pool(x, "max_pool2d", kernel_size, stride, padding, 2, "max",
                 ceil_mode, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, "max_pool3d", kernel_size, stride, padding, 3, "max",
                 ceil_mode, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, "avg_pool1d", kernel_size, stride, padding, 1, "avg",
                 ceil_mode, data_format, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, "avg_pool2d", kernel_size, stride, padding, 2, "avg",
                 ceil_mode, data_format, exclusive, divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, "avg_pool3d", kernel_size, stride, padding, 3, "avg",
                 ceil_mode, data_format, exclusive, divisor_override)


_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _adaptive(x, op: str, output_size, spatial: int, mode: str):
    (x,) = cast_inputs(op, x)
    return _ADAPTIVE[mode, spatial](x, _pair(output_size, spatial))


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, "adaptive_avg_pool1d", output_size, 1, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    cf = data_format == "NCHW"
    out = _adaptive(_to_cf(x, cf), "adaptive_avg_pool2d", output_size, 2,
                    "avg")
    return _from_cf(out, cf)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    if data_format != "NCDHW":
        raise NotImplementedError("adaptive_avg_pool3d supports NCDHW only")
    return _adaptive(x, "adaptive_avg_pool3d", output_size, 3, "avg")


def _no_mask(return_mask: bool, what: str) -> None:
    if return_mask:
        raise NotImplementedError(f"{what}(return_mask=True) is not "
                                  "implemented")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool1d")
    return _adaptive(x, "adaptive_max_pool1d", output_size, 1, "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool2d")
    return _adaptive(x, "adaptive_max_pool2d", output_size, 2, "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool3d")
    return _adaptive(x, "adaptive_max_pool3d", output_size, 3, "max")


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return torch.clamp_min(1 - x.abs(), 0)


def _resize_weights(m: int, n: int, kernel, device) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` (scale n / m, no translation,
    antialiased): ``(m, n)`` fp32."""
    scale = n / m
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    f32 = torch.float32
    sample = (torch.arange(n, dtype=f32, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=f32, device=device)[:, None]
         ).abs() / kscale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    (x,) = cast_inputs("interpolate", x)
    spatial = x.dim() - 2
    cf = data_format.startswith("NC")
    x = _to_cf(x, cf)
    in_sp = [int(d) for d in x.shape[2:]]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        out_sp = [int(v) for v in (size if isinstance(size, (list, tuple))
                                   else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * spatial
        out_sp = [int(d * f) for d, f in zip(in_sp, sf)]
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode]
    for i, (m, n) in enumerate(zip(in_sp, out_sp)):
        if m == n:
            continue
        ax = 2 + i
        if method == "nearest":
            idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * m / n).long()
            x = x.index_select(ax, idx)
            continue
        w = _resize_weights(m, n, _triangle if method == "linear"
                            else _keys_cubic, x.device).to(x.dtype)
        x = torch.tensordot(x.movedim(ax, -1), w, dims=1).movedim(-1, ax)
    return _from_cf(x, cf)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format, name)


def _nchw_only(data_format: str) -> None:
    if data_format != "NCHW":
        raise ValueError(
            f"{data_format!r} layout is not implemented; use NCHW")


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    _nchw_only(data_format)
    (x,) = cast_inputs("pixel_shuffle", x)
    return TF.pixel_shuffle(x, int(upscale_factor))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    _nchw_only(data_format)
    (x,) = cast_inputs("pixel_unshuffle", x)
    return TF.pixel_unshuffle(x, int(downscale_factor))


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    _nchw_only(data_format)
    (x,) = cast_inputs("channel_shuffle", x)
    n, c, h, w = x.shape
    g = int(groups)
    return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``(N, C kh kw, L)``, the channel slowest in each column."""
    (x,) = cast_inputs("unfold", x)
    return TF.unfold(x, _pair(kernel_sizes, 2), _pair(dilations, 2),
                     _pair(paddings, 2), _pair(strides, 2))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the sum of each column back into its patch."""
    (x,) = cast_inputs("fold", x)
    return TF.fold(x, _pair(output_sizes, 2), _pair(kernel_sizes, 2),
                   _pair(dilations, 2), _pair(paddings, 2),
                   _pair(strides, 2))
