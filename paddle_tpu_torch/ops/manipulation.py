"""Shape and layout manipulation, the port of
``paddle_tpu/ops/manipulation.py`` (``paddle.tensor.manipulation``) as
functions on tensors, with paddle's conventions: ``reshape``'s 0 copies the
input's dimension and -1 infers one; ``expand``'s -1 keeps one; ``split``
takes a count or sizes with one -1; ``pad`` takes the full-rank form
``[d0_before, d0_after, ...]`` or the spatial form innermost first,
placed by ``data_format``; ``slice`` clamps its bounds and ``crop`` raises
outside the input. None of these ops casts (the JAX package's do not
either, but ``cast``, which casts outside ``auto_cast``).
"""

from __future__ import annotations

import builtins
from typing import List, Sequence

import torch
import torch.nn.functional as TF

__all__ = ["as_complex", "as_real", "broadcast_tensors", "broadcast_to",
           "cast", "chunk", "concat", "crop", "diag", "diag_embed",
           "diagonal", "expand", "expand_as", "flatten", "flip", "fliplr",
           "flipud", "meshgrid", "moveaxis", "pad", "repeat_interleave",
           "reshape", "roll", "rot90", "slice", "split", "squeeze", "stack",
           "strided_slice", "swapaxes", "t", "tile", "transpose", "tril",
           "triu", "unbind", "unsqueeze"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
           "complex64": torch.complex64, "complex128": torch.complex128}


def _int(v) -> int:
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _ints(vs) -> List[int]:
    if isinstance(vs, torch.Tensor):
        return [int(v) for v in vs.tolist()]
    return [_int(v) for v in vs]


def _norm_shape(shape, x_shape) -> List[int]:
    """Paddle's reshape: 0 copies the input's dimension, -1 infers."""
    return [x_shape[i] if s == 0 else s for i, s in enumerate(_ints(shape))]


def reshape(x, shape, name=None):
    return torch.reshape(x, _norm_shape(shape, x.shape))


def flatten(x, start_axis: int = 0, stop_axis: int = -1, name=None):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


def transpose(x, perm, name=None):
    return x.permute(*_ints(perm))


def t(x, name=None):
    if x.dim() > 2:
        raise ValueError("paddle.t only supports tensors with ndim <= 2")
    return x.t() if x.dim() == 2 else x


def squeeze(x, axis=None, name=None):
    """Drop the given axes of size 1 (others are left), or every axis of
    size 1."""
    if axis is None:
        return torch.squeeze(x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    keep = [a % x.dim() for a in _ints(axes) if x.shape[a % x.dim()] == 1]
    return torch.squeeze(x, tuple(keep)) if keep else x


def unsqueeze(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    for ax in sorted(a if a >= 0 else a + x.dim() + 1 for a in _ints(axes)):
        x = x.unsqueeze(ax)
    return x


def concat(x: Sequence[torch.Tensor], axis=0, name=None):
    return torch.cat(list(x), dim=_int(axis))


def stack(x: Sequence[torch.Tensor], axis: int = 0, name=None):
    return torch.stack(list(x), dim=axis)


def split(x, num_or_sections, axis=0, name=None):
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = _ints(num_or_sections)
        if -1 in sections:
            known = builtins.sum(s for s in sections if s != -1)
            sections = [dim - known if s == -1 else s for s in sections]
    return list(torch.split(x, sections, dim=axis))


def chunk(x, chunks: int, axis=0, name=None):
    return split(x, chunks, axis=axis)


def unbind(input, axis: int = 0, name=None):
    return list(torch.unbind(input, dim=axis))


def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times) if isinstance(repeat_times, (list, tuple,
                                                            torch.Tensor)) \
        else [int(repeat_times)]
    return torch.tile(x, tuple(reps))


def expand(x, shape, name=None):
    """Broadcast to ``shape``; -1 keeps the input's dimension."""
    shape = _norm_shape(shape, x.shape)
    lead = len(shape) - x.dim()
    full = [x.shape[i - lead] if s == -1 else s for i, s in enumerate(shape)]
    return x.expand(*full)


def expand_as(x, y, name=None):
    return x.expand(y.shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def roll(x, shifts, axis=None, name=None):
    sh = tuple(shifts) if isinstance(shifts, (list, tuple)) else shifts
    if axis is None:
        return torch.roll(x, sh)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return torch.roll(x, sh, ax)


def flip(x, axis, name=None):
    ax = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(x, ax)


def fliplr(x, name=None):
    if x.dim() < 2:
        raise ValueError("fliplr requires a tensor of at least 2-D")
    return flip(x, 1)


def flipud(x, name=None):
    if x.dim() < 1:
        raise ValueError("flipud requires a tensor of at least 1-D")
    return flip(x, 0)


def rot90(x, k: int = 1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def pad(x, pad, mode: str = "constant", value: float = 0.0,
        data_format: str = "NCHW", name=None):
    """``jnp.pad`` modes under paddle's names (``replicate`` is edge,
    ``circular`` wrap). ``pad`` of twice the rank is the full-rank form;
    otherwise pairs of the spatial axes innermost first, after the channel
    axis of a channels-first ``data_format`` and before that of a
    channels-last one."""
    p = _ints(pad)
    nd = x.dim()
    if len(p) == 2 * nd:
        pairs = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    else:
        spatial = [(p[2 * i], p[2 * i + 1]) for i in range(len(p) // 2)]
        spatial.reverse()
        if data_format.endswith("C") and nd >= 3:
            pairs = [(0, 0)] * (nd - len(spatial) - 1) + spatial + [(0, 0)]
        else:
            pairs = [(0, 0)] * (nd - len(spatial)) + spatial
    if mode == "constant":
        flat = [v for pr in reversed(pairs) for v in pr]
        return TF.pad(x, flat, mode="constant", value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad mode {mode!r}: use constant, reflect, "
                         "replicate or circular")
    for ax, (lo, hi) in enumerate(pairs):
        if lo == hi == 0:
            continue
        n = x.shape[ax]
        i = torch.arange(-lo, n + hi, device=x.device)
        if mode == "reflect":
            period = 2 * (n - 1)
            i = i.abs() % period
            i = torch.where(i >= n, period - i, i)
        elif mode == "replicate":
            i = i.clamp(0, n - 1)
        else:
            i = i % n
        x = x.index_select(ax, i)
    return x


def tril(x, diagonal: int = 0, name=None):
    return torch.tril(x, diagonal)


def triu(x, diagonal: int = 0, name=None):
    return torch.triu(x, diagonal)


def diag(x, offset: int = 0, padding_value: float = 0.0, name=None):
    if x.dim() == 1:
        d = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
            d = torch.where(mask, d, padding_value)
        return d
    return torch.diag(x, offset)


def diagonal(x, offset: int = 0, axis1: int = 0, axis2: int = 1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


def diag_embed(x, offset: int = 0, dim1: int = -2, dim2: int = -1,
               name=None):
    return torch.diag_embed(x, offset, dim1, dim2)


def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*args, indexing="ij"))


def cast(x, dtype):
    """``x`` in ``dtype`` (a torch dtype or paddle's name of one)."""
    return x.to(_DTYPES[dtype] if isinstance(dtype, str) else dtype)


def slice(input, axes, starts, ends):
    """``input[start:end]`` along each axis, negative bounds from the end,
    every bound clamped into the axis."""
    idx = [builtins.slice(None)] * input.dim()
    for ax, st, en in zip(_ints(axes), _ints(starts), _ints(ends)):
        dim = input.shape[ax]
        st = builtins.max(st + dim, 0) if st < 0 else builtins.min(st, dim)
        en = builtins.max(en + dim, 0) if en < 0 else builtins.min(en, dim)
        idx[ax] = builtins.slice(st, en)
    return input[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing ``start:end:stride`` along each axis (a negative
    stride walks backwards)."""
    for ax, st, en, sd in zip(_ints(axes), _ints(starts), _ints(ends),
                              _ints(strides)):
        keep = range(x.shape[ax])[builtins.slice(st, en, sd)]
        x = x.index_select(ax, torch.tensor(list(keep), dtype=torch.long,
                                            device=x.device))
    return x


def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis1: int, axis2: int, name=None):
    return torch.swapaxes(x, axis1, axis2)


def as_real(x, name=None):
    return torch.stack([x.real, x.imag], dim=-1)


def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


def crop(x, shape=None, offsets=None, name=None):
    """The ``shape``-sized box at ``offsets`` (0s by default; -1 in shape
    keeps the rest of that axis); raises where it leaves the input."""
    nd, full = x.dim(), x.shape
    offs = [0] * nd if offsets is None else _ints(offsets)
    shp = [-1] * nd if shape is None else _ints(shape)
    shp = [full[i] - offs[i] if s == -1 else s for i, s in enumerate(shp)]
    for i, (o, s) in enumerate(zip(offs, shp)):
        if o < 0 or s < 0 or o + s > full[i]:
            raise ValueError(f"crop out of bounds on dim {i}: offset {o} + "
                             f"shape {s} > input dim {full[i]}")
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))]
