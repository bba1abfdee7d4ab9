"""Rotary position embedding: the hand-written Hopper kernel
(``csrc/rope.cu``, forward and backward, up to three tensors in one
launch) and its plain PyTorch version. The port's own kernel: the JAX
package's ``apply_rotary`` (``paddle_tpu/models/llama.py``) and
``fused_rotary_position_embedding``
(``paddle_tpu/incubate/nn_functional.py:94-167``) are XLA-fused jnp, no
Pallas function.

Each tensor is ``(B, L, H, D)``; the row at sequence index ``l`` of batch
``b`` sits at position ``positions[b, l]`` (a device tensor, never read on
the host) or ``offset + l``. ``cos`` and ``sin`` are tables with one row per
position, ``D/2`` wide (a frequency a pair) or ``D`` wide (a value an
element, the incubate form). Pairs are the halves ``(j, j + D/2)``
(``neox``) or neighbours ``(2j, 2j + 1)``; each turns as
``(x1 c1 - x2 s1, x2 c2 + x1 s2)`` in fp32 from the tensors and tables
cast to ``dtype`` and ``table_dtype`` (the op's AMP casts), rounded once
to ``dtype``. The backward turns the gradient back.

:func:`rope` runs :func:`rope_reference` for CPU tensors (gradients by
autograd) and the kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import _native
from ._fused_io import (aligned16, cuda_device, dtype_code, plain_path,
                        ptr, stream)

__all__ = ["LaunchPlan", "launch_plan", "launches", "rope",
           "rope_reference"]

launches = _native.LaunchCounter("rope")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] \
    + [ctypes.c_int] * 13 + [ctypes.c_void_p]

# the kernel's CTA: 8 warps, each an item (a position and a run of its heads)
THREADS = 256
WARPS = THREADS // 32
# warps an SM should have before one warp takes more of a position's heads
TARGET_WARPS_SM = 32
INDEX_LIMIT = 2 ** 31


class LaunchPlan(NamedTuple):
    """One launch of the kernel: ``grid`` CTAs of ``threads``; ``items`` =
    positions x ``parts`` warps, each turning ``heads_per_part`` heads of
    its position (the tensors' heads in order); ``lph`` lanes a head,
    ``hpw`` heads a warp step, ``nch`` chunks a lane, ``cph`` chunks of
    ``vec`` pairs a head."""
    grid: int
    threads: int
    items: int
    parts: int
    heads_per_part: int
    lph: int
    hpw: int
    nch: int
    cph: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def launch_plan(positions: int, heads: int, d: int, vec: int,
                sms: int) -> LaunchPlan:
    """The launch over ``positions`` (b, l) rows of ``heads`` heads (all
    tensors') of ``d`` elements, ``vec`` pairs a chunk (8: 16-byte loads,
    or 1), on a card of ``sms`` SMs. A warp takes all of a position's heads
    where the card still gets ``TARGET_WARPS_SM`` warps an SM (Llama's
    training shapes), else the heads are split into parts, down to one
    warp step each (decode)."""
    cph = d // 2 // vec
    lph = min(cph, 32)
    hpw = 32 // lph
    nch = _ceil(cph, lph)
    steps = _ceil(heads, hpw)
    sp = max(1, min(steps, positions * steps // (sms * TARGET_WARPS_SM)))
    hpp = sp * hpw
    parts = _ceil(heads, hpp)
    items = positions * parts
    return LaunchPlan(_ceil(items, WARPS), THREADS, items, parts, hpp, lph,
                      hpw, nch, cph)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bind(lib) -> dict:
    """The C entry point of a built ``rope`` library, typed."""
    fn = lib.rope
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return {"rope": fn}


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("rope"))


def _table_rows(table: torch.Tensor, n: int, offset: int,
                positions: Optional[torch.Tensor]) -> torch.Tensor:
    """The table's rows for each (b, l): ``(B or 1, L, 1, W)``."""
    if positions is None:
        return table[offset:offset + n][None, :, None, :]
    return table[positions.long()][:, :, None, :]


def _turn(x, c1, s1, c2, s2, neox: bool, back: bool = False):
    """fp32 turn of x (any float dtype) by tables already in fp32-ready
    form; returns fp32."""
    xf = x.float()
    if neox:
        x1, x2 = xf.chunk(2, dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
    if back:
        y1, y2 = x1 * c1 + x2 * s2, x2 * c2 - x1 * s1
    else:
        y1, y2 = x1 * c1 - x2 * s1, x2 * c2 + x1 * s2
    if neox:
        return torch.cat([y1, y2], dim=-1)
    return torch.stack([y1, y2], dim=-1).flatten(-2)


def _halves(t: torch.Tensor, d: int, neox: bool):
    """A table's rows as the (first, second) element of each pair."""
    if t.shape[-1] == d // 2:
        return t, t
    if neox:
        return t[..., :d // 2], t[..., d // 2:]
    return t[..., 0::2], t[..., 1::2]


def rope_reference(xs: Sequence[torch.Tensor], cos: torch.Tensor,
                   sin: torch.Tensor, *, offset: int = 0,
                   positions: Optional[torch.Tensor] = None,
                   neox: bool = True, dtype: Optional[torch.dtype] = None,
                   table_dtype: Optional[torch.dtype] = None,
                   backward: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain version: each ``(B, L, H, D)`` tensor of ``xs`` turned (or,
    with ``backward``, turned back) in the ops of the port's former
    ``_rotate``."""
    outs = []
    for x in xs:
        dt = dtype or x.dtype
        x = x.to(dt)
        c = _table_rows(cos.to(table_dtype or cos.dtype), x.shape[1],
                        offset, positions)
        s = _table_rows(sin.to(table_dtype or sin.dtype), x.shape[1],
                        offset, positions)
        d = x.shape[-1]
        c1, c2 = _halves(c, d, neox)
        s1, s2 = _halves(s, d, neox)
        outs.append(_turn(x, c1, s1, c2, s2, neox, backward).to(dt))
    return tuple(outs)


def _launch(xs, cos, sin, *, offset, positions, neox, dtype, table_dtype,
            backward, out_dtypes, fns=None):
    dev = cuda_device("rope", *xs, cos, sin, positions)
    if len(xs) > 3:
        raise ValueError("rope: the kernel turns at most three tensors")
    x0 = xs[0]
    if any(x.dim() != 4 or x.shape[:2] != x0.shape[:2]
           or x.shape[3] != x0.shape[3] or x.dtype != x0.dtype for x in xs):
        raise ValueError(f"rope: tensors must be (B, L, H, D) of one dtype "
                         f"with one B, L and D, got "
                         f"{[(tuple(x.shape), x.dtype) for x in xs]}")
    b, n, _, d = x0.shape
    if d % 2:
        raise ValueError(f"rope: head_dim must be even, got {d}")
    if cos.shape != sin.shape or cos.dtype != sin.dtype or \
            cos.dim() != 2 or cos.shape[1] not in (d // 2, d):
        raise ValueError(f"rope: cos/sin must be (positions, {d // 2}) or "
                         f"(positions, {d}) of one dtype, got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")
    if positions is None and offset + n > cos.shape[0]:
        raise ValueError(f"rope: positions {offset}..{offset + n - 1} run "
                         f"past the table's {cos.shape[0]} rows")
    if positions is not None:
        if positions.shape != (b, n) or positions.dtype not in (
                torch.int32, torch.int64):
            raise ValueError(f"rope: positions must be int32 or int64 of "
                             f"shape {(b, n)}, got {positions.dtype} "
                             f"{tuple(positions.shape)}")
        positions = positions.contiguous()
    xs = [x.contiguous() for x in xs]
    cos, sin = cos.contiguous(), sin.contiguous()
    if max(t.numel() for t in (*xs, cos)) >= INDEX_LIMIT or \
            b * n >= INDEX_LIMIT:
        raise ValueError(f"rope: the kernel indexes tensors of fewer than "
                         f"2^31 elements, got {[tuple(x.shape) for x in xs]}"
                         f", tables {tuple(cos.shape)}")
    outs = [torch.empty(x.shape, dtype=dt, device=dev)
            for x, dt in zip(xs, out_dtypes)]
    vec = 8 if d % 16 == 0 and cos.shape[1] % 8 == 0 and \
        aligned16(*xs, *outs, cos, sin) else 1
    heads = [x.shape[2] for x in xs] + [0] * 3
    ins = list(xs) + [None] * 3
    os = list(outs) + [None] * 3
    c = functools.partial(dtype_code, what="rope")
    if b * n and sum(heads):
        plan = launch_plan(b * n, sum(heads), d, vec, _sm_count(dev.index))
        fn = (fns or _kernels())["rope"]
        with torch.cuda.device(dev):
            err = fn(ptr(ins[0]), ptr(ins[1]), ptr(ins[2]), ptr(os[0]),
                     ptr(os[1]), ptr(os[2]), b * n, *heads[:3], n, d,
                     ptr(cos), ptr(sin), cos.shape[1], cos.shape[1],
                     c(cos.dtype), c(table_dtype or cos.dtype),
                     ptr(positions),
                     int(positions is not None
                         and positions.dtype == torch.int64),
                     offset, c(x0.dtype), c(dtype or x0.dtype),
                     c(out_dtypes[0]), int(neox), int(backward), vec,
                     plan.grid, plan.threads, plan.parts,
                     plan.heads_per_part, plan.lph, plan.hpw, plan.nch,
                     stream(dev))
        _native.check(err, "rope kernel launch")
        launches.launched(1, _native.io_cost, *xs, cos, sin, positions,
                          *outs)
    return tuple(outs)


class Rope(torch.autograd.Function):
    """The kernel over up to three tensors, with its backward kernel."""

    @staticmethod
    def forward(ctx, cos, sin, positions, opts, *xs):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(cos, sin, positions)
        ctx.opts = opts
        ctx.in_dtypes = [x.dtype for x in xs]
        ctx.shapes = [x.shape for x in xs]
        dt = opts["dtype"] or xs[0].dtype
        return _launch(xs, cos, sin, positions=positions, backward=False,
                       out_dtypes=[dt] * len(xs), **opts)

    @staticmethod
    def backward(ctx, *grads):
        cos, sin, positions = ctx.saved_tensors
        opts = dict(ctx.opts, positions=positions)
        dt = opts["dtype"] or ctx.in_dtypes[0]
        gs = [torch.zeros(shape, dtype=dt, device=cos.device)
              if g is None else g for g, shape in zip(grads, ctx.shapes)]
        dxs = _launch(gs, cos, sin, backward=True,
                      out_dtypes=ctx.in_dtypes, **dict(opts, dtype=dt))
        return (None, None, None, None, *dxs)


def rope(xs: Sequence[torch.Tensor], cos: torch.Tensor, sin: torch.Tensor,
         *, offset: int = 0, positions: Optional[torch.Tensor] = None,
         neox: bool = True, dtype: Optional[torch.dtype] = None,
         table_dtype: Optional[torch.dtype] = None
         ) -> Tuple[torch.Tensor, ...]:
    """Each tensor of ``xs`` turned as the module docstring says: the
    plain version for CPU tensors, one kernel launch for CUDA tensors.
    ``dtype`` / ``table_dtype``: what the op casts the tensors and the
    tables to (default: their own)."""
    kw = dict(offset=offset, positions=positions, neox=neox, dtype=dtype,
              table_dtype=table_dtype)
    if plain_path(xs[0]):
        return rope_reference(xs, cos, sin, **kw)
    opts = dict(kw)
    del opts["positions"]
    return Rope.apply(cos, sin, positions, opts, *xs)
