"""Embedding lookup with ``padding_idx``, and its deterministic backward:
the hand-written Hopper kernel (``csrc/embedding.cu``) and its plain
PyTorch version. The port's own kernel: the JAX package gathers with
``jnp.take`` and leaves the gradient's scatter-add to XLA
(``paddle_tpu/ops/nn_ops.py`` ``embedding``), no Pallas function.

Forward: the rows of ``weight`` at ``ids``, 0 where an id equals
``padding_idx`` (compared as given, as the JAX package compares it).
Backward, with no atomics on the sums: the gradient rows that share an id
are summed in token order within pieces of :data:`CHUNK` rows (a run of one
id cut from its first row), and the pieces of a longer run added in piece
order, each sum accumulating in the weight's dtype with a rounding after
every add, as the JAX package's scatter-add does (fp32: the fp32 sum; bf16
under O2: what keeps the gradients within the parity bound of the
reference, whose bf16 scatter-add rounds each add). Rows that no token hit
and the padding row are 0. A run of at most CHUNK rows is therefore the
token-order sum that autograd's scatter-add takes on the CPU, bit for bit.
On a card its kernels do it (``csrc/embedding.cu``): a stable radix sort
of the tokens by id over tiles of sorted positions, an index kernel that
writes each row's run as a row pointer, and one launch whose windows of
sorted positions sum the hit rows and the pieces of long runs and whose
other CTAs write the zero rows, so that every row of the gradient is
written once (:func:`launch_plan` sizes the last). Eager and captured
steps give the same bits.

:func:`embedding` runs the plain version for CPU tensors (the gather, and
:func:`embedding_bwd_reference` through :class:`Embedding`'s backward) and
the kernel for CUDA tensors; any other device raises. Ids must lie in
``[0, rows)``; the kernel writes zeros for others, the plain version
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .. import _native
from ._fused_io import (aligned16, cuda_device, dtype_code, plain_path, ptr,
                        stream)

__all__ = ["CHUNK", "embedding", "embedding_bwd_reference", "embedding_cost",
           "embedding_reference", "launch_plan", "launches"]

launches = _native.LaunchCounter("embedding")
CHUNK = 64   # rows of a piece of one id's run (csrc/embedding.cu CHUNK)
# the backward's table kernel (csrc/embedding.cu): a CTA's threads at most
# (one vector of V columns of a row each), and the gradient rows a CTA of
# its zero rows covers
MAX_THREADS = 256
ROWS_PER_CTA = 16
# sorted positions a window (a CTA of the table kernel) starts segments
# in; each window has two fp32 scratch slots for pieces of long runs
WINDOW = 16
# sorted positions a CTA of the sort takes; the sort's digits (8 bits a
# pass, a pass per byte of rows)
SORT_TILE = 512
RADIX = 256
# positions and rows are 32-bit in the backward's kernels, with room for
# their grids' last CTA
INDEX_LIMIT = 2 ** 31 - 1024

_ARGTYPES_OF = {
    "emb_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
    + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p],
    "emb_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


class Plan(NamedTuple):
    """The backward's table kernel: ``vec`` columns a thread (8: 16-byte
    vectors of bf16, or 1), ``threads`` a CTA and ``strips`` CTAs across a
    row; ``windows`` CTAs of WINDOW sorted positions (the hit rows) before
    its CTAs of ROWS_PER_CTA gradient rows (the zero rows)."""
    vec: int
    threads: int
    strips: int
    windows: int


def launch_plan(n: int, d: int, vec: int) -> Plan:
    """The table kernel for ``n`` tokens into rows of ``d``: as few strips
    as MAX_THREADS allows, each CTA as wide as its strip's share of a row's
    vectors (rounded up to warps)."""
    vecs = -(-d // vec)
    strips = -(-vecs // MAX_THREADS)
    per_strip = -(-vecs // strips)
    threads = -(-per_strip // 32) * 32
    return Plan(vec, threads, strips, -(-n // WINDOW))


def bind(lib) -> dict:
    """The C entry points of a built ``embedding`` library, typed."""
    fns = {}
    for name, types in _ARGTYPES_OF.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("embedding"))


def embedding_reference(ids: torch.Tensor, weight: torch.Tensor,
                        padding_idx: Optional[int] = None) -> torch.Tensor:
    """Plain version of the forward: ``weight[ids]``, 0 at padding_idx."""
    out = weight[ids.long()]
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return out


def embedding_bwd_reference(ids: torch.Tensor, dy: torch.Tensor, rows: int,
                            padding_idx: Optional[int] = None,
                            dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Plain version of the backward: the kernel's sums in the kernel's
    order (pieces of CHUNK rows in token order, then the pieces of a run in
    order, each from 0), rounded to ``dtype`` (dy's by default) after each
    add. Deterministic on any device."""
    d = dy.shape[-1]
    dev = dy.device
    dtype = dtype or dy.dtype

    def add(acc, x):   # acc + x in fp32, rounded to dtype
        return (acc + x).to(dtype).float()
    flat = ids.reshape(-1).to(device=dev, dtype=torch.int64)
    n = flat.numel()
    out = torch.zeros(rows, d, dtype=torch.float32, device=dev)
    if n:
        s, perm = torch.sort(flat, stable=True)
        g = dy.reshape(n, d)[perm].float()
        pos = torch.arange(n, device=dev)
        rs = torch.searchsorted(s, s)
        re = torch.searchsorted(s, s, right=True)
        first = (pos - rs) % CHUNK == 0
        ps, pe = pos[first], torch.clamp(re[first], max=pos[first] + CHUNK)
        part = torch.zeros(len(ps), d, dtype=torch.float32, device=dev)
        for c in range(CHUNK):
            sel = ps + c < pe
            if not bool(sel.any()):
                break
            part[sel] = add(part[sel], g[ps[sel] + c])
        run0 = torch.nonzero(ps == rs[first]).flatten()   # first pieces
        count = torch.diff(run0, append=torch.tensor([len(ps)], device=dev))
        acc = torch.zeros(len(run0), d, dtype=torch.float32, device=dev)
        for m in range(int(count.max())):
            sel = count > m
            acc[sel] = add(acc[sel], part[run0[sel] + m])
        out[s[ps[run0]]] = acc
    if padding_idx is not None and 0 <= padding_idx < rows:
        out[padding_idx] = 0.0
    return out.to(dtype)


def embedding_cost(ids, weight, out) -> tuple:
    """The forward launch's ``(flops, bytes)``: the ids, the table rows
    they hit (each once: a host count of the distinct ids), the output."""
    hit = int(torch.unique(ids).numel())
    return 0.0, float(_native.tensor_bytes(ids, out)
                      + hit * weight.shape[1] * weight.element_size())


def _launch_fwd(ids, weight, pad: Optional[int], fns=None):
    dev = cuda_device("embedding", ids, weight)
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.long()
    ids = ids.contiguous()
    weight = weight.contiguous()
    rows, d = weight.shape
    out = torch.empty(*ids.shape, d, dtype=weight.dtype, device=dev)
    row_bytes = d * weight.element_size()
    unit = next(u for u in (16, 4, 2) if row_bytes % u == 0
                and weight.data_ptr() % u == 0 and out.data_ptr() % u == 0)
    if ids.numel() and d:
        with torch.cuda.device(dev):
            err = (fns or _kernels())["emb_fwd"](
                ptr(ids), ptr(weight), ptr(out), ids.numel(), rows,
                row_bytes, unit, int(ids.dtype == torch.int64),
                -1 if pad is None else pad, stream(dev))
        _native.check(err, "embedding forward kernel launch")
        launches.launched(1, embedding_cost, ids, weight, out)
    return out


def _launch_bwd(ids, dy, rows: int, pad: Optional[int], dtype, fns=None):
    dev = cuda_device("embedding", ids, dy)
    d = dy.shape[-1]
    flat = ids.reshape(-1)
    if flat.dtype not in (torch.int32, torch.int64):
        flat = flat.long()
    flat = flat.contiguous()
    n = flat.numel()
    if n >= INDEX_LIMIT or rows >= INDEX_LIMIT:
        raise ValueError(f"embedding backward: {n} tokens into {rows} rows; "
                         f"the kernel takes fewer than 2^31 - 1024 of each")
    # first, so that it takes the block a caller just freed; every element
    # is written by the kernels
    dw = torch.empty(rows, d, dtype=dtype, device=dev)
    if rows and d:
        dy = dy.reshape(n, d).contiguous()
        plan = launch_plan(n, d, 8 if d % 8 == 0 and aligned16(dy, dw)
                           else 1)
        # the sorted keys and tokens, the row pointer, the windows' tickets,
        # the sort's digit counts by pass and tile; the pieces' slots (the
        # sort's passes before them)
        passes = -(-rows.bit_length() // 8)
        idx = torch.empty(2 * n + rows + 1 + plan.windows * plan.strips
                          + passes * RADIX * -(-n // SORT_TILE),
                          dtype=torch.int32, device=dev)
        part = torch.empty(max(2 * plan.windows * d, 2 * n),
                           dtype=torch.float32, device=dev)
        c = functools.partial(dtype_code, what="embedding")
        with torch.cuda.device(dev):
            err = (fns or _kernels())["emb_bwd"](
                ptr(flat), ptr(dy), ptr(dw), ptr(idx), ptr(part), n, rows, d,
                int(flat.dtype == torch.int64), c(dy.dtype), c(dtype),
                -1 if pad is None else pad, plan.vec, plan.threads,
                plan.strips, stream(dev))
        _native.check(err, "embedding backward kernel launch")
        launches.launched(1, _native.io_cost, flat, dy, dw)
    return dw


class Embedding(torch.autograd.Function):
    """The gather kernel with the deterministic backward kernel."""

    @staticmethod
    def forward(ctx, ids, weight, pad):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.pad, ctx.dtype = weight.shape[0], pad, weight.dtype
        return _launch_fwd(ids, weight, pad)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        dw = _launch_bwd(ids, dy, ctx.rows, ctx.pad, ctx.dtype) \
            if ctx.needs_input_grad[1] else None
        return None, dw, None


class _PlainEmbedding(torch.autograd.Function):
    """The plain version with the plain backward (the CPU path)."""

    @staticmethod
    def forward(ctx, ids, weight, pad):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.pad, ctx.dtype = weight.shape[0], pad, weight.dtype
        return embedding_reference(ids, weight, pad)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        dw = embedding_bwd_reference(ids, dy, ctx.rows, ctx.pad, ctx.dtype) \
            if ctx.needs_input_grad[1] else None
        return None, dw, None


def embedding(ids: torch.Tensor, weight: torch.Tensor,
              padding_idx: Optional[int] = None) -> torch.Tensor:
    """Rows of ``weight`` (2-D) at integer ``ids``, 0 at ``padding_idx``:
    the plain version for CPU tensors, the kernel for CUDA tensors."""
    if plain_path(weight):
        return _PlainEmbedding.apply(ids, weight, padding_idx)
    return Embedding.apply(ids, weight, padding_idx)
