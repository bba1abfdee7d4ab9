"""RMSNorm and LayerNorm with the pre-norm residual (and bias) add: the
hand-written Hopper kernel (``csrc/fused_norm.cu``, forward and backward)
and its plain PyTorch version. The port's own kernel: the JAX package's
``rms_norm`` / ``layer_norm`` (``paddle_tpu/ops/nn_ops.py``) and
``fused_rms_norm`` / ``fused_layer_norm``
(``paddle_tpu/incubate/nn_functional.py:23-91``) are XLA-fused jnp, no
Pallas function.

A :class:`NormSpec` says what is computed: the kind, epsilon, the dtype
of the add (``add``; None: no add), the dtype the norm's input is cast to
(``norm``), the weight's and bias's cast dtypes and the output dtype, and
the order of the weight multiply. The plain order (``fused=False``, the
port's ``rms_norm`` and ``layer_norm``) rounds the normalised value to
``norm`` before the weight; the fused order (``incubate``'s
``fused_rms_norm`` / ``fused_layer_norm``) multiplies by the weight in
fp32 and rounds once. The statistics are fp32 in both.

:func:`fused_norm` runs :func:`fused_norm_reference` for CPU tensors (its
gradients by autograd) and the kernel, through an autograd function whose
backward is the kernel's backward, for CUDA tensors; any other device
raises. :func:`launch_plan` sizes each launch from the rows, the columns,
the vector width and the card's SM count (read once per device): the
row-group kernels (a persistent grid, rows of 8-column chunks held in
registers by groups of 1-8 warps, fed by a ring of asynchronous copies)
where there are rows for every SM and their shared memory fits, else the
block-per-row kernels (a row over the same threads, so its bits do not
depend on the call's row count). The
backward's weight, bias and pre-bias gradients are per-CTA partial sums
folded in a fixed order by a second kernel: no atomics, so launches on the
same inputs agree bit for bit, inside a CUDA graph too.
:func:`fused_norm_bwd_reference` is the backward's plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import _native
from ._fused_io import (aligned16, cuda_device, dtype_code, plain_path,
                        ptr, stream)

__all__ = ["LaunchPlan", "NormSpec", "fused_norm", "fused_norm_bwd_reference",
           "fused_norm_reference", "launch_plan", "launches"]

launches = _native.LaunchCounter("fused_norm")

# the block-per-row backward keeps five fp32 rows in shared memory (227 KB
# a block)
MAX_COLS = 11264
# the row-group kernels: 8-column chunks a thread, warps a group, warps a
# CTA (more groups when a group has fewer), ring depths tried
NC_MAX = 2
GROUP_WARPS_MAX = 8
CTA_WARPS = 8
STAGES = (4, 3, 2)
# a group's exchange slots (fp32), the forward's mbarrier a stage (bytes),
# bytes of rows in flight an SM worth having (two microseconds of an SM's
# share of the memory bandwidth)
RED_FLOATS = 64
MBAR_BYTES = 8
IN_FLIGHT = 64 * 1024
# what an H100 SM offers: dynamic shared memory a block, shared memory an SM
# and its per-block reserve, threads, registers; the registers a thread of
# the row-group kernels takes at most (csrc/fused_norm.cu builds them for 4
# CTAs of 256 threads an SM forward, 2 backward) and of the block-per-row
# ones (1024 threads)
SMEM_BLOCK = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
THREADS_SM = 2048
REGS_SM = 65536
REGS_FWD = 64
REGS_BWD = 128
REGS_BLOCK = 64
BLOCKS_SM = 32

_ARGTYPES_FWD = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 14 + [ctypes.c_float] + [ctypes.c_int] * 9 \
    + [ctypes.c_longlong, ctypes.c_void_p]
_ARGTYPES_BWD = [ctypes.c_void_p] * 13 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 27 + [ctypes.c_longlong, ctypes.c_void_p]


@dataclass(frozen=True)
class NormSpec:
    kind: str                             # "rms" or "ln"
    eps: float
    norm: torch.dtype                     # the norm's input is cast to it
    out: torch.dtype
    add: Optional[torch.dtype] = None     # the pre-norm add's dtype
    weight: Optional[torch.dtype] = None  # the weight's cast dtype
    bias: Optional[torch.dtype] = None    # the bias's cast dtype
    fused: bool = False                   # weight before the rounding
    naxes: int = 1                        # trailing axes normalised


def bind(lib) -> dict:
    """The C entry points of a built ``fused_norm`` library, typed."""
    fns = {}
    for name, types in (("fused_norm_fwd", _ARGTYPES_FWD),
                        ("fused_norm_bwd", _ARGTYPES_BWD)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("fused_norm"))


def _stats(hf: torch.Tensor, spec: NormSpec):
    dims = tuple(range(hf.dim() - spec.naxes, hf.dim()))
    if spec.kind == "rms":
        r = torch.rsqrt(hf.square().mean(dim=dims, keepdim=True) + spec.eps)
        return hf * r, r
    mu = hf.mean(dim=dims, keepdim=True)
    var = hf.var(dim=dims, unbiased=False, keepdim=True)
    r = torch.rsqrt(var + spec.eps)
    return (hf - mu) * r, r


def fused_norm_reference(x, weight=None, bias=None, residual=None,
                         pre_bias=None, *, spec: NormSpec):
    """Plain version: ``(out, h)``, ``h`` the add's result (None without
    an add), in the ops of the port's ``rms_norm`` / ``layer_norm`` (plain
    order) or of the JAX package's ``fused_*_norm`` (fused order)."""
    h = None
    if spec.add is not None:
        h = x.to(spec.add)
        if pre_bias is not None:
            h = h + pre_bias.to(spec.add)
        if residual is not None:
            h = h + residual.to(spec.add)
    xn = (x if h is None else h).to(spec.norm)
    w = None if weight is None else weight.to(spec.weight)
    b = None if bias is None else bias.to(spec.bias)
    n, _ = _stats(xn.float(), spec)
    if spec.fused:
        out = n
        if w is not None:
            out = out * w.float()
        if b is not None:
            out = out + b.float()
        return out.to(spec.out), h
    out = n.to(spec.norm)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out, h


def fused_norm_bwd_reference(dy, dres, h, weight=None, *, spec: NormSpec,
                             dx_dtype: torch.dtype, bias_dtype=None,
                             pre_bias_dtype=None):
    """Plain version of the backward, in the kernel's operations: from the
    output's gradient ``dy``, the add result's ``dres`` (or None) and the
    norm's saved input ``h`` (the add's result, else x), returns ``(dx,
    dweight, dbias, dpre_bias)`` (None where there is no such input; dx in
    ``dx_dtype``, the others in their inputs' dtypes)."""
    cols = math.prod(h.shape[h.dim() - spec.naxes:])
    hn = h.to(spec.norm).float().reshape(-1, cols)
    g = dy.float().reshape(-1, cols)
    n, r = _stats(hn, NormSpec(spec.kind, spec.eps, spec.norm, spec.out))
    w = None if weight is None else \
        weight.to(spec.weight).float().reshape(cols)
    dw = db = dpb = None
    if spec.fused:
        gn = g if w is None else g * w
        if w is not None:
            dw = (g * n).sum(0)
    else:
        gn = (g if w is None else (g * w).to(spec.out).float()) \
            .to(spec.norm).float()
        if w is not None:
            dw = (g * n.to(spec.norm).float()).to(spec.out).float().sum(0) \
                .to(spec.out)
    if bias_dtype is not None:
        db = g.sum(0) if spec.fused else g.sum(0).to(spec.out)
        db = db.to(spec.bias).to(bias_dtype)
    if dw is not None:
        dw = dw.to(spec.weight).to(weight.dtype)
    ma = (gn * n).mean(-1, keepdim=True)
    t = gn - n * ma
    if spec.kind == "ln":
        t = t - gn.mean(-1, keepdim=True)
    v = (r * t).to(spec.norm).float()
    if spec.add is not None:
        v = v.to(spec.add).float()
        if dres is not None:
            v = (v + dres.float().reshape(-1, cols)).to(spec.add).float()
        if pre_bias_dtype is not None:
            dpb = v.sum(0).to(spec.add).to(pre_bias_dtype)
    return v.to(dx_dtype).reshape(h.shape), dw, db, dpb


@dataclass(frozen=True)
class LaunchPlan:
    """How one launch of K1 is laid out. ``ring``: the row-group kernel,
    ``grid`` CTAs of ``groups`` row groups of ``group_warps`` warps, each
    thread holding ``nc`` 8-column chunks of a row, ``stages`` rows of
    ``stage_bytes`` in each group's copy ring; CTA i takes rows ``[i *
    rows_per_cta, (i + 1) * rows_per_cta)`` and group g of them every
    ``groups``-th from the g-th. Else the block-per-row kernel: the forward
    one row a block (with 8-element vectors ``nc`` chunks a thread), the
    backward ``rows_per_cta`` rows a block. ``grid`` is also the number of
    the backward's partial rows."""
    ring: bool
    grid: int
    threads: int
    smem: int
    rows_per_cta: int
    group_warps: int = 0
    groups: int = 0
    nc: int = 0
    stages: int = 0
    stage_bytes: int = 0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _ctas_an_sm(threads: int, smem: int, regs: int) -> int:
    return min(BLOCKS_SM, THREADS_SM // threads, REGS_SM // (regs * threads),
               SMEM_SM // (smem + SMEM_RESERVED))


def _threads_for(cols: int) -> int:
    """The block-per-row kernels' threads for rows of single elements."""
    return min(1024, max(32, _ceil(cols, 32) * 32))


def group_warps(cols: int) -> int:
    """The warps a row of ``cols`` (8-element vectors) is spread over, in
    both kernels: the fewest (a power of 2) that leave each thread NC_MAX
    chunks at most. A function of ``cols`` alone, so that a row's sums run
    in one order whatever the rows beside it in the call."""
    gw = 1
    while 32 * gw * NC_MAX < _ceil(cols, 8):
        gw *= 2
    return gw


def _ring_plan(rows: int, cols: int, sms: int, row_bytes: int,
               cta_vecs: int, group_vecs: int, regs: int,
               bar: int) -> Optional[LaunchPlan]:
    chunks = cols // 8
    gw = group_warps(cols)
    if gw > GROUP_WARPS_MAX:
        return None
    nc = _ceil(chunks, 32 * gw)
    groups = max(1, CTA_WARPS // gw)
    while groups > 1 and _ceil(rows, groups) < sms:
        groups //= 2
    stage = cols * row_bytes
    best = None
    g = groups
    while g >= 1:
        for stages in STAGES:
            smem = (g * stages * (stage + bar) + cta_vecs * cols * 4
                    + g * group_vecs * cols * 4 + g * RED_FLOATS * 4)
            if smem > SMEM_BLOCK:
                continue
            threads = g * gw * 32
            per_sm = _ctas_an_sm(threads, smem, regs)
            if per_sm < 1:
                continue
            # rows in flight an SM (to IN_FLIGHT), then warps, then depth
            score = (min(per_sm * g * (stages - 1) * stage, IN_FLIGHT),
                     per_sm * threads, stages)
            if best is None or score > best[0]:
                best = (score, g, stages, smem, threads, per_sm)
        g //= 2
    if best is None:
        return None
    _, g, stages, smem, threads, per_sm = best
    grid = min(_ceil(rows, g), sms * per_sm)
    rpc = _ceil(rows, grid)
    # no deeper ring than a group has rows (one row a CTA: no prefetch)
    fewer = max(0, stages - max(1, _ceil(rpc, g)))
    return LaunchPlan(True, _ceil(rows, rpc), threads,
                      smem - fewer * g * (stage + bar), rpc, gw, g, nc,
                      stages - fewer, stage)


@functools.lru_cache(maxsize=4096)
def launch_plan(rows: int, cols: int, vec: int, sms: int, *,
                backward: bool = False, row_bytes: int = 4,
                cta_vecs: int = 0, group_vecs: int = 0) -> LaunchPlan:
    """The launch of K1's forward (or ``backward``) over ``rows`` rows of
    ``cols`` elements, 8 elements a vector (``vec`` 8) or 1, on a card of
    ``sms`` SMs. ``row_bytes``: bytes a column of the rows the kernel
    streams (forward: x and residual; backward: dy, h and d res_out);
    ``cta_vecs``: fp32 columns a CTA keeps (the forward's weight, bias and
    pre-bias; the backward's weight); ``group_vecs``: fp32 columns each
    row group adds into (the backward's weight, bias and pre-bias
    gradients; the forward's ring stages also carry an mbarrier each). The
    row-group kernel where ``vec`` is 8 and its shared memory fits (a forward only with as many rows as SMs; a backward with
    fewer takes one row a CTA, no prefetch); else the block-per-row
    ones."""
    if vec == 8 and (backward or rows >= sms):
        plan = _ring_plan(rows, cols, sms, row_bytes, cta_vecs, group_vecs,
                          REGS_BWD if backward else REGS_FWD,
                          0 if backward else MBAR_BYTES)
        if plan is not None:
            return plan
    threads = 32 * group_warps(cols) if vec == 8 else _threads_for(cols)
    if not backward:
        # vec 8 up to 16 warps: each thread's chunks in registers, only the
        # 32 reduction slots in shared memory; else looping, the row's hn too
        if vec == 8 and threads <= 512:
            return LaunchPlan(False, rows, threads, 32 * 4, 1,
                              nc=_ceil(cols // 8, threads))
        return LaunchPlan(False, rows, threads, (cols + 32) * 4, 1)
    smem = (5 * cols + 32) * 4
    grid = min(rows, sms * _ctas_an_sm(threads, smem, REGS_BLOCK))
    rpc = _ceil(rows, grid)
    return LaunchPlan(False, _ceil(rows, rpc), threads, smem, rpc)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_args(plan: LaunchPlan) -> tuple:
    return (plan.threads, plan.smem, plan.group_warps, plan.groups, plan.nc,
            plan.stages, plan.stage_bytes, plan.rows_per_cta)


def _size(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.element_size()


def _vec(cols: int, *ts) -> int:
    return 8 if cols % 8 == 0 and aligned16(*ts) else 1


def _cols(x: torch.Tensor, spec: NormSpec) -> int:
    cols = math.prod(x.shape[x.dim() - spec.naxes:])
    if not 0 < cols <= MAX_COLS:
        raise ValueError(f"fused_norm: the kernel normalises rows of 1 to "
                         f"{MAX_COLS} elements, got {cols}")
    return cols


def _launch_fwd(x, weight, bias, residual, pre_bias, spec, fns=None):
    """The forward kernel: ``(out, res_out, mean, rstd)``."""
    dev = cuda_device("fused_norm", x, weight, bias, residual, pre_bias)
    cols = _cols(x, spec)
    x = x.contiguous()
    if residual is not None:
        if residual.shape != x.shape:
            raise ValueError(f"fused_norm: residual {tuple(residual.shape)} "
                             f"must have x's shape {tuple(x.shape)}")
        residual = residual.contiguous()
    vecs = [t if t is None else t.contiguous()
            for t in (weight, bias, pre_bias)]
    for t in vecs:
        if t is not None and t.numel() != cols:
            raise ValueError(f"fused_norm: weights and biases must have "
                             f"{cols} elements, got {t.numel()}")
    weight, bias, pre_bias = vecs
    rows = x.numel() // cols
    out = torch.empty(x.shape, dtype=spec.out, device=dev)
    has_add = spec.add is not None
    res_out = torch.empty(x.shape, dtype=spec.add, device=dev) \
        if has_add else None
    mean = torch.empty(rows, dtype=torch.float32, device=dev) \
        if spec.kind == "ln" else None
    rstd = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows:
        fn = (fns or _kernels())["fused_norm_fwd"]
        vec = _vec(cols, x, residual, pre_bias, weight, bias, out, res_out)
        plan = launch_plan(
            rows, cols, vec, _sm_count(dev.index),
            row_bytes=_size(x) + _size(residual), cta_vecs=3)
        with torch.cuda.device(dev):
            err = fn(ptr(x), ptr(residual), ptr(pre_bias), ptr(weight),
                     ptr(bias), ptr(out), ptr(res_out), ptr(mean), ptr(rstd),
                     rows, cols, dtype_code(x.dtype, "fused_norm"),
                     dtype_code(None if residual is None else residual.dtype,
                                "fused_norm"),
                     dtype_code(None if pre_bias is None else pre_bias.dtype,
                                "fused_norm"),
                     dtype_code(None if weight is None else weight.dtype,
                                "fused_norm"),
                     dtype_code(spec.weight, "fused_norm"),
                     dtype_code(None if bias is None else bias.dtype,
                                "fused_norm"),
                     dtype_code(spec.bias, "fused_norm"),
                     dtype_code(spec.out, "fused_norm"),
                     dtype_code(spec.add, "fused_norm"),
                     dtype_code(spec.norm, "fused_norm"),
                     int(spec.kind == "ln"), int(spec.fused), vec,
                     spec.eps, int(plan.ring), plan.grid, *_plan_args(plan),
                     stream(dev))
        _native.check(err, "fused_norm forward kernel launch")
        launches.launched(1, _native.io_cost, x, residual, pre_bias, weight,
                          bias, out, res_out, mean, rstd)
    return out, res_out, mean, rstd


def _launch_bwd(dy, dres, h, mean, rstd, weight, spec, *, dx_dtype,
                want_w, bias_dtype, pre_bias_dtype, fns=None):
    """The backward kernel: ``(dx, dw, db, dpb)``; dw, db and dpb are
    None where not asked for (``want_w``, ``bias_dtype``,
    ``pre_bias_dtype``)."""
    dev = cuda_device("fused_norm", dy, dres, h, weight)
    cols = _cols(h, spec)
    dy, h = dy.contiguous(), h.contiguous()
    dres = None if dres is None else dres.contiguous()
    weight = None if weight is None else weight.contiguous()
    rows = h.numel() // cols
    dx = torch.empty(h.shape, dtype=dx_dtype, device=dev)
    want_b, want_pb = bias_dtype is not None, pre_bias_dtype is not None
    vec = _vec(cols, dy, dres, h, weight, dx)
    plan = launch_plan(
        max(rows, 1), cols, vec, _sm_count(dev.index), backward=True,
        row_bytes=_size(dy) + _size(h) + _size(dres),
        cta_vecs=int(weight is not None),
        group_vecs=int(want_w) + int(want_b) + int(want_pb))

    def part(on):
        return torch.empty(plan.grid, cols, dtype=torch.float32,
                           device=dev) if on else None
    pw, pb, ppb = part(want_w), part(want_b), part(want_pb)
    dw = torch.empty(cols, dtype=weight.dtype, device=dev) if want_w else None
    db = torch.empty(cols, dtype=bias_dtype, device=dev) if want_b else None
    dpb = torch.empty(cols, dtype=pre_bias_dtype, device=dev) \
        if want_pb else None
    if rows:
        fn = (fns or _kernels())["fused_norm_bwd"]
        c = functools.partial(dtype_code, what="fused_norm")
        with torch.cuda.device(dev):
            err = fn(ptr(dy), ptr(dres), ptr(h), ptr(mean), ptr(rstd),
                     ptr(weight), ptr(dx), ptr(pw), ptr(pb), ptr(ppb),
                     ptr(dw), ptr(db), ptr(dpb), rows, cols, plan.grid,
                     c(dy.dtype), c(None if dres is None else dres.dtype),
                     c(h.dtype), c(None if weight is None else weight.dtype),
                     c(spec.weight), c(dx_dtype), c(spec.bias),
                     c(bias_dtype), c(spec.add), c(pre_bias_dtype),
                     c(spec.out), c(spec.add), c(spec.norm),
                     int(spec.add is not None), int(spec.kind == "ln"),
                     int(spec.fused), vec, int(plan.ring), *_plan_args(plan),
                     stream(dev))
        _native.check(err, "fused_norm backward kernel launch")
        launches.launched(1, _native.io_cost, dy, dres, h, mean, rstd,
                          weight, dx, dw, db, dpb)
    if dw is not None and weight.shape != dw.shape:
        dw = dw.reshape(weight.shape)
    return dx, dw, db, dpb


class FusedNorm(torch.autograd.Function):
    """The kernel with its backward kernel; outputs ``out`` or, with an
    add, ``(out, h)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, pre_bias, spec):
        ctx.set_materialize_grads(False)
        out, h, mean, rstd = _launch_fwd(x, weight, bias, residual,
                                         pre_bias, spec)
        ctx.save_for_backward(x if h is None else h, mean, rstd, weight)
        ctx.spec = spec
        ctx.dtypes = (x.dtype, None if bias is None else bias.dtype,
                      None if pre_bias is None else pre_bias.dtype)
        ctx.shapes = tuple(None if t is None else t.shape
                           for t in (weight, bias, pre_bias))
        return out if h is None else (out, h)

    @staticmethod
    def backward(ctx, dy, dres=None):
        h, mean, rstd, weight = ctx.saved_tensors
        spec = ctx.spec
        x_dtype, b_dtype, pb_dtype = ctx.dtypes
        need = ctx.needs_input_grad
        if dy is None:
            dy = torch.zeros(h.shape, dtype=spec.out, device=h.device)
        dx, dw, db, dpb = _launch_bwd(
            dy, dres, h, mean, rstd, weight, spec,
            dx_dtype=x_dtype if spec.add is None else spec.add,
            want_w=weight is not None and need[1],
            bias_dtype=b_dtype if need[2] else None,
            pre_bias_dtype=pb_dtype if need[4] else None)
        shapes = ctx.shapes
        if db is not None:
            db = db.reshape(shapes[1])
        if dpb is not None:
            dpb = dpb.reshape(shapes[2])
        return dx, dw, db, dx if need[3] else None, dpb, None


def fused_norm(x, weight=None, bias=None, residual=None, pre_bias=None, *,
               spec: NormSpec) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(out, h)`` as :func:`fused_norm_reference` computes it (``h``:
    None without an add): the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if plain_path(x):
        return fused_norm_reference(x, weight, bias, residual, pre_bias,
                                    spec=spec)
    out = FusedNorm.apply(x, weight, bias, residual, pre_bias, spec)
    return out if spec.add is not None else (out, None)
