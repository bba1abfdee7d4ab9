"""``act(y + b)``, a linear layer's bias add and activation: the
hand-written Hopper kernel (``csrc/bias_act.cu``, forward and backward) and
its plain PyTorch version. The port's own kernel: the JAX package leaves
matmul + bias + activation to XLA's fusion (``paddle_tpu/incubate/
nn_functional.py:212`` ``fused_linear_activation``, the encoder layer's
``linear1`` -> activation), no Pallas function.

``act`` is ``"none"`` (identity), ``"relu"``, ``"gelu"`` (erf form) or
``"gelu_tanh"``. The casts are the plain ops' under ``amp.auto_cast``, held
in :class:`ActSpec`: the add's result dtype ``h`` (``y + b`` promoted) and
the activation's dtype ``a`` (its input cast and its output). The kernel
rounds where the plain ops round: the add to ``h``, the cast to ``a``, the
activation to ``a`` (torch computes each op in fp32 and rounds once; the
JAX package rounds GELU's erf form after each primitive, ROADMAP Queue C).
Its backward reads the saved ``y`` and ``b`` and recomputes the
pre-activation (no activation is saved); the bias gradient is summed in
fp32 per run of rows (:func:`launch_plan`) and the partials folded in a
fixed order, so every launch gives the same bits. With ``period=P`` the
bias holds one row for each P rows (the expert-choice MoE's ``(E, 1, I)``
bias over ``E x C`` rows: P = C), one launch for all of them; the bias
gradient has a row for each.

:func:`bias_act` runs :func:`bias_act_reference` for CPU tensors (gradients
by autograd) and the kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .. import _native
from ._fused_io import (aligned16, cuda_device, dtype_code, plain_path,
                        ptr, stream)

__all__ = ["ACTS", "ActSpec", "LaunchPlan", "bias_act",
           "bias_act_bwd_reference", "bias_act_reference", "launch_plan",
           "launches"]

launches = _native.LaunchCounter("bias_act")
ACTS = {"none": 0, "relu": 1, "gelu": 2, "gelu_tanh": 3}

_ARGTYPES_OF = {
    "bias_act_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
    + [ctypes.c_void_p],
    "bias_act_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15
    + [ctypes.c_void_p],
    "bias_act_tables": [ctypes.c_int] + [ctypes.c_void_p] * 3,
    "bias_act_table_size": [],
}

TX = 32          # threads of a CTA along the columns (csrc TX)
MAX_TY = 8       # warps of a CTA along the rows (csrc MAX_TY)
# rows a warp takes, the plan's choices in order: the most that still leave
# a thread for each of the card's 2048 an SM (four rows in flight a
# thread); a lookup launch the fewest of RT_STAGED that put its runs in one
# wave of the CTAs that fit, else RT_WALK (forward, backward), its CTAs
# walking runs (at the MoE's (8192, 14336) on an H100, 2 and 4 rows a warp
# were 10% and 4% faster than 8: PERF.md §6, K6)
RT_FWD = (4, 2, 1)
RT_BWD = (4, 2, 1)
# a forward of fp32 rows holds one in flight (csrc fwd_rows_in_flight): a
# row a warp
RT_FWD_WIDE = 1
RT_STAGED = (4, 8, 16)
RT_WALK = {False: 2, True: 4}
MAX_GRID_Y = 65535
INDEX_LIMIT = 2 ** 31
# the activations the kernel looks up in a table (bf16 throughout, vectors
# of 8), from calls of this many elements up: a smaller call does not pay
# for each CTA's copy of the table
TABLE_ACTS = ("gelu", "gelu_tanh")
TABLE_MIN = 2 ** 20
# CTAs of a lookup launch that fit an SM, forward and backward (csrc
# staged_smem and its launch bounds)
STAGED_CTAS = {False: 4, True: 3}


class LaunchPlan(NamedTuple):
    """One launch: CTAs of ``threads`` = 32 x ``ty``, a column strip of
    32 threads of ``vec`` columns each (``grid_y`` strips) by ``ty`` warps
    of ``rt`` consecutive rows each; a run is ``ty x rt`` rows of one bias
    period of ``period`` rows, ``bpp`` runs a period, ``runs`` = bias rows
    x ``bpp`` in all; CTA x of a strip takes runs x, x + ``grid_x``, ...
    The backward writes one fp32 column partial a run (``runs`` rows of
    them) and folds bias row e's, rows ``e bpp .. e bpp + bpp - 1``, in
    order. ``table``: the activation is looked up (:data:`TABLE_ACTS`),
    the rows streamed through a ``cp.async`` ring."""
    vec: int
    threads: int
    ty: int
    rt: int
    bpp: int
    runs: int
    grid_x: int
    grid_y: int
    period: int
    table: bool


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def launch_plan(rows: int, n: int, vec: int, sms: int, *,
                period: Optional[int] = None, backward: bool = False,
                table: bool = False, wide: bool = False,
                rt: Optional[int] = None, ty: int = MAX_TY,
                ctas: Optional[int] = None) -> LaunchPlan:
    """The launch over ``rows`` rows of ``n`` columns in vectors of ``vec``
    (8 or 1) on a card of ``sms`` SMs, one bias row for each ``period``
    rows (None: one for all); ``table``: the call may look its activation
    up, which it does from :data:`TABLE_MIN` elements; ``wide``: y is
    fp32. A warp takes the most rows of ``RT_FWD`` / ``RT_BWD`` that still
    leave a thread for each of the card's 2048 an SM (a forward of fp32
    rows :data:`RT_FWD_WIDE`), a CTA a run; a lookup launch no more CTAs
    than fit at once (:data:`STAGED_CTAS` an SM), the fewest rows of
    ``RT_STAGED`` that put all its runs in one wave of them, else
    ``RT_WALK``, each CTA walking runs. ``rt``, ``ty`` and ``ctas`` (a
    lookup launch's CTAs an SM) override the choices (the variants tool
    measures them)."""
    p = period or rows
    strips = _ceil(n // vec, TX)
    if strips > MAX_GRID_Y:
        raise ValueError(f"bias_act: {n} columns in vectors of {vec} need "
                         f"{strips} column strips, more than {MAX_GRID_Y}")
    if not 1 <= ty <= MAX_TY:
        raise ValueError(f"bias_act: {ty} warps a CTA")
    table = table and vec == 8 and rows * n >= TABLE_MIN
    if ctas is None and table:
        ctas = STAGED_CTAS[backward]

    def runs_of(r):
        return (rows // p) * _ceil(p, ty * r)
    if rt is None and table:
        cap = max(1, ctas * sms // strips)
        rt = next((r for r in RT_STAGED if runs_of(r) <= cap),
                  RT_WALK[backward])
    elif rt is None and wide and not backward:
        rt = RT_FWD_WIDE
    elif rt is None:
        choices = RT_BWD if backward else RT_FWD
        rt = next((r for r in choices
                   if rows * strips * TX // r >= 2048 * sms), choices[-1])
    bpp = _ceil(p, ty * rt)
    runs = runs_of(rt)
    # a lookup launch's CTAs walk runs: no more of them than fit at once;
    # any other launch a CTA a run
    grid_x = max(1, min(runs, ctas * sms // strips)) if table else runs
    return LaunchPlan(vec, TX * ty, ty, rt, bpp, runs, grid_x, strips, p,
                      table)


def _plan_args(plan: LaunchPlan) -> tuple:
    return (plan.vec, plan.runs, plan.grid_x, plan.grid_y, plan.threads,
            plan.bpp, plan.rt)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_size(what: str, *ts) -> None:
    if any(t is not None and t.numel() >= INDEX_LIMIT for t in ts):
        raise ValueError(f"bias_act: the kernel indexes tensors of fewer "
                         f"than 2^31 elements, got {what} "
                         f"{[tuple(t.shape) for t in ts if t is not None]}")


def bind(lib) -> dict:
    """The C entry points of a built ``bias_act`` library, typed."""
    fns = {}
    for name, types in _ARGTYPES_OF.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("bias_act"))


@functools.cache
def _tables(index: int, act: str):
    """``(forward, backward)`` tables of ``act`` on card ``index``: the
    activation's bf16 bits and its derivative factor (fp32) for every bf16
    pre-activation of magnitude in [2^-16, 16), computed by the kernel's own
    functions on the card, once a process (``bias_act_tables``)."""
    dev = torch.device("cuda", index)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("bias_act: the activation tables are built on "
                           "the first eager call, not inside a capture")
    fns = _kernels()
    size = fns["bias_act_table_size"]()
    fwd = torch.empty(size, dtype=torch.int16, device=dev)
    bwd = torch.empty(size, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fns["bias_act_tables"](ACTS[act], ptr(fwd), ptr(bwd),
                                     stream(dev))
        _native.check(err, "bias_act tables kernel launch")
        # later launches may run on other streams
        torch.cuda.current_stream(dev).synchronize()
    return fwd, bwd


def _table_ok(y, b, spec: ActSpec) -> bool:
    """Whether the call's set can look its activation up: a GELU form,
    bf16 throughout."""
    bf = torch.bfloat16
    return (spec.act in TABLE_ACTS and y.dtype == bf and spec.h == bf
            and spec.a == bf and (b is None or b.dtype == bf))


@dataclass(frozen=True)
class ActSpec:
    """The activation and the plain ops' dtypes: ``h`` of ``y + b``, ``a``
    of the activation's input cast and output."""
    act: str
    h: torch.dtype
    a: torch.dtype


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(h)
    if act in ("gelu", "gelu_tanh"):
        return torch.nn.functional.gelu(
            h, approximate="tanh" if act == "gelu_tanh" else "none")
    if act != "none":
        raise ValueError(f"activation must be one of {sorted(ACTS)}, got "
                         f"{act!r}")
    return h


def _add_bias(y: torch.Tensor, b: torch.Tensor,
              period: Optional[int]) -> torch.Tensor:
    if not period:
        return y + b
    n = y.shape[-1]
    return (y.reshape(-1, period, n) + b.reshape(-1, 1, n)).view(y.shape)


def bias_act_reference(y: torch.Tensor, b: Optional[torch.Tensor],
                       spec: ActSpec,
                       period: Optional[int] = None) -> torch.Tensor:
    """Plain version: ``act((y + b).to(a))``, each op rounding as torch's
    does; with ``period`` row r adds bias row ``r // period``."""
    h = y if b is None else _add_bias(y, b, period)
    return _act(h.to(spec.a), spec.act)


def bias_act_bwd_reference(y, b, dy, spec: ActSpec,
                           period: Optional[int] = None):
    """``(dy_y, db)`` of the plain version, by autograd (db None without
    b)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (y, b)
                  if t is not None]
        out = bias_act_reference(leaves[0], leaves[1] if b is not None
                                 else None, spec, period)
        grads = torch.autograd.grad(out, leaves, dy)
    return grads[0], grads[1] if b is not None else None


def _flat(y: torch.Tensor):
    n = y.shape[-1]
    return y.contiguous(), (y.numel() // n if n else 0), n


def _vec(n: int, *ts) -> int:
    return 8 if n % 8 == 0 and aligned16(*ts) else 1


def _bias_rows(b, rows: int, n: int, period: Optional[int]) -> int:
    """How many bias rows b must hold, checked against its size."""
    want = rows // period if period else 1
    if period and rows % period:
        raise ValueError(f"bias_act: {rows} rows are not a multiple of the "
                         f"bias period {period}")
    if b is not None and b.numel() != want * n:
        raise ValueError(f"bias_act: bias of {b.numel()} for {want} bias "
                         f"rows of {n}")
    return want


def _launch_fwd(y, b, spec: ActSpec, period: Optional[int] = None,
                fns=None, plan=None):
    """``plan``: a :func:`launch_plan` in place of the wrapper's own (the
    variants tool)."""
    dev = cuda_device("bias_act", y, b)
    y, rows, n = _flat(y)
    b = None if b is None else b.contiguous()
    _bias_rows(b, rows, n, period)
    _check_size("y", y)
    out = torch.empty(y.shape, dtype=spec.a, device=dev)
    if rows and n:
        c = functools.partial(dtype_code, what="bias_act")
        plan = plan or launch_plan(rows, n, _vec(n, y, b, out),
                                   _sm_count(dev.index), period=period,
                                   table=_table_ok(y, b, spec),
                                   wide=y.dtype == torch.float32)
        table = _tables(dev.index, spec.act)[0] if plan.table else None
        with torch.cuda.device(dev):
            err = (fns or _kernels())["bias_act_fwd"](
                ptr(y), ptr(b), ptr(out), ptr(table), rows, plan.period, n,
                ACTS[spec.act], c(y.dtype),
                c(None if b is None else b.dtype), c(spec.h), c(spec.a),
                *_plan_args(plan), stream(dev))
        _native.check(err, "bias_act forward kernel launch")
        launches.launched(1, _native.io_cost, y, b, out)
    return out


def _launch_bwd(y, b, dy, spec: ActSpec, period: Optional[int] = None,
                fns=None, plan=None):
    """``(dy_y, db)``: the gradients of y and of the bias (None without)."""
    dev = cuda_device("bias_act", y, b, dy)
    y, rows, n = _flat(y)
    dy = dy.contiguous()
    b = None if b is None else b.contiguous()
    bias_rows = _bias_rows(b, rows, n, period)
    _check_size("y", y)
    dyy = torch.empty(y.shape, dtype=y.dtype, device=dev)
    db = None if b is None else torch.empty(bias_rows * n, dtype=b.dtype,
                                            device=dev)
    if rows and n:
        c = functools.partial(dtype_code, what="bias_act")
        plan = plan or launch_plan(rows, n, _vec(n, y, b, dy, dyy),
                                   _sm_count(dev.index), period=period,
                                   backward=True,
                                   table=_table_ok(y, b, spec))
        table = _tables(dev.index, spec.act)[1] if plan.table else None
        part = None if b is None else torch.empty(
            (plan.runs, n), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = (fns or _kernels())["bias_act_bwd"](
                ptr(y), ptr(b), ptr(dy), ptr(dyy), ptr(part), ptr(db),
                ptr(table), rows, plan.period, n, ACTS[spec.act], c(y.dtype),
                c(None if b is None else b.dtype), c(spec.h), c(spec.a),
                *_plan_args(plan), stream(dev))
        _native.check(err, "bias_act backward kernel launch")
        launches.launched(1, _native.io_cost, y, b, dy, dyy, db)
    elif db is not None:
        db.zero_()
    return dyy, None if db is None else db.view(b.shape)


class BiasAct(torch.autograd.Function):
    """The kernel with its backward kernel; saves y and b only."""

    @staticmethod
    def forward(ctx, y, b, spec, period):
        ctx.save_for_backward(y, b)
        ctx.spec, ctx.period = spec, period
        return _launch_fwd(y, b, spec, period)

    @staticmethod
    def backward(ctx, dy):
        y, b = ctx.saved_tensors
        dyy, db = _launch_bwd(y, b, dy, ctx.spec, ctx.period)
        return dyy, db, None, None


def bias_act(y: torch.Tensor, b: Optional[torch.Tensor],
             spec: ActSpec, period: Optional[int] = None) -> torch.Tensor:
    """``act(y + b)`` over y's last axis (b of that length, or None; with
    ``period``, one bias row for each ``period`` rows of y): the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if spec.act not in ACTS:
        raise ValueError(f"activation must be one of {sorted(ACTS)}, got "
                         f"{spec.act!r}")
    if plain_path(y):
        return bias_act_reference(y, b, spec, period)
    return BiasAct.apply(y, b, spec, period)
