"""K10, batch norm with the ResNet and PP-YOLOE blocks' fused tails: the hand-written
Hopper kernel (``csrc/batch_norm.cu``, four launches: the batch statistics
with the running-buffer update, the apply, the backward's per-channel
reduce and its apply) and its plain PyTorch version. The port's own kernel:
the JAX package's ``batch_norm_stats`` and ``batch_norm``
(``paddle_tpu/ops/nn_ops.py:210-264``) are XLA-fused jnp, no Pallas
function.

:func:`batch_norm` takes ``paddle.nn.functional.batch_norm``'s arguments
and two of the port's own: ``act="relu"`` or ``act="swish"`` applies that
activation to the output, and ``residual`` (with an ``act``) adds a tensor
of x's shape before it, ``relu(add(bn(x), residual))``: the tails of
ResNet's blocks, and ``swish(bn(x))`` and ``swish(add(bn(x), residual))``,
those of PP-YOLOE's ``ConvBNLayer`` and ``RepVggBlock``. The casts are the
JAX package's ops' under the active ``amp.auto_cast``: the norm and its
statistics as ``batch_norm`` (black-listed: fp32 under O2), the tail as
``add`` and ``relu`` / ``swish`` (bf16 under O2), so under O2 a
bottleneck's tail is ``relu(bf16(bf16(bn3(x)) + identity))`` as there.
The kernel does the casts as it loads and stores; its statistics are fp32,
its sums fixed in order (bit-equal launches). The backward saves x, the
per-channel mean and biased variance and, with the residual's ReLU tail,
the output (the mask); with a ReLU or swish tail the bias (and
``add_swish``'s residual), from which it recomputes the tail's input at
the apply's rounding points. :func:`bn_plan` chooses how the kernel walks
the view (channels last, a group of channels first, or a run of one
channel) and how wide its loads are.

:func:`batch_norm` runs :func:`batch_norm_reference` for CPU tensors (its
gradients by autograd, its running buffers updated in place) and the
kernel, through :class:`BatchNorm`, for CUDA tensors; any other device
raises. :func:`batch_norm_bwd_reference` is the plain version of the
backward's two launches, from the tensors the forward saved. Where the
kernel differs from the reference by design, see ``ROADMAP.md`` (K10's
divergences).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .. import _native
from ..amp import cast_dtype, cast_inputs
from ._fused_io import cuda_device, dtype_code, plain_path, ptr, stream

__all__ = ["BNPlan", "BNSpec", "TAILS", "batch_norm",
           "batch_norm_bwd_reference", "batch_norm_reference", "bn_geometry",
           "bn_plan", "bn_spec", "launches_bwd", "launches_fwd"]

# csrc/batch_norm.cu: threads a block (at most), values a thread holds in a
# pass of the statistics (and of the other launches), elements of one
# channel a run-route block, and the col route's shared memory (its largest
# kernel's: two values a column of the block and a count a row)
THREADS = 256
STATS_ELEMS = 32
APPLY_ELEMS = 16
RUN_CHUNK = THREADS * STATS_ELEMS
COL_SMEM_BYTES = (2 * THREADS * 8 + THREADS) * 4
# the run route's least S: a step of 256 vectors wraps an image's run at
# most 4 times
RUN_MIN_S = 512
# most channels a launch takes: a grid's y dimension (the run route's
# channels, the col route's groups) holds at most 65535 blocks
MAX_CHANNELS = 65535
TAILS = ("none", "relu", "add_relu", "swish", "add_swish")
# the tails whose backward recomputes the activation's input from x, the
# statistics, the weight and the bias (add_swish: and the residual)
RECOMPUTE_TAILS = ("relu", "swish", "add_swish")
_TAIL_CODE = {t: i for i, t in enumerate(TAILS)}
_ROUTE_CODE = {"cl": 0, "group": 0, "run": 1}
# the kernel's modes (csrc/batch_norm.cu): every tensor and rounding point
# fp32, 4 elements a load; x bf16 under O2 (the norm's rounding points
# fp32, the tail's bf16, the other tensors bf16 or fp32), 8 a load; anything
# else, one
MODES = ("fp32", "bf16", "generic")
_MODE_VEC = {"fp32": 4, "bf16": 8, "generic": 1}

launches_fwd: Dict[str, _native.LaunchCounter] = {
    t: _native.LaunchCounter("batch_norm" + ("" if t == "none" else f"[{t}]"))
    for t in TAILS}
launches_bwd: Dict[str, _native.LaunchCounter] = {
    t: _native.LaunchCounter("batch_norm" + ("" if t == "none" else f"[{t}]")
                             + "_bwd")
    for t in TAILS}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES_OF = {
    "bn_stats": [_P] * 6 + [_F] * 3 + [_P] * 3,
    "bn_apply": [_P] * 7 + [_F] + [_P] * 3,
    "bn_bwd": [_I] + [_P] * 14 + [_F, _I, _I] + [_P] * 3,
}


def bind(lib) -> dict:
    """The C entry points of a built ``batch_norm`` library, typed."""
    fns = {}
    for name, types in _ARGTYPES_OF.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("batch_norm"))


@dataclass(frozen=True)
class BNSpec:
    """The reference's rounding points: ``norm`` the dtype x takes in the
    norm (and the normalised value is rounded to), ``wmul`` / ``badd`` the
    dtypes of ``* weight`` and ``+ bias`` (None: no such operand), ``act``
    the tail's dtype (the ``add``'s and the activation's; None: no tail),
    ``out``
    the output's."""
    norm: torch.dtype
    wmul: Optional[torch.dtype]
    badd: Optional[torch.dtype]
    act: Optional[torch.dtype]
    out: torch.dtype
    tail: str


def bn_spec(x, weight=None, bias=None, residual=None,
            act: Optional[str] = None) -> BNSpec:
    """The rounding points of :func:`batch_norm_reference` on these inputs
    under the active ``auto_cast``."""
    if act not in (None, "relu", "swish"):
        raise ValueError(f"act must be None, 'relu' or 'swish', got {act!r}")
    if residual is not None and act is None:
        raise ValueError("a residual is added only before a ReLU or a swish "
                         "(act='relu' or 'swish'), the ResNet and RepVGG "
                         "blocks' tails")
    norm = cur = cast_dtype("batch_norm", x.dtype)
    wmul = badd = None
    if weight is not None:
        cur = wmul = torch.promote_types(
            cur, cast_dtype("batch_norm", weight.dtype))
    if bias is not None:
        cur = badd = torch.promote_types(
            cur, cast_dtype("batch_norm", bias.dtype))
    if act is None:
        return BNSpec(norm, wmul, badd, None, cur, "none")
    if residual is None:
        a = cast_dtype(act, cur)
        return BNSpec(norm, wmul, badd, a, a, act)
    a = torch.promote_types(cast_dtype("add", cur),
                            cast_dtype("add", residual.dtype))
    if cast_dtype(act, a) != a:
        raise ValueError(f"the add's dtype {a} and the {act}'s "
                         f"{cast_dtype(act, a)} differ under this "
                         "auto_cast; the fused tail takes one")
    return BNSpec(norm, wmul, badd, a, a, "add_" + act)


def _channel_axis(x: torch.Tensor, data_format: str) -> int:
    return 1 if data_format.startswith("NC") else x.dim() - 1


def bn_geometry(x: torch.Tensor, data_format: str) -> Tuple[int, int, int]:
    """``(n, S, C)``: the kernel's (N, C, S) view of contiguous x, ``n = N
    S`` elements a channel. Channels first: (x.shape[0], C, the rest);
    channels last: (all but C, C, 1)."""
    ch = _channel_axis(x, data_format)
    c = int(x.shape[ch])
    if ch == 1:
        rows, s = int(x.shape[0]), math.prod(int(d) for d in x.shape[2:])
    else:
        rows, s = math.prod(int(d) for d in x.shape[:-1]), 1
    return rows * s, s, c


@dataclass(frozen=True)
class BNPlan:
    """How the kernel walks an ``(n, S, C)`` view (``csrc/batch_norm.cu``):
    ``route`` "cl" (channels last, S = 1) or "group" (a group of ``k``
    channels first, each image's ``k S`` elements contiguous) on the col
    kernels, whose block of ``tx x ty`` threads takes ``width = tx vec``
    columns of the ``(rows, C S)`` view (row stride ``rstride``) and
    ``rpc`` rows of a chunk, its grid ``(chunks, groups)``; or "run" (one
    channel first with a large S), a block of 256 threads taking
    ``RUN_CHUNK`` elements of a channel, its grid ``(chunks, C)``.
    ``mode`` (``MODES``) the kernel's dtypes, ``vec`` its elements a load:
    16 bytes of x (4 fp32 or 8 bf16), or one in the generic mode. The
    launch's grid is ``(blocks, grid[1])``, ``blocks`` up to ``chunks`` as
    many as the card holds at once (``csrc/batch_norm.cu``, ``grid_of``),
    each block walking the chunks ``x, x + blocks, ...``; a reducing launch
    writes one partial a block and channel, folded by a second launch."""
    route: str
    mode: str
    vec: int
    n: int
    s: int
    c: int
    chunks: int
    rows: int = 0
    rstride: int = 0
    rpc: int = 0
    width: int = 0
    k: int = 0
    tx: int = 0
    ty: int = 0
    groups: int = 0

    @property
    def threads(self) -> int:
        return THREADS if self.route == "run" else self.tx * self.ty

    @property
    def grid(self) -> Tuple[int, int]:
        """The largest grid: a block a chunk."""
        return (self.chunks, self.c if self.route == "run" else self.groups)

    def partials(self, per: int) -> int:
        """Floats of a reducing launch's partials, ``per`` a channel and
        chunk."""
        return self.chunks * self.c * per

    @functools.cached_property
    def packed(self):
        """The plan as the C entry points read it (``plan_of``)."""
        return (ctypes.c_longlong * 15)(
            _ROUTE_CODE[self.route], self.vec, self.n, self.s, self.c,
            self.chunks, self.rows, self.rstride, self.rpc, self.width,
            self.k, self.tx, self.ty, self.groups, MODES.index(self.mode))


def _col_plan(route, mode, vec, n, s, c, width, k, groups) -> BNPlan:
    """A col-route plan: blocks of ``ty`` rows of ``tx = width / vec``
    threads, a chunk the rows of one pass of the apply (``ty`` times
    ``APPLY_ELEMS / vec`` vectors, one in the generic mode): fine enough
    that the blocks' rounds of chunks come out even."""
    tx = width // vec
    ty = THREADS // tx
    rows = n // s
    rpc = ty * (APPLY_ELEMS // vec if vec > 1 else 1)
    return BNPlan(route, mode, vec, n, s, c, -(-rows // rpc), rows, c * s,
                  rpc, width, k, tx, ty, groups)


def _route(n: int, s: int, c: int, mode: str) -> Optional[BNPlan]:
    """The plan in ``mode`` (at its vector width), or None where no route
    takes it: channels last when the width divides C; channels first, a
    run of a channel when the width divides a large S, else a group of the
    fewest channels whose run is whole vectors (``vec / gcd(S, vec)``)."""
    vec = _MODE_VEC[mode]
    if s == 1:
        if c % vec:
            return None
        nvec = c // vec
        tx = -(-nvec // -(-nvec // 32))     # ceil(nvec / ceil(nvec / 32))
        return _col_plan("cl", mode, vec, n, s, c, tx * vec, tx * vec,
                         -(-c // (tx * vec)))
    if s % vec == 0 and s >= RUN_MIN_S:
        return BNPlan("run", mode, vec, n, s, c, -(-n // RUN_CHUNK))
    k = vec // math.gcd(s, vec)
    if c % k == 0 and k * s // vec <= THREADS:
        return _col_plan("group", mode, vec, n, s, c, k * s, k, c // k)
    if vec == 1:    # S of 257 to 511 elements: one channel's run
        return BNPlan("run", mode, 1, n, s, c, -(-n // RUN_CHUNK))
    return None


@functools.cache
def bn_plan(geo: Tuple[int, int, int], mode: str,
            aligns: Tuple[int, ...]) -> BNPlan:
    """The kernel's plan for the ``(n, S, C)`` view ``geo`` in ``mode``
    (:func:`_mode` of the launch's dtypes), ``aligns`` the largest power of
    two up to 16 that divides the address of each of the launch's
    element-wise tensors: at the mode's 16-byte vectors where every one is
    16-byte aligned and a route takes the shape, else one element a load
    (the generic mode), which every shape takes."""
    if mode != "generic" and min(aligns) >= 16:
        plan = _route(*geo, mode)
        if plan is not None:
            return plan
    return _route(*geo, "generic")


_BF16_OK = (None, torch.float32, torch.bfloat16)


def _mode(dts: dict) -> str:
    """The kernel's mode for a launch's dtypes (``_CODE_ORDER``'s names;
    the weight's and bias's, and their gradients', take any)."""
    if all(d in (None, torch.float32) for d in dts.values()):
        return "fp32"
    if dts.get("x") == torch.bfloat16 \
            and all(dts.get(k) in (None, torch.float32)
                    for k in ("norm", "wmul", "badd")) \
            and dts.get("act") in (None, torch.bfloat16) \
            and all(dts.get(k) in _BF16_OK
                    for k in ("r", "out", "dy", "dx", "dres")):
        return "bf16"
    return "generic"


def _plan(geo, mode: str, *ts: Optional[torch.Tensor]) -> BNPlan:
    """:func:`bn_plan` for a launch on the element-wise tensors ``ts``
    (Nones skipped)."""
    return bn_plan(geo, mode, tuple(min(16, p & -p) for p in (
        t.data_ptr() for t in ts if t is not None)))


def batch_norm_reference(x, running_mean, running_var, weight=None,
                         bias=None, training: bool = False,
                         momentum: float = 0.9, epsilon: float = 1e-5,
                         data_format: str = "NCHW", use_global_stats=None,
                         *, residual=None, act: Optional[str] = None):
    """Plain version, the JAX package's ``batch_norm`` step by step: in
    training (and not ``use_global_stats``) the batch mean and biased
    variance in fp32 (the variance of the deviations), the running buffers
    updated in place (``m r + (1 - m) batch``, the variance times ``n / (n
    - 1)``); the normalised value rounded to x's (cast) dtype, then ``*
    weight + bias``; then the tail, ``act(add(., residual))`` with ``act``
    ReLU or swish (``F.silu``)."""
    bn_spec(x, weight, bias, residual, act)     # validates act / residual
    x, weight, bias = cast_inputs("batch_norm", x, weight, bias)
    ch = _channel_axis(x, data_format)
    axes = [i for i in range(x.dim()) if i != ch]
    shape = [1] * x.dim()
    shape[ch] = -1
    x32 = x.float()
    if training and not use_global_stats:
        mu = x32.mean(axes)
        var = (x32 - mu.view(shape)).square().mean(axes)
        n = x.numel() // max(int(x.shape[ch]), 1)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1.0 - momentum) * mu.to(running_mean.dtype))
            unbiased = var * (n / max(n - 1, 1))
            running_var.copy_(momentum * running_var + (1.0 - momentum)
                              * unbiased.to(running_var.dtype))
    else:
        mu, var = running_mean, running_var
    out = ((x32 - mu.view(shape).float())
           * torch.rsqrt(var.view(shape).float() + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.view(shape)
    if bias is not None:
        out = out + bias.view(shape)
    if residual is not None:
        out, residual = cast_inputs("add", out, residual)
        out = out + residual
    if act is not None:
        (out,) = cast_inputs(act, out)
        out = torch.relu(out) if act == "relu" else \
            torch.nn.functional.silu(out)
    return out


def _view3(t: torch.Tensor, geo) -> torch.Tensor:
    n, s, c = geo
    return t.reshape(n // s, c, s)


def _tail_input(x3, mean, r, weight, bias, res3, spec: BNSpec):
    """The tail's activation input z, recomputed as the apply computes it:
    the normalised value, ``* w``, ``+ b`` each rounded to its dtype, the
    residual added (``add_swish``), rounded to the tail's dtype; fp32. The
    ReLU tail's mask is ``z > 0``, the output's bit for bit."""
    c = x3.shape[1]
    t = ((x3 - mean.float().view(1, c, 1)) * r).to(spec.norm).float()
    if weight is not None:
        t = (t * weight.float().view(1, c, 1)).to(spec.wmul).float()
    if bias is not None:
        t = (t + bias.float().view(1, c, 1)).to(spec.badd).float()
    if spec.tail == "add_swish":
        t = (t.to(spec.act).float() + res3.to(spec.act).float()).to(
            spec.act).float()
    return t.to(spec.act).float()


def batch_norm_bwd_reference(x, dy, out, weight, mean, var, epsilon: float,
                             spec: BNSpec, geo, batch_stats: bool,
                             bias_dtype=None, residual_dtype=None, *,
                             bias=None, residual=None) -> dict:
    """Plain version of the backward's launches on the saved tensors (x,
    the per-channel mean and biased variance; the forward's output for the
    ``add_relu`` mask; the bias, and for ``add_swish`` the residual, where
    the tail's input is recomputed): ``g`` = dy where the tail's input is
    positive (``relu``: z recomputed by :func:`_tail_input`; ``add_relu``:
    the output), any dy without a tail, or for a swish tail ``rnd(dy (s + z
    s (1 - s)))`` with ``s = sigmoid(z)`` and the product rounded to the
    tail's dtype; ``dx = w r (g - sum(g) / n - xhat sum(g xhat) / n)`` with
    batch statistics (``w r g`` without), ``dw = sum(g xhat)``, ``db =
    sum(g)``, the residual's gradient ``g``; fp32 throughout, each rounded
    to its tensor's dtype. ``{"dx", "dw", "db", "dres"}`` (None where there
    is no such tensor)."""
    n, s, c = geo
    g = _view3(dy, geo).float()
    r = torch.rsqrt(var.float() + epsilon).view(1, c, 1)
    x3 = _view3(x, geo).float()
    if spec.tail in RECOMPUTE_TAILS:
        z = _tail_input(x3, mean, r, weight, bias,
                        None if residual is None else _view3(residual, geo),
                        spec)
        if spec.tail == "relu":
            g = torch.where(z > 0, g, 0.0)
        else:
            sg = 1.0 / (1.0 + torch.exp(-z))
            g = (g * (sg + z * sg * (1.0 - sg))).to(spec.act).float()
    elif spec.tail != "none":
        g = torch.where(_view3(out, geo) > 0, g, 0.0)
    xh = (x3 - mean.float().view(1, c, 1)) * r
    sg, sgx = g.sum((0, 2)), (g * xh).sum((0, 2))
    w = 1.0 if weight is None else weight.float().reshape(1, c, 1)
    if batch_stats:
        d = w * r * (g - sg.view(1, c, 1) / n - xh * sgx.view(1, c, 1) / n)
    else:
        d = w * r * g
    return {"dx": d.to(x.dtype).reshape(x.shape),
            "dw": None if weight is None else sgx.to(weight.dtype).view(
                weight.shape),
            "db": None if bias_dtype is None else sg.to(bias_dtype),
            "dres": None if residual_dtype is None else g.to(
                residual_dtype).reshape(x.shape)}


# the order of the dtype codes a launch passes (csrc/batch_norm.cu,
# codes_of), before the tail
_CODE_ORDER = ("x", "w", "b", "r", "out", "dy", "dx", "dres", "dw", "db",
               "norm", "wmul", "badd", "act")


@functools.cache
def _codes_array(dts: tuple, tail: str):
    """``(codes, mode)``: the C array of the dtype codes (absent tensors
    fp32) and the tail, and the kernel's mode for these dtypes."""
    codes = [dtype_code(d, "batch_norm") for d in dts]
    return ((ctypes.c_int * 15)(*codes, _TAIL_CODE[tail]),
            _mode(dict(zip(_CODE_ORDER, dts))))


def _codes(tail: str, **dts):
    """:func:`_codes_array` of the dtypes by name (absent: None)."""
    return _codes_array(tuple(dts.get(k) for k in _CODE_ORDER), tail)


def _dt(t: Optional[torch.Tensor]):
    return None if t is None else t.dtype


def _launch_stats(x, running_mean, running_var, momentum, geo, update: bool):
    n, s, c = geo
    dev = x.device
    codes, mode = _codes("none", x=x.dtype)
    plan = _plan(geo, mode, x)
    part = torch.empty(plan.partials(3), dtype=torch.float32, device=dev)
    mean = torch.empty(c, dtype=torch.float32, device=dev)
    var = torch.empty(c, dtype=torch.float32, device=dev)
    unbias = n / max(n - 1, 1)
    with torch.cuda.device(dev):
        err = _kernels()["bn_stats"](
            ptr(x), ptr(part), ptr(mean), ptr(var),
            ptr(running_mean) if update else None,
            ptr(running_var) if update else None, momentum, 1.0 - momentum,
            unbias, plan.packed, codes, stream(dev))
    _native.check(err, "batch_norm stats kernel launch")
    return mean, var


def _launch_apply(x, weight, bias, residual, mean, var, eps, spec: BNSpec,
                  geo):
    dev = x.device
    out = torch.empty(x.shape, dtype=spec.out, device=dev)
    codes, mode = _codes(spec.tail, x=x.dtype, w=_dt(weight), b=_dt(bias),
                         r=_dt(residual), out=spec.out, norm=spec.norm,
                         wmul=spec.wmul, badd=spec.badd, act=spec.act)
    plan = _plan(geo, mode, x, residual, out)
    with torch.cuda.device(dev):
        err = _kernels()["bn_apply"](
            ptr(x), ptr(weight), ptr(bias), ptr(residual), ptr(out),
            ptr(mean), ptr(var), eps, plan.packed, codes, stream(dev))
    _native.check(err, "batch_norm apply kernel launch")
    return out


def _reduces(dw, db, dx, batch_stats: bool) -> bool:
    """Whether the backward runs its reduce: for dw, db, or a dx with batch
    statistics."""
    return dw is not None or db is not None or (dx is not None
                                                and batch_stats)


def _gres(spec: BNSpec, dw, db, dx, dres, batch_stats: bool) -> bool:
    """Whether the reduce writes the gradient at the tail's input into
    dres (the residual's gradient, exactly: dres has the tail's dtype) and
    the apply reads it back for dx instead of the tail again."""
    return dres is not None and dres.dtype == spec.act \
        and _reduces(dw, db, dx, batch_stats)


def _bwd_plan(spec: BNSpec, geo, x, dy, out, weight, bias, residual, dw, db,
              dx, dres):
    """``(plan, codes)`` of both backward launches (the reduce's partials
    sized by the plan)."""
    codes, mode = _codes(spec.tail, x=x.dtype, w=_dt(weight), b=_dt(bias),
                         r=_dt(residual), out=_dt(out), dy=dy.dtype,
                         dx=_dt(dx), dres=_dt(dres), dw=_dt(dw), db=_dt(db),
                         norm=spec.norm, wmul=spec.wmul, badd=spec.badd,
                         act=spec.act)
    return _plan(geo, mode, x, dy, out, residual, dx, dres), codes


def _launch_bwd(phase: int, x, dy, out, weight, mean, var, eps, spec, geo,
                part, sums, dw, db, dx, dres, batch_stats: bool, bias=None,
                residual=None):
    dev = x.device
    plan, codes = _bwd_plan(spec, geo, x, dy, out, weight, bias, residual,
                            dw, db, dx, dres)
    if phase == 0 and part.numel() < plan.partials(2):
        raise ValueError(f"batch_norm backward: {part.numel()} partials for "
                         f"{plan.partials(2)}")
    with torch.cuda.device(dev):
        err = _kernels()["bn_bwd"](
            phase, ptr(x), ptr(dy), ptr(out), ptr(weight), ptr(bias),
            ptr(residual), ptr(mean), ptr(var), ptr(part), ptr(sums),
            ptr(dw), ptr(db), ptr(dx), ptr(dres), eps, int(batch_stats),
            int(_gres(spec, dw, db, dx, dres, batch_stats)), plan.packed,
            codes, stream(dev))
    _native.check(err, "batch_norm backward kernel launch")


def _check(x, running_mean, running_var, weight, bias, residual, geo):
    dev = cuda_device("batch_norm", x, running_mean, running_var, weight,
                      bias, residual)
    n, _, c = geo
    if not 0 < n < 2 ** 31 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"batch_norm kernel: {n} elements a channel and "
                         f"{c} channels; it takes 1 to 2^31 - 1 and 1 to "
                         f"{MAX_CHANNELS}")
    for name, b in (("running_mean", running_mean),
                    ("running_var", running_var)):
        if b.dtype != torch.float32 or b.shape != (c,) \
                or not b.is_contiguous():
            raise ValueError(f"batch_norm kernel: {name} must be a "
                             f"contiguous fp32 ({c},) buffer, got "
                             f"{b.dtype} {tuple(b.shape)}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p is not None and p.numel() != c:
            raise ValueError(f"batch_norm kernel: {name} has {p.numel()} "
                             f"elements for {c} channels")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"batch_norm kernel: residual {tuple(residual.shape)}"
                         f" for x {tuple(x.shape)}")
    return dev


class BatchNorm(torch.autograd.Function):
    """The kernel's forward (stats with the running update, then apply; the
    apply alone on the running statistics) and its backward (reduce, then
    apply)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                batch_stats, momentum, eps, spec, geo):
        x = x.contiguous()
        residual = None if residual is None else residual.contiguous()
        weight = None if weight is None else weight.contiguous()
        bias = None if bias is None else bias.contiguous()
        if batch_stats:
            mean, var = _launch_stats(x, running_mean, running_var,
                                      momentum, geo, True)
        else:
            mean, var = running_mean, running_var
        out = _launch_apply(x, weight, bias, residual, mean, var, eps, spec,
                            geo)
        launches_fwd[spec.tail].launched(
            2 if batch_stats else 1, _native.io_cost, x, residual, out,
            *([x] if batch_stats else []))
        # the backward's mask or swish input: the output's sign (add_relu),
        # else recomputed from x, the statistics, the weight, the bias (and
        # add_swish's residual)
        recompute = spec.tail in RECOMPUTE_TAILS
        ctx.save_for_backward(
            x, weight, mean, var, out if spec.tail == "add_relu" else None,
            bias if recompute else None,
            residual if spec.tail == "add_swish" else None)
        ctx.cfg = (batch_stats, eps, spec, geo,
                   None if bias is None else bias.dtype,
                   None if residual is None else residual.dtype)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, var, out, bias, residual = ctx.saved_tensors
        batch_stats, eps, spec, geo, b_dt, r_dt = ctx.cfg
        need = ctx.needs_input_grad
        dev = x.device
        dy = dy.contiguous()
        c = geo[2]
        sums = torch.empty(2 * c, dtype=torch.float32, device=dev)
        dw = torch.empty(c, dtype=weight.dtype, device=dev) \
            if weight is not None and need[1] else None
        db = torch.empty(c, dtype=b_dt, device=dev) \
            if b_dt is not None and need[2] else None
        dx = torch.empty(x.shape, dtype=x.dtype, device=dev) \
            if need[0] else None
        dres = torch.empty(x.shape, dtype=r_dt, device=dev) \
            if r_dt is not None and need[3] else None
        plan, _ = _bwd_plan(spec, geo, x, dy, out, weight, bias, residual,
                            dw, db, dx, dres)
        part = torch.empty(plan.partials(2), dtype=torch.float32, device=dev)
        args = (x, dy, out, weight, mean, var, eps, spec, geo, part, sums,
                dw, db, dx, dres, batch_stats)
        # the recomputing tails read the bias (and add_swish the residual)
        extra = {"bias": bias, "residual": residual} \
            if spec.tail in RECOMPUTE_TAILS else {}
        calls = 0
        if _reduces(dw, db, dx, batch_stats):
            _launch_bwd(0, *args, **extra)
            calls += 1
        # the reduce has written dres already where _gres
        if dx is not None or (dres is not None and not _gres(
                spec, dw, db, dx, dres, batch_stats)):
            _launch_bwd(1, *args, **extra)
            calls += 1
        if calls:
            launches_bwd[spec.tail].launched(calls, _native.io_cost, x, dy,
                                             out, residual, dx, dres)
        wgrad = None if dw is None else dw.view(weight.shape)
        return (dx, wgrad, db, dres, None, None, None, None, None, None,
                None)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats=None, *, residual=None,
               act: Optional[str] = None):
    """``paddle.nn.functional.batch_norm`` with the fused tail (module
    docstring): the plain version for CPU tensors, K10 for CUDA tensors.
    The running buffers (fp32) are updated in place in training."""
    if plain_path(x):
        return batch_norm_reference(
            x, running_mean, running_var, weight, bias, training, momentum,
            epsilon, data_format, use_global_stats, residual=residual,
            act=act)
    spec = bn_spec(x, weight, bias, residual, act)
    geo = bn_geometry(x, data_format)
    _check(x, running_mean, running_var, weight, bias, residual, geo)
    return BatchNorm.apply(x, weight, bias, residual, running_mean,
                           running_var, bool(training and not
                                             use_global_stats),
                           float(momentum), float(epsilon), spec, geo)
