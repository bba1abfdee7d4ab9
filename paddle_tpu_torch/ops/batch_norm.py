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
per-channel mean and biased variance and, with a ReLU tail, the output
(the ReLU mask); with a swish tail, which its output cannot invert, the
bias and the residual, from which it recomputes the swish's input.

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
from ._fused_io import cuda_device, divider, dtype_code, plain_path, ptr, stream

__all__ = ["BNSpec", "TAILS", "batch_norm", "batch_norm_bwd_reference",
           "batch_norm_reference", "bn_geometry", "bn_spec",
           "launches_bwd", "launches_fwd"]

# csrc/batch_norm.cu: elements of one channel a block
CHUNK = 4096
# most channels a launch takes: its grid is (chunks, C), and a grid's y
# dimension holds at most 65535 blocks
MAX_CHANNELS = 65535
TAILS = ("none", "relu", "add_relu", "swish", "add_swish")
# the tails whose backward recomputes the activation's input
SWISH_TAILS = ("swish", "add_swish")
_TAIL_CODE = {t: i for i, t in enumerate(TAILS)}

launches_fwd: Dict[str, _native.LaunchCounter] = {
    t: _native.LaunchCounter("batch_norm" + ("" if t == "none" else f"[{t}]"))
    for t in TAILS}
launches_bwd: Dict[str, _native.LaunchCounter] = {
    t: _native.LaunchCounter("batch_norm" + ("" if t == "none" else f"[{t}]")
                             + "_bwd")
    for t in TAILS}

_P, _I, _LL, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_uint)
_GEO = [_LL, _LL, _I, _I, _U, _I]
_ARGTYPES_OF = {
    "bn_stats": [_P, _I] + _GEO + [_P] * 6 + [_F] * 3 + [_P],
    "bn_apply": [_P] * 7 + _GEO + [_F] + [_I] * 10 + [_P],
    "bn_bwd": [_I] + [_P] * 6 + _GEO + [_F] + [_I] * 5 + [_P] * 2
    + [_I] * 6 + [_P] * 5
    + [_I] * 2 + [_P] * 2 + [_I] * 3 + [_P],
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


_tickets: Dict[torch.device, torch.Tensor] = {}


def _ticket_buffer(dev: torch.device) -> torch.Tensor:
    """The device's tickets of the last-block fold: zero between launches
    (each channel's last block puts its ticket back), made once per device
    (so before any capture: an eager call comes first)."""
    t = _tickets.get(dev)
    if t is None:
        t = _tickets[dev] = torch.zeros(MAX_CHANNELS, dtype=torch.int32,
                                        device=dev)
    return t


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


def _swish_input(x3, mean, r, weight, bias, res3, spec: BNSpec):
    """The swish tails' activation input z, recomputed as the apply
    computes it: the normalised value, ``* w``, ``+ b`` each rounded to
    its dtype, the residual added (``add_swish``), rounded to the tail's
    dtype; fp32."""
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
    the forward's output for the ReLU mask, the per-channel mean and
    biased variance; for a swish tail the bias and the residual instead of
    the output): ``g`` = dy where the output is positive (any output
    without a tail), or for a swish tail ``rnd(dy (s + z s (1 - s)))``
    with ``s = sigmoid(z)``, z the swish's input recomputed
    (:func:`_swish_input`) and the product rounded to the tail's dtype;
    ``dx = w r (g - sum(g) / n - xhat sum(g xhat) / n)`` with batch
    statistics (``w r g`` without), ``dw = sum(g xhat)``, ``db = sum(g)``,
    the residual's gradient ``g``; fp32 throughout, each rounded to its
    tensor's dtype. ``{"dx", "dw", "db", "dres"}`` (None where there is no
    such tensor)."""
    n, s, c = geo
    g = _view3(dy, geo).float()
    r = torch.rsqrt(var.float() + epsilon).view(1, c, 1)
    x3 = _view3(x, geo).float()
    if spec.tail in SWISH_TAILS:
        z = _swish_input(x3, mean, r, weight, bias,
                         None if residual is None else _view3(residual, geo),
                         spec)
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


def _codes(*dts):
    return [dtype_code(d, "batch_norm") for d in dts]


def _launch_stats(x, running_mean, running_var, momentum, geo, update: bool):
    n, s, c = geo
    dev = x.device
    chunks = -(-n // CHUNK)
    magic, shift = divider(s)
    part = torch.empty(c * chunks * 3, dtype=torch.float32, device=dev)
    mean = torch.empty(c, dtype=torch.float32, device=dev)
    var = torch.empty(c, dtype=torch.float32, device=dev)
    unbias = n / max(n - 1, 1)
    with torch.cuda.device(dev):
        err = _kernels()["bn_stats"](
            ptr(x), *_codes(x.dtype), n, s, c, chunks, magic, shift,
            ptr(part), ptr(_ticket_buffer(dev)), ptr(mean), ptr(var),
            ptr(running_mean) if update else None,
            ptr(running_var) if update else None, momentum, 1.0 - momentum,
            unbias, stream(dev))
    _native.check(err, "batch_norm stats kernel launch")
    return mean, var


def _launch_apply(x, weight, bias, residual, mean, var, eps, spec: BNSpec,
                  geo):
    n, s, c = geo
    dev = x.device
    out = torch.empty(x.shape, dtype=spec.out, device=dev)
    chunks = -(-n // CHUNK)
    magic, shift = divider(s)
    wd = None if weight is None else weight.dtype
    bd = None if bias is None else bias.dtype
    rd = None if residual is None else residual.dtype
    with torch.cuda.device(dev):
        err = _kernels()["bn_apply"](
            ptr(x), ptr(weight), ptr(bias), ptr(residual), ptr(out),
            ptr(mean), ptr(var), n, s, c, chunks, magic, shift, eps,
            *_codes(x.dtype, wd, bd, rd, spec.out, spec.norm, spec.wmul,
                    spec.badd, spec.act), _TAIL_CODE[spec.tail],
            stream(dev))
    _native.check(err, "batch_norm apply kernel launch")
    return out


def _launch_bwd(phase: int, x, dy, out, weight, mean, var, eps, spec, geo,
                part, sums, dw, db, dx, dres, batch_stats: bool, bias=None,
                residual=None):
    n, s, c = geo
    dev = x.device
    chunks = -(-n // CHUNK)
    magic, shift = divider(s)
    wd = None if weight is None else weight.dtype
    with torch.cuda.device(dev):
        err = _kernels()["bn_bwd"](
            phase, ptr(x), ptr(dy), ptr(out), ptr(weight), ptr(mean),
            ptr(var), n, s, c, chunks, magic, shift, eps,
            *_codes(x.dtype, dy.dtype, None if out is None else out.dtype,
                    wd), _TAIL_CODE[spec.tail], ptr(bias), ptr(residual),
            *_codes(None if bias is None else bias.dtype,
                    None if residual is None else residual.dtype, spec.norm,
                    spec.wmul, spec.badd, spec.act), ptr(part),
            ptr(_ticket_buffer(dev)), ptr(sums), ptr(dw), ptr(db),
            *_codes(None if dw is None else dw.dtype,
                    None if db is None else db.dtype), ptr(dx), ptr(dres),
            *_codes(None if dx is None else dx.dtype,
                    None if dres is None else dres.dtype),
            int(batch_stats), stream(dev))
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
        swish = spec.tail in SWISH_TAILS
        ctx.save_for_backward(
            x, weight, mean, var,
            out if spec.tail != "none" and not swish else None,
            bias if swish else None, residual if swish else None)
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
        n, _, c = geo
        chunks = -(-n // CHUNK)
        part = torch.empty(c * chunks * 2, dtype=torch.float32, device=dev)
        sums = torch.empty(2 * c, dtype=torch.float32, device=dev)
        dw = torch.empty(c, dtype=weight.dtype, device=dev) \
            if weight is not None and need[1] else None
        db = torch.empty(c, dtype=b_dt, device=dev) \
            if b_dt is not None and need[2] else None
        dx = torch.empty(x.shape, dtype=x.dtype, device=dev) \
            if need[0] else None
        dres = torch.empty(x.shape, dtype=r_dt, device=dev) \
            if r_dt is not None and need[3] else None
        args = (x, dy, out, weight, mean, var, eps, spec, geo, part, sums,
                dw, db, dx, dres, batch_stats)
        # the swish tails' recompute reads the bias and the residual
        extra = {"bias": bias, "residual": residual} \
            if spec.tail in SWISH_TAILS else {}
        calls = 0
        if dw is not None or db is not None or (dx is not None
                                                and batch_stats):
            _launch_bwd(0, *args, **extra)
            calls += 1
        if dx is not None or dres is not None:
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
