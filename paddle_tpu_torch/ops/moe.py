"""K9 ``moe_route``: the Mixture-of-Experts dispatch and combine by index,
the hand-written Hopper kernel (``csrc/moe.cu``, forward and backward) and
its plain PyTorch version. The port's own kernel: the JAX package routes
with XLA-fused jnp, one-hot einsums over ``(tokens, experts, capacity)``
in ``MoELayer`` (``paddle_tpu/incubate/moe.py:75-77, :153, :169``) and a
gather and a scatter-add in the expert-choice MoE
(``paddle_tpu/incubate/nn.py:230, :236-238``), no Pallas function.

A :class:`Routes` table, built on the device from the gate's picks with
tensor ops and no host read (so a step that routes can be captured), says
where each token goes: route ``r`` of token ``t`` lies in ``ptr[t] ..
ptr[t + 1]`` in route order (first choice before second; experts in order
for expert choice), ``slot[r]`` is its row ``e * capacity + c`` of the
experts' ``(E, C, M)`` rows or -1 (dropped), ``slot_route[s]`` the route of
slot ``s`` or -1 (empty), ``route_token[r]`` its token.

* :func:`moe_dispatch` gathers the experts' rows ``(E * C, M)`` from the
  tokens (0 for an empty slot); its backward sums each token's slots in
  route order, accumulating in ``acc_dtype``.
* :func:`moe_combine` gives each token the sum over its routes of
  ``gate * (y[slot] + bias[e])``, with the roundings of :class:`CombineSpec`;
  its backward gives ``dy[slot] = gate * dout[t]`` and ``dgate = <y[slot]
  (+ bias), dout[t]>`` (an fp32 row dot), and the bias gradient as the sum
  of each expert's ``dy`` rows.

Two kernels serve the four: token-major ``moe_gather_sum`` (combine,
dispatch backward) and slot-major ``moe_slot_rows`` (dispatch, combine
backward). Neither uses atomics: every launch gives the same bits.
:func:`moe_dispatch` and :func:`moe_combine` run the plain versions for
CPU tensors and the kernels for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from .. import _native
from ._fused_io import (aligned16, cuda_device, dtype_code, plain_path,
                        ptr, stream)

__all__ = ["CombineSpec", "Routes", "dense_routes", "expert_choice_routes",
           "gather_sum_reference", "launches_combine", "launches_dispatch",
           "moe_combine", "moe_dispatch", "route_cost", "slot_rows_reference",
           "token_choice_routes"]

launches_dispatch = _native.LaunchCounter("moe_dispatch")
launches_combine = _native.LaunchCounter("moe_combine")

_ARGTYPES_OF = {
    "moe_gather_sum": [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
    + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "moe_slot_rows": [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
    + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}


def bind(lib) -> dict:
    """The C entry points of a built ``moe`` library, typed."""
    fns = {}
    for name, types in _ARGTYPES_OF.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    return bind(_native.load("moe"))


@dataclass(frozen=True)
class Routes:
    """The routing table (int32 device tensors; see the module
    docstring): ``ptr`` (T + 1), ``slot`` (R), ``slot_route`` (E C),
    ``route_token`` (R)."""
    ptr: torch.Tensor
    slot: torch.Tensor
    slot_route: torch.Tensor
    route_token: torch.Tensor
    experts: int
    capacity: int

    @property
    def tokens(self) -> int:
        return self.ptr.numel() - 1

    @property
    def slots(self) -> int:
        return self.experts * self.capacity


@dataclass(frozen=True)
class CombineSpec:
    """The combine's roundings: ``h`` of the bias add (None without a
    bias), ``p`` of the gate product, ``a`` of each add of the sum, ``out``
    of the result."""
    h: Optional[torch.dtype]
    p: torch.dtype
    a: torch.dtype
    out: torch.dtype


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def token_choice_routes(expert: torch.Tensor, pos: torch.Tensor,
                        keep: torch.Tensor, experts: int,
                        capacity: int) -> Routes:
    """Routes of a token-choice gate: ``expert``, ``pos`` (place in the
    expert's queue) and ``keep`` of shape ``(S, k)``; route ``s k + j`` is
    token s's j-th choice."""
    s, k = expert.shape
    dev = expert.device
    n = experts * capacity
    slot = torch.where(keep, expert.long() * capacity + pos.long(),
                       -1).reshape(-1)
    r = torch.arange(s * k, device=dev)
    # dropped routes land on a spare last slot, which is cut off
    slot_route = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    slot_route.scatter_(0, torch.where(slot >= 0, slot, n),
                        r.to(torch.int32))
    return Routes(ptr=_int32(torch.arange(0, s * k + 1, k, device=dev)),
                  slot=_int32(slot), slot_route=slot_route[:n].contiguous(),
                  route_token=_int32(r // k), experts=experts,
                  capacity=capacity)


def expert_choice_routes(sel: torch.Tensor, tokens: int):
    """Routes of an expert-choice pick ``sel`` ``(E, C)`` of token indices
    (each expert's tokens distinct; -1 for an empty slot) over ``tokens``
    tokens, and ``perm``: route r is slot ``perm[r]`` (a token's slots in
    expert order, from a stable sort of the slots' tokens). Empty slots
    sort first, as routes that no token's range reaches (slot -1)."""
    e, c = sel.shape
    dev = sel.device
    flat = sel.reshape(-1).long()
    s_tok, perm = torch.sort(flat, stable=True)
    ptr_ = torch.searchsorted(s_tok, torch.arange(tokens + 1, device=dev))
    slot_route = torch.empty(e * c, dtype=torch.int32, device=dev)
    slot_route.scatter_(0, perm, torch.arange(e * c, dtype=torch.int32,
                                              device=dev))
    return Routes(ptr=_int32(ptr_),
                  slot=_int32(torch.where(s_tok >= 0, perm, -1)),
                  slot_route=_int32(torch.where(flat >= 0, slot_route, -1)),
                  route_token=_int32(s_tok), experts=e,
                  capacity=c), perm


def dense_routes(dispatch: torch.Tensor, combine: torch.Tensor):
    """``(routes, gates (R,) in combine's dtype)`` of a gate's dense
    ``(dispatch, combine)`` ``(S, E, C)``, built on the device: slot
    ``(e, c)`` holds the token where its dispatch column is not 0 (the
    reference gates' dispatch is one-hot, at most one token a slot) and
    weighs it by ``combine`` there; a token's slots in expert order. The
    routing reads no gradient from ``dispatch``, whose entries are 0 or 1."""
    s, e, c = dispatch.shape
    col = dispatch.detach().reshape(s, e * c)
    tok = col.argmax(0)
    live = col.gather(0, tok[None])[0] != 0
    routes, perm = expert_choice_routes(
        torch.where(live, tok, -1).view(e, c), s)
    gate = combine.reshape(s, e * c).gather(0, tok[None])[0]
    return routes, gate[perm]


def _rnd(x: torch.Tensor, dt: Optional[torch.dtype]) -> torch.Tensor:
    return x if dt in (None, torch.float32) else x.to(dt).float()


def gather_sum_reference(y: torch.Tensor, routes: Routes,
                         gate: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor],
                         spec: CombineSpec) -> torch.Tensor:
    """Plain version of the token-major kernel: each token's routes in
    route order, the kernel's operations and roundings in its order."""
    m = y.shape[-1]
    p0 = routes.ptr.long()
    t = routes.tokens
    counts = p0[1:] - p0[:-1]
    acc = torch.zeros(t, m, dtype=torch.float32, device=y.device)
    nr = routes.slot.numel()
    kmax = int(counts.max()) if t and nr else 0
    y32 = y.reshape(-1, m).float()
    b32 = None if bias is None else bias.reshape(-1, m).float()
    for j in range(kmax):
        r = (p0[:-1] + j).clamp(max=nr - 1)
        s = routes.slot.long()[r]
        valid = (counts > j) & (s >= 0)
        sc = s.clamp(min=0)
        v = y32[sc]
        if b32 is not None:
            v = _rnd(v + b32[sc // routes.capacity], spec.h)
        if gate is not None:
            v = _rnd(v * gate.float()[r][:, None], spec.p)
        v = _rnd(acc + _rnd(v, spec.a), spec.a)
        acc = torch.where(valid[:, None], v, acc)
    return acc.to(spec.out)


def slot_rows_reference(src: torch.Tensor, routes: Routes,
                        gate: Optional[torch.Tensor], y: Optional[
                            torch.Tensor], bias: Optional[torch.Tensor],
                        out_dtype: torch.dtype,
                        h: Optional[torch.dtype] = None):
    """Plain version of the slot-major kernel: ``(out (slots, M), dgate
    (R,) fp32 or None)``; dgate is summed in torch's order, not the
    kernel's."""
    m = src.shape[-1]
    r = routes.slot_route.long()
    valid = r >= 0
    rc = r.clamp(min=0)
    nr = routes.route_token.numel()
    if nr == 0:
        return torch.zeros(routes.slots, m, dtype=out_dtype,
                           device=src.device), (
            None if y is None else torch.zeros(0, device=src.device))
    x = src.reshape(-1, m).float()[routes.route_token.long()[rc]]
    o = x if gate is None else x * gate.float()[rc][:, None]
    out = torch.where(valid[:, None], o, 0.0).to(out_dtype)
    if y is None:
        return out, None
    w = y.reshape(-1, m).float()
    if bias is not None:
        e = torch.arange(routes.slots, device=src.device) // routes.capacity
        w = _rnd(w + bias.reshape(-1, m).float()[e], h)
    dot = (w * x).sum(-1)
    dgate = torch.zeros(nr, dtype=torch.float32, device=src.device)
    dgate[rc[valid]] = dot[valid]
    return out, dgate


def _vec(m: int, *ts) -> int:
    return 8 if m % 8 == 0 and aligned16(*ts) else 1


def _check_routes(routes: Routes, dev) -> None:
    for name in ("ptr", "slot", "slot_route", "route_token"):
        t = getattr(routes, name)
        if t.dtype != torch.int32 or t.device != dev or \
                not t.is_contiguous():
            raise ValueError(f"moe_route: routes.{name} must be contiguous "
                             f"int32 on {dev}, got {t.dtype} on {t.device}")


def _launch_gather(y, routes: Routes, gate, bias, spec: CombineSpec,
                   fns=None):
    dev = cuda_device("moe_route", y, gate, bias)
    _check_routes(routes, dev)
    m = y.shape[-1]
    y = y.reshape(-1, m).contiguous()
    bias = None if bias is None else bias.reshape(-1, m).contiguous()
    gate = None if gate is None else gate.float().contiguous()
    out = torch.empty(routes.tokens, m, dtype=spec.out, device=dev)
    if routes.tokens and m:
        c = functools.partial(dtype_code, what="moe_route")
        with torch.cuda.device(dev):
            err = (fns or _kernels())["moe_gather_sum"](
                ptr(y), ptr(bias), ptr(routes.ptr), ptr(routes.slot),
                ptr(gate), ptr(out), routes.tokens, m, routes.capacity,
                c(y.dtype), c(None if bias is None else bias.dtype),
                c(spec.h), c(spec.p), c(spec.a), c(spec.out),
                _vec(m, y, bias, out), stream(dev))
        _native.check(err, "moe_gather_sum kernel launch")
    return out


def _launch_rows(src, routes: Routes, gate, y, bias, out_dtype, h,
                 fns=None):
    dev = cuda_device("moe_route", src, gate, y, bias)
    _check_routes(routes, dev)
    m = src.shape[-1]
    src = src.reshape(-1, m).contiguous()
    y = None if y is None else y.reshape(-1, m).contiguous()
    bias = None if bias is None or y is None else \
        bias.reshape(-1, m).contiguous()
    gate = None if gate is None else gate.float().contiguous()
    out = torch.empty(routes.slots, m, dtype=out_dtype, device=dev)
    dgate = None if y is None else torch.zeros(
        routes.route_token.numel(), dtype=torch.float32, device=dev)
    if routes.slots and m:
        c = functools.partial(dtype_code, what="moe_route")
        with torch.cuda.device(dev):
            err = (fns or _kernels())["moe_slot_rows"](
                ptr(src), ptr(routes.slot_route), ptr(routes.route_token),
                ptr(gate), ptr(out), ptr(y), ptr(bias), ptr(dgate),
                routes.slots, m, routes.capacity, c(src.dtype),
                c(out_dtype), c(None if y is None else y.dtype),
                c(None if bias is None else bias.dtype), c(h),
                _vec(m, src, out, y, bias), stream(dev))
        _native.check(err, "moe_slot_rows kernel launch")
    return out, dgate


def route_cost(routes: Routes, y, src, gate, bias, out, by_slot: bool):
    """A launch's ``(flops, bytes)`` for this routing (host counts of the
    live routes): the routing table; ``by_slot`` (dispatch, the combine's
    backward): the rows of ``src`` of tokens with a live route, every slot
    row of ``out``, the live rows of ``y``, the gate read and its gradient
    written; else (combine, the dispatch's backward): the live slot rows of
    ``y``, every token row of ``out``, the gate read. The bias as given."""
    live = routes.slot >= 0
    n_live = int(live.sum())
    m = out.shape[-1]
    nbytes = 4 * sum(t.numel() for t in (routes.ptr, routes.slot,
                                         routes.slot_route,
                                         routes.route_token))
    nbytes += _native.tensor_bytes(bias)
    if gate is not None:
        nbytes += (2 if by_slot else 1) * 4 * routes.slot.numel()
    if by_slot:
        toks = int((torch.bincount(routes.route_token.long()[live],
                                   minlength=routes.tokens) > 0).sum())
        nbytes += toks * m * src.element_size() + out.numel() * \
            out.element_size()
        if y is not None:
            nbytes += n_live * m * y.element_size()
    else:
        nbytes += n_live * m * y.element_size() + out.numel() * \
            out.element_size()
    return 0.0, float(nbytes)


def _gather(y, routes, gate, bias, spec, plain: bool, counter):
    if plain:
        return gather_sum_reference(y, routes, gate, bias, spec)
    out = _launch_gather(y, routes, gate, bias, spec)
    counter.launched(1, route_cost, routes, y, None, gate, bias, out, False)
    return out


def _rows(src, routes, gate, y, bias, out_dtype, h, plain: bool, counter):
    if plain:
        return slot_rows_reference(src, routes, gate, y, bias, out_dtype, h)
    out = _launch_rows(src, routes, gate, y, bias, out_dtype, h)
    counter.launched(1, route_cost, routes, y, src, gate, bias, out[0], True)
    return out


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, routes, out_dtype, acc_dtype, plain):
        ctx.routes, ctx.acc, ctx.x_dtype, ctx.plain = \
            routes, acc_dtype, x.dtype, plain
        return _rows(x, routes, None, None, None, out_dtype, None, plain,
                     launches_dispatch)[0]

    @staticmethod
    def backward(ctx, dy):
        spec = CombineSpec(None, torch.float32, ctx.acc, ctx.x_dtype)
        dx = _gather(dy, ctx.routes, None, None, spec, ctx.plain,
                     launches_dispatch)
        return dx, None, None, None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, gate, bias, routes, spec, plain):
        ctx.save_for_backward(y, gate, bias)
        ctx.routes, ctx.spec, ctx.plain = routes, spec, plain
        return _gather(y, routes, gate, bias, spec, plain, launches_combine)

    @staticmethod
    def backward(ctx, dout):
        y, gate, bias = ctx.saved_tensors
        r = ctx.routes
        need_gate = ctx.needs_input_grad[1]
        dy, dgate = _rows(dout, r, gate, y if need_gate else None, bias,
                          y.dtype, ctx.spec.h, ctx.plain, launches_combine)
        db = None
        if bias is not None and ctx.needs_input_grad[2]:
            db = dy.view(r.experts, r.capacity, -1).float().sum(1).to(
                bias.dtype).view(bias.shape)
        return dy.view(y.shape), dgate, db, None, None, None


def moe_dispatch(x: torch.Tensor, routes: Routes,
                 out_dtype: Optional[torch.dtype] = None,
                 acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The experts' rows ``(E * C, M)`` gathered from the tokens ``x``
    ``(T, M)`` (cast to ``out_dtype``, x's by default; 0 for an empty
    slot). The backward sums each token's slots in route order in
    ``acc_dtype`` and rounds to x's dtype: the plain version for CPU
    tensors, the kernels for CUDA tensors."""
    return _Dispatch.apply(x, routes, out_dtype or x.dtype, acc_dtype,
                           plain_path(x))


def moe_combine(y: torch.Tensor, gate: torch.Tensor, routes: Routes,
                bias: Optional[torch.Tensor] = None,
                spec: Optional[CombineSpec] = None) -> torch.Tensor:
    """Each token's sum over its routes of ``gate[r] * (y[slot] +
    bias[e])``: ``y`` ``(E * C, M)`` (or ``(E, C, M)``), ``gate`` ``(R,)``
    fp32, ``bias`` ``(E, M)`` or None; roundings by ``spec`` (fp32 sums
    into fp32 by default). Gradients reach y, gate and bias: the plain
    version for CPU tensors, the kernels for CUDA tensors."""
    if spec is None:
        spec = CombineSpec(None, torch.float32, torch.float32,
                           torch.promote_types(y.dtype, torch.float32))
    if gate.dtype != torch.float32:
        raise TypeError(f"moe_combine: gate must be fp32, got {gate.dtype}")
    return _Combine.apply(y, gate, bias, routes, spec, plain_path(y))
