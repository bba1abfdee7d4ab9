"""Mixture-of-Experts, the port of ``paddle_tpu/incubate/moe.py``:
``NaiveGate`` (``:34``), ``GShardGate`` (``:89``), ``SwitchGate``
(``:96``) and ``MoELayer`` (``:116``), with the same parameter keys
(``gate.gate_proj.weight``, ``experts.{i}.*``).

* **The gates.** fp32 softmax of the ``gate_proj`` logits, top-k experts a
  token (ties to the lower expert, as ``jax.lax.top_k``: a stable
  descending sort), each route's place in its expert's queue from a cumsum
  in priority order (every first choice before every second choice),
  ``capacity = max(ceil(k cf S / E), 4)``, overflow dropped and the kept
  gates renormalised (floor 1e-9); the GShard aux loss ``sum(mean(probs) *
  frac(first choice)) * E`` is kept on ``l_aux``. ``forward`` returns the
  JAX package's dense ``(dispatch, combine, aux)`` of shape ``(S, E, C)``;
  :meth:`NaiveGate.route` returns the same routing as an index table
  (``ops/moe.py`` ``Routes``), built on the device with no host read.
* **MoELayer.** The gate routes by index: the tokens are gathered into the
  experts' ``(E, C, M)`` rows by the dispatch kernel and the experts'
  outputs summed back, weighted by the gates, by the combine kernel (K9,
  ``ops/moe.py``), where the JAX package multiplies one-hot ``(S, E, C)``
  tensors. Their dtypes are the reference einsums': fp32 (the gates' dtype)
  unless ``amp.auto_cast`` O2 casts ``moe_dispatch`` / ``moe_combine`` to
  the low dtype. Experts are the user's modules, called one by one on
  ``(C, M)``. A gate given as an object without ``route`` keeps the
  reference's contract, ``gate(x) -> (dispatch, combine, aux)``: its dense
  tensors become the same index table on the device (``dense_routes``,
  for a one-hot dispatch as the reference gates give) and take the same
  kernels.
* ``gate`` as a dict (``{"type": "gshard" | "switch" | "naive",
  "top_k", "capacity_factor"}``) builds the gate as the reference does,
  with ``capacity_factor`` 1.5 by default for every type (``"switch"``
  included: the reference's behaviour, kept).

Not ported: the expert-parallel sharding constraint (``_ep_mesh``, ``:103``);
``moe_group`` and ``mp_group`` are accepted and unused, as the port runs
on one card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..amp import cast_dtype, cast_inputs
from ..device import resolve_device
from ..nn.common import Linear
from ..ops.moe import (CombineSpec, Routes, dense_routes, moe_combine,
                       moe_dispatch, token_choice_routes)

__all__ = ["GShardGate", "MoELayer", "NaiveGate", "SwitchGate", "top_k"]


def top_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest along the last axis, ties to
    the lower index as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order): a stable descending sort, sliced."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class NaiveGate(nn.Module):
    """Top-k softmax gate over ``num_experts`` (see the module docstring).
    ``gate_proj`` starts Xavier-uniform from ``generator`` (by default one
    seeded with 0) on ``device`` (``cuda`` unless ``device="cpu"``)."""

    def __init__(self, d_model: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.5, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.gate_proj = Linear(d_model, num_experts, bias_attr=False,
                                device=dev, dtype=dtype)
        g = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        bound = (6.0 / (d_model + num_experts)) ** 0.5
        with torch.no_grad():
            self.gate_proj.weight.uniform_(-bound, bound, generator=g)
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.l_aux: Optional[torch.Tensor] = None

    def capacity(self, num_tokens: int) -> int:
        c = int(math.ceil(self.top_k * self.capacity_factor * num_tokens
                          / self.num_experts))
        return max(c, 4)

    def route(self, x: torch.Tensor):
        """``(routes, gates (S k,) fp32, aux)`` for tokens ``x`` ``(S, M)``:
        the index form of :meth:`forward`; sets ``l_aux``."""
        (logits,) = cast_inputs("moe_gate", self.gate_proj(x))
        probs = torch.softmax(logits.float(), dim=-1)
        e, k, s = self.num_experts, self.top_k, x.shape[0]
        topv, topi = top_k(probs, k)
        # priority: every first choice before every second choice (gshard)
        onehot = nn.functional.one_hot(topi.t().reshape(-1), e)  # (k S, E)
        before = torch.cumsum(onehot, dim=0) - onehot
        pos = (onehot * before).sum(-1).reshape(k, s).t()
        cap = self.capacity(s)
        keep = pos < cap
        gates = topv * keep
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        ce = nn.functional.one_hot(topi[:, 0], e).float().mean(0)
        self.l_aux = (probs.mean(0) * ce).sum() * e
        return token_choice_routes(topi, pos, keep, e, cap), \
            gates.reshape(-1), self.l_aux

    def forward(self, x: torch.Tensor):
        """x ``(S, M)`` -> ``(dispatch (S, E, C), combine (S, E, C),
        aux)``, the JAX gate's dense tensors (fp32)."""
        routes, gates, aux = self.route(x)
        return _dense(routes, gates) + (aux,)


def _dense(routes: Routes, gates: torch.Tensor):
    """The dense ``(dispatch, combine)`` of a token-choice routing."""
    s, n = routes.tokens, routes.slots
    slot = routes.slot.long()
    live = slot >= 0
    tok = routes.route_token.long()
    col = torch.where(live, slot, n)          # dropped: a spare column
    disp = torch.zeros(s, n + 1, device=gates.device)
    comb = torch.zeros(s, n + 1, device=gates.device, dtype=gates.dtype)
    disp = disp.index_put((tok, col), live.float())
    comb = comb.index_put((tok, col), torch.where(live, gates, 0.0))
    shape = (s, routes.experts, routes.capacity)
    return disp[:, :n].reshape(shape), comb[:, :n].reshape(shape)


class GShardGate(NaiveGate):
    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=1.5,
                 group=None, **kw):
        super().__init__(d_model, num_experts, top_k=top_k,
                         capacity_factor=capacity_factor, **kw)


class SwitchGate(NaiveGate):
    def __init__(self, d_model, num_experts, top_k=1, capacity_factor=1.25,
                 group=None, **kw):
        super().__init__(d_model, num_experts, top_k=top_k,
                         capacity_factor=capacity_factor, **kw)


_GATES = {"gshard": GShardGate, "switch": SwitchGate, "naive": NaiveGate}


def _device_of(experts: nn.ModuleList, device):
    if device is not None:
        return resolve_device(device)
    for p in experts.parameters():
        return p.device
    return resolve_device(None)


class MoELayer(nn.Module):
    """Parity: ``paddle.incubate.distributed.models.moe.MoELayer`` (see the
    module docstring). ``experts``: a list or ``ModuleList`` of modules each
    mapping ``(C, M) -> (C, M')``. A gate built from a dict lives on
    ``device`` (by default the experts' device), its weights from
    ``generator``."""

    def __init__(self, d_model: int, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval: int = 0, top_k: int = 2,
                 *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        self.d_model = d_model
        self.experts = experts if isinstance(experts, nn.ModuleList) \
            else nn.ModuleList(list(experts))
        num_experts = len(self.experts)
        if gate is None or isinstance(gate, dict):
            cfg = gate or {}
            cls = _GATES[cfg.get("type", "gshard")]
            self.gate = cls(d_model, num_experts,
                            top_k=cfg.get("top_k", top_k),
                            capacity_factor=cfg.get("capacity_factor", 1.5),
                            device=_device_of(self.experts, device),
                            dtype=dtype, generator=generator)
        else:
            self.gate = gate
        self.l_aux: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, self.d_model)
        e = len(self.experts)
        if hasattr(self.gate, "route"):
            routes, gates, aux = self.gate.route(flat)
            d_dt = torch.float32
        else:
            dispatch, combine, aux = self.gate(flat)
            routes, gates = dense_routes(dispatch, combine)
            d_dt = dispatch.dtype
        self.l_aux = aux
        # the reference einsums' dtypes: the gate's (fp32), or the O2 dtype
        d_dt = cast_dtype("moe_dispatch", d_dt)
        x_dt = cast_dtype("moe_dispatch", flat.dtype)
        expert_in = moe_dispatch(flat.to(x_dt), routes,
                                 torch.promote_types(d_dt, x_dt))
        expert_in = expert_in.view(e, routes.capacity, -1)
        expert_out = torch.stack([expert(expert_in[i]) for i, expert
                                  in enumerate(self.experts)], dim=0)
        c_dt = cast_dtype("moe_combine", gates.dtype)
        y_dt = cast_dtype("moe_combine", expert_out.dtype)
        spec = CombineSpec(None, torch.float32, torch.float32,
                           torch.promote_types(c_dt, y_dt))
        out = moe_combine(expert_out.to(y_dt).reshape(routes.slots, -1),
                          gates.to(c_dt).float(), routes, spec=spec)
        return out.reshape(*x.shape[:-1], out.shape[-1])
