"""Optimizers, the port of ``paddle_tpu/optimizer/__init__.py``:
``Optimizer`` (parameter list, step counter ``t``, ``step``,
``clear_grad``), ``Adam`` and ``AdamW`` with the JAX package's
constructor arguments and memory knobs.

* ``moment_dtype="float32"``: the update is plain PyTorch elementwise
  math in fp32, as the JAX package leaves it to XLA.
* ``moment_dtype="int8"``: every parameter's update is one launch of the
  fused int8 AdamW kernel (``ops/q8_adam.py``; its plain version on the
  CPU), ragged parameters included: the kernel masks the tail of the last
  2048-block, which gives what the JAX package's chunked leg gives.
  Accumulators keep the JAX names and layouts: ``moment1``,
  ``moment2_sqrt`` int8 ``(nb, 2048)`` and ``moment1_scale``,
  ``moment2_sqrt_scale`` fp32 ``(nb,)``.
* Master weights follow ``_ensure_master``: ``use_master_weights=None``
  keeps an fp32 master for each bf16/fp16 parameter; ``False`` keeps none
  and writes bf16 back with stochastic rounding (``stochastic_rounding``,
  on by default), its bits drawn from the optimizer's own seeded
  ``torch.Generator`` once per (step, parameter).
* The bias corrections ``c1 = 1 - beta1^t``, ``c2 = 1 - beta2^t`` are
  computed in fp32 on the host, as the JAX package computes them in fp32
  on the device: no device sync per step.

Not ported (they raise): grad clipping, LR schedulers, parameter groups,
``lazy_mode``, ``use_multi_tensor=True``, ``apply_decay_param_fun``,
``lr_ratio`` and bf16 moments.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops import q8_adam

__all__ = ["Adam", "AdamW", "Optimizer"]

_LOW = (torch.bfloat16, torch.float16)


class Optimizer:
    """Base class: a flat parameter list, a step counter ``t`` and the
    per-parameter state (accumulators and fp32 masters, keyed by the
    parameter's ``id``)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, seed: int = 0):
        if parameters is None:
            raise ValueError("pass parameters=model.parameters()")
        if grad_clip is not None:
            raise NotImplementedError("grad clipping is not ported")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("LR schedulers are not ported: pass a "
                                      "float learning_rate")
        params = list(parameters)
        if params and isinstance(params[0], dict):
            raise NotImplementedError("parameter groups are not ported")
        self._params = params
        self._learning_rate = float(learning_rate)
        self._weight_decay = weight_decay
        self._use_master_weights: Optional[bool] = None
        self._stochastic_rounding = True
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._generator = torch.Generator().manual_seed(int(seed))
        self.t = 0

    def _acc(self, name: str, p: torch.Tensor, init=None) -> torch.Tensor:
        store = self._accumulators.setdefault(name, {})
        t = store.get(id(p))
        if t is None:
            t = torch.zeros_like(p, dtype=torch.float32) if init is None \
                else init
            store[id(p)] = t
        return t

    def _ensure_master(self, p: torch.Tensor) -> Optional[torch.Tensor]:
        """fp32 master of a low-precision parameter (AMP O2), or None."""
        if self._use_master_weights is False or p.dtype not in _LOW:
            return None
        m = self._master_weights.get(id(p))
        if m is None:
            m = p.detach().float()
            self._master_weights[id(p)] = m
        return m

    def _create_accumulators(self, p: torch.Tensor) -> None:
        """Create this optimizer's per-parameter state (overridden)."""

    def _materialize_state(self) -> None:
        for p in self._params:
            self._ensure_master(p)
            self._create_accumulators(p)

    def _on_params_cast(self) -> None:
        """``amp.decorate`` cast the parameters: rebuild the masters from
        the cast values, and the state for the new dtypes."""
        self._master_weights.clear()
        self._accumulators.clear()
        self._materialize_state()

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self._generator))

    def _write_back(self, p: torch.Tensor, new32: torch.Tensor) -> None:
        """An fp32 update into a master-free parameter: bf16 rounds
        stochastically when enabled, anything else is a plain cast."""
        if p.dtype == torch.bfloat16 and self._stochastic_rounding:
            bits = q8_adam.sr_bits(self._draw_seed(), p.numel(), p.device)
            p.copy_(q8_adam.stochastic_round_bf16(new32, bits.view(p.shape)))
        else:
            p.copy_(new32)

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        lr = self._learning_rate
        for p in self._params:
            if p.grad is None:
                continue
            g = p.grad
            if self._weight_decay is not None:   # coupled L2 (not AdamW's)
                coeff = getattr(self._weight_decay, "coeff",
                                self._weight_decay)
                g = g + float(coeff) * p
            self._update_param(p, g, lr)

    def _update_param(self, p, g, lr) -> None:
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._params:
            p.grad = None


class Adam(Optimizer):
    """``paddle.optimizer.Adam`` with the JAX package's memory knobs
    ``moment_dtype`` and ``use_master_weights`` (see the module
    docstring). ``seed`` seeds the stochastic-rounding bits."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, moment_dtype="float32",
                 use_master_weights=None, stochastic_rounding=True,
                 name=None, seed: int = 0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, seed)
        if lazy_mode:
            raise NotImplementedError("lazy_mode is not ported")
        if use_multi_tensor:
            raise NotImplementedError(
                "the fused multi-tensor AdamW is not ported: "
                "use_multi_tensor=False")
        if str(moment_dtype) not in ("float32", "int8"):
            raise NotImplementedError(f"moment_dtype must be float32 or "
                                      f"int8, got {moment_dtype!r}")
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._moment_q8 = str(moment_dtype) == "int8"
        self._use_master_weights = use_master_weights
        self._stochastic_rounding = bool(stochastic_rounding)
        self._materialize_state()

    def _create_accumulators(self, p):
        if self._moment_q8:
            nb = -(-p.numel() // q8_adam.Q8_BLOCK)
            for name in ("moment1", "moment2_sqrt"):
                self._acc(name, p, torch.zeros(
                    (nb, q8_adam.Q8_BLOCK), dtype=torch.int8,
                    device=p.device))
                self._acc(name + "_scale", p, torch.ones(
                    nb, dtype=torch.float32, device=p.device))
            return
        for name in ("moment1", "moment2"):
            self._acc(name, p)

    def _corrections(self):
        """``(c1, c2)`` in fp32, as the JAX package computes them."""
        t = np.float32(self.t)
        c1 = np.float32(1.0) - np.float32(self._beta1) ** t
        c2 = np.float32(1.0) - np.float32(self._beta2) ** t
        return float(c1), float(c2)

    def _adam_core(self, p, g, lr, decoupled_wd: float = 0.0) -> None:
        c1, c2 = self._corrections()
        decay = 1.0 - lr * decoupled_wd if decoupled_wd else None
        master = self._ensure_master(p)
        b1, b2 = self._beta1, self._beta2
        if self._moment_q8:
            base = master if master is not None else p
            use_sr = (master is None and p.dtype == torch.bfloat16
                      and self._stochastic_rounding)
            q8_adam.q8_adam_update(
                self._acc("moment1", p), self._acc("moment1_scale", p),
                self._acc("moment2_sqrt", p),
                self._acc("moment2_sqrt_scale", p), base.view(-1),
                g.contiguous().view(-1), lr=lr, c1=c1, c2=c2,
                eps=self._epsilon, beta1=b1, beta2=b2, decay=decay,
                seed=self._draw_seed() if use_sr else 0, use_sr=use_sr)
            if master is not None:
                p.copy_(master)
            return
        m, v = self._acc("moment1", p), self._acc("moment2", p)
        g32 = g.float()
        new_m = b1 * m.float() + (1 - b1) * g32
        new_v = b2 * v.float() + (1 - b2) * g32 * g32
        m.copy_(new_m)
        v.copy_(new_v)
        base = master if master is not None else p.float()
        if decay is not None:
            base = base * decay
        new_p = base - lr * (new_m / c1) / (torch.sqrt(new_v / c2)
                                            + self._epsilon)
        if master is not None:
            master.copy_(new_p)
            p.copy_(new_p)
        else:
            self._write_back(p, new_p)

    def _update_param(self, p, g, lr):
        self._adam_core(p, g, lr)


class AdamW(Adam):
    """Decoupled weight decay (``weight_decay`` default 0.01, applied to
    every parameter)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, moment_dtype="float32",
                 use_master_weights=None, stochastic_rounding=True,
                 name=None, seed: int = 0):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError("lr_ratio and apply_decay_param_fun "
                                      "are not ported")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         use_multi_tensor, moment_dtype, use_master_weights,
                         stochastic_rounding, name, seed)
        self._wd_coeff = float(getattr(weight_decay, "coeff", weight_decay)
                               or 0.0)

    def _update_param(self, p, g, lr):
        self._adam_core(p, g, lr, decoupled_wd=self._wd_coeff)
