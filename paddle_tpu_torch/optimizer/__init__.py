"""Optimizers, the port of ``paddle_tpu/optimizer/__init__.py``:
``Optimizer`` (parameter list, step counter, ``step``, ``clear_grad``),
``Adam`` and ``AdamW`` with the JAX package's constructor arguments and
memory knobs, gradient clipping (``ClipGradByValue``, ``ClipGradByNorm``,
``ClipGradByGlobalNorm``) and the LR schedulers (``lr``).

* **Carried state on the device.** The step count ``_step_t`` (0-d int32)
  and the LR ``_lr_t`` (0-d fp32) live on the parameters' device, as the
  JAX package carries them: ``step()`` advances ``_step_t`` on the device,
  the bias corrections ``c1 = 1 - beta1^t``, ``c2 = 1 - beta2^t`` are
  computed there in fp32 from it, and the stochastic-rounding seeds are
  derived there from it (and the optimizer's ``seed``) per parameter. An
  ``LRScheduler`` pushes each new value into ``_lr_t`` (``scheduler.step()``
  between steps). Each step fills one block of device scalars (``lr``,
  ``decay = 1 - lr * wd``, ``c1``, ``c2``, the NaN gate, the global-norm
  scale; ``ops/q8_adam.py SCALARS``) that the update kernels read: a step
  captured as a CUDA graph (``jit.capture_step``) then replays with no
  value frozen. ``t`` reads the count (a host read). A host write to
  ``_lr_t`` or ``_step_t`` while a step is being captured raises
  ``HostStateWriteError``.
* ``moment_dtype="float32"``: per-parameter plain PyTorch elementwise math
  in fp32, as the JAX package leaves it to XLA.
* ``moment_dtype="int8"``: every parameter's update is one launch of the
  fused int8 AdamW kernel (``ops/q8_adam.py``; its plain version on the
  CPU), ragged parameters included: the kernel masks the tail of the last
  2048-block, which gives what the JAX package's chunked leg gives.
  Accumulators keep the JAX names and layouts: ``moment1``,
  ``moment2_sqrt`` int8 ``(nb, 2048)`` and ``moment1_scale``,
  ``moment2_sqrt_scale`` fp32 ``(nb,)``.
* ``use_multi_tensor=True`` (the reference's fused path): one flat fp32
  buffer each for the master, m and v over every parameter, the
  parameters views of a flat buffer of their dtype, the step's gradients
  copied into a flat gradient of that dtype (one ``_foreach_copy_``), and
  one launch of the multi-tensor AdamW kernel (``ops/multi_tensor_adam.py``)
  a step. The gradients are not kept as views of the flat gradient:
  backward then adds into each view (one kernel a parameter), where it
  hands a fresh gradient over at no cost, and the copy is cheaper than
  those adds (``tools/ab_flat_grads.py``). Refused with int8 moments, as there; ``ClipGradByNorm`` and a
  coupled ``weight_decay`` of ``Adam`` take the per-parameter path, as
  there. A parameter with no gradient keeps its state unchanged.
* Master weights follow ``_ensure_master``: ``use_master_weights=None``
  keeps an fp32 master for each bf16/fp16 parameter; ``False`` keeps none
  and writes bf16 back with stochastic rounding (``stochastic_rounding``,
  on by default).
* Under the NaN gate of a captured step (``core.step_capture.gated``) a
  step whose loss is not finite writes nothing and leaves ``_step_t``
  where it was, decided on the device.

Not ported (they raise): parameter groups, ``lazy_mode``,
``apply_decay_param_fun``, ``lr_ratio``, bf16 moments and the master-free
multi-tensor layout; ``state_dict``.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import torch

from ..core import step_capture
from ..ops import multi_tensor_adam as mta
from ..ops import q8_adam
from ..ops._u32 import M32, derive_seed
from . import lr as lr_mod
from .lr import LRScheduler

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Optimizer", "lr"]

lr = lr_mod

_LOW = (torch.bfloat16, torch.float16)
_FLAT_ALIGN = 64       # elements: each parameter's offset in the flat buffers


class _ClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


def _clips(p) -> bool:
    return getattr(p, "need_clip", True)


class ClipGradByValue(_ClipBase):
    """Clip every gradient element to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None or not _clips(p)
                 else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(_ClipBase):
    """Scale each gradient to an L2 norm of at most ``clip_norm``:
    ``scale = min(clip_norm / max(||g||, 1e-12), 1)``, in fp32 on the
    device."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None or not _clips(p):
                out.append((p, g))
                continue
            g32 = g.float()
            n = torch.sqrt(torch.sum(g32 * g32))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            out.append((p, (g32 * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(_ClipBase):
    """Scale all gradients together: ``total`` the L2 norm over all of
    them, ``scale = clip_norm / max(total, clip_norm)``, in fp32 on the
    device with no host read."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def scale(self, total: torch.Tensor) -> torch.Tensor:
        """The factor for a global norm ``total`` (0-d fp32)."""
        return self.clip_norm / torch.clamp(total, min=self.clip_norm)

    def __call__(self, params_grads):
        sq = [torch.sum(g.float() * g.float()) for p, g in params_grads
              if g is not None and _clips(p)]
        if not sq:
            return params_grads
        scale = self.scale(torch.sqrt(torch.stack(sq).sum()))
        return [(p, g if g is None or not _clips(p)
                 else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


class Optimizer:
    """Base class: a flat parameter list, the carried step count and LR,
    and the per-parameter state (accumulators and fp32 masters, keyed by
    the parameter's ``id``)."""

    _betas = (0.0, 0.0)   # c1 = c2 = 1 for an optimizer without moments
    _wd_coeff = 0.0

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, seed: int = 0):
        if parameters is None:
            raise ValueError("pass parameters=model.parameters()")
        if grad_clip is not None and not isinstance(grad_clip, _ClipBase):
            raise TypeError(f"grad_clip must be a ClipGradBy* object, got "
                            f"{type(grad_clip).__name__}")
        params = list(parameters)
        if params and isinstance(params[0], dict):
            raise NotImplementedError("parameter groups are not ported")
        self._params = params
        self._index = {id(p): i for i, p in enumerate(params)}
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) else float(learning_rate)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._use_master_weights: Optional[bool] = None
        self._stochastic_rounding = True
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        dev = params[0].device if params else torch.device("cpu")
        self._step_t = torch.zeros((), dtype=torch.int32, device=dev)
        self._lr_t = torch.tensor(self.get_lr(), dtype=torch.float32,
                                  device=dev)
        self._betas_t = torch.tensor(self._betas, dtype=torch.float32,
                                     device=dev)
        self._seed_t = torch.tensor(int(seed) & M32, dtype=torch.int64,
                                    device=dev)
        if isinstance(learning_rate, LRScheduler):
            learning_rate.__dict__.setdefault("_bound_opts", []).append(
                weakref.ref(self))

    # -- carried state --------------------------------------------------------
    @property
    def t(self) -> int:
        """The step count (a host read of ``_step_t``)."""
        return int(self._step_t)

    @t.setter
    def t(self, value: int) -> None:
        step_capture.check_host_write("Optimizer._step_t")
        self._step_t.fill_(int(value))

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)
        self._write_lr(self._learning_rate)

    def _sync_lr_tensor(self) -> None:
        """The bound scheduler moved: carry its value to ``_lr_t``."""
        if isinstance(self._learning_rate, LRScheduler):
            self._write_lr(float(self._learning_rate.last_lr))

    def _write_lr(self, value: float) -> None:
        step_capture.check_host_write("Optimizer._lr_t (scheduler.step() "
                                      "or set_lr)")
        self._lr_t.fill_(value)

    def _scalars(self, gate: Optional[torch.Tensor],
                 grad_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """This step's block of device scalars (``q8_adam.SCALARS``), from
        ``_lr_t`` and the already advanced ``_step_t``, in fp32 as the JAX
        package computes them."""
        c = 1.0 - self._betas_t ** self._step_t.float()
        one = torch.ones((), dtype=torch.float32, device=c.device)
        decay = 1.0 - self._lr_t * self._wd_coeff
        return torch.stack([self._lr_t, decay, c[0], c[1],
                            one if gate is None else gate.float(),
                            one if grad_scale is None else grad_scale])

    def _sr_seeds(self) -> torch.Tensor:
        """(P,) int64 seeds of this step's stochastic rounding, one per
        parameter: draw ``t * P + i`` of the optimizer's ``seed``
        (``ops._u32.derive_seed``), on the device from ``_step_t``."""
        n = len(self._params)
        idx = torch.arange(n, dtype=torch.int64, device=self._step_t.device)
        return derive_seed(self._seed_t, self._step_t.long() * n + idx)

    # -- per-parameter state --------------------------------------------------
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

    def _write_back(self, p: torch.Tensor, new32: torch.Tensor,
                    seed: torch.Tensor, keep) -> None:
        """An fp32 update into a master-free parameter: bf16 rounds
        stochastically when enabled, anything else is a plain cast; nothing
        where ``keep`` (the gate withheld the step)."""
        if p.dtype == torch.bfloat16 and self._stochastic_rounding:
            bits = q8_adam.sr_bits(seed, p.numel(), p.device)
            new = q8_adam.stochastic_round_bf16(new32, bits.view(p.shape))
        else:
            new = new32.to(p.dtype)
        p.copy_(new if keep is None else torch.where(keep, p, new))

    # -- the step -------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        gate = step_capture.current_gate()
        self._step_t.add_(1 if gate is None else gate.to(torch.int32))
        pg = [(p, p.grad) for p in self._params if p.grad is not None]
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        sc = self._scalars(gate)
        seeds = self._sr_seeds() if self._needs_seeds() else None
        for p, g in pg:
            if self._weight_decay is not None:   # coupled L2 (not AdamW's)
                coeff = getattr(self._weight_decay, "coeff",
                                self._weight_decay)
                g = g + float(coeff) * p
            i = self._index[id(p)]
            self._update_param(p, g, sc, None if seeds is None else seeds[i],
                               None if gate is None else ~gate)

    def _needs_seeds(self) -> bool:
        return self._stochastic_rounding and self._use_master_weights is \
            False and any(p.dtype == torch.bfloat16 for p in self._params)

    def _update_param(self, p, g, sc, seed, keep) -> None:
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._params:
            p.grad = None



class _Flat:
    """The multi-tensor layout: every parameter's slice of the flat
    buffers starts at a multiple of ``_FLAT_ALIGN`` elements (zeros
    between, which the update leaves at zero)."""

    def __init__(self, params: List[torch.Tensor]):
        self.params = params
        self.offsets = []
        total = 0
        for p in params:
            self.offsets.append((total, p.numel()))
            total += -(-p.numel() // _FLAT_ALIGN) * _FLAT_ALIGN
        self.total = total
        dev = params[0].device
        self.master = torch.zeros(total, dtype=torch.float32, device=dev)
        with torch.no_grad():
            for p, (off, n) in zip(params, self.offsets):
                self.master[off:off + n].copy_(p.detach().reshape(-1))
        self.m = torch.zeros_like(self.master)
        self.v = torch.zeros_like(self.master)
        self.param: Optional[torch.Tensor] = None
        self.grad = torch.empty(0)
        self.rebind()

    def views(self, flat: torch.Tensor):
        return [flat[off:off + n].view(p.shape)
                for p, (off, n) in zip(self.params, self.offsets)]

    def rebind(self) -> None:
        """Make the parameters views of the flat parameter buffer (the
        master itself for fp32 parameters, else a buffer of their dtype
        rounded from the master) and allocate the flat gradient."""
        dtypes = {p.dtype for p in self.params}
        if len(dtypes) != 1:
            raise NotImplementedError(
                f"use_multi_tensor needs parameters of one dtype, got "
                f"{sorted(str(d) for d in dtypes)}")
        dtype = dtypes.pop()
        self.param = None if dtype == torch.float32 \
            else self.master.to(dtype)
        flat = self.master if self.param is None else self.param
        for p, view in zip(self.params, self.views(flat)):
            p.data = view
        self.grad = torch.zeros(self.total, dtype=dtype,
                                device=self.master.device)
        self._grad_views = self.views(self.grad)
        self._runs_cache: Dict[tuple, list] = {}

    def gather_grads(self) -> tuple:
        """Copy this step's gradients into the flat gradient (zeros for a
        parameter without one; a gradient already there is not copied) and
        return which parameters have one."""
        live = tuple(p.grad is not None for p in self.params)
        dst, src = [], []
        for p, view, ok in zip(self.params, self._grad_views, live):
            if not ok:
                view.zero_()
            elif p.grad.data_ptr() != view.data_ptr():
                dst.append(view)
                src.append(p.grad)
        if dst:
            torch._foreach_copy_(dst, src)
        return live

    def runs(self, live: tuple) -> list:
        """``(start, end)`` of the flat ranges to update: the whole buffer,
        or the runs of parameters that have a gradient."""
        r = self._runs_cache.get(live)
        if r is None:
            r = []
            for ok, (off, n) in zip(live, self.offsets):
                if not ok:
                    continue
                end = off + -(-n // _FLAT_ALIGN) * _FLAT_ALIGN
                if r and r[-1][1] == off:
                    r[-1] = (r[-1][0], end)
                else:
                    r.append((off, end))
            self._runs_cache[live] = r
        return r


class Adam(Optimizer):
    """``paddle.optimizer.Adam`` with the JAX package's memory knobs
    ``moment_dtype`` and ``use_master_weights`` and its multi-tensor path
    (see the module docstring). ``seed`` seeds the stochastic-rounding
    bits."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, moment_dtype="float32",
                 use_master_weights=None, stochastic_rounding=True,
                 name=None, seed: int = 0):
        self._betas = (beta1, beta2)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, seed)
        if lazy_mode:
            raise NotImplementedError("lazy_mode is not ported")
        if str(moment_dtype) not in ("float32", "int8"):
            raise NotImplementedError(f"moment_dtype must be float32 or "
                                      f"int8, got {moment_dtype!r}")
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._moment_q8 = str(moment_dtype) == "int8"
        if self._moment_q8 and use_multi_tensor:
            raise ValueError(
                "moment_dtype='int8' is supported on the per-param path "
                "only; drop use_multi_tensor")
        self._use_master_weights = use_master_weights
        self._stochastic_rounding = bool(stochastic_rounding)
        # the reference's fusable test: clip by norm and a coupled decay
        # take the per-parameter path
        self._use_multi_tensor = bool(use_multi_tensor) and bool(
            self._params) and weight_decay is None and not isinstance(
            grad_clip, ClipGradByNorm)
        self._flat: Optional[_Flat] = None
        self._materialize_state()

    def _materialize_state(self) -> None:
        if not self._use_multi_tensor:
            super()._materialize_state()
            return
        if self._use_master_weights is False:
            raise NotImplementedError("the master-free multi-tensor layout "
                                      "is not ported: use_master_weights="
                                      "False needs use_multi_tensor=False")
        if self._flat is None:
            self._flat = _Flat(self._params)

    def _on_params_cast(self) -> None:
        if self._flat is None:
            super()._on_params_cast()
            return
        if self._use_master_weights is False:
            raise NotImplementedError("the master-free multi-tensor layout "
                                      "is not ported")
        # the flat master holds the values from before the cast; the new
        # low-precision parameters become views of a buffer rounded from it
        self._flat.rebind()

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

    @torch.no_grad()
    def step(self) -> None:
        if self._flat is None:
            super().step()
            return
        gate = step_capture.current_gate()
        self._step_t.add_(1 if gate is None else gate.to(torch.int32))
        fs = self._flat
        live = fs.gather_grads()
        clip = self._grad_clip
        gscale = None
        if isinstance(clip, ClipGradByGlobalNorm):
            gscale = clip.scale(torch.linalg.vector_norm(
                fs.grad, dtype=torch.float32))
        sc = self._scalars(gate, gscale)
        for a, b in fs.runs(live):
            mta.multi_tensor_adam_update(
                fs.master[a:b], fs.m[a:b], fs.v[a:b],
                None if fs.param is None else fs.param[a:b], fs.grad[a:b],
                scalars=sc, eps=self._epsilon, beta1=self._beta1,
                beta2=self._beta2, has_wd=bool(self._wd_coeff),
                grad_scale=gscale is not None,
                clip_value=(clip.min, clip.max)
                if isinstance(clip, ClipGradByValue) else None)

    def _adam_core(self, p, g, sc, seed, keep) -> None:
        has_wd = bool(self._wd_coeff)
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
                g.contiguous().view(-1), scalars=sc, has_wd=has_wd,
                eps=self._epsilon, beta1=b1, beta2=b2,
                seed=seed if use_sr else 0, use_sr=use_sr)
            if master is not None:
                p.copy_(master)
            return
        lr, decay, c1, c2 = sc[0], sc[1], sc[2], sc[3]
        m, v = self._acc("moment1", p), self._acc("moment2", p)
        g32 = g.float()
        new_m = b1 * m.float() + (1 - b1) * g32
        new_v = b2 * v.float() + (1 - b2) * g32 * g32

        def put(dst, new):
            dst.copy_(new if keep is None else torch.where(keep, dst, new))
        put(m, new_m)
        put(v, new_v)
        base = master if master is not None else p.float()
        if has_wd:
            base = base * decay
        new_p = base - lr * (new_m / c1) / (torch.sqrt(new_v / c2)
                                            + self._epsilon)
        if master is not None:
            put(master, new_p)
            p.copy_(master)
        else:
            self._write_back(p, new_p, seed, keep)

    def _update_param(self, p, g, sc, seed, keep):
        self._adam_core(p, g, sc, seed, keep)


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
        self._wd_coeff = float(getattr(weight_decay, "coeff", weight_decay)
                               or 0.0)
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         use_multi_tensor, moment_dtype, use_master_weights,
                         stochastic_rounding, name, seed)
