"""Optimizers, the port of ``paddle_tpu/optimizer/__init__.py``:
``Optimizer`` (parameter list, step counter, ``step``, ``minimize``,
``clear_grad``), ``SGD``, ``Momentum``, ``Adam`` and ``AdamW`` with the JAX
package's constructor arguments and memory knobs, ``Adamax``, ``Adagrad``,
``Adadelta``, ``RMSProp``, ``Lamb``, ``LBFGS``, ``Rprop``, ``ASGD``,
``NAdam`` and ``RAdam``, the regularizers ``L1Decay`` and ``L2Decay``,
gradient clipping (``ClipGradByValue``, ``ClipGradByNorm``,
``ClipGradByGlobalNorm``) and the LR schedulers (``lr``).

* **Carried state on the device.** The step count ``_step_t`` (0-d int32)
  and the LR ``_lr_t`` (0-d fp32) live on the parameters' device, as the
  JAX package carries them: ``step()`` advances ``_step_t`` on the device,
  the bias corrections ``c1 = 1 - beta1^t``, ``c2 = 1 - beta2^t`` are
  computed there in fp32 from it (and every other function of ``t``:
  NAdam's momentum schedule, RAdam's rectification switch, ASGD's history
  slot), and the stochastic-rounding seeds are derived there from it (and
  the optimizer's ``seed``). An ``LRScheduler`` pushes each new value into
  ``_lr_t`` (``scheduler.step()`` between steps). Each step fills one
  block of device scalars (``lr``, ``decay = 1 - lr * wd``, ``c1``,
  ``c2``, the NaN gate, the global-norm scale; ``ops/q8_adam.py
  SCALARS``) that the updates read: a step captured as a CUDA graph
  (``jit.capture_step``) then replays with no value frozen. ``t`` reads
  the count (a host read). A host write to ``_lr_t`` or ``_step_t`` while
  a step is being captured raises ``HostStateWriteError``. ``LBFGS`` is
  eager only.
* ``moment_dtype`` ``"float32"``, ``"bfloat16"`` or ``"float16"``:
  per-parameter plain PyTorch elementwise math in fp32 over moments kept
  in that dtype (rounded to nearest), as the JAX package leaves it to XLA.
* ``moment_dtype="int8"``: every parameter's update is one launch of the
  fused int8 AdamW kernel (``ops/q8_adam.py``; its plain version on the
  CPU), ragged parameters included: the kernel masks the tail of the last
  2048-block, which gives what the JAX package's chunked leg gives.
  Accumulators keep the JAX names and layouts: ``moment1``,
  ``moment2_sqrt`` int8 ``(nb, 2048)`` and ``moment1_scale``,
  ``moment2_sqrt_scale`` fp32 ``(nb,)``. A legacy checkpoint's linear
  ``moment2`` / ``moment2_scale`` is converted on load, with the JAX
  package's warning.
* ``use_multi_tensor=True`` (the reference's fused path, ``_Flat``): one
  flat buffer each for the storage, m and v over every parameter, the
  step's gradients copied into a flat gradient (one ``_foreach_copy_``),
  and one launch of the multi-tensor AdamW kernel
  (``ops/multi_tensor_adam.py``) per run of the flat buffer (parameters
  with a gradient, of one dtype) a step. The storage is an fp32 master
  and the parameters views of it (fp32) or of a flat buffer of their dtype
  rounded to nearest from it; with ``use_master_weights=False`` and every
  parameter bf16 it is the bf16 parameters themselves (no fp32 buffer),
  written with stochastic rounding under one seed a step, drawn by flat
  index. The gradients are not kept as views of the flat gradient:
  backward then adds into each view (one kernel a parameter), where it
  hands a fresh gradient over at no cost, and the copy is cheaper than
  those adds (``tools/ab_flat_grads.py``). Refused with int8 moments, as
  there; ``ClipGradByNorm``, a coupled ``weight_decay`` of ``Adam`` and a
  parameter's own ``regularizer`` take the per-parameter path, as there.
  A parameter with no gradient keeps its state unchanged.
* Master weights (``SGD``, ``Momentum``, ``Adam``) follow
  ``_ensure_master``: ``use_master_weights=None`` keeps an fp32 master for
  each bf16/fp16 parameter; ``False`` keeps none and writes bf16 back with
  stochastic rounding (``stochastic_rounding``, on by default). The other
  optimizers keep no masters and cast their fp32 result to the
  parameter's dtype to nearest, as there.
* A parameter's own ``regularizer`` (``L1Decay``: ``coeff * sign(p)``,
  ``L2Decay``: ``coeff * p``) is added to its gradient before the update
  and takes precedence over the optimizer's coupled ``weight_decay``; it
  applies under ``AdamW`` too. As in the JAX package, an optimizer-level
  ``weight_decay=L1Decay(c)`` adds ``c * p``, the L2 form. Parameters that
  do not require a gradient are skipped.
* Under the NaN gate of a captured step (``core.step_capture.gated``), or
  ``amp.GradScaler``'s found-inf gate, a step whose loss or gradients are
  not finite writes nothing and leaves ``_step_t`` where it was, decided
  on the device.
* **Parameter groups** (``_normalize_param_groups``): a list of dicts
  ``{"params", "learning_rate" (a scale of the LR), "weight_decay",
  "grad_clip"}``. A group's clip replaces the optimizer's for its
  parameters; a group's ``weight_decay`` is ``Adam``'s coupled L2 and, as
  in the reference, has no effect on ``AdamW`` (whose decay is its
  ``weight_decay`` coefficient). ``AdamW``'s ``lr_ratio(p)`` scales a
  parameter's LR and ``apply_decay_param_fun(name)`` says whether it
  decays. A parameter's name is its ``param_name`` attribute where it
  has one (a torch tensor's ``name`` is read-only; :func:`set_parameter_names`
  gives each parameter of a module its state-dict key), else
  ``param_<i>``, its place in the optimizer's list; ``apply_decay_param_fun``
  raises unless every parameter has a ``param_name``. Names, LR scales and
  decay flags are read once, when the optimizer is built, for both paths
  (a JAX parameter's name is fixed when it is made).
  On the per-parameter path a parameter with another LR scale or no decay
  takes its own block of scalars (``lr * scale``, ``1 - lr * scale * wd``);
  on the multi-tensor path the scales and decay flags are per-tensor
  tables the kernel reads. A group with its own clip or weight decay, and
  an optimizer-level ``ClipGradByGlobalNorm`` over more than one group
  (each group is clipped by its own norm), take the per-parameter path,
  as the reference's fusable test does.
* ``state_dict`` / ``set_state_dict`` (``set_dict``) with the JAX
  package's keys: ``step``, ``LR_Scheduler``, ``<name>_<accumulator>``
  and ``master_weights`` ``{name: master}`` for low-precision parameters
  (the multi-tensor layout exposes per-parameter views of its flat
  buffers, as there: in the master-free layout the bf16 slices of the
  parameters themselves). Values load from tensors or numpy arrays, so a
  state saved by either package loads in the other.

Not ported (it raises): ``lazy_mode``, which needs SelectedRows
gradients.
"""

from __future__ import annotations

import warnings
import weakref
from typing import Dict, List, Optional

import torch

from ..core import step_capture
from ..ops import multi_tensor_adam as mta
from ..ops import q8_adam
from ..ops._u32 import M32, derive_seed
from ..ops.q8_adam import sqrt_rn
from ..regularizer import L1Decay, L2Decay
from . import lr as lr_mod
from .lr import LRScheduler

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "L1Decay", "L2Decay", "LBFGS", "Lamb", "Momentum", "NAdam",
           "Optimizer", "RAdam", "RMSProp", "Rprop", "SGD", "lr",
           "set_parameter_names"]

lr = lr_mod

_LOW = (torch.bfloat16, torch.float16)
_FLAT_ALIGN = 64       # elements: each parameter's offset in the flat buffers
_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16, "int8": torch.float32}


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


def _normalize_param_groups(parameters) -> List[dict]:
    """A flat parameter list, or paddle-style group dicts ``{'params',
    'learning_rate' (scale), 'weight_decay', 'grad_clip'}``, as groups."""
    plist = list(parameters)
    if plist and isinstance(plist[0], dict):
        groups = [{"params": list(g["params"]),
                   "learning_rate": g.get("learning_rate", 1.0),
                   "weight_decay": g.get("weight_decay", None),
                   "grad_clip": g.get("grad_clip", None)} for g in plist]
    else:
        groups = [{"params": plist, "learning_rate": 1.0,
                   "weight_decay": None, "grad_clip": None}]
    for g in groups:
        if g["grad_clip"] is not None and not isinstance(g["grad_clip"],
                                                         _ClipBase):
            raise TypeError(f"a group's grad_clip must be a ClipGradBy* "
                            f"object, got {type(g['grad_clip']).__name__}")
    return groups


def set_parameter_names(module: torch.nn.Module, prefix: str = "") -> None:
    """Give each parameter of ``module`` its state-dict key (after
    ``prefix``) as its ``param_name``: the name ``apply_decay_param_fun``
    sees and the optimizer's ``state_dict`` keys carry."""
    for n, p in module.named_parameters():
        p.param_name = prefix + n


def _as_tensor(src) -> torch.Tensor:
    """A state-dict value (tensor or numpy array, bf16 included) as a
    tensor of its own dtype."""
    if isinstance(src, torch.Tensor):
        return src
    from ..convert import _to_tensor
    return _to_tensor(getattr(src, "_data", src))


def _load(src, like: torch.Tensor) -> torch.Tensor:
    """A state-dict value as a tensor of ``like``'s dtype, shape and
    device."""
    return _as_tensor(src).to(device=like.device, dtype=like.dtype) \
        .reshape(like.shape)


def _put(dst: torch.Tensor, new: torch.Tensor, keep) -> None:
    """``dst <- new`` in ``dst``'s dtype (to nearest), or nothing where
    ``keep`` (the gate withheld the step)."""
    dst.copy_(new if keep is None else torch.where(keep, dst, new))


def _weak(c: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a JAX weak-typed scalar meets ``like``: rounded to
    ``like``'s dtype first (a fill on its device, so a captured step can
    hold it)."""
    return torch.full((), c, dtype=like.dtype, device=like.device)


def _pow32(base: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """``base ** exp`` of fp32 tensors, correctly rounded to fp32 (taken in
    fp64 on the device), as XLA's ``pow`` gives it: the same bits on the
    card and on the CPU, whose fp32 ``pow`` is an ulp off at some
    exponents, an error ``1 - beta2^t`` magnifies a thousandfold."""
    return (base.double() ** exp.double()).float()


def _moment_dtype(moment_dtype) -> torch.dtype:
    """``moment_dtype``'s storage dtype (``int8`` keeps fp32 here, its
    codes are separate accumulators), or the JAX package's error."""
    key = str(moment_dtype).replace("torch.", "")
    if key not in _MOMENT_DTYPES:
        raise TypeError(f"data type {moment_dtype!r} not understood")
    return _MOMENT_DTYPES[key]


class Optimizer:
    """Base class: the parameter groups and their flat list, the carried
    step count and LR, and the per-parameter state (accumulators and fp32
    masters, keyed by the parameter's ``id``)."""

    _betas = (0.0, 0.0)   # c1 = c2 = 1 for an optimizer without moments
    _wd_coeff = 0.0
    _coupled_decay = True   # a weight_decay is L2 added to the gradient
    _lr_ratio = None
    _apply_decay_param_fun = None
    _uses_masters = False   # SGD, Momentum and Adam keep fp32 masters

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, seed: int = 0):
        if parameters is None:
            raise ValueError("pass parameters=model.parameters()")
        if grad_clip is not None and not isinstance(grad_clip, _ClipBase):
            raise TypeError(f"grad_clip must be a ClipGradBy* object, got "
                            f"{type(grad_clip).__name__}")
        self._groups = _normalize_param_groups(parameters)
        params = [p for g in self._groups for p in g["params"]]
        self._params = params
        self._index = {id(p): i for i, p in enumerate(params)}
        # names, LR scales and decay flags are read once, here, as a JAX
        # parameter's name is fixed when it is made
        self._names = [getattr(p, "param_name", None) or f"param_{i}"
                       for i, p in enumerate(params)]
        if self._apply_decay_param_fun is not None and any(
                getattr(p, "param_name", None) is None for p in params):
            raise ValueError("apply_decay_param_fun needs every parameter's "
                             "param_name: call set_parameter_names(model) "
                             "before building the optimizer")
        self._meta = self._param_meta()
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
        c = 1.0 - _pow32(self._betas_t, self._step_t)
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
    def _acc(self, name: str, p: torch.Tensor, init=None,
             dtype=torch.float32) -> torch.Tensor:
        store = self._accumulators.setdefault(name, {})
        t = store.get(id(p))
        if t is None:
            t = torch.zeros_like(p, dtype=dtype) if init is None else init
            store[id(p)] = t
        return t

    def _state(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """Accumulator ``name`` of ``p``, made by
        :meth:`_create_accumulators` where it is missing."""
        t = self._accumulators.get(name, {}).get(id(p))
        if t is None:
            self._create_accumulators(p)
            t = self._accumulators[name][id(p)]
        return t

    def _ensure_master(self, p: torch.Tensor) -> Optional[torch.Tensor]:
        """fp32 master of a low-precision parameter (AMP O2), or None."""
        if not self._uses_masters or self._use_master_weights is False \
                or p.dtype not in _LOW:
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
            if p.requires_grad:
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
        _put(p, new, keep)

    def _write_param(self, p, new32, seed, keep) -> None:
        """An fp32 update into ``p`` through its master where it has one,
        else :meth:`_write_back`."""
        master = self._ensure_master(p)
        if master is None:
            self._write_back(p, new32, seed, keep)
            return
        _put(master, new32, keep)
        p.copy_(master)

    # -- names, LR scales and decay flags ------------------------------------
    def _name(self, i: int) -> str:
        return self._names[i]

    def _param_meta(self) -> List[tuple]:
        """``(lr scale, decays)`` of each parameter: the group's LR scale
        times ``optimize_attr``'s times ``lr_ratio(p)``; whether
        ``apply_decay_param_fun`` lets it decay (read once, at
        construction, for both paths)."""
        out = []
        for g in self._groups:
            for p in g["params"]:
                scale = float(g["learning_rate"]) * float(getattr(
                    p, "optimize_attr", {}).get("learning_rate", 1.0))
                if self._lr_ratio is not None:
                    scale *= float(self._lr_ratio(p))
                fun = self._apply_decay_param_fun
                decays = fun is None or bool(fun(self._name(
                    self._index[id(p)])))
                out.append((scale, decays))
        return out

    def _param_scalars(self, sc: torch.Tensor, meta: tuple,
                       cache: dict) -> torch.Tensor:
        """The step's scalar block for a parameter of ``meta``: ``sc``
        itself at scale 1 with decay, else one with ``lr * scale`` and
        ``1 - lr * scale * wd`` (made once a step for each ``meta``)."""
        scale, decays = meta
        if scale == 1.0 and (decays or not self._wd_coeff):
            return sc
        blk = cache.get(meta)
        if blk is None:
            lr = sc[0] if scale == 1.0 else sc[0] * scale
            decay = 1.0 - lr * self._wd_coeff if decays else sc[1]
            blk = cache[meta] = torch.stack([lr, decay, *sc[2:]])
        return blk

    # -- the step -------------------------------------------------------------
    def _params_grads(self, group) -> list:
        """``(p, g)`` of the group's trainable parameters with a gradient,
        clipped by the group's or the optimizer's clip."""
        pg = [(p, p.grad) for p in group["params"]
              if p.grad is not None and p.requires_grad]
        clip = group["grad_clip"] or self._grad_clip
        return clip(pg) if clip is not None else pg

    def _decayed_grad(self, p, g, wd):
        """The gradient with the parameter's own regularizer added (L1:
        ``coeff * sign(p)``, L2: ``coeff * p``), else the coupled decay
        ``coeff * p`` of a ``weight_decay`` (whatever its kind)."""
        reg = getattr(p, "regularizer", None)
        if reg is not None:
            return g + _weak(reg.coeff, p) * (
                p if getattr(reg, "_l2", True) else torch.sign(p))
        if wd is not None and self._coupled_decay:
            return g + _weak(float(getattr(wd, "coeff", wd)), p) * p
        return g

    @torch.no_grad()
    def step(self) -> None:
        gate = step_capture.current_gate()
        self._step_t.add_(1 if gate is None else gate.to(torch.int32))
        sc = self._scalars(gate)
        seeds = self._sr_seeds() if self._needs_seeds() else None
        meta, cache = self._meta, {}
        for group in self._groups:
            wd = group["weight_decay"] if group["weight_decay"] is not None \
                else self._weight_decay
            for p, g in self._params_grads(group):
                g = self._decayed_grad(p, g, wd)
                i = self._index[id(p)]
                self._update_param(
                    p, g, self._param_scalars(sc, meta[i], cache),
                    None if seeds is None else seeds[i],
                    None if gate is None else ~gate,
                    bool(self._wd_coeff) and meta[i][1])

    def _needs_seeds(self) -> bool:
        return self._uses_masters and self._stochastic_rounding and \
            self._use_master_weights is False and any(
                p.dtype == torch.bfloat16 for p in self._params)

    def _update_param(self, p, g, sc, seed, keep, has_wd: bool) -> None:
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` and :meth:`step` (eager only: the port has
        no static graph mode)."""
        loss.backward()
        self.step()
        return None, None

    # -- state ----------------------------------------------------------------
    def _state_views(self):
        """``(name, accumulator name, tensor)`` of every accumulator and
        ``(name, None, master)`` of every fp32 master."""
        for i, p in enumerate(self._params):
            for acc, store in self._accumulators.items():
                t = store.get(id(p))
                if t is not None:
                    yield self._name(i), acc, t
            if id(p) in self._master_weights:
                yield self._name(i), None, self._master_weights[id(p)]

    def state_dict(self) -> dict:
        """The JAX package's keys (see the module docstring); the values
        are the live tensors (views of the flat buffers on the
        multi-tensor path)."""
        state = {"step": self._step_t}
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        for name, acc, t in self._state_views():
            if acc is None:
                state.setdefault("master_weights", {})[name] = t
            else:
                state[f"{name}_{acc}"] = t
        return state

    @torch.no_grad()
    def set_state_dict(self, state: dict) -> None:
        """Load a state of :meth:`state_dict`'s keys, from either package
        (tensors or numpy arrays)."""
        step_capture.check_host_write("Optimizer._step_t")
        self._step_t.copy_(_load(state.get("step", 0), self._step_t))
        if isinstance(self._learning_rate, LRScheduler) and \
                "LR_Scheduler" in state:
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
            self._sync_lr_tensor()
        mw = state.get("master_weights", {})
        for name, acc, t in list(self._state_views()):
            src = mw.get(name) if acc is None else state.get(f"{name}_{acc}")
            if src is not None:
                t.copy_(_load(src, t))

    set_dict = set_state_dict


class SGD(Optimizer):
    """``p -= lr * g``, through the fp32 master of a low-precision
    parameter (O2) or, master-free, written back with stochastic rounding
    (bf16)."""

    _uses_masters = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, seed: int = 0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, seed)
        self._materialize_state()

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        master = self._ensure_master(p)
        base = master if master is not None else p.float()
        self._write_param(p, base - sc[0] * g.float(), seed, keep)


class Momentum(Optimizer):
    """``v = momentum * v + g`` (fp32 ``velocity``), ``p -= lr * v`` or,
    with ``use_nesterov``, ``p -= lr * (g + momentum * v)``; masters and
    write-back as :class:`SGD`."""

    _uses_masters = True

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None, seed: int = 0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, seed)
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._materialize_state()

    def _create_accumulators(self, p):
        self._acc("velocity", p)

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        v = self._acc("velocity", p)
        g32 = g.float()
        new_v = self._momentum * v + g32
        _put(v, new_v, keep)
        upd = g32 + self._momentum * new_v if self._nesterov else new_v
        master = self._ensure_master(p)
        base = master if master is not None else p.float()
        self._write_param(p, base - sc[0] * upd, seed, keep)


class _Flat:
    """The multi-tensor layout: every parameter's slice of the flat
    buffers starts at a multiple of ``_FLAT_ALIGN`` elements (zeros
    between, which the update leaves at zero). ``master`` is the storage:
    fp32, or the bf16 parameters themselves in the master-free layout
    (``master_free`` and every parameter bf16); ``m`` and ``v`` are of
    ``moment_dtype``; ``lows`` holds a flat buffer for each low-precision
    dtype of the parameters beside an fp32 master (its parameters' slices
    rounded to nearest from the master; ``param`` is that buffer where
    all parameters share its dtype)."""

    def __init__(self, params: List[torch.Tensor], moment_dtype=torch.float32,
                 master_free: bool = False):
        self.params = params
        self.offsets = []
        total = 0
        for p in params:
            self.offsets.append((total, p.numel()))
            total += -(-p.numel() // _FLAT_ALIGN) * _FLAT_ALIGN
        self.total = total
        dev = params[0].device
        storage = torch.bfloat16 if self._bf16_storage(master_free) \
            else torch.float32
        self.master = torch.zeros(total, dtype=storage, device=dev)
        with torch.no_grad():
            for p, (off, n) in zip(params, self.offsets):
                self.master[off:off + n].copy_(p.detach().reshape(-1))
        self.m = torch.zeros(total, dtype=moment_dtype, device=dev)
        self.v = torch.zeros_like(self.m)
        self.lows: Dict[torch.dtype, torch.Tensor] = {}
        self.grad = torch.empty(0)
        self.tables: Optional[tuple] = None
        self.rebind()

    def _bf16_storage(self, master_free: bool) -> bool:
        return master_free and all(p.dtype == torch.bfloat16
                                   for p in self.params)

    @property
    def master_free(self) -> bool:
        return self.master.dtype == torch.bfloat16

    @property
    def param(self) -> Optional[torch.Tensor]:
        """The flat parameter buffer beside an fp32 master where every
        parameter has its one low-precision dtype, else None."""
        dtypes = {p.dtype for p in self.params}
        return self.lows.get(dtypes.pop()) if len(dtypes) == 1 else None

    def state_bytes(self) -> int:
        """Bytes of the optimizer's state: the storage, m and v."""
        return sum(t.numel() * t.element_size()
                   for t in (self.master, self.m, self.v))

    def set_tables(self, meta: List[tuple]) -> None:
        """The kernel's per-tensor tables from each parameter's ``(lr
        scale, decays)``: every slice's end in the flat buffers (int64),
        its LR scale and decay flag (fp32); None where every parameter has
        scale 1 and decays."""
        if all(m == (1.0, True) for m in meta):
            self.tables = None
            return
        dev = self.master.device
        ends = [off + -(-n // _FLAT_ALIGN) * _FLAT_ALIGN
                for off, n in self.offsets]
        self.tables = (
            torch.tensor(ends, dtype=torch.int64, device=dev),
            torch.tensor([s for s, _ in meta], dtype=torch.float32,
                         device=dev),
            torch.tensor([1.0 if d else 0.0 for _, d in meta],
                         dtype=torch.float32, device=dev))

    def views(self, flat: torch.Tensor):
        return [flat[off:off + n].view(p.shape)
                for p, (off, n) in zip(self.params, self.offsets)]

    def recast(self, master_free: bool) -> None:
        """``amp.decorate`` cast the parameters: in the master-free layout
        of bf16 parameters the storage becomes bf16, rounded to nearest
        from the values it held (those before the cast), and no fp32
        buffer is kept; otherwise the fp32 master keeps them. Then
        :meth:`rebind`."""
        bf16 = self._bf16_storage(master_free)
        if bf16 != self.master_free:
            self.master = self.master.to(torch.bfloat16 if bf16
                                         else torch.float32)
        self.rebind()

    def rebind(self) -> None:
        """Make the parameters views of the storage (fp32 parameters of
        the master, every parameter in the master-free layout) or of the
        flat buffer of their dtype rounded from the master, and allocate
        the flat gradient: of the parameters' dtype, fp32 where they mix
        dtypes."""
        dtypes = {p.dtype for p in self.params}
        self.lows = {} if self.master_free else {
            dt: self.master.to(dt) for dt in sorted(dtypes, key=str)
            if dt != torch.float32}
        for p, view in zip(self.params, self.views(self.master)):
            flat = self.lows.get(p.dtype)
            p.data = view if flat is None else \
                flat[view.storage_offset():][:view.numel()].view(p.shape)
        self.grad = torch.zeros(
            self.total, dtype=dtypes.pop() if len(dtypes) == 1
            else torch.float32, device=self.master.device)
        self._grad_views = self.views(self.grad)
        self._dtype_at = {off: p.dtype
                          for p, (off, _) in zip(self.params, self.offsets)}
        self._runs_cache: Dict[tuple, list] = {}

    def gather_grads(self) -> tuple:
        """Copy this step's gradients into the flat gradient (zeros for a
        parameter without one or that does not require one; a gradient
        already there is not copied) and return which parameters have
        one."""
        live = tuple(p.grad is not None and p.requires_grad
                     for p in self.params)
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

    def dtype_at(self, start: int) -> torch.dtype:
        """The dtype of the parameters of the run starting at ``start``."""
        return self._dtype_at[start]

    def runs(self, live: tuple) -> list:
        """``(start, end)`` of the flat ranges to update: the whole buffer,
        or the runs of parameters of one dtype that have a gradient."""
        r = self._runs_cache.get(live)
        if r is None:
            r = []
            prev = None
            for ok, p, (off, n) in zip(live, self.params, self.offsets):
                if not ok:
                    continue
                end = off + -(-n // _FLAT_ALIGN) * _FLAT_ALIGN
                if r and r[-1][1] == off and prev == p.dtype:
                    r[-1] = (r[-1][0], end)
                else:
                    r.append((off, end))
                prev = p.dtype
            self._runs_cache[live] = r
        return r


class Adam(Optimizer):
    """``paddle.optimizer.Adam`` with the JAX package's memory knobs
    ``moment_dtype`` (``"float32"``, ``"bfloat16"``, ``"float16"`` or
    ``"int8"``) and ``use_master_weights`` and its multi-tensor path (see
    the module docstring). ``seed`` seeds the stochastic-rounding bits.
    With bf16 moments and ``use_master_weights=False`` over bf16
    parameters the state is 6 bytes a parameter (bf16 parameter, m and v).
    """

    _uses_masters = True

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
        self._moment_dtype = _moment_dtype(moment_dtype)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._moment_q8 = str(moment_dtype) == "int8"
        if self._moment_q8 and use_multi_tensor:
            raise ValueError(
                "moment_dtype='int8' is supported on the per-param path "
                "only; drop use_multi_tensor")
        self._use_master_weights = use_master_weights
        self._stochastic_rounding = bool(stochastic_rounding)
        # the reference's fusable test: clip by norm, a coupled decay, a
        # parameter's regularizer, a group's own clip or decay, and a
        # global norm over several groups (each group clipped by its own
        # norm) take the per-parameter path
        self._use_multi_tensor = bool(use_multi_tensor) and bool(
            self._params) and weight_decay is None and not isinstance(
            grad_clip, ClipGradByNorm) and all(
            g["grad_clip"] is None and g["weight_decay"] is None
            for g in self._groups) and (len(self._groups) == 1 or
                                        not isinstance(grad_clip,
                                                       ClipGradByGlobalNorm)) \
            and all(getattr(p, "regularizer", None) is None
                    for p in self._params)
        self._flat: Optional[_Flat] = None
        self._materialize_state()

    def _materialize_state(self) -> None:
        if not self._use_multi_tensor:
            super()._materialize_state()
            return
        if self._flat is None:
            self._flat = _Flat(self._params, self._moment_dtype,
                               self._use_master_weights is False)
            self._flat.set_tables(self._meta)

    def _on_params_cast(self) -> None:
        if self._flat is None:
            super()._on_params_cast()
            return
        # the flat master holds the values from before the cast: the new
        # low-precision parameters become views of a buffer rounded from
        # it, or of the bf16 storage itself (master-free)
        self._flat.recast(self._use_master_weights is False)

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
            self._acc(name, p, dtype=self._moment_dtype)

    def _flat_seed(self) -> Optional[torch.Tensor]:
        """The step's seed of the master-free layout's rounding: draw
        ``t`` of the optimizer's ``seed``, on the device (one a step)."""
        if not (self._flat.master_free and self._stochastic_rounding):
            return None
        return derive_seed(self._seed_t, self._step_t.long())

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
        seed = self._flat_seed()
        for a, b in fs.runs(live):
            low = fs.lows.get(fs.dtype_at(a))
            mta.multi_tensor_adam_update(
                fs.master[a:b], fs.m[a:b], fs.v[a:b],
                None if low is None else low[a:b], fs.grad[a:b],
                scalars=sc, eps=self._epsilon, beta1=self._beta1,
                beta2=self._beta2, has_wd=bool(self._wd_coeff),
                grad_scale=gscale is not None,
                clip_value=(clip.min, clip.max)
                if isinstance(clip, ClipGradByValue) else None,
                tables=fs.tables, base=a, wd=self._wd_coeff, seed=seed,
                stochastic_rounding=seed is not None)

    def _state_views(self):
        if self._flat is None:
            yield from super()._state_views()
            return
        fs = self._flat
        for i, (p, m, v, w) in enumerate(zip(
                fs.params, fs.views(fs.m), fs.views(fs.v),
                fs.views(fs.master))):
            yield self._name(i), "moment1", m
            yield self._name(i), "moment2", v
            if p.dtype in _LOW:
                yield self._name(i), None, w

    @torch.no_grad()
    def set_state_dict(self, state: dict) -> None:
        super().set_state_dict(state)
        if self._moment_q8:
            self._convert_legacy_q8_v(state)

    set_dict = set_state_dict

    def _convert_legacy_q8_v(self, state: dict) -> None:
        """A legacy int8 checkpoint keeps ``moment2`` as linear-v int8
        codes with ``moment2_scale``; the layout is sqrt-space under
        ``moment2_sqrt``: convert per block on load, with the JAX package's
        warning (binding the codes directly would square-shrink v)."""
        legacy = [(i, p) for i, p in enumerate(self._params)
                  if f"{self._name(i)}_moment2" in state]
        if not legacy:
            return
        warnings.warn("converting legacy int8 moment2 (linear v) checkpoint "
                      "state to the sqrt-space layout (moment2_sqrt)")
        for i, p in legacy:
            q = _as_tensor(state[f"{self._name(i)}_moment2"])
            sc = state.get(f"{self._name(i)}_moment2_scale")
            codes = self._acc("moment2_sqrt", p)
            scale = self._acc("moment2_sqrt_scale", p)
            if sc is None or q.dtype != torch.int8:
                continue
            sc = _load(sc, scale)
            v = torch.clamp(q.to(scale.device).float() * sc[:, None], min=0.0)
            nq, nsc = q8_adam.q8_quantize(sqrt_rn(v).reshape(-1))
            codes.copy_(nq)
            scale.copy_(nsc)

    def _adam_core(self, p, g, sc, seed, keep, has_wd) -> None:
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
        m = self._acc("moment1", p, dtype=self._moment_dtype)
        v = self._acc("moment2", p, dtype=self._moment_dtype)
        g32 = g.float()
        new_m = b1 * m.float() + (1 - b1) * g32
        new_v = b2 * v.float() + (1 - b2) * g32 * g32
        _put(m, new_m, keep)
        _put(v, new_v, keep)
        base = master if master is not None else p.float()
        if has_wd:
            base = base * decay
        new_p = base - lr * (new_m / c1) / (sqrt_rn(new_v / c2)
                                            + self._epsilon)
        self._write_param(p, new_p, seed, keep)

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        self._adam_core(p, g, sc, seed, keep, has_wd)


class AdamW(Adam):
    """Decoupled weight decay (``weight_decay`` default 0.01), on every
    parameter that ``apply_decay_param_fun(name)`` lets decay (all without
    one); ``lr_ratio(p)`` scales a parameter's LR."""

    _coupled_decay = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, moment_dtype="float32",
                 use_master_weights=None, stochastic_rounding=True,
                 name=None, seed: int = 0):
        self._wd_coeff = float(getattr(weight_decay, "coeff", weight_decay)
                               or 0.0)
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         use_multi_tensor, moment_dtype, use_master_weights,
                         stochastic_rounding, name, seed)


class Adamax(Optimizer):
    """Adam with the infinity norm: ``u = max(beta2 * u, |g|)``,
    ``p -= (lr / (1 - beta1^t)) * m / (u + eps)`` (fp32 ``moment``,
    ``inf_norm``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._betas = (beta1, beta2)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._materialize_state()

    def _create_accumulators(self, p):
        self._acc("moment", p)
        self._acc("inf_norm", p)

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        m, u = self._acc("moment", p), self._acc("inf_norm", p)
        g32 = g.float()
        new_m = self._beta1 * m + (1 - self._beta1) * g32
        new_u = torch.maximum(self._beta2 * u, torch.abs(g32))
        _put(m, new_m, keep)
        _put(u, new_u, keep)
        _put(p, (p.float() - sc[0] / sc[2] * new_m / (new_u + self._epsilon)
                 ).to(p.dtype), keep)


class Adagrad(Optimizer):
    """``acc += g^2``, ``p -= lr * g / (sqrt(acc) + eps)``; the fp32
    ``moment`` starts at ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value
        self._materialize_state()

    def _create_accumulators(self, p):
        self._acc("moment", p, torch.full_like(p, self._init_acc,
                                               dtype=torch.float32))

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        acc = self._state("moment", p)
        g32 = g.float()
        new_acc = acc + g32 * g32
        _put(acc, new_acc, keep)
        _put(p, (p.float() - sc[0] * g32 / (sqrt_rn(new_acc)
                                            + self._epsilon)).to(p.dtype),
             keep)


class Adadelta(Optimizer):
    """``upd = sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) * g``,
    ``p -= lr * upd`` (fp32 ``avg_squared_grad``,
    ``avg_squared_update``)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho
        self._materialize_state()

    def _create_accumulators(self, p):
        self._acc("avg_squared_grad", p)
        self._acc("avg_squared_update", p)

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        avg_sq = self._acc("avg_squared_grad", p)
        avg_upd = self._acc("avg_squared_update", p)
        g32, rho = g.float(), self._rho
        new_sq = rho * avg_sq + (1 - rho) * g32 * g32
        upd = sqrt_rn(avg_upd + self._epsilon) / \
            sqrt_rn(new_sq + self._epsilon) * g32
        new_upd = rho * avg_upd + (1 - rho) * upd * upd
        _put(avg_sq, new_sq, keep)
        _put(avg_upd, new_upd, keep)
        _put(p, (p.float() - sc[0] * upd).to(p.dtype), keep)


class RMSProp(Optimizer):
    """``E[g^2] = rho E[g^2] + (1 - rho) g^2`` (less ``E[g]^2`` when
    ``centered``), ``mom = momentum * mom + lr * g / sqrt(. + eps)``,
    ``p -= mom`` (fp32 ``mean_square``, ``momentum``, ``mean_grad``)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered
        self._materialize_state()

    def _create_accumulators(self, p):
        self._acc("mean_square", p)
        self._acc("momentum", p)
        if self._centered:
            self._acc("mean_grad", p)

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        ms, mom = self._acc("mean_square", p), self._acc("momentum", p)
        g32, rho = g.float(), self._rho
        new_ms = rho * ms + (1 - rho) * g32 * g32
        _put(ms, new_ms, keep)
        denom = new_ms
        if self._centered:
            mg = self._acc("mean_grad", p)
            new_mg = rho * mg + (1 - rho) * g32
            _put(mg, new_mg, keep)
            denom = new_ms - new_mg * new_mg
        upd = self._momentum * mom + sc[0] * g32 / sqrt_rn(
            denom + self._epsilon)
        _put(mom, upd, keep)
        _put(p, (p.float() - upd).to(p.dtype), keep)


class Lamb(Optimizer):
    """Adam's ratio ``r = m_hat / (sqrt(v_hat) + eps)`` plus
    ``lamb_weight_decay * p`` (none where ``exclude_from_weight_decay_fn(p)``),
    scaled by the trust ratio ``||p|| / ||upd||`` (1 where either is 0),
    computed on the device (the norms summed in fp64)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        self._betas = (beta1, beta2)
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn
        self._materialize_state()

    def _create_accumulators(self, p):
        self._acc("moment1", p)
        self._acc("moment2", p)

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        m, v = self._acc("moment1", p), self._acc("moment2", p)
        g32, b1, b2 = g.float(), self._beta1, self._beta2
        new_m = b1 * m + (1 - b1) * g32
        new_v = b2 * v + (1 - b2) * g32 * g32
        _put(m, new_m, keep)
        _put(v, new_v, keep)
        r = (new_m / sc[2]) / (sqrt_rn(new_v / sc[3]) + self._epsilon)
        wd = 0.0 if (self._exclude_fn is not None and self._exclude_fn(p)) \
            else self._lamb_wd
        p32 = p.float()
        upd = r + wd * p32
        # the norms summed in fp64 and rounded once: an fp32 sum over an
        # embedding's millions of elements is off by 1e-4 in a CPU's
        # order (the card's by far less), and the trust ratio carries it
        w_norm = torch.linalg.vector_norm(p32, dtype=torch.float64).float()
        u_norm = torch.linalg.vector_norm(upd, dtype=torch.float64).float()
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        _put(p, (p32 - sc[0] * trust * upd).to(p.dtype), keep)


class LBFGS(Optimizer):
    """The JAX package's ``LBFGS`` shim, ported as it is: ``step(closure)``
    takes ``max_iter`` steps of plain descent ``p -= lr * g``, calling
    ``closure()`` (forward and backward, returning the loss) before each,
    and returns the last loss; ``step()`` without a closure takes one step
    on the gradients there. No history, no line search, no step count.
    Eager only: the closure's host calls cannot be captured."""

    def __init__(self, learning_rate=1.0, max_iter=20, history_size=100,
                 parameters=None, **kw):
        super().__init__(learning_rate, parameters, None, None)
        self._max_iter = max_iter

    @torch.no_grad()
    def _descend(self) -> None:
        lr = self.get_lr()
        for p, g in self._params_grads({"params": self._params,
                                         "grad_clip": None}):
            p.copy_(p - _weak(lr, g) * g)

    def step(self, closure=None):
        if closure is None:
            self._descend()
            return None
        loss = None
        for _ in range(self._max_iter):
            self.clear_grad()
            with torch.enable_grad():
                loss = closure()
            self._descend()
        return loss


class Rprop(Optimizer):
    """Resilient backpropagation: per-element step sizes (fp32
    ``step_size``, starting at the LR) grown by ``etas[1]`` where the
    gradient keeps its sign and shrunk by ``etas[0]`` where it flips,
    clipped to ``learning_rate_range``; a flipped gradient takes no step
    and is kept as 0 (``prev_grad``)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_range = (float(learning_rate_range[0]),
                          float(learning_rate_range[1]))
        self._etas = (float(etas[0]), float(etas[1]))
        self._materialize_state()

    def _create_accumulators(self, p):
        lr0 = self._learning_rate.last_lr if isinstance(
            self._learning_rate, LRScheduler) else self._learning_rate
        self._acc("prev_grad", p)
        self._acc("step_size", p, torch.full_like(p, float(lr0),
                                                  dtype=torch.float32))

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        prev, size = self._state("prev_grad", p), self._state("step_size", p)
        g32 = g.float()
        sign = torch.sign(g32 * prev)
        eta_minus, eta_plus = self._etas
        one = torch.ones_like(sign)
        factor = torch.where(sign > 0, eta_plus * one,
                             torch.where(sign < 0, eta_minus * one, one))
        new_size = torch.clamp(size * factor, self._lr_range[0],
                               self._lr_range[1])
        g_eff = torch.where(sign < 0, torch.zeros_like(g32), g32)
        _put(size, new_size, keep)
        _put(prev, g_eff, keep)
        _put(p, (p.float() - torch.sign(g_eff) * new_size).to(p.dtype), keep)


class ASGD(Optimizer):
    """Averaged SGD: ``p -= lr * d / min(t, batch_num)``, ``d`` the sum of
    the last ``batch_num`` gradients (fp32 ``d``; the history
    ``grad_hist`` ``(batch_num, *shape)``, slot ``(t - 1) % batch_num``
    chosen on the device)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._batch_num = max(1, int(batch_num))
        self._materialize_state()

    def _create_accumulators(self, p):
        self._acc("d", p)
        if self._batch_num > 1:
            self._acc("grad_hist", p, torch.zeros(
                (self._batch_num, *p.shape), dtype=torch.float32,
                device=p.device))

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        d = self._acc("d", p)
        g32 = g.float()
        t = self._step_t
        if self._batch_num > 1:
            hist = self._state("grad_hist", p)
            slot = ((t.long() - 1) % self._batch_num).reshape(1)
            old = hist.index_select(0, slot)[0]
            new_d = d - old + g32
            hist.index_copy_(0, slot, (g32 if keep is None else torch.where(
                keep, old, g32)).unsqueeze(0))
        else:
            new_d = g32
        _put(d, new_d, keep)
        n = torch.clamp(t.float(), max=float(self._batch_num))
        _put(p, (p.float() - sc[0] * new_d / n).to(p.dtype), keep)


class NAdam(Optimizer):
    """Adam with Nesterov momentum: the momentum schedule ``mu_t = beta1
    (1 - 0.5 * 0.96^(t psi))`` and its running product (the 0-d fp32
    ``mu_product``), ``p -= lr * m_hat / (sqrt(v / (1 - beta2^t)) +
    eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        self._betas = (beta1, beta2)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon, self._psi = epsilon, momentum_decay
        self._materialize_state()

    def _create_accumulators(self, p):
        self._acc("moment1", p)
        self._acc("moment2", p)
        self._acc("mu_product", p, torch.ones((), dtype=torch.float32,
                                              device=p.device))

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        m, v = self._acc("moment1", p), self._acc("moment2", p)
        mu_prod = self._state("mu_product", p)
        g32, b1, b2 = g.float(), self._beta1, self._beta2
        t = self._step_t.float()
        base = torch.full((), 0.96, dtype=torch.float32, device=t.device)
        mu_t = b1 * (1 - 0.5 * _pow32(base, t * self._psi))
        mu_next = b1 * (1 - 0.5 * _pow32(base, (t + 1) * self._psi))
        new_mu_prod = mu_prod * mu_t
        new_m = b1 * m + (1 - b1) * g32
        new_v = b2 * v + (1 - b2) * g32 * g32
        _put(m, new_m, keep)
        _put(v, new_v, keep)
        _put(mu_prod, new_mu_prod, keep)
        m_hat = (mu_next * new_m / (1 - new_mu_prod * mu_next)
                 + (1 - mu_t) * g32 / (1 - new_mu_prod))
        v_hat = new_v / sc[3]
        _put(p, (p.float() - sc[0] * m_hat / (sqrt_rn(v_hat)
                                              + self._epsilon)).to(p.dtype),
             keep)


class RAdam(Optimizer):
    """Rectified Adam: where the variance estimate is tractable (``rho_t >
    5``, decided on the device with ``where``) the adaptive step ``lr r_t
    m_hat sqrt(1 - beta2^t) / (sqrt(v) + eps)``, else the plain momentum
    step ``lr m_hat``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        self._betas = (beta1, beta2)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._materialize_state()

    def _create_accumulators(self, p):
        self._acc("moment1", p)
        self._acc("moment2", p)

    def _update_param(self, p, g, sc, seed, keep, has_wd):
        m, v = self._acc("moment1", p), self._acc("moment2", p)
        g32, b1, b2 = g.float(), self._beta1, self._beta2
        t = self._step_t.float()
        new_m = b1 * m + (1 - b1) * g32
        new_v = b2 * v + (1 - b2) * g32 * g32
        _put(m, new_m, keep)
        _put(v, new_v, keep)
        m_hat = new_m / sc[2]
        bc2 = sc[3]
        rho_inf = 2.0 / (1 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * _pow32(self._betas_t[1], t) / bc2
        r_num = (rho_t - 4.0) * (rho_t - 2.0) * rho_inf
        r_den = (rho_inf - 4.0) * (rho_inf - 2.0) * torch.clamp(rho_t,
                                                                min=1e-6)
        r_t = sqrt_rn(torch.clamp(r_num / r_den, min=0.0))
        adaptive = (sc[0] * r_t * m_hat * sqrt_rn(bc2)
                    / (sqrt_rn(new_v) + self._epsilon))
        upd = torch.where(rho_t > 5.0, adaptive, sc[0] * m_hat)
        _put(p, (p.float() - upd).to(p.dtype), keep)
