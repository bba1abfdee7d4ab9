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
* ``state_dict`` / ``set_state_dict`` with the JAX package's keys:
  ``step``, ``LR_Scheduler``, ``<name>_<accumulator>`` (``moment1``,
  ``moment2``, or the int8 layout's four) and ``master_weights`` ``{name:
  fp32 master}`` for low-precision parameters; the multi-tensor layout
  exposes per-parameter views of its flat buffers, as there. Values load
  from tensors or numpy arrays, so a state saved by either package loads
  in the other.

Not ported (they raise): ``lazy_mode``, bf16 moments and the master-free
multi-tensor layout.
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
           "ClipGradByValue", "Optimizer", "lr", "set_parameter_names"]

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


def _load(src, like: torch.Tensor) -> torch.Tensor:
    """A state-dict value (tensor or numpy array, bf16 included) as a
    tensor of ``like``'s dtype, shape and device."""
    if not isinstance(src, torch.Tensor):
        from ..convert import _to_tensor
        src = _to_tensor(getattr(src, "_data", src))
    return src.to(device=like.device, dtype=like.dtype).reshape(like.shape)


class Optimizer:
    """Base class: the parameter groups and their flat list, the carried
    step count and LR, and the per-parameter state (accumulators and fp32
    masters, keyed by the parameter's ``id``)."""

    _betas = (0.0, 0.0)   # c1 = c2 = 1 for an optimizer without moments
    _wd_coeff = 0.0
    _coupled_decay = True   # a weight_decay is L2 added to the gradient
    _lr_ratio = None
    _apply_decay_param_fun = None

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
    @torch.no_grad()
    def step(self) -> None:
        gate = step_capture.current_gate()
        self._step_t.add_(1 if gate is None else gate.to(torch.int32))
        sc = self._scalars(gate)
        seeds = self._sr_seeds() if self._needs_seeds() else None
        meta, cache = self._meta, {}
        for group in self._groups:
            pg = [(p, p.grad) for p in group["params"] if p.grad is not None]
            clip = group["grad_clip"] or self._grad_clip
            if clip is not None:
                pg = clip(pg)
            wd = group["weight_decay"] if group["weight_decay"] is not None \
                else self._weight_decay
            for p, g in pg:
                if wd is not None and self._coupled_decay:   # L2
                    g = g + float(getattr(wd, "coeff", wd)) * p
                i = self._index[id(p)]
                self._update_param(
                    p, g, self._param_scalars(sc, meta[i], cache),
                    None if seeds is None else seeds[i],
                    None if gate is None else ~gate,
                    bool(self._wd_coeff) and meta[i][1])

    def _needs_seeds(self) -> bool:
        return self._stochastic_rounding and self._use_master_weights is \
            False and any(p.dtype == torch.bfloat16 for p in self._params)

    def _update_param(self, p, g, sc, seed, keep, has_wd: bool) -> None:
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._params:
            p.grad = None

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
        self.tables: Optional[tuple] = None
        self.rebind()

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
        # the reference's fusable test: clip by norm, a coupled decay, a
        # group's own clip or decay, and a global norm over several groups
        # (each group clipped by its own norm) take the per-parameter path
        self._use_multi_tensor = bool(use_multi_tensor) and bool(
            self._params) and weight_decay is None and not isinstance(
            grad_clip, ClipGradByNorm) and all(
            g["grad_clip"] is None and g["weight_decay"] is None
            for g in self._groups) and (len(self._groups) == 1 or
                                        not isinstance(grad_clip,
                                                       ClipGradByGlobalNorm))
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
            self._flat.set_tables(self._meta)

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
                if isinstance(clip, ClipGradByValue) else None,
                tables=fs.tables, base=a, wd=self._wd_coeff)

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

    def _adam_core(self, p, g, sc, seed, keep, has_wd: bool) -> None:
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
