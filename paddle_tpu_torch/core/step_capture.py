"""Whole-step capture on the card, the port of
``paddle_tpu/core/step_capture.py``: :class:`CapturedStep` (surfaced as
``paddle_tpu_torch.jit.capture_step``) records forward, backward and the
optimizer update of a train step as one ``torch.cuda.CUDAGraph`` and
replays it, so a step costs one graph launch on the host instead of one
launch per op.

* **Key and retrace.** A graph serves one signature: the structural
  signature of ``step_fn`` and ``update_fn`` (code objects and the content
  of hashable closure values, identity for the rest: a mutated closure
  scalar makes a new key), ``nan_gate``, ``iters_per_call`` and each
  argument's shape, dtype and device (other leaves by value). A new key is
  a new capture; at most 8 graphs are kept, in LRU order.
* **Capture.** The first call of a key copies the arguments into static
  buffers and runs the step eagerly on a side stream: that warm-up is the
  call's real step. Then the step is captured (nothing runs) into a graph
  whose memory comes from this object's own pool; the graph keeps each
  ``DropoutRNG`` the warm-up drew from (it writes their counters). Later
  calls copy their arguments
  into the static buffers and replay. The loss comes back as a clone of
  the static output. Kernel launches recorded at capture are added to
  their wrappers' counters on each replay. Nothing may keep the autograd
  graph of an earlier eager step alive (a loss tensor of it): its
  gradient accumulators run on the stream they were made on, which the
  capture cannot record.
* **State on the device.** Everything a replay must advance lives in
  device memory: the optimizer's step count and LR (``_step_t``,
  ``_lr_t``), the bias corrections and rounding seeds derived from them,
  and the dropout seed counter of each ``DropoutRNG`` (hidden and
  attention dropout draw every seed from it). A
  host-computed value written to ``_lr_t`` or ``_step_t`` while capturing
  raises :class:`HostStateWriteError`
  and is never demoted to the eager tier: e.g. ``scheduler.step()`` inside
  ``update_fn`` would freeze the LR. Call it between steps.
* **``nan_gate``.** The update applies only where the loss is finite,
  decided on the device (:func:`current_gate` hands the flag to the
  optimizer: its kernels write nothing and ``_step_t`` does not advance),
  and the seed counters of the ``DropoutRNG`` objects the step drew from
  are put back (no other RNG is touched): a skipped step leaves
  parameters, moments, masters, ``_step_t`` and the counters bitwise
  unchanged, so the next step draws the skipped step's dropout masks.
* **``iters_per_call``.** K steps over K-stacked arguments (leading axis
  K) captured into one graph; the losses come back stacked. Incompatible
  with ``nan_gate``, as in the reference.
* **Tiers and bypasses.** ``PADDLE_TPU_STEP_CAPTURE=off`` runs every call
  eagerly (bypass ``off``); a step whose tensor arguments lie on the CPU,
  or that runs where no card is, runs eagerly (bypass ``cpu``): a CPU has
  no graphs. A step that cannot be captured (a host read or sync inside
  it) is memoized as eager for its key, warns once and counts bypass
  ``untraceable``; the warm-up was its one real execution. Only CUDA's
  capture errors count so; any other failure of a capture or a replay
  raises. The eager tier gates on the
  host, as the reference's does.

* **Cost.** With the program cost registry installed
  (``observability.enable()``), each signature's program is counted once,
  in its eager warm-up (on the CPU, its first call), and filed as a
  ``train.step`` record with the graph pool's growth over the capture; the
  record retires when the signature's graph is dropped or this object
  dies. The modules and optimizer the functions hold feed the HBM ledger.

``stats`` (per object) and :func:`capture_info` (process-wide) count hits,
retraces and bypasses by reason, and so do the metrics
``train.capture_hits_total``, ``train.capture_retraces_total`` and
``train.capture_bypasses_total{reason}`` (host-side increments at each
call, never inside a captured region; free while observability is off).
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import threading
import types
import warnings
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from .. import _native
from .. import observability as _obs
from ..observability import cost as _cost

__all__ = ["CapturedStep", "HostStateWriteError", "capture_context",
           "capture_info", "capture_step", "capturing", "check_host_write",
           "current_gate", "gated", "mode", "stats_clear"]


class HostStateWriteError(RuntimeError):
    """A captured step writes carried state (``_lr_t``, ``_step_t``) from
    a host-computed value: every replay would serve
    the capture-time constant, e.g. ``scheduler.step()`` inside the
    captured update freezes the LR. Move the host write outside the
    captured step, or set ``PADDLE_TPU_STEP_CAPTURE=off``."""


_VALID_MODES = ("auto", "off")


def mode() -> str:
    """``PADDLE_TPU_STEP_CAPTURE``: ``auto`` (the default) or ``off``."""
    m = os.environ.get("PADDLE_TPU_STEP_CAPTURE", "auto").strip().lower()
    if m not in _VALID_MODES:
        raise ValueError(f"PADDLE_TPU_STEP_CAPTURE must be one of "
                         f"{'|'.join(_VALID_MODES)}, got {m!r}")
    return m


_local = threading.local()


def capturing() -> bool:
    """True inside :func:`capture_context` or while the current CUDA
    stream is capturing."""
    if getattr(_local, "capturing", False):
        return True
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def capture_context():
    """The region a captured step is recorded in: host writes to carried
    state raise :class:`HostStateWriteError` there."""
    prev = getattr(_local, "capturing", False)
    _local.capturing = True
    try:
        yield
    finally:
        _local.capturing = prev


def check_host_write(what: str) -> None:
    """Raise :class:`HostStateWriteError` if ``what`` is written from the
    host while a step is being captured."""
    if capturing():
        raise HostStateWriteError(
            f"{what} is written from a host value inside a captured train "
            f"step: every replay would serve the capture-time constant. "
            f"Keep per-step host writes (e.g. scheduler.step()) outside "
            f"the captured step, or set PADDLE_TPU_STEP_CAPTURE=off")


def current_gate() -> Optional[torch.Tensor]:
    """The NaN gate of the update running now: a 0-d bool tensor (True:
    apply), or None when the update is not gated."""
    return getattr(_local, "gate", None)


@contextlib.contextmanager
def gated(finite: torch.Tensor):
    """Run an optimizer update under the device-side gate ``finite``."""
    prev = getattr(_local, "gate", None)
    _local.gate = finite
    try:
        yield
    finally:
        _local.gate = prev


_LOCK = threading.Lock()
_STATS: Dict[str, Any] = {"hits": 0, "retraces": 0, "bypasses": {}}
# the side stream of every capture's warm-up, one a device: cuBLAS keeps a
# 32 MiB workspace for each stream it has run on for the process's life, so
# a stream a capture would leave one more workspace behind, carved out of
# whatever large cached block the capture found free (pinning that segment)
_WARM_STREAMS: Dict[Any, Any] = {}


def _warm_stream(dev):
    with _LOCK:
        side = _WARM_STREAMS.get(dev)
        if side is None:
            side = _WARM_STREAMS[dev] = torch.cuda.Stream(dev)
    return side


def _count(kind: str, reason: Optional[str] = None) -> None:
    with _LOCK:
        if kind == "bypass":
            b = _STATS["bypasses"]
            b[reason] = b.get(reason, 0) + 1
        else:
            _STATS[kind] += 1
    if kind == "bypass":
        _obs.inc("train.capture_bypasses_total", reason=reason or "other")
    elif kind == "hits":
        _obs.inc("train.capture_hits_total")
    else:
        _obs.inc("train.capture_retraces_total")


def capture_info() -> Dict[str, Any]:
    with _LOCK:
        return {"hits": _STATS["hits"], "retraces": _STATS["retraces"],
                "bypasses": dict(_STATS["bypasses"])}


def stats_clear() -> None:
    with _LOCK:
        _STATS.update(hits=0, retraces=0, bypasses={})


# ---------------------------------------------------------------------------
# structural signature (the reference's _structural_sig over its dispatch
# cache's value fingerprint)
# ---------------------------------------------------------------------------

_SCALARS = (bool, int, float, str, bytes, complex)
_MAX_FN_DEPTH = 3


class _IdKey:
    """Identity key for a closure value that is not keyed by content
    (tensors, modules, optimizers): equal only to itself, and holding the
    object so its id is never reused while the key lives."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _IdKey) and other.obj is self.obj


def _fp_value(v, depth: int):
    """Fingerprint of one closure value: content for scalars, containers,
    nested functions and partials (a mutated value makes a new key),
    identity for everything else."""
    if v is None:
        return None
    t = v.__class__
    if t in _SCALARS:
        return (t, v)
    if t is tuple or t is list:
        return ("T" if t is tuple else "L",
                tuple(_fp_value(x, depth) for x in v))
    if t is dict:
        return ("D", tuple(sorted(
            (str(k), _fp_value(x, depth)) for k, x in v.items())))
    if t is frozenset:
        return ("FS", v)
    if isinstance(v, types.FunctionType):
        if depth >= _MAX_FN_DEPTH:
            return ("F", _IdKey(v))
        return _fp_fn(v, depth + 1)
    if isinstance(v, functools.partial):
        return ("P", _fp_value(v.func, depth),
                tuple(_fp_value(a, depth) for a in v.args),
                tuple(sorted((k, _fp_value(a, depth))
                             for k, a in v.keywords.items())))
    return _IdKey(v)


def _fp_fn(fn, depth: int):
    parts = [fn.__code__]
    for cell in fn.__closure__ or ():
        try:
            parts.append(_fp_value(cell.cell_contents, depth))
        except ValueError:  # empty cell
            parts.append(("E",))
    if fn.__defaults__:
        parts.append(tuple(_fp_value(d, depth) for d in fn.__defaults__))
    if fn.__kwdefaults__:
        parts.append(tuple(sorted(
            (k, _fp_value(d, depth)) for k, d in fn.__kwdefaults__.items())))
    return ("FN", tuple(parts))


def _structural_sig(fn) -> Any:
    """The step or update closure's signature: code object, closure cells,
    defaults (the reference's ``_structural_sig``)."""
    if fn is None:
        return None
    if not isinstance(fn, types.FunctionType):
        return _IdKey(fn)
    return _fp_fn(fn, 0)


def _recording_draws(keep_counters: bool):
    from ..nn.common import recording_draws   # nn imports optimizer imports us
    return recording_draws(keep_counters)


def _loss_tensor(out) -> torch.Tensor:
    """The loss out of what the step returned (the first element of a
    tuple or list)."""
    if isinstance(out, (tuple, list)):
        if not out:
            raise ValueError("captured step returned an empty sequence")
        out = out[0]
    if not isinstance(out, torch.Tensor):
        raise ValueError("captured step must return the step's loss tensor")
    return out


# CUDA's errors for work a capture cannot record, raised by the step's own
# host read, sync or blocking copy (or by ending a capture they broke)
_CAPTURE_ERRORS = (
    "cudaErrorStreamCaptureUnsupported",
    "operation not permitted when stream is capturing",
    "cudaErrorStreamCaptureInvalidated",
    "operation failed due to a previous error during capture",
    "cudaErrorStreamCaptureImplicit",
    "operation would make the legacy stream depend on a capturing blocking "
    "stream",
    "cudaErrorCapturedEvent",
    "operation not permitted on an event last recorded in a capturing stream",
)


def _is_capture_failure(e: BaseException) -> bool:
    """True when ``e``, or the error it was raised while handling, is one of
    CUDA's capture errors: the step did something a capture cannot record.
    """
    seen = set()
    while isinstance(e, BaseException) and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, RuntimeError) and any(
                m in str(e) for m in _CAPTURE_ERRORS):
            return True
        e = e.__cause__ or e.__context__
    return False


def _detach_clone(out):
    return pytree.tree_map(
        lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
        out)


def _stack(outs):
    return pytree.tree_map(
        lambda *xs: torch.stack([x.detach() for x in xs])
        if isinstance(xs[0], torch.Tensor) else xs[0], *outs)


class _Graph:
    """One captured signature: the graph, its static argument buffers,
    its static output, the launches its capture recorded and the
    ``DropoutRNG`` objects it draws from (kept: it writes their
    counters)."""

    __slots__ = ("graph", "static_args", "static_out", "recorded", "rngs")

    def __init__(self, graph, static_args, static_out, recorded, rngs):
        self.graph = graph
        self.static_args = static_args
        self.static_out = static_out
        self.recorded = recorded
        self.rngs = rngs


class CapturedStep:
    """One train step as one CUDA graph (see the module docstring).

    ``step_fn(*args) -> loss`` (or ``(loss, extras...)``) runs forward and
    backward; ``update_fn`` (optional) applies the optimizer update inside
    the same graph; ``clear_fn`` clears the gradients where the eager
    tier's gate withholds the update. ``nan_gate`` makes the update
    conditional on a finite loss, on the device. ``iters_per_call`` runs K
    steps over K-stacked arguments per call."""

    _MAX_GRAPHS = 8

    def __init__(self, step_fn: Callable, *,
                 update_fn: Optional[Callable[[], None]] = None,
                 clear_fn: Optional[Callable[[], None]] = None,
                 nan_gate: bool = False, iters_per_call: int = 1):
        if nan_gate and update_fn is None:
            raise ValueError("nan_gate requires update_fn (the gate decides "
                             "whether the update applies)")
        if nan_gate and iters_per_call > 1:
            raise ValueError("nan_gate gates one step; it cannot ride a "
                             "multi-step (iters_per_call > 1) graph")
        if iters_per_call < 1:
            raise ValueError(f"iters_per_call must be >= 1, got "
                             f"{iters_per_call}")
        self._step_fn = step_fn
        self._update_fn = update_fn
        self._clear_fn = clear_fn
        self._nan_gate = bool(nan_gate)
        self._iters = int(iters_per_call)
        self._mode = mode()
        self._graphs: "OrderedDict[Any, _Graph]" = OrderedDict()
        self._dead: set = set()   # keys whose capture failed: eager forever
        self._warned = False
        self._pool = None
        self.stats: Dict[str, Any] = {"hits": 0, "retraces": 0,
                                      "bypasses": {}}
        # the cost registry: the ledger's sources, the keys counted eagerly
        _cost.register_state(*_cost.state_owners(step_fn, update_fn,
                                                  clear_fn))
        self._cost_keys: set = set()

    @property
    def applies_update(self) -> bool:
        """True when the optimizer update is part of this step (the caller
        must not apply it again)."""
        return self._update_fn is not None

    @property
    def num_graphs(self) -> int:
        return len(self._graphs)

    def _note(self, kind: str, reason: Optional[str] = None) -> None:
        if kind == "bypass":
            b = self.stats["bypasses"]
            b[reason] = b.get(reason, 0) + 1
        else:
            self.stats[kind] += 1
        _count(kind, reason)

    # -- the call ------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        reason = self._bypass_reason(args, kwargs)
        if reason is not None:
            self._note("bypass", reason)
            if reason == "cpu" and _cost.installed():
                return self._eager_step_counted(args, kwargs)
            return self._eager_step(args, kwargs)
        key = self._key(args, kwargs)
        if key in self._dead:
            self._note("bypass", "untraceable")
            return self._eager_step(args, kwargs)
        entry = self._lookup(key)
        if entry is None:
            return self._capture(key, args, kwargs)
        self._note("hits")
        return self._replay(entry, args, kwargs)

    def _bypass_reason(self, args, kwargs) -> Optional[str]:
        if self._mode == "off":
            return "off"
        leaves = [x for x in pytree.tree_leaves((args, kwargs))
                  if isinstance(x, torch.Tensor)]
        if not torch.cuda.is_available() or any(
                x.device.type != "cuda" for x in leaves):
            return "cpu"
        return None

    def _key(self, args, kwargs):
        """The signature a graph serves (rebuilt per call: a mutated
        closure scalar must retire the graph, never serve its constant)."""
        fn_sig = (_structural_sig(self._step_fn),
                  _structural_sig(self._update_fn),
                  self._nan_gate, self._iters)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        sigs = []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                sigs.append(("t", tuple(leaf.shape), leaf.dtype,
                             str(leaf.device)))
            else:
                try:
                    hash(leaf)
                    sigs.append(("s", leaf))
                except TypeError:
                    sigs.append(("s", repr(leaf)))
        return (fn_sig, str(spec), tuple(sigs))

    def _lookup(self, key) -> Optional[_Graph]:
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
        return entry

    def _store(self, key, entry: _Graph) -> None:
        self._graphs[key] = entry
        self._graphs.move_to_end(key)
        while len(self._graphs) > self._MAX_GRAPHS:
            old, _ = self._graphs.popitem(last=False)
            _cost.retire_program(self, _cost_key(old))

    def _file_cost(self, key, tally, temp_bytes=None) -> None:
        _cost.record_program(
            self, _cost_key(key), "train.step",
            getattr(self._step_fn, "__name__", "step"), tally,
            temp_bytes=temp_bytes)

    def _eager_step_counted(self, args, kwargs):
        """The CPU's eager tier with the cost registry on: a signature's
        first call is counted and filed."""
        key = self._key(args, kwargs)
        with _cost.counted(key not in self._cost_keys) as tally:
            out = self._eager_step(args, kwargs)
        if tally is not None:
            self._cost_keys.add(key)
            self._file_cost(key, tally)
        return out

    # -- the step body, shared by warm-up, capture and the eager tier --------
    def _once_gated(self, args, kwargs, drawn: set):
        """One step whose update is gated on the device: no host read. The
        ``DropoutRNG`` objects it draws from are added to ``drawn``."""
        with _recording_draws(self._nan_gate) as log:
            out = self._step_fn(*args, **kwargs)
        drawn.update(log)
        if self._update_fn is not None:
            if self._nan_gate:
                finite = torch.isfinite(
                    _loss_tensor(out).detach().reshape(-1)[0].float())
                with gated(finite):
                    self._update_fn()
                for r, s in log.items():
                    r.counter.copy_(torch.where(finite, r.counter, s))
            else:
                self._update_fn()
        return out

    def _body(self, args, kwargs, drawn: set):
        if self._iters == 1:
            return self._once_gated(args, kwargs, drawn)
        outs = [self._once_gated(*self._slice(i, args, kwargs), drawn)
                for i in range(self._iters)]
        return _stack(outs)

    def _slice(self, i: int, args, kwargs):
        return pytree.tree_map(
            lambda x: x[i] if isinstance(x, torch.Tensor) and x.dim() > 0
            else x, (args, kwargs))

    # -- capture and replay --------------------------------------------------
    def _capture(self, key, args, kwargs):
        static = pytree.tree_map(
            lambda x: x.detach().clone() if isinstance(x, torch.Tensor)
            else x, (args, kwargs))
        s_args, s_kwargs = static
        tensors = [x for x in pytree.tree_leaves(static)
                   if isinstance(x, torch.Tensor)]
        dev = tensors[0].device if tensors else \
            torch.device("cuda", torch.cuda.current_device())
        side = _warm_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        drawn: set = set()
        with torch.cuda.stream(side), _cost.counted() as tally:
            out = self._body(s_args, s_kwargs, drawn)   # the call's real step
        torch.cuda.current_stream(dev).wait_stream(side)
        result = _detach_clone(out)
        del out
        torch.cuda.empty_cache()   # the warm-up's blocks, before the pool
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(dev)
        try:
            with _native.recorded_launches() as recorded, capture_context(), \
                    torch.cuda.device(dev), \
                    torch.cuda.graph(graph, pool=self._pool):
                static_out = self._body(s_args, s_kwargs, drawn)
        except HostStateWriteError:
            raise   # deliberate: never demoted to a silently stale tier
        except Exception as e:   # noqa: BLE001 - sorted just below
            if not _is_capture_failure(e):
                raise
            self._dead.add(key)
            self._note("bypass", "untraceable")
            if not self._warned:
                self._warned = True
                warnings.warn(
                    f"step capture: the step cannot be "
                    f"captured ({type(e).__name__}: {e}); this signature "
                    f"runs on the eager tier")
            return result
        self._store(key, _Graph(graph, static, _detach(static_out),
                                dict(recorded), tuple(drawn)))
        self._file_cost(key, tally,
                        torch.cuda.memory_reserved(dev) - reserved)
        self._note("retraces")
        return result

    def _replay(self, entry: _Graph, args, kwargs):
        for dst, src in zip(pytree.tree_leaves(entry.static_args),
                            pytree.tree_leaves((args, kwargs))):
            if isinstance(dst, torch.Tensor) and dst is not src:
                dst.copy_(src)
        entry.graph.replay()
        for counter, n in entry.recorded.items():
            counter.add(n)
        return _detach_clone(entry.static_out)

    # -- eager tier ----------------------------------------------------------
    def _eager_step(self, args, kwargs):
        if self._iters == 1:
            return self._eager_once(args, kwargs)
        return _stack([self._eager_once(*self._slice(i, args, kwargs))
                       for i in range(self._iters)])

    def _eager_once(self, args, kwargs):
        """The reference's eager tier: the gate reads the loss on the host;
        a skipped step clears the gradients and puts the dropout seed
        counters back. The outputs come back detached, as a replay's."""
        with _recording_draws(self._nan_gate) as log:
            out = _detach(self._step_fn(*args, **kwargs))
        if self._update_fn is None:
            return out
        if self._nan_gate:
            if math.isfinite(float(_loss_tensor(out).reshape(-1)[0])):
                self._update_fn()
            else:
                for r, s in log.items():
                    r.counter.copy_(s)
                if self._clear_fn is not None:
                    self._clear_fn()
        else:
            self._update_fn()
        return out


def _cost_key(key) -> str:
    """The cost registry's name of a signature's program."""
    return f"step:{abs(hash(key)):x}"


def _detach(out):
    """``out`` with every tensor detached (for the static output kept for
    replays: the captured tensors themselves, which a replay writes)."""
    return pytree.tree_map(
        lambda x: x.detach() if isinstance(x, torch.Tensor) else x, out)


def capture_step(step_fn: Callable, *,
                 update_fn: Optional[Callable[[], None]] = None,
                 clear_fn: Optional[Callable[[], None]] = None,
                 nan_gate: bool = False,
                 iters_per_call: int = 1) -> CapturedStep:
    """Capture a train step as one CUDA graph: ``paddle.jit.capture_step``
    (see :class:`CapturedStep`). Honours ``PADDLE_TPU_STEP_CAPTURE``
    (``off`` keeps every call on the eager tier)."""
    return CapturedStep(step_fn, update_fn=update_fn, clear_fn=clear_fn,
                        nan_gate=nan_gate, iters_per_call=iters_per_call)
