"""Program cost accounting: the port of ``paddle_tpu/observability/cost.py``,
with its public names, record fields, metric families and environment
knobs, so a dashboard or a runbook written for the JAX package reads this
one unchanged.

The port's programs are its captured CUDA graphs: the serving engine's
decode graph of each batch bucket and prefill graph of each key, and the
captured train step of each signature (on the CPU, where there are no
graphs, the same programs run eagerly). This module is the process-global
**program cost registry** that keeps one record for each live program: its
flops and bytes, its graph pool's growth, and what they derive with the
timing histograms (MFU, bandwidth share) and with the live state (the HBM
ledger).

What differs from the JAX package, by design:

* ``model_source`` is ``"analytic"``: there is no XLA ``cost_analysis()``.
  A program is counted during one eager call of it (the last warm-up call
  before its capture on a card, its first call on the CPU), never inside
  the capture. Two sources add up (:func:`counted`): every hand-written
  kernel launch files the flops and bytes of its wrapper's cost function
  (``_native.build.cost_hook``; the same counts ``chip_smoke.py`` feeds its
  bounds), and every aten op files its input and output bytes (XLA's
  ``bytes accessed`` sums operands and outputs) and, for ``mm``,
  ``addmm``, ``bmm`` and ``baddbmm``, the flops of
  ``torch.utils.flop_counter``'s formulas. Elementwise flops are not
  counted. A program with nothing counted, or whose count failed, is
  ``"none"`` and is counted in ``cost.analysis_failures_total``, never
  raised.
* ``temp_bytes`` is the graph pool's growth in ``memory_reserved`` over
  the capture on a card, None on the CPU; no argument, output or code
  bytes are modelled, so ``peak_bytes`` is ``temp_bytes``.
* No ``dispatch`` site (the port has no eager dispatch cache) and no
  collectives (the port has none yet).
* The HBM ledger walks weakly registered owners: the KV pools
  (:func:`register_kv_cache`) and the modules and optimizers an engine's
  callables or a captured step's functions close over
  (:func:`register_state`), in place of the JAX package's global state
  registry. Parameters are ``param``; an optimizer's fp32 masters
  ``master``; its accumulators named ``moment*`` and its flat moments
  ``moment``; everything else ``other``. A tensor counts once.
* The device model of ``gpu`` is the card's own memory and one NVIDIA
  H100 80GB HBM3 at 700 W: 989e12 dense bf16 flop/s, 3.35e12 HBM bytes/s.

Contracts, as in the JAX package: zero per-step host work (a program is
counted once; a kernel launch outside a count pays one None test, a replay
nothing); graceful degradation (failures counted, never raised); records
retire with their owner (an engine, a captured step) or their graph.

Env knobs: ``PADDLE_TPU_COST=on|off`` (default on; the test suite turns it
off suite-wide), ``PADDLE_TPU_HBM_BYTES`` / ``PADDLE_TPU_PEAK_FLOPS`` /
``PADDLE_TPU_HBM_BW_BYTES`` (device model), and
``PADDLE_TPU_HBM_WARN_FRACTION`` (default 0.10: the once-per-process
low-headroom warning threshold).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch

from .. import _native

_log = logging.getLogger(__name__)

__all__ = [
    "ProgramCostRecord", "mode", "installed", "install", "uninstall",
    "clear", "records", "record_analytic", "device_model", "hbm_ledger",
    "utilization", "debug_doc", "flight_snapshot", "healthz_component",
    "register_kv_cache", "decode_bucket_records", "prefix_sharing_stats",
    # the port's own: the count of one eager call, and its record
    "Tally", "counted", "record_program", "register_state", "retire_program",
    "state_owners",
]

# ---------------------------------------------------------------------------
# metric families (pre-created so capture never races family creation)
# ---------------------------------------------------------------------------
from . import _REGISTRY as _R            # noqa: E402  (same package)

_PROGRAMS = _R.gauge(
    "cost.programs", "live compiled programs with a cost record")
_CAPTURED = _R.counter(
    "cost.programs_captured_total",
    "cost records captured at compile time, by hook site and which cost "
    "model produced the figures", labelnames=("site", "model_source"))
_RETIRED = _R.counter(
    "cost.records_retired_total",
    "cost records dropped (cache eviction / retrace / program death)",
    labelnames=("site",))
_FAILURES = _R.counter(
    "cost.analysis_failures_total",
    "cost/memory analysis calls that returned nothing or raised "
    "(counted, never raised)", labelnames=("reason",))
_FLOPS_G = _R.gauge(
    "cost.program_flops", "modeled flops of one program",
    labelnames=("site", "program"))
_BYTES_G = _R.gauge(
    "cost.program_bytes", "modeled bytes accessed by one program",
    labelnames=("site", "program"))
_PEAK_G = _R.gauge(
    "cost.program_peak_bytes",
    "modeled memory footprint of one program (the port: its graph pool's "
    "growth)", labelnames=("site", "program"))
_MFU_G = _R.gauge(
    "cost.mfu", "achieved MFU: modeled flops / measured seconds / device "
    "peak flops", labelnames=("site", "program"))
_BW_G = _R.gauge(
    "cost.bandwidth_util", "achieved HBM bandwidth fraction: modeled "
    "bytes / measured seconds / device bandwidth",
    labelnames=("site", "program"))
_HBM_G = _R.gauge(
    "cost.hbm_bytes", "live HBM ledger, by component",
    labelnames=("component",))

# ---------------------------------------------------------------------------
# record + registry state
# ---------------------------------------------------------------------------


@dataclass
class ProgramCostRecord:
    """One live program's modeled cost, counted once."""

    key: str                             # registry key (unique per program)
    site: str                            # train.step | serving.* | analytic
    program: str                         # human label (bucket, key, ...)
    model_source: str                    # xla | analytic | none
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None     # argument+output+temp+code
    bucket: Optional[int] = None         # serving decode batch bucket
    collectives: Dict[str, int] = field(default_factory=dict)
    captured_at: float = 0.0
    analysis_seconds: float = 0.0


_LOCK = threading.RLock()
_RECORDS: "OrderedDict[str, ProgramCostRecord]" = OrderedDict()
_INSTALLED = False
#: owner ids with a live weakref finalizer (retire-on-death)
_FINALIZED: set = set()
#: weakrefs to every live PagedKVCache (ledger input)
_KV_CACHES: List[Any] = []
#: weakrefs to the modules and optimizers whose tensors the ledger walks
_STATE: List[Any] = []
#: the low-headroom warning fires once per process (list so tests can
#: reset the latch without reaching for a global statement)
_HBM_WARN_ONCE = [False]


def mode() -> str:
    """``PADDLE_TPU_COST`` resolved: ``on`` (default) or ``off``."""
    v = os.environ.get("PADDLE_TPU_COST", "on").strip().lower()
    return "off" if v in ("off", "0", "false", "no") else "on"


def installed() -> bool:
    return _INSTALLED


def install() -> None:
    """Turn counting on (no-op when ``PADDLE_TPU_COST=off``): the engine
    and the captured step then count each new program once. Called from
    ``observability.enable()``."""
    global _INSTALLED
    if mode() == "off":
        return
    with _LOCK:
        _INSTALLED = True


def uninstall() -> None:
    """Stop counting new programs; records remain readable until
    :func:`clear`."""
    global _INSTALLED
    with _LOCK:
        _INSTALLED = False


# ---------------------------------------------------------------------------
# device model
# ---------------------------------------------------------------------------

_GIB = 1024 ** 3
#: per-platform defaults. ``gpu``: the card's own memory
#: (``total_memory``), and the peak rates of one "NVIDIA H100 80GB HBM3,
#: 700.00 W" that PERF.md and chip_smoke.py use (dense bf16, HBM3). The CPU
#: tier models the JAX package's CPU figures, so the two ledgers compare on
#: the CPU. Override any of the three via env.
_DEVICE_DEFAULTS = {
    "gpu": {"hbm_bytes": 80 * _GIB, "peak_flops": 989e12,
            "hbm_bw_bytes": 3.35e12},
    "cpu": {"hbm_bytes": 16 * _GIB, "peak_flops": 1e12,
            "hbm_bw_bytes": 50e9},
}


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        _log.warning("ignoring unparseable %s=%r", name, raw)
        return None


def _platform() -> str:
    return "gpu" if torch.cuda.is_available() else "cpu"


def device_model() -> Dict[str, Any]:
    """The modeled device: HBM bytes, peak flop/s, HBM bandwidth."""
    platform = _platform()
    base = dict(_DEVICE_DEFAULTS[platform])
    if platform == "gpu":
        base["hbm_bytes"] = int(torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory)
    hbm = _env_float("PADDLE_TPU_HBM_BYTES")
    peak = _env_float("PADDLE_TPU_PEAK_FLOPS")
    bw = _env_float("PADDLE_TPU_HBM_BW_BYTES")
    return {
        "platform": platform,
        "hbm_bytes": int(hbm) if hbm else base["hbm_bytes"],
        "peak_flops": peak if peak else base["peak_flops"],
        "hbm_bw_bytes": bw if bw else base["hbm_bw_bytes"],
        "source": "env" if (hbm or peak or bw) else "default",
    }


# ---------------------------------------------------------------------------
# counting one eager call
# ---------------------------------------------------------------------------

#: aten ops that move no data: allocations (their outputs are written by
#: the op or kernel that fills them), host reads of a scalar, and the view
#: that ``matmul`` returns (not marked a view in its schema)
_NO_BYTES = frozenset(("aten::empty", "aten::empty_like",
                       "aten::empty_strided", "aten::new_empty",
                       "aten::new_empty_strided", "aten::_local_scalar_dense",
                       "aten::resize_", "aten::set_", "aten::_unsafe_view"))


#: gathers: the rows they read are the rows they write, so the bytes are
#: the output twice and the indices (not the whole source: a gather from
#: the KV pool reads the pages it names)
_GATHERS = frozenset(("aten::index", "aten::index_select", "aten::gather",
                      "aten::embedding"))
#: writes into part of a tensor: the indices and the values read, the
#: values written (not the whole destination: a token's K/V written into
#: the pool moves that token's bytes)
_SCATTERS = frozenset(("aten::index_put_", "aten::index_put",
                       "aten::_index_put_impl_", "aten::index_copy_",
                       "aten::index_copy", "aten::index_add_",
                       "aten::index_add", "aten::scatter_", "aten::scatter",
                       "aten::scatter_add_", "aten::scatter_add",
                       "aten::scatter_reduce_", "aten::scatter_reduce"))


def _op_bytes(name: str, args, kwargs, out) -> int:
    """An aten op's bytes: its tensor operands and outputs, each once (XLA's
    ``bytes accessed``), but for gathers and partial writes (above)."""
    operands = list(_leaves(args)) + list(_leaves(tuple(kwargs.values())))
    if name in _GATHERS:
        return _native.tensor_bytes(*operands[1:]) + \
            2 * _native.tensor_bytes(*_leaves(out))
    if name in _SCATTERS:
        return _native.tensor_bytes(*operands[1:], operands[-1])
    return _native.tensor_bytes(*operands, *_leaves(out))


def _flop_formulas():
    from torch.utils import flop_counter as fc
    aten = torch.ops.aten
    return {aten.mm: fc.mm_flop, aten.addmm: fc.addmm_flop,
            aten.bmm: fc.bmm_flop, aten.baddbmm: fc.baddbmm_flop}


def _leaves(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _leaves(y)


@dataclass
class Tally:
    """What :func:`counted` saw: flops and bytes in all, and the kernel
    launches' by counter name (``kernels``: [launches, flops, bytes]).
    ``failed`` is set when a cost function or an op's count raised."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    failed: bool = False
    seconds: float = 0.0      # the counted call's wall time

    def kernel(self, name: str, n: int, cost, args) -> None:
        from torch.utils._python_dispatch import _disable_current_modes
        try:
            # the cost function's own ops (a host read of t, a count of
            # distinct ids) are not the program's
            with _disable_current_modes():
                flops, nbytes = cost(*args)
        except Exception as e:   # noqa: BLE001 - counted, never raised
            self.failed = True
            _FAILURES.inc(reason="count_error")
            _log.debug("cost: %s's cost function failed: %s", name, e)
            return
        row = self.kernels.setdefault(name, [0, 0.0, 0.0])
        row[0] += n
        row[1] += n * flops
        row[2] += n * nbytes
        self.flops += n * flops
        self.bytes_accessed += n * nbytes

    def op(self, func, args, kwargs, out, formulas) -> None:
        name = func._schema.name
        if func.is_view or name in _NO_BYTES:
            return
        try:
            nbytes = float(_op_bytes(name, args, kwargs, out))
            flops = 0.0
            formula = formulas.get(func.overloadpacket)
            if formula is not None:
                # flop_counter's calling convention: the op's arguments
                # and its output, reduced to shapes by the formula's wrapper
                flops = float(formula(*args, **kwargs, out_val=out))
        except Exception as e:   # noqa: BLE001 - counted, never raised
            self.failed = True
            _FAILURES.inc(reason="count_error")
            _log.debug("cost: counting %s failed: %s", name, e)
            return
        self.flops += flops
        self.bytes_accessed += nbytes


def _counting_mode(tally: Tally):
    from torch.utils._python_dispatch import TorchDispatchMode
    formulas = _flop_formulas()

    class _AtenCount(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            tally.op(func, args, kwargs, out, formulas)
            return out

    return _AtenCount()


@contextlib.contextmanager
def counted(active: bool = True) -> Iterator[Optional[Tally]]:
    """Count the eager call made inside: yields a :class:`Tally` that fills
    as the call runs (kernel launches through their wrappers' cost
    functions, aten ops under a dispatch mode). Yields None, counting
    nothing, when the registry is not installed or ``active`` is false.
    Never around a capture: a capture launches nothing, and the count is
    the eager call's. The hook is process-wide, so the callers hold the
    locks that keep other threads' launches out (the serving engines'
    capture lock)."""
    if not (active and _INSTALLED):
        yield None
        return
    tally = Tally()
    prev = _native.build.cost_hook
    _native.build.cost_hook = lambda name, n, cost, args: tally.kernel(
        name, n, cost, args)
    t0 = time.perf_counter()
    try:
        with _counting_mode(tally):
            yield tally
    finally:
        _native.build.cost_hook = prev
        tally.seconds = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# capture core
# ---------------------------------------------------------------------------

def _store(rec: ProgramCostRecord) -> None:
    with _LOCK:
        _RECORDS.pop(rec.key, None)
        _RECORDS[rec.key] = rec
        _PROGRAMS.set(len(_RECORDS))
    _CAPTURED.inc(site=rec.site, model_source=rec.model_source)
    if rec.flops is not None:
        _FLOPS_G.set(rec.flops, site=rec.site, program=rec.program)
    if rec.bytes_accessed is not None:
        _BYTES_G.set(rec.bytes_accessed, site=rec.site, program=rec.program)
    if rec.peak_bytes is not None:
        _PEAK_G.set(rec.peak_bytes, site=rec.site, program=rec.program)


def _retire(key: str) -> None:
    with _LOCK:
        rec = _RECORDS.pop(key, None)
        _PROGRAMS.set(len(_RECORDS))
    if rec is not None:
        _RETIRED.inc(site=rec.site)


def _owner_prefix(owner_id: int) -> str:
    return f"obj:{owner_id:x}:"


def _retire_prefix(prefix: str, owner_id: Optional[int] = None) -> None:
    """Retire every record whose key starts with ``prefix`` (an owner
    died, taking all its programs)."""
    with _LOCK:
        if owner_id is not None:
            _FINALIZED.discard(owner_id)
        dead = [k for k in _RECORDS if k.startswith(prefix)]
    for k in dead:
        _retire(k)


def _program_key(owner, program_key: str) -> str:
    return _owner_prefix(id(owner)) + program_key


def record_program(owner, program_key: str, site: str, program: str,
                   tally: Optional[Tally], *, bucket: Optional[int] = None,
                   temp_bytes: Optional[int] = None
                   ) -> Optional[ProgramCostRecord]:
    """File ``owner``'s program ``program_key`` from the count of one of
    its eager calls (None: the registry was off then, nothing is filed);
    ``analysis_seconds`` is that counted call's wall time. Every record of
    ``owner`` retires when it dies. Never raises."""
    if tally is None:
        return None
    oid = id(owner)
    with _LOCK:
        first = oid not in _FINALIZED
        if first:
            _FINALIZED.add(oid)
    if first:
        weakref.finalize(owner, _retire_prefix, _owner_prefix(oid), oid)
    flops = nbytes = None
    if tally.failed:
        source = "none"
    elif tally.flops or tally.bytes_accessed:
        source = "analytic"
        flops, nbytes = tally.flops, tally.bytes_accessed
    else:
        source = "none"
        _FAILURES.inc(reason="no_count")
    rec = ProgramCostRecord(
        key=_program_key(owner, program_key), site=site, program=program,
        model_source=source, flops=flops, bytes_accessed=nbytes,
        temp_bytes=temp_bytes, peak_bytes=temp_bytes, bucket=bucket,
        captured_at=time.time(), analysis_seconds=tally.seconds)
    _store(rec)
    return rec


def retire_program(owner, program_key: str) -> None:
    """Retire one program of ``owner`` (its graph was dropped)."""
    _retire(_program_key(owner, program_key))


def record_analytic(program: str, flops: float, *, site: str = "analytic",
                    bytes_accessed: Optional[float] = None) -> None:
    """Register an analytic estimate: :func:`paddle_tpu_torch.flops` files
    its per-network totals here, as the JAX package's ``paddle.flops``
    does."""
    rec = ProgramCostRecord(
        key=f"analytic:{site}:{program}", site=site, program=program,
        model_source="analytic", flops=float(flops),
        bytes_accessed=bytes_accessed, captured_at=time.time())
    _store(rec)


def clear() -> None:
    """Drop every record (test isolation seam; wired into
    ``observability.reset()``)."""
    with _LOCK:
        _RECORDS.clear()
        _PROGRAMS.set(0)


def records(site: Optional[str] = None) -> List[Dict[str, Any]]:
    """Plain-data view of the live records, insertion-ordered."""
    with _LOCK:
        recs = list(_RECORDS.values())
    return [asdict(r) for r in recs if site is None or r.site == site]


def decode_bucket_records() -> Dict[int, Dict[str, Any]]:
    """{batch bucket: record} for the live serving decode programs."""
    out: Dict[int, Dict[str, Any]] = {}
    for r in records(site="serving.decode"):
        if r.get("bucket") is not None:
            out[int(r["bucket"])] = r
    return out


# ---------------------------------------------------------------------------
# the ledger's sources
# ---------------------------------------------------------------------------

def _live(refs: List[Any]) -> List[Any]:
    with _LOCK:
        refs[:] = [r for r in refs if r() is not None]
        return [r() for r in refs]


def _register(refs: List[Any], obj) -> None:
    with _LOCK:
        if not any(r() is obj for r in refs):
            refs.append(weakref.ref(obj))


def register_kv_cache(kv) -> None:
    """Track a live PagedKVCache's pool/scales bytes in the HBM ledger
    (weakly: a dropped engine drops its pool from the ledger)."""
    _register(_KV_CACHES, kv)


def _is_optimizer(obj) -> bool:
    return hasattr(obj, "_accumulators") and hasattr(obj, "_master_weights")


def register_state(*owners) -> None:
    """Track the tensors of modules and optimizers in the HBM ledger
    (weakly): an engine's model, a captured step's model and optimizer.
    Anything else is ignored."""
    for o in owners:
        if isinstance(o, torch.nn.Module) or _is_optimizer(o):
            _register(_STATE, o)


def state_owners(*fns) -> List[Any]:
    """The modules and optimizers ``fns`` are bound to or close over (one
    level deep): a model's ``serving_callables``, a step function, an
    optimizer's ``step``."""
    found: List[Any] = []
    for fn in fns:
        cands = [getattr(fn, "__self__", None)]
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                cands.append(cell.cell_contents)
            except ValueError:       # an empty cell
                continue
        for c in cands:
            if (isinstance(c, torch.nn.Module) or _is_optimizer(c)) and \
                    not any(c is f for f in found):
                found.append(c)
    return found


def prefix_sharing_stats() -> List[Dict[str, Any]]:
    """Per-live-pool prefix-sharing counters: one row per registered
    PagedKVCache (its ``prefix_stats()``)."""
    rows: List[Dict[str, Any]] = []
    for kv in _live(_KV_CACHES):
        stats = getattr(kv, "prefix_stats", None)
        if stats is None:
            continue
        try:
            rows.append(stats())
        except Exception as e:             # pragma: no cover - defensive
            rows.append({"error": str(e)})
    return rows


# ---------------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------------

def warn_fraction() -> float:
    v = _env_float("PADDLE_TPU_HBM_WARN_FRACTION")
    return 0.10 if v is None else v


class _Bytes:
    """Bytes of tensors by ledger component, each tensor counted once."""

    def __init__(self):
        self.by = {"param": 0, "master": 0, "moment": 0, "other": 0}
        self._seen: set = set()

    def add(self, comp: str, t) -> None:
        if not isinstance(t, torch.Tensor) or t.numel() == 0:
            return
        k = (t.data_ptr(), t.numel(), t.dtype)
        if k in self._seen:
            return
        self._seen.add(k)
        self.by[comp] += t.numel() * t.element_size()

    def module(self, m: torch.nn.Module) -> None:
        for p in m.parameters():
            self.add("param", p)
        for b in m.buffers():
            self.add("other", b)

    def optimizer(self, opt) -> None:
        for p in getattr(opt, "_params", ()) or ():
            self.add("param", p)
        for name, store in opt._accumulators.items():
            for t in store.values():
                self.add("moment" if "moment" in name else "other", t)
        for t in opt._master_weights.values():
            self.add("master", t)
        flat = getattr(opt, "_flat", None)
        if flat is not None:
            self.add("moment", flat.m)
            self.add("moment", flat.v)
            # the storage: the parameters' own where they are its views
            # (fp32 parameters, the master-free layout), else a master
            p0 = flat.params[0] if flat.params else None
            if p0 is None or p0.untyped_storage().data_ptr() != \
                    flat.master.untyped_storage().data_ptr():
                self.add("master", flat.master)
            self.add("other", flat.grad)
        for name in ("_step_t", "_lr_t", "_betas_t", "_seed_t"):
            self.add("other", getattr(opt, name, None))


def hbm_ledger() -> Dict[str, Any]:
    """The live HBM ledger: what is resident (the registered modules,
    optimizers and KV pools), what the programs need on top (the largest
    graph pool growth), and the headroom against the device model. Pure
    read: walks live objects, no device work."""
    acc = _Bytes()
    for o in _live(_STATE):
        if isinstance(o, torch.nn.Module):
            acc.module(o)
        else:
            acc.optimizer(o)
    param, master, moment, other = (acc.by[k] for k in
                                    ("param", "master", "moment", "other"))
    kv_pool = 0
    for kv in _live(_KV_CACHES):
        kv_pool += int(getattr(getattr(kv, "pool", None), "nbytes", 0) or 0)
        kv_pool += int(getattr(getattr(kv, "scales", None), "nbytes", 0) or 0)
    donated = 0
    g = _R.get("train.capture_donated_bytes")
    if g is not None:
        try:
            donated = int(g.value())
        except Exception:
            donated = 0
    with _LOCK:
        temps = [r.temp_bytes for r in _RECORDS.values()
                 if r.temp_bytes is not None]
    program_temp_peak = max(temps) if temps else 0
    dev = device_model()
    state_total = param + master + moment + other
    peak_hbm = state_total + kv_pool + program_temp_peak
    headroom = dev["hbm_bytes"] - peak_hbm
    frac = headroom / dev["hbm_bytes"] if dev["hbm_bytes"] else 0.0
    ledger = {
        "param_bytes": param, "master_bytes": master,
        "moment_bytes": moment, "other_state_bytes": other,
        "state_bytes_total": state_total, "kv_pool_bytes": kv_pool,
        "donated_bytes": donated, "program_temp_peak_bytes":
        program_temp_peak, "hbm_bytes": dev["hbm_bytes"],
        "peak_hbm_bytes": peak_hbm, "headroom_bytes": headroom,
        "headroom_fraction": frac,
    }
    for comp in ("param_bytes", "master_bytes", "moment_bytes",
                 "other_state_bytes", "kv_pool_bytes",
                 "program_temp_peak_bytes", "peak_hbm_bytes",
                 "headroom_bytes"):
        _HBM_G.set(ledger[comp], component=comp[:-len("_bytes")])
    fire_warn = False
    if frac < warn_fraction():
        with _LOCK:
            if not _HBM_WARN_ONCE[0]:
                _HBM_WARN_ONCE[0] = True
                fire_warn = True
    if fire_warn:
        _log.warning(
            "HBM headroom %.1f%% below the %.0f%% warn threshold: modeled "
            "peak %d bytes vs %d device bytes (state %d + kv %d + program "
            "temps %d) — set PADDLE_TPU_HBM_BYTES if the device model is "
            "wrong", 100 * frac, 100 * warn_fraction(), peak_hbm,
            dev["hbm_bytes"], state_total, kv_pool, program_temp_peak)
    return ledger


# ---------------------------------------------------------------------------
# utilization join (cost records x timing histograms)
# ---------------------------------------------------------------------------

def _hist_mean(name: str) -> Optional[float]:
    """Mean of every sample across ALL label series of one histogram
    family, or None when the family has no samples."""
    h = _R.get(name)
    if h is None:
        return None
    total = count = 0.0
    for st in h.series().values():
        total += st["sum"]
        count += st["count"]
    return (total / count) if count else None


def utilization() -> List[Dict[str, Any]]:
    """Join the live cost records against the measured timing histograms:
    ``train.step_seconds`` prices the captured step, ``serving.tpot_seconds``
    prices each decode bucket (TPOT ~ one decode step). Sets the
    ``cost.mfu`` / ``cost.bandwidth_util`` gauges and returns the rows."""
    step_s = _hist_mean("train.step_seconds")
    tpot_s = _hist_mean("serving.tpot_seconds")
    dev = device_model()
    rows: List[Dict[str, Any]] = []
    for r in records():
        secs = None
        if r["site"] == "train.step":
            secs = step_s
        elif r["site"] == "serving.decode":
            secs = tpot_s
        if not secs:
            continue
        mfu = bw = None
        if r["flops"]:
            mfu = r["flops"] / (secs * dev["peak_flops"])
            _MFU_G.set(mfu, site=r["site"], program=r["program"])
        if r["bytes_accessed"]:
            bw = r["bytes_accessed"] / (secs * dev["hbm_bw_bytes"])
            _BW_G.set(bw, site=r["site"], program=r["program"])
        if mfu is None and bw is None:
            continue
        rows.append({"key": r["key"], "site": r["site"],
                     "program": r["program"], "bucket": r["bucket"],
                     "seconds": secs, "mfu": mfu, "bandwidth_util": bw})
    return rows


# ---------------------------------------------------------------------------
# operator surfaces: /debug/cost, flight dumps, /healthz
# ---------------------------------------------------------------------------

def debug_doc() -> Dict[str, Any]:
    """The ``/debug/cost`` document: one record per live program, the HBM
    ledger, the measured-utilization join, and the device model they are
    priced against."""
    try:
        hbm: Any = hbm_ledger()
    except Exception as e:                             # pragma: no cover
        hbm = {"error": str(e)}
    return {
        "pid": os.getpid(), "mode": mode(), "installed": installed(),
        "device": device_model(), "records": records(),
        "hbm": hbm, "utilization": utilization(),
        "prefix_sharing": prefix_sharing_stats(),
    }


def flight_snapshot() -> Dict[str, Any]:
    """Cost snapshot embedded in flight-recorder dumps. NEVER raises: a
    post-mortem must not die collecting its own context. Off, only the
    prefix-index counters ride along (cheap dict reads)."""
    if not installed():
        return {"mode": "off", "prefix_sharing": prefix_sharing_stats()}
    try:
        return {"records": records(), "hbm": hbm_ledger(),
                "prefix_sharing": prefix_sharing_stats()}
    except Exception as e:
        return {"error": str(e)}


def healthz_component() -> Optional[Dict[str, Any]]:
    """The 503-independent ``hbm`` component for ``/healthz``: ledger
    bytes + headroom detail. ``ok`` is always True: low headroom warns
    (once) but never takes the process out of rotation. None when the
    registry is not installed (``/healthz`` may be polled hot)."""
    if not installed():
        return None
    try:
        led = hbm_ledger()
    except Exception:
        return None
    return {
        "ok": True, "stale": False,
        "hbm_bytes": led["hbm_bytes"],
        "peak_hbm_bytes": led["peak_hbm_bytes"],
        "state_bytes_total": led["state_bytes_total"],
        "kv_pool_bytes": led["kv_pool_bytes"],
        "headroom_bytes": led["headroom_bytes"],
        "headroom_fraction": led["headroom_fraction"],
        "warn": led["headroom_fraction"] < warn_fraction(),
    }
