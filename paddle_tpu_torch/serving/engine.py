"""The serving step loop: continuous batching over a paged KV pool. The
port of ``paddle_tpu/serving/engine.py``.

* The model enters as two callables (``LlamaForCausalLM.serving_callables``,
  or ``tools/fmt_stack.py``'s ``FMTStack.serving_callables`` for the
  ``FusedMultiTransformer`` stack); nothing here depends on the model:

  - ``prefill_fn(ids (1, n), cache (L, 2, 1, H, M, D), start=0) ->
    (first_token (1, 1), cache)``, filling positions ``[start, start + n)``
    of ``cache`` in place; ``[0, start)`` is a resident shared prefix. A
    2-argument ``prefill_fn(ids, cache)`` (``start`` always 0) works too,
    with prefix sharing off;
  - ``step_fn(tok (B, 1), cache: PagedDecodeCache, t (B,)) -> (next_token
    (B, 1), cache)``, whose attention reads the pool through the page
    tables and writes position ``t`` into it.

* Batch rows are assigned to active slots per step (per-slot state is on
  the host: a page-table row, a position, the last token), so the batch is
  compact. It is padded up to a bucket size (default {1, 4, 16}); padded
  rows read and write only the scratch page.

* On a card each bucket's decode step is one CUDA graph (the port's form of
  the JAX engine's one compiled program per bucket): ``step_fn`` captured
  over static ``tok``/``tables``/``t`` buffers, the pool and the weights.
  :meth:`Engine.warmup` captures every bucket; a bucket first met without
  it is captured at its first step. A step copies the host arrays into the
  static buffers, replays, and reads the next tokens back: one host sync.
  A capture or replay that fails raises; there is no eager fallback. On
  the CPU (``device="cpu"``) the step runs eagerly.

* Likewise each prefill key ``(start, n)`` is one CUDA graph on a card
  (:class:`PrefillGraph`, the JAX engine's ``prefill_program`` per prompt
  length and tail program per ``start``): :func:`prefill_body` captured
  over static ``ids (1, n)`` and page-row buffers. ``warmup(prompt_lens)``
  captures the full prefills of those lengths; any other key is captured
  at the admission that first meets it, which then costs an eager warm-up
  call and the capture besides the replay, with every live slot waiting.
  Prompts are not padded to a length bucket: padding would change the
  attention. The CPU engine calls :func:`prefill_body` eagerly, so its
  tests run the code a card replays. The engine's first prefill capture
  is preceded by one of ``max_len`` tokens, dropped once the key's own
  graph holds the pool: the shared pool then holds the largest prefill's
  temporaries, which every later key reuses (met shortest first, each
  longer key would add its whole footprint to the pool). The prefill
  graphs are kept least recently used first out: before a new capture,
  while the card has no room for a ``max_len`` prefill or the host is
  short of memory (:meth:`Engine._memory_short`), the oldest are dropped.

* Admission happens at step boundaries by prefill-into-slot: the scheduler
  pops what fits (a slot, and pages for the request's whole lifetime), the
  prompt is prefilled into a buffer of the prompt's pages
  (``M = pages * page_size``), the buffer is stored into the pool
  (``kv_cache.scatter_prefill_pages``), and the first token is emitted.
  With prefix sharing (``ServingConfig.prefix_sharing``) the admission
  first maps the longest resident chain of full prompt pages read-only
  (``PagedKVCache.acquire_prefix``), gathers it into the buffer, prefills
  only the tail from ``start`` and stores only the tail's pages; then it
  publishes its own full prompt pages. The scheduler's budget charges the
  tail only.

* A slot is evicted on eos, on length, or on cancel; its pages return to
  the pool (shared ones lose one reference).

The pool is updated **in place** and never reallocated (the JAX engine
threads it through its compiled programs as functional state); a replay
checks that it has not moved. The JAX engine's fault sites, watchdog,
replay, metrics and traces are later slices.
"""

from __future__ import annotations

import inspect
import threading
import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _native
from ..device import resolve_device
from ..ops.paged_attention import PagedDecodeCache
from . import kv_cache as _kv
from .scheduler import (GenerationRequest, GenerationResult, Scheduler,
                        _Pending)

__all__ = ["ServingConfig", "Engine", "EngineStopped", "DrainTimeout",
           "DecodeGraph", "PrefillGraph", "prefill_body"]

# bound on joining the loop thread when stop() was given no drain budget
_STOP_JOIN_S = 30.0
# eager calls on a side stream before a decode or prefill capture (PyTorch's
# graph API wants the call's lazy work, here the kernels' first build and
# load and cuBLAS's handles, done before it records; one call does it all)
_WARM_STEPS = 1
# below this share of the host's memory available, the least recently used
# prefill graphs are dropped before another is captured
_HOST_AVAILABLE_SHARE = 1 / 8


class EngineStopped(RuntimeError):
    """The engine is draining or stopped: ``submit`` rejects new work, and
    queued requests that were never admitted resolve with this at a
    drained stop."""


class DrainTimeout(EngineStopped):
    """An admitted request was still decoding when the drain budget ran
    out."""


def _prefill_accepts_start(fn: Callable) -> bool:
    """Whether ``prefill_fn`` takes the ``start`` offset (its third
    positional argument) and can prefill only a prompt's unshared tail."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return False
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return True
    return len([p for p in params if p.kind in (
        p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]) >= 3


@dataclass
class ServingConfig:
    """Engine sizing and policy. The model-shape fields must match the
    cache layout the callables consume (``num_heads`` counts KV heads)."""

    num_layers: int
    num_heads: int
    head_dim: int
    max_len: int
    max_batch: int = 16
    buckets: Tuple[int, ...] = (1, 4, 16)
    max_queue: int = 64
    page_size: int = 64
    num_pages: Optional[int] = None      # default: full coverage + scratch
    kv_dtype: str = "native"             # native | bf16 | int8
    compute_dtype: str = "float32"       # float32 | bfloat16
    policy: str = "fifo"
    prefill_token_budget: Optional[int] = None
    device: Optional[str] = None         # None -> cuda (raises without one)
    # prefix-cache page sharing: auto = share when prefill_fn takes a start
    # offset, on = require that (a 2-argument prefill_fn raises), off =
    # never consult the index
    prefix_sharing: str = "auto"
    min_shared_pages: int = 1            # shortest chain worth mapping

    def __post_init__(self):
        self.buckets = tuple(sorted(set(int(b) for b in self.buckets)))
        if not self.buckets or self.buckets[-1] < self.max_batch:
            raise ValueError(f"buckets {self.buckets} must cover max_batch "
                             f"{self.max_batch}")
        if self.prefix_sharing not in ("auto", "on", "off"):
            raise ValueError(f"prefix_sharing must be auto|on|off, got "
                             f"{self.prefix_sharing!r}")
        if self.min_shared_pages < 1:
            raise ValueError(f"min_shared_pages must be >= 1, got "
                             f"{self.min_shared_pages}")

    def kv_config(self) -> _kv.KVCacheConfig:
        cfg = _kv.KVCacheConfig(
            num_layers=self.num_layers, num_heads=self.num_heads,
            head_dim=self.head_dim, max_len=self.max_len,
            page_size=self.page_size, num_pages=self.num_pages,
            compute_dtype=self.compute_dtype, kv_dtype=self.kv_dtype,
            min_shared_pages=self.min_shared_pages)
        if cfg.num_pages is None:
            cfg.num_pages = self.max_batch * cfg.pages_per_slot + 1
        return cfg


@dataclass(eq=False)
class _Slot:
    """Host-side state of one admitted request."""

    pending: _Pending
    page_ids: List[int]
    table_row: np.ndarray               # (pages_per_slot,) int32
    t: int                              # next cache write position
    last_tok: int
    tokens: List[int] = field(default_factory=list)
    first_token_time: float = 0.0
    last_token_time: float = 0.0
    # leading pages mapped read-only from the prefix index: this slot holds
    # one reference on each, which free() hands back
    shared_pages: int = 0

    @property
    def request(self) -> GenerationRequest:
        return self.pending.request


def _host_memory() -> Optional[Tuple[int, int]]:
    """``(available, total)`` bytes of host memory, from
    ``/proc/meminfo``; None where there is none."""
    try:
        with open("/proc/meminfo") as f:
            info = dict(ln.split(":", 1) for ln in f if ":" in ln)
        return (int(info["MemAvailable"].split()[0]) * 1024,
                int(info["MemTotal"].split()[0]) * 1024)
    except (OSError, KeyError, ValueError):
        return None


def prefill_body(prefill_fn: Callable, kv: _kv.PagedKVCache,
                 ids: torch.Tensor, pages: torch.Tensor,
                 start: int = 0) -> torch.Tensor:
    """One admission's prefill on the card's (or the CPU's) tensors: the
    JAX engine's ``prefill_body`` (``start == 0``) and ``tail_body``.

    ``ids (1, n)`` int64 are the prompt's tokens from ``start`` on,
    ``pages (k,)`` int32 the slot's pages covering ``[0, start + n)``;
    ``start`` is a page-aligned Python int. Zeroes a dense ``(L, 2, 1, H,
    k * page_size, D)`` buffer, gathers the shared prefix pages
    ``pages[:start // page_size]`` into it, runs ``prefill_fn`` and stores
    the pages from ``start`` on (positions past ``start + n`` zeroed);
    returns the first token ``(1, 1)`` on the device. No host read: the
    CPU engine calls it eagerly and :class:`PrefillGraph` captures it."""
    cfg = kv.config
    ps = cfg.page_size
    dtype = cfg.torch_compute_dtype
    dense = torch.zeros((cfg.num_layers, 2, 1, cfg.num_heads,
                         pages.shape[0] * ps, cfg.head_dim),
                        dtype=dtype, device=ids.device)
    with torch.no_grad():
        if start:
            dense[:, :, :, :, :start] = _kv.gather_pages(
                kv.pool, kv.scales, pages[:start // ps], dtype)
            nxt, dense = prefill_fn(ids, dense, start)
        else:
            nxt, dense = prefill_fn(ids, dense)
        _kv.scatter_prefill_pages(dense, kv.pool, kv.scales,
                                  pages[start // ps:],
                                  start + int(ids.shape[1]), ps, start=start)
    return nxt


class _EngineGraph:
    """What the decode and prefill graphs share: static device buffers
    filled through pinned staging, a capture after warm-up calls on a side
    stream, and replays that check the pool and count launches.

    The capture bakes in the addresses of the static buffers, the pool,
    its scales and the model's weights, so the pool must never be
    reallocated: :meth:`replay` raises if it moved. Replays count the
    kernel launches the capture recorded (``_native.recorded_launches``).
    Graphs of one engine share a memory pool, so a graph's output is valid
    only until another graph replays."""

    def __init__(self, kv: _kv.PagedKVCache, buffers: Tuple[torch.Tensor, ...],
                 what: str):
        if kv.device.type != "cuda":
            raise ValueError(f"a {what} needs a pool on a CUDA device, not "
                             f"{kv.device}")
        self.what = what
        self._kv = kv
        self._buffers = buffers
        # pinned staging, so the host-to-card copies are asynchronous
        self._staging = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                         for x in buffers]
        self._pool_ptrs = self._pointers()
        self.replays = 0

    def _capture(self, fn: Callable, mempool,
                 side: Optional[torch.cuda.Stream]) -> torch.Tensor:
        """Run ``fn`` ``_WARM_STEPS`` times on the side stream ``side`` (a
        stream of its own if None), then capture one call of it into
        ``mempool``; returns the call's output (the graph's). Warm-up
        memory stays cached for its stream, so the engine gives all its
        graphs one side stream."""
        dev = self._kv.device
        t0 = time.perf_counter()
        if side is None:
            side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(_WARM_STEPS):
                fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: CUDA calls of the process's other threads (a caller's
        # tensors, another engine) neither fail nor spoil the capture; this
        # thread makes none, and the engine's replays run one at a time
        with _native.recorded_launches() as self.launches, torch.no_grad(), \
                torch.cuda.graph(self.graph, pool=mempool,
                                 capture_error_mode="thread_local"):
            out = fn()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        return out

    def _pointers(self) -> Tuple[int, int]:
        sc = self._kv.scales
        return (self._kv.pool.data_ptr(),
                sc.data_ptr() if sc is not None else 0)

    def load(self, *arrays: np.ndarray) -> None:
        """Copy one call's host arrays into the static buffers (queued on
        the current stream; the previous replay's output read has retired
        the previous copies, so the staging is free)."""
        for host, dev, arr in zip(self._staging, self._buffers, arrays):
            host.numpy()[...] = arr
            dev.copy_(host, non_blocking=True)

    def replay(self) -> torch.Tensor:
        """Launch the captured call on the current buffers; returns its
        output."""
        if self._pointers() != self._pool_ptrs:
            raise RuntimeError(
                f"{self.what}: the KV pool moved since its capture; the pool "
                f"must be updated in place")
        self.graph.replay()
        for counter, n in self.launches.items():
            counter.add(n)
        self.replays += 1
        return self.next


class DecodeGraph(_EngineGraph):
    """One bucket's decode step as a CUDA graph.

    ``tok (b, 1)`` int64, ``tables (b, S)`` int32 and ``t (b,)`` int32 are
    static device buffers (:meth:`load` fills them), ``next (b, 1)`` the
    graph's output. Warm-up calls write page 0 only."""

    def __init__(self, step_fn: Callable, kv: _kv.PagedKVCache, bucket: int,
                 mempool, side: Optional[torch.cuda.Stream] = None):
        dev = kv.device
        S = kv.config.pages_per_slot
        self.bucket = bucket
        self.tok = torch.zeros((bucket, 1), dtype=torch.int64, device=dev)
        self.tables = torch.zeros((bucket, S), dtype=torch.int32, device=dev)
        self.t = torch.zeros((bucket,), dtype=torch.int32, device=dev)
        super().__init__(kv, (self.tok, self.tables, self.t),
                         f"decode graph of bucket {bucket}")
        view = PagedDecodeCache(pool=kv.pool, tables=self.tables, t=self.t,
                                page_size=kv.config.page_size,
                                scales=kv.scales)
        self.next = self._capture(
            lambda: step_fn(self.tok, view, self.t)[0], mempool, side)


class PrefillGraph(_EngineGraph):
    """One prefill key as a CUDA graph: :func:`prefill_body` over static
    ``ids (1, n)`` int64 and ``pages (k,)`` int32 buffers, ``k`` the pages
    covering ``start + n`` positions (:meth:`load` fills them); ``next (1,
    1)`` is the first token. The key ``(start, n)`` fixes every shape and
    the true length ``start + n``, as the JAX engine's program is fixed by
    its input shapes and tail ``start``. Warm-up calls run with the page
    row all 0: they write the scratch page only."""

    def __init__(self, prefill_fn: Callable, kv: _kv.PagedKVCache,
                 start: int, n: int, mempool,
                 side: Optional[torch.cuda.Stream] = None):
        dev = kv.device
        cfg = kv.config
        if start % cfg.page_size or start < 0 or n < 1 \
                or start + n > cfg.max_len:
            raise ValueError(
                f"prefill key (start {start}, n {n}): start must be "
                f"page-aligned ({cfg.page_size}), n >= 1 and start + n <= "
                f"max_len {cfg.max_len}")
        self.key = (start, n)
        self.ids = torch.zeros((1, n), dtype=torch.int64, device=dev)
        self.pages = torch.zeros((kv.pages_for(start + n),),
                                 dtype=torch.int32, device=dev)
        super().__init__(kv, (self.ids, self.pages),
                         f"prefill graph of (start {start}, n {n})")
        self.next = self._capture(
            lambda: prefill_body(prefill_fn, kv, self.ids, self.pages, start),
            mempool, side)


class Engine:
    """Continuous-batching decode engine over a paged KV pool.

    ``step()`` is single-consumer (your own loop, :meth:`run`, or the
    :meth:`start` thread); ``submit`` and ``cancel`` are safe from any
    thread."""

    def __init__(self, prefill_fn: Callable, step_fn: Callable,
                 config: ServingConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self._prefill_fn = prefill_fn
        self._step_fn = step_fn
        self.kv = _kv.PagedKVCache(config.kv_config(), self.device)
        capable = _prefill_accepts_start(prefill_fn)
        if config.prefix_sharing == "on" and not capable:
            raise ValueError(
                "prefix_sharing='on' needs a prefill callable that takes a "
                "start offset (prefill_fn(ids, cache, start)); this one "
                "takes 2 arguments: pass 'auto' or 'off', or extend it")
        self._share_prefix = config.prefix_sharing != "off" and capable
        # prompt tokens asked for and computed (guarded by _slot_lock)
        self._prefill_tokens_requested = 0
        self._prefill_tokens_computed = 0
        self.scheduler = Scheduler(
            max_queue=config.max_queue, policy=config.policy,
            prefill_token_budget=config.prefill_token_budget,
            prefill_cost=self._prefill_cost if self._share_prefix else None)
        # decode graphs by bucket and prefill graphs by (start, n), least
        # recently used first (a card only), sharing one memory pool;
        # replays run one at a time on the step thread
        self._graphs: Dict[int, DecodeGraph] = {}
        self._prefill_graphs: "OrderedDict[Tuple[int, int], PrefillGraph]" \
            = OrderedDict()
        # prefill graphs captured and dropped, their capture seconds, and
        # the replays of dropped ones (guarded by _graph_lock)
        self._prefill_captures = 0
        self._prefill_evictions = 0
        self._pool_primed = False
        self._prefill_capture_s = 0.0
        self._evicted_replays: Counter = Counter()
        self._graph_lock = threading.Lock()
        self._capture_pool = None
        # the step loop's own counts: decode steps by live rows, prefills
        # by kind (guarded by _slot_lock)
        self._batch_sizes: Counter = Counter()
        self._prefills: Counter = Counter()
        self._slots: List[_Slot] = []    # admission order == batch row order
        self._slot_lock = threading.Lock()
        # orders submit's draining check + enqueue against stop's latch, so
        # a request is either refused or swept by the drain, never stranded
        self._submit_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- device calls -------------------------------------------------------
    def _prefill(self, prompt: np.ndarray, row: np.ndarray,
                 start: int = 0) -> int:
        """Prefill ``prompt`` into the pages of ``row``; returns the first
        token (one host sync). With ``start > 0`` the pages covering
        ``[0, start)`` are a shared prefix: they are read into the buffer,
        and only the tail is computed and stored. A replay of the key's
        graph on a card, an eager :func:`prefill_body` call on the CPU."""
        pages = row[:self.kv.pages_for(int(prompt.size))]
        if self.device.type == "cuda":
            g = self.prefill_graph(start, int(prompt.size) - start)
            g.load(prompt[None, start:], pages)
            return int(g.replay().reshape(-1)[0])
        ids = torch.as_tensor(prompt[None, start:], dtype=torch.int64,
                              device=self.device)
        nxt = prefill_body(self._prefill_fn, self.kv, ids,
                           torch.as_tensor(pages, device=self.device), start)
        return int(nxt.reshape(-1)[0])

    def _decode(self, tok: np.ndarray, tables: np.ndarray,
                t: np.ndarray) -> np.ndarray:
        """One batched decode step over the pool; returns next tokens
        (bucket,) (one host sync). A replay of the bucket's graph on a
        card, an eager ``step_fn`` call on the CPU."""
        if self.device.type == "cuda":
            g = self.decode_graph(int(tok.shape[0]))
            g.load(tok, tables, t)
            return g.replay().reshape(-1).cpu().numpy()
        dev = self.device
        t_d = torch.as_tensor(t, device=dev)
        view = PagedDecodeCache(
            pool=self.kv.pool, tables=torch.as_tensor(tables, device=dev),
            t=t_d, page_size=self.kv.config.page_size, scales=self.kv.scales)
        with torch.no_grad():
            nxt, _ = self._step_fn(torch.as_tensor(tok, device=dev), view,
                                   t_d)
        return nxt.reshape(-1).cpu().numpy()

    def _capture_args(self):
        """The memory pool every graph of this engine captures into, and
        the side stream of their warm-up calls."""
        if self._capture_pool is None:
            self._capture_pool = (torch.cuda.graph_pool_handle(),
                                torch.cuda.Stream(self.device))
        return self._capture_pool

    def decode_graph(self, bucket: int) -> DecodeGraph:
        """The CUDA graph of ``bucket``'s decode step, captured on first
        use (a card only)."""
        if self.device.type != "cuda":
            raise RuntimeError("decode graphs need a CUDA device; the CPU "
                               "engine decodes eagerly")
        if bucket not in self.config.buckets:
            raise ValueError(f"{bucket} is not one of the buckets "
                             f"{self.config.buckets}")
        with self._graph_lock:
            g = self._graphs.get(bucket)
            if g is None:
                g = DecodeGraph(self._step_fn, self.kv, bucket,
                                *self._capture_args())
                self._graphs[bucket] = g
        return g

    def prefill_graph(self, start: int, n: int) -> PrefillGraph:
        """The CUDA graph of the prefill of ``n`` tokens after a resident
        prefix of ``start`` positions (0: a full prefill of an ``n``-token
        prompt), captured on first use (a card only). Before a capture,
        while :meth:`_memory_short`, the least recently used prefill graph
        is dropped; the engine's first is preceded by the pool's primer, a
        capture of ``max_len`` tokens (the module docstring), counted in
        ``prefill_graphs`` and ``prefill_capture_s``."""
        if self.device.type != "cuda":
            raise RuntimeError("prefill graphs need a CUDA device; the CPU "
                               "engine prefills eagerly")
        if start and not self._share_prefix:
            raise ValueError(f"a tail prefill (start {start}) needs prefix "
                             f"sharing on and a prefill_fn that takes start")
        key = (int(start), int(n))
        with self._graph_lock:
            g = self._prefill_graphs.get(key)
            if g is not None:
                self._prefill_graphs.move_to_end(key)
                return g
            while self._prefill_graphs and self._memory_short():
                old_key, old = self._prefill_graphs.popitem(last=False)
                self._evicted_replays[old_key] += old.replays
                self._prefill_evictions += 1
                del old
            primer = None
            if not self._pool_primed:
                primer = self._count_capture(PrefillGraph(
                    self._prefill_fn, self.kv, 0, self.config.max_len,
                    *self._capture_args()))
                self._pool_primed = True
            g = self._count_capture(PrefillGraph(
                self._prefill_fn, self.kv, *key, *self._capture_args()))
            self._prefill_graphs[key] = g
            del primer
        return g

    def _count_capture(self, g: PrefillGraph) -> PrefillGraph:
        self._prefill_captures += 1
        self._prefill_capture_s += g.capture_s
        return g

    def _memory_short(self) -> bool:
        """Whether the card could not hold a ``max_len`` prefill's dense
        buffer twice over (``cudaMemGetInfo``'s free memory and what the
        caching allocator holds unused), or the host has less than
        ``_HOST_AVAILABLE_SHARE`` of its memory available. A prefill graph
        holds its executable on both, and the shared pool's temporaries are
        reused by the next capture."""
        cfg = self.kv.config
        dense = (cfg.num_layers * 2 * cfg.num_heads * cfg.max_len
                 * cfg.head_dim * cfg.torch_compute_dtype.itemsize)
        free = torch.cuda.mem_get_info(self.device)[0] \
            + torch.cuda.memory_reserved(self.device) \
            - torch.cuda.memory_allocated(self.device)
        host = _host_memory()
        return free < 2 * dense or (
            host is not None and host[0] < host[1] * _HOST_AVAILABLE_SHARE)

    def warmup(self, prompt_lens: Sequence[int] = ()) -> "Engine":
        """Make every batch bucket and the full prefill of each of
        ``prompt_lens`` ready before the first request: on a card capture
        their graphs, on the CPU run each once. Writes nothing outside
        page 0."""
        S = self.kv.config.pages_per_slot
        on_card = self.device.type == "cuda"
        for b in self.config.buckets:
            if on_card:
                self.decode_graph(b)
            else:
                self._decode(np.zeros((b, 1), np.int64),
                             np.zeros((b, S), np.int32),
                             np.zeros((b,), np.int32))
        for lp in prompt_lens:
            if on_card:
                self.prefill_graph(0, int(lp))
            else:
                self._prefill(np.zeros((int(lp),), np.int32),
                              np.zeros((S,), np.int32))
        return self

    def decode_stats(self) -> Dict[str, object]:
        """The step loop's counts so far: ``steps`` (decode steps by their
        live rows), ``replays`` (decode graph replays by bucket),
        ``prefills`` (``"full"`` and ``"tail"`` admissions),
        ``prefill_replays`` (prefill graph replays by ``(start, n)``, with
        those of dropped graphs), ``prefill_graphs`` (prefill graphs
        captured), ``prefill_graphs_live`` (those kept),
        ``prefill_evictions`` (those dropped) and ``prefill_capture_s``
        (seconds their warm-ups and captures took). The CPU engine replays
        and captures nothing."""
        with self._graph_lock:
            replays = {b: g.replays for b, g in sorted(self._graphs.items())}
            prefill_replays = dict(self._evicted_replays)
            for k, g in self._prefill_graphs.items():
                prefill_replays[k] = prefill_replays.get(k, 0) + g.replays
            graphs = {"prefill_replays": dict(sorted(prefill_replays.items())),
                      "prefill_graphs": self._prefill_captures,
                      "prefill_graphs_live": len(self._prefill_graphs),
                      "prefill_evictions": self._prefill_evictions,
                      "prefill_capture_s": self._prefill_capture_s}
        with self._slot_lock:
            return {"steps": dict(self._batch_sizes), "replays": replays,
                    "prefills": dict(self._prefills), **graphs}

    # -- request surface ----------------------------------------------------
    def _pages_needed(self, request: GenerationRequest) -> int:
        last = min(self.config.max_len,
                   int(request.prompt.size) + request.max_new_tokens)
        return self.kv.pages_for(last)

    def _prefill_cost(self, request: GenerationRequest) -> int:
        """The scheduler's admission cost: prompt tokens the prefill will
        compute, the full prompt less the resident prefix chain (a peek:
        admission claims the chain itself)."""
        shared = self.kv.peek_prefix_pages(request.prompt) \
            * self.config.page_size
        return max(1, int(request.prompt.size) - shared)

    def prefix_summary(self) -> frozenset:
        """The pool's resident chain digests."""
        return self.kv.prefix_summary()

    @property
    def prefix_sharing_enabled(self) -> bool:
        return self._share_prefix

    def prefill_token_stats(self) -> Tuple[int, int]:
        """``(requested, computed)`` prompt tokens over all admissions."""
        with self._slot_lock:
            return (self._prefill_tokens_requested,
                    self._prefill_tokens_computed)

    def submit(self, request: GenerationRequest):
        """Enqueue; returns a Future resolving to GenerationResult. Raises
        QueueFull, DeadlineExceeded (shed on arrival), EngineStopped
        (draining) or ValueError (the request can never fit) here."""
        if int(request.prompt.size) + request.max_new_tokens \
                > self.config.max_len:
            raise ValueError(
                f"prompt ({request.prompt.size}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_len "
                f"{self.config.max_len}")
        if self._pages_needed(request) > self.kv.config.num_pages - 1:
            raise ValueError("request needs more pages than the pool holds")
        with self._submit_lock:
            if self._draining.is_set():
                raise EngineStopped("engine is draining/stopped: not "
                                    "admitting")
            fut = self.scheduler.submit(request,
                                        submit_time=time.monotonic())
        self._wake.set()
        return fut

    def cancel(self, request_id: int) -> bool:
        ok = self.scheduler.cancel(request_id)
        self._wake.set()
        return ok

    @property
    def active_requests(self) -> int:
        with self._slot_lock:
            return len(self._slots)

    @property
    def queue_depth(self) -> int:
        return self.scheduler.queue_depth

    # -- the step loop ------------------------------------------------------
    def step(self) -> bool:
        """One step boundary: evict cancellations, admit what fits, run one
        batched decode step. Returns False when there was nothing to do."""
        progressed = self._process_cancellations()
        if not self._draining.is_set():
            progressed |= self._admit()
        if not self._slots:
            return progressed
        self._decode_step(list(self._slots))
        return True

    def run(self) -> None:
        """Drive step() until queue and slots drain (offline mode)."""
        self._stop.clear()
        self._draining.clear()
        while self.scheduler.queue_depth or self._slots:
            self.step()

    def start(self) -> "Engine":
        """Serve from a background thread until stop()."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._draining.clear()

        def loop():
            while not self._stop.is_set():
                if not self.step():
                    self._wake.wait(0.01)
                    self._wake.clear()

        self._thread = threading.Thread(target=loop, name="serving-engine",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = False,
             timeout: Optional[float] = None) -> None:
        """Stop serving. ``drain=False`` pauses where it stands (``start()``
        resumes). ``drain=True`` stops admitting, keeps stepping until every
        admitted request finishes or ``timeout`` seconds pass, then fails
        the still-active ones with :class:`DrainTimeout` and the
        never-admitted ones with :class:`EngineStopped`: every Future
        resolves and every page returns to the pool."""
        if self._thread is not None \
                and threading.current_thread() is self._thread:
            raise RuntimeError("Engine.stop() called from the engine step "
                               "thread; use cancel()")
        deadline = None if timeout is None else time.monotonic() + timeout
        if drain:
            with self._submit_lock:
                self._draining.set()
            self._wake.set()
            while self.active_requests and (
                    deadline is None or time.monotonic() < deadline):
                if self._thread is None:
                    self.step()
                else:
                    time.sleep(0.002)
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=_STOP_JOIN_S if deadline is None else
                   max(0.0, deadline - time.monotonic()) + 1.0)
            if t.is_alive():
                raise RuntimeError("serving loop thread did not stop")
        self._thread = None
        if drain:
            for slot in list(self._slots):
                self._finish_error(slot, DrainTimeout(
                    f"request {slot.request.request_id} evicted at drain "
                    f"timeout after {len(slot.tokens)} tokens"))
            for pend in self.scheduler.drain_queue():
                pend.future.set_exception(EngineStopped(
                    f"request {pend.request.request_id} never admitted: "
                    f"engine stopped"))

    # -- step phases ----------------------------------------------------------
    def _process_cancellations(self) -> bool:
        cancelled = self.scheduler.take_cancelled_active()
        hit = False
        for slot in [s for s in self._slots
                     if s.request.request_id in cancelled]:
            self._finish(slot, "cancelled")
            hit = True
        return hit

    def _admit(self) -> bool:
        free_slots = self.config.max_batch - len(self._slots)
        if free_slots <= 0:
            return False
        claimed = 0   # pages reserved by this boundary's earlier admissions

        def can_fit(req: GenerationRequest) -> bool:
            nonlocal claimed
            need = self._pages_needed(req)
            if claimed + need > self.kv.free_pages:
                return False
            claimed += need
            return True

        admitted = False
        pending = self.scheduler.next_admissions(free_slots, can_fit)
        for i, p in enumerate(pending):
            try:
                status = self._admit_one(p)
            except BaseException as exc:
                # the popped requests behind this one go back in order;
                # this one fails, and the error surfaces
                self.scheduler.requeue(pending[i + 1:])
                if not p.future.done():
                    p.future.set_exception(exc)
                raise
            if status == "noroom":
                # the pool could not cover what can_fit reserved (single
                # consumer: not expected); put this one and the rest back
                self.scheduler.requeue(pending[i:])
                break
            admitted |= status == "ok"
        return admitted

    def _admit_one(self, pending: _Pending) -> str:
        """Admit one popped request: ``"ok"``, ``"failed"`` (its future
        holds the error) or ``"noroom"`` (untouched; the caller requeues
        it)."""
        req = pending.request
        prompt = req.prompt
        shared: List[int] = []
        if self._share_prefix:
            shared = self.kv.acquire_prefix(prompt)
        try:
            pages = self.kv.alloc(self._pages_needed(req) - len(shared))
        except BaseException:
            if shared:
                self.kv.free(shared)
            raise
        if pages is None:
            if shared:
                self.kv.free(shared)
            return "noroom"
        pages = shared + pages
        start = len(shared) * self.config.page_size
        row = self.kv.table_row(pages)
        try:
            first_tok = self._prefill(prompt, row, start)
            if self._share_prefix:
                # full prompt pages are frozen now: decode writes land at
                # t >= prompt length, past every one of them
                self.kv.publish(prompt, pages)
        except Exception as exc:
            self.kv.free(pages)     # shared pages lose one reference
            pending.future.set_exception(exc)
            return "failed"
        now = time.monotonic()
        slot = _Slot(pending=pending, page_ids=pages, table_row=row,
                     t=int(prompt.size), last_tok=first_tok,
                     first_token_time=now, last_token_time=now,
                     shared_pages=len(shared))
        with self._slot_lock:
            self._slots.append(slot)
            self._prefill_tokens_requested += int(prompt.size)
            self._prefill_tokens_computed += int(prompt.size) - start
            self._prefills["tail" if start else "full"] += 1
        self._emit_token(slot, first_tok, now)
        return "ok"

    def _bucket_for(self, n: int) -> int:
        for b in self.config.buckets:
            if b >= n:
                return b
        raise AssertionError(f"no bucket for batch {n}")  # __post_init__

    def _decode_step(self, included: List[_Slot]) -> None:
        bucket = self._bucket_for(len(included))
        S = self.kv.config.pages_per_slot
        tok = np.zeros((bucket, 1), np.int64)
        t = np.zeros((bucket,), np.int32)
        tables = np.zeros((bucket, S), np.int32)   # padded rows -> scratch
        for i, slot in enumerate(included):
            tok[i, 0] = slot.last_tok
            t[i] = slot.t
            tables[i] = slot.table_row
        next_np = self._decode(tok, tables, t)
        with self._slot_lock:
            self._batch_sizes[len(included)] += 1
        now = time.monotonic()
        for i, slot in enumerate(included):
            slot.t += 1
            self._emit_token(slot, int(next_np[i]), now)

    def _emit_token(self, slot: _Slot, token: int, now: float) -> None:
        req = slot.request
        slot.tokens.append(token)
        slot.last_tok = token
        slot.last_token_time = now
        if req.stream is not None:
            try:
                req.stream(req.request_id, token)
            except Exception as exc:
                # a raising callback fails its own request, not the batch
                self._finish_error(slot, exc)
                return
        if req.eos_token_id is not None and token == req.eos_token_id:
            self._finish(slot, "eos")
        elif len(slot.tokens) >= req.max_new_tokens \
                or slot.t >= self.config.max_len:
            self._finish(slot, "length")

    def _release(self, slot: _Slot) -> bool:
        with self._slot_lock:
            if slot not in self._slots:
                return False
            self._slots.remove(slot)
        self.kv.free(slot.page_ids)
        return True

    def _finish(self, slot: _Slot, reason: str) -> None:
        if not self._release(slot):
            return
        n = len(slot.tokens)
        tpot = ((slot.last_token_time - slot.first_token_time) / (n - 1)
                if n > 1 else None)
        sub = slot.pending.submit_time
        slot.pending.future.set_result(GenerationResult(
            slot.request.request_id, slot.tokens, reason,
            ttft_s=slot.first_token_time - sub if sub else None,
            tpot_s=tpot))

    def _finish_error(self, slot: _Slot, exc: BaseException) -> None:
        if self._release(slot):
            slot.pending.future.set_exception(exc)
