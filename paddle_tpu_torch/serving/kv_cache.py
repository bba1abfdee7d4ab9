"""Slot-paged KV cache for the serving engine: a fixed pool of pages on the
card plus per-slot page tables, with an optional int8 leg. The port of
``paddle_tpu/serving/kv_cache.py``.

Layout:

* ``pool``   -- ``(num_pages, L, 2, H, page_size, D)``. One page holds
  ``page_size`` consecutive positions of ONE sequence across ALL layers (K
  and V). Page 0 is the scratch page: padded batch rows and unused
  page-table entries point at it.
* ``scales`` -- ``(num_pages, L, 2, H)`` fp32, int8 leg only: symmetric
  per-(page, layer, K/V, head) absmax scales, ``scale = absmax / 127``,
  zero absmax quantized with scale 1.
* page table -- ``(pages_per_slot,)`` int32 per slot; unused entries 0.

The engine writes prefilled pages with :func:`scatter_prefill_pages` and
each decoded token with ``ops.paged_attention.scatter_token_inplace`` (the
dense decode tier: :func:`gather_pages` into the stacked cache, then
:func:`scatter_token_page`), all **in place** (the JAX package threads the pool through its programs as
functional state instead): the pool never moves, so the engine's captured
decode graphs can hold its address. int8 requantization contract: writing
position ``t`` re-quantizes its whole page with positions ``> t`` zeroed.

Host-side accounting (:class:`PagedKVCache`) is a refcounted free list over
page ids with page 0 reserved, plus the prompt-prefix index: full prompt
pages are published under their chain digest
(:func:`prefix_chain_digests`), and a later prompt with the same leading
pages maps them read-only (:meth:`PagedKVCache.acquire_prefix`), so its
prefill reads them back (:func:`gather_pages`) and computes only its tail.
A shared page is never a store target: :func:`scatter_prefill_pages`
writes from ``start`` onwards only, and decode writes land past the
prompt.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import observability as _obs
from ..ops.paged_attention import PagedDecodeCache  # noqa: F401  (re-export)

__all__ = ["KVCacheConfig", "PagedKVCache", "PagedDecodeCache",
           "gather_pages", "scatter_prefill_pages", "scatter_token_page",
           "quantize_pages", "prefix_chain_digests"]

_Q8_MAX = 127.0
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


@dataclass
class KVCacheConfig:
    """Shape + dtype contract shared by the host pool and the device ops."""

    num_layers: int
    num_heads: int
    head_dim: int
    max_len: int
    page_size: int = 64
    num_pages: Optional[int] = None   # default set by the engine
    compute_dtype: str = "float32"    # dtype the decode step consumes
    kv_dtype: str = "native"          # "native" | "bf16" | "int8"
    min_shared_pages: int = 1         # shortest prefix chain worth sharing

    def __post_init__(self):
        if self.max_len % self.page_size != 0:
            raise ValueError(
                f"max_len ({self.max_len}) must be a multiple of page_size "
                f"({self.page_size})")
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{sorted(_COMPUTE_DTYPES)}, got "
                             f"{self.compute_dtype!r}")
        if self.kv_dtype not in ("native", "bf16", "int8"):
            raise ValueError(f"kv_dtype must be native|bf16|int8, got "
                             f"{self.kv_dtype!r}")
        if self.min_shared_pages < 1:
            raise ValueError("min_shared_pages must be >= 1")

    @property
    def pages_per_slot(self) -> int:
        return self.max_len // self.page_size

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return _COMPUTE_DTYPES[self.compute_dtype]

    @property
    def storage_dtype(self) -> torch.dtype:
        if self.kv_dtype == "int8":
            return torch.int8
        if self.kv_dtype == "bf16":
            return torch.bfloat16
        return self.torch_compute_dtype

    def page_shape(self) -> Tuple[int, ...]:
        return (self.num_layers, 2, self.num_heads, self.page_size,
                self.head_dim)


def quantize_pages(pages: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """absmax-int8 quantize ``(..., ps, D)`` pages -> (int8 pages, fp32
    scales over the leading dims)."""
    x = pages.float()
    scale = x.abs().amax(dim=(-2, -1)) / _Q8_MAX
    scale = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(x / scale[..., None, None]), -_Q8_MAX, _Q8_MAX)
    return q.to(torch.int8), scale


def gather_pages(pool: torch.Tensor, scales: Optional[torch.Tensor],
                 tables: torch.Tensor, dtype: torch.dtype,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pages -> the dense stacked cache ``(L, 2, B, H, S * page_size, D)``
    in ``dtype``: ``tables`` ``(B, S)`` page ids (a 1-D ``(S,)`` is one
    slot, ``B = 1``). Rows gathered through scratch entries carry garbage
    at positions the decode's span mask (``<= t``) never admits. The int8
    leg dequantizes with the pages' scales, the multiply in ``dtype`` (as
    the JAX package does); other legs only convert when the storage dtype
    differs. ``out``: a buffer of that shape to gather into (one page slot
    at a time, so no second cache-sized temporary), returned."""
    ids = tables.long()
    if ids.dim() == 1:
        ids = ids[None]
    b, n = ids.shape
    _, l, two, h, ps, d = pool.shape
    if out is None:
        out = torch.empty((l, two, b, h, n * ps, d), dtype=dtype,
                          device=pool.device)
    slots = out.view(l, two, b, h, n, ps, d)
    for s in range(n):
        taken = pool[ids[:, s]]                       # (B, L, 2, H, ps, D)
        if scales is not None:
            taken = taken.to(dtype) * \
                scales[ids[:, s]][..., None, None].to(dtype)
        slots[:, :, :, :, s] = taken.permute(1, 2, 0, 3, 4, 5)
    return out


def scatter_token_page(dense: torch.Tensor, pool: torch.Tensor,
                       scales: Optional[torch.Tensor], tables: torch.Tensor,
                       t: torch.Tensor, page_size: int) -> None:
    """Write back, in place, the one page per slot that holds position
    ``t``: ``dense`` is the stacked cache ``(L, 2, B, H, M, D)`` after a
    decode step wrote position ``t`` of each row; positions ``> t`` in that
    page are zeroed (a fresh page never inherits stale bytes, and the int8
    scales cover written positions only), and on an int8 pool the page is
    quantized anew with its scales. ``tables`` ``(B, S)``, ``t`` ``(B,)``."""
    ps = page_size
    b = dense.shape[2]
    t64 = t.long().reshape(-1)
    pos = (t64 // ps * ps)[:, None] + torch.arange(ps, device=dense.device)
    rows = torch.arange(b, device=dense.device)[:, None]
    pages = dense[:, :, rows, :, pos]                 # (B, ps, L, 2, H, D)
    pages = pages.permute(0, 2, 3, 4, 1, 5)           # (B, L, 2, H, ps, D)
    valid = pos <= t64[:, None]
    pages = torch.where(valid[:, None, None, None, :, None], pages, 0)
    pids = tables.long().gather(1, (t64 // ps)[:, None])[:, 0]
    if scales is not None:
        q8, sc = quantize_pages(pages)
        pool[pids] = q8
        scales[pids] = sc
    else:
        pool[pids] = pages.to(pool.dtype)


def scatter_prefill_pages(dense: torch.Tensor, pool: torch.Tensor,
                          scales: Optional[torch.Tensor],
                          page_ids: torch.Tensor, true_len: int,
                          page_size: int, start: int = 0) -> None:
    """Store a prefilled single-slot cache into the pool, in place.

    ``dense`` is ``(L, 2, 1, H, n * page_size, D)`` with positions
    ``[start, true_len)`` freshly computed; positions past ``true_len`` are
    zeroed before they reach the pool. ``start`` is page-aligned: only the
    pages from ``start // page_size`` on are written, so the pages a
    prefix-shared admission mapped read-only are never a store target.
    ``page_ids`` is ``(n - start // page_size,)``: those pages only."""
    ps = page_size
    if start % ps != 0:
        raise ValueError(f"start ({start}) must be page-aligned ({ps})")
    l, two, _, h, lp, d = dense.shape
    n = (lp - start) // ps
    if n * ps != lp - start or page_ids.shape != (n,):
        raise ValueError(f"dense positions [{start}, {lp}) must be "
                         f"{page_ids.shape[0]} pages of {ps}")
    x = dense[:, :, 0, :, start:].reshape(l, two, h, n, ps, d)
    x = x.permute(3, 0, 1, 2, 4, 5)
    pos = start + torch.arange(lp - start, device=dense.device).reshape(n, ps)
    valid = pos < int(true_len)
    x = torch.where(valid[:, None, None, None, :, None], x, 0)
    ids = page_ids.long()
    if scales is not None:
        q8, sc = quantize_pages(x)
        pool[ids] = q8
        scales[ids] = sc
    else:
        pool[ids] = x.to(pool.dtype)


def prefix_chain_digests(tokens, page_size: int,
                         limit: Optional[int] = None) -> List[bytes]:
    """Chain digests of a prompt's full pages: ``h_i = blake2b(h_{i-1} ||
    tokens[i * ps:(i + 1) * ps])`` (16 bytes), at most ``limit`` of them.
    Two prompts share a prefix of ``k`` pages exactly when their first
    ``k`` digests are equal, so the index is a flat ``digest -> page``
    dict and a lookup walks until the first miss."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    n = toks.size // page_size
    if limit is not None:
        n = min(n, limit)
    out: List[bytes] = []
    h = b""
    for i in range(n):
        h = hashlib.blake2b(
            h + toks[i * page_size:(i + 1) * page_size].tobytes(),
            digest_size=16).digest()
        out.append(h)
    return out


class PagedKVCache:
    """The preallocated page pool on ``device`` plus refcounted page
    accounting and the prompt-prefix index. Thread-safe: the free list,
    the refcounts ``_ref``, the index ``_index`` and the idle LRU are
    guarded by one lock.

    Page lifecycle::

        alloc()            rc = 1, private
        publish()          the page enters the prefix index (content frozen)
        acquire_prefix()   rc += 1 per sharer (read-only mapping)
        free()             rc -= 1; at rc == 0 a published page parks on the
                           idle LRU (still indexed, reclaimable), any other
                           page returns to the free list
        alloc() pressure   idle pages are evicted LRU-first (their index
                           entries dropped) when the free list cannot cover

    ``free()`` raises (and counts ``double_free_total``) on a free that
    would corrupt the accounting: of the scratch page, of a page on the
    free list or the idle LRU, or of a page whose refcount is already 0."""

    def __init__(self, config: KVCacheConfig, device: torch.device):
        if config.num_pages is None:
            raise ValueError("KVCacheConfig.num_pages must be set (the "
                             "engine sizes it from max_batch)")
        if config.num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is scratch)")
        self.config = config
        self.device = device
        shape = (config.num_pages,) + config.page_shape()
        self.pool = torch.zeros(shape, dtype=config.storage_dtype,
                                device=device)
        self.scales: Optional[torch.Tensor] = None
        if config.quantized:
            self.scales = torch.ones(
                (config.num_pages, config.num_layers, 2, config.num_heads),
                dtype=torch.float32, device=device)
        self._lock = threading.Lock()
        # page 0 is scratch: never allocated. _free_set mirrors _free for
        # the double-free check
        self._free: List[int] = list(range(config.num_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._ref: Dict[int, int] = {}        # entries only while rc > 0
        self._index: Dict[bytes, int] = {}    # chain digest -> page
        self._page_hash: Dict[int, bytes] = {}
        # published pages with rc == 0, least recently used first
        self._idle: "OrderedDict[int, None]" = OrderedDict()
        self._high_water = 0
        self._double_free_total = 0
        self._prefix_queries = 0
        self._prefix_query_hits = 0
        self._prefix_pages_shared_total = 0

    @property
    def free_pages(self) -> int:
        """Allocatable pages: the free list plus the idle pages ``alloc``
        may reclaim."""
        with self._lock:
            return len(self._free) + len(self._idle)

    @property
    def outstanding_pages(self) -> int:
        """Pages claimed by slots (rc > 0; 0 after a clean drain)."""
        with self._lock:
            return len(self._ref)

    @property
    def idle_pages(self) -> int:
        """Published pages kept with rc == 0 (the prefix cache)."""
        with self._lock:
            return len(self._idle)

    @property
    def double_free_total(self) -> int:
        with self._lock:
            return self._double_free_total

    def refcounts(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._ref)

    def pages_for(self, positions: int) -> int:
        """Pages needed to cover logical positions ``[0, positions)``."""
        ps = self.config.page_size
        return min(self.config.pages_per_slot, -(-positions // ps))

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` private pages (rc = 1), or None if the pool cannot
        cover them. Takes the free list first, then evicts idle pages
        LRU-first, dropping their index entries."""
        with self._lock:
            if n > len(self._free) + len(self._idle):
                return None
            ids: List[int] = []
            for _ in range(n):
                if self._free:
                    pid = self._free.pop()
                    self._free_set.discard(pid)
                else:
                    pid, _ = self._idle.popitem(last=False)
                    self._unpublish_locked(pid)
                self._ref[pid] = 1
                ids.append(pid)
            self._note_usage_locked()
        return ids

    def free(self, ids: Sequence[int]) -> None:
        """Release one claim on each page: a shared page (rc > 1) is
        decremented; at rc == 0 a published page parks on the idle LRU and
        any other returns to the free list."""
        with self._lock:
            for pid in ids:
                rc = self._ref.get(pid, 0)
                if pid == 0 or pid in self._free_set or pid in self._idle \
                        or rc <= 0:
                    self._double_free_total += 1
                    _obs.inc("serving.kv.double_free_total")
                    raise ValueError(
                        f"double free / scratch free: page {pid} (rc={rc})")
                if rc > 1:
                    self._ref[pid] = rc - 1
                    continue
                del self._ref[pid]
                if pid in self._page_hash:
                    self._idle[pid] = None
                else:
                    self._free.append(pid)
                    self._free_set.add(pid)
            self._note_usage_locked()

    # -- prefix sharing ------------------------------------------------------
    def _shareable_digests(self, tokens) -> List[bytes]:
        # the tail keeps at least one prompt token, so the admission still
        # has a position to prefill and emit its first token from
        ps = self.config.page_size
        toks = np.asarray(tokens).reshape(-1)
        return prefix_chain_digests(toks, ps, limit=max(0, (toks.size - 1)
                                                        // ps))

    def acquire_prefix(self, tokens) -> List[int]:
        """Map the longest resident prefix chain of ``tokens`` read-only:
        bump each page's refcount and return the page ids in chain order,
        or ``[]`` when the chain is shorter than ``min_shared_pages``. At
        most ``(len(tokens) - 1) // page_size`` pages are shared."""
        digests = self._shareable_digests(tokens)
        with self._lock:
            self._prefix_queries += 1
            got: List[int] = []
            for h in digests:
                pid = self._index.get(h)
                if pid is None:
                    break
                got.append(pid)
            if len(got) < self.config.min_shared_pages:
                return []
            for pid in got:
                self._idle.pop(pid, None)      # revived from the idle LRU
                self._ref[pid] = self._ref.get(pid, 0) + 1
            self._prefix_query_hits += 1
            self._prefix_pages_shared_total += len(got)
            _obs.inc("serving.kv.prefix_pages_shared_total", float(len(got)))
            self._note_usage_locked()
        return got

    def peek_prefix_pages(self, tokens) -> int:
        """Length of the resident prefix chain of ``tokens``, claiming
        nothing (the scheduler's admission cost): the same cap and
        ``min_shared_pages`` threshold as :meth:`acquire_prefix`."""
        digests = self._shareable_digests(tokens)
        with self._lock:
            depth = 0
            for h in digests:
                if h not in self._index:
                    break
                depth += 1
        return depth if depth >= self.config.min_shared_pages else 0

    def publish(self, tokens, page_ids: Sequence[int]) -> int:
        """Index a freshly prefilled slot's full prompt pages (page ``k <
        len(tokens) // page_size``; the page holding the prompt's end also
        takes decoded tokens and is not frozen). The first publisher of a
        digest wins. Returns how many pages were newly indexed."""
        digests = prefix_chain_digests(tokens, self.config.page_size)
        added = 0
        with self._lock:
            for h, pid in zip(digests, page_ids):
                if h in self._index or pid in self._page_hash \
                        or self._ref.get(pid, 0) <= 0:
                    continue
                self._index[h] = pid
                self._page_hash[pid] = h
                added += 1
            if added:
                _obs.set_gauge("serving.kv.prefix_index_pages",
                               float(len(self._index)))
        return added

    def prefix_summary(self) -> frozenset:
        """The resident chain digests (a router's placement signal)."""
        with self._lock:
            return frozenset(self._index)

    def prefix_stats(self) -> Dict[str, float]:
        """Point-in-time sharing and accounting numbers."""
        with self._lock:
            claims = sum(self._ref.values())
            queries = self._prefix_queries
            return {
                "pages_in_use": float(len(self._ref)),
                "pages_idle": float(len(self._idle)),
                "pages_high_water": float(self._high_water),
                "pages_shared_ratio":
                    (claims - len(self._ref)) / claims if claims else 0.0,
                "prefix_index_pages": float(len(self._index)),
                "prefix_queries": float(queries),
                "prefix_query_hits": float(self._prefix_query_hits),
                "prefix_hit_rate":
                    self._prefix_query_hits / queries if queries else 0.0,
                "prefix_pages_shared_total":
                    float(self._prefix_pages_shared_total),
                "double_free_total": float(self._double_free_total),
            }

    def _unpublish_locked(self, pid: int) -> None:
        h = self._page_hash.pop(pid, None)
        if h is not None and self._index.get(h) == pid:
            del self._index[h]

    def _note_usage_locked(self) -> None:
        in_use = len(self._ref)
        self._high_water = max(self._high_water, in_use)
        if not _obs.enabled():
            return
        claims = sum(self._ref.values())
        _obs.set_gauge("serving.kv.pages_in_use", float(in_use))
        _obs.set_gauge("serving.kv.pages_high_water", float(self._high_water))
        _obs.set_gauge("serving.kv.pages_shared_ratio",
                       (claims - in_use) / claims if claims else 0.0)

    def table_row(self, page_ids: Sequence[int]) -> np.ndarray:
        """A slot's page-table row: allocated ids then scratch padding."""
        row = np.zeros(self.config.pages_per_slot, np.int32)
        row[:len(page_ids)] = np.asarray(page_ids, np.int32)
        return row
