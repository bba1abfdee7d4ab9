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
each decoded token with ``ops.paged_attention.scatter_token_inplace``, both
**in place** (the JAX package threads the pool through its programs as
functional state instead). int8 requantization contract: writing position
``t`` re-quantizes its whole page with positions ``> t`` zeroed.

Host-side accounting (:class:`PagedKVCache`) is a refcounted free list over
page ids with page 0 reserved. Prefix sharing is not ported yet: every page
is private to one slot.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.paged_attention import PagedDecodeCache  # noqa: F401  (re-export)

__all__ = ["KVCacheConfig", "PagedKVCache", "PagedDecodeCache",
           "scatter_prefill_pages", "quantize_pages"]

_Q8_MAX = 127.0
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def scatter_prefill_pages(dense: torch.Tensor, pool: torch.Tensor,
                          scales: Optional[torch.Tensor],
                          page_ids: torch.Tensor, true_len: int,
                          page_size: int) -> None:
    """Store a prefilled single-slot cache into the pool, in place.

    ``dense`` is ``(L, 2, 1, H, n * page_size, D)`` with positions
    ``[0, true_len)`` filled; positions past ``true_len`` are zeroed before
    they reach the pool. ``page_ids`` is ``(n,)``: the slot's first ``n``
    pages."""
    ps = page_size
    l, two, _, h, lp, d = dense.shape
    n = lp // ps
    if n * ps != lp or page_ids.shape != (n,):
        raise ValueError(f"dense length {lp} must be {page_ids.shape[0]} "
                         f"pages of {ps}")
    x = dense[:, :, 0].reshape(l, two, h, n, ps, d).permute(3, 0, 1, 2, 4, 5)
    pos = torch.arange(lp, device=dense.device).reshape(n, ps)
    valid = pos < int(true_len)
    x = torch.where(valid[:, None, None, None, :, None], x, 0)
    ids = page_ids.long()
    if scales is not None:
        q8, sc = quantize_pages(x)
        pool[ids] = q8
        scales[ids] = sc
    else:
        pool[ids] = x.to(pool.dtype)


class PagedKVCache:
    """The preallocated page pool on ``device`` plus refcounted page
    accounting. Thread-safe: the free list and refcounts are guarded by one
    lock. ``free()`` raises on a double free or a free of the scratch
    page."""

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
        self._free: List[int] = list(range(config.num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def outstanding_pages(self) -> int:
        """Pages currently claimed by slots (0 after a clean drain)."""
        with self._lock:
            return len(self._ref)

    def refcounts(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._ref)

    def pages_for(self, positions: int) -> int:
        """Pages needed to cover logical positions ``[0, positions)``."""
        ps = self.config.page_size
        return min(self.config.pages_per_slot, -(-positions // ps))

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` pages, or None if the pool cannot cover them."""
        with self._lock:
            if n > len(self._free):
                return None
            ids = [self._free.pop() for _ in range(n)]
            for pid in ids:
                self._ref[pid] = 1
        return ids

    def free(self, ids: Sequence[int]) -> None:
        """Release one claim on each page."""
        with self._lock:
            for pid in ids:
                rc = self._ref.get(pid, 0)
                if pid == 0 or rc <= 0:
                    raise ValueError(
                        f"double free / scratch free: page {pid} (rc={rc})")
                del self._ref[pid]
                self._free.append(pid)

    def table_row(self, page_ids: Sequence[int]) -> np.ndarray:
        """A slot's page-table row: allocated ids then scratch padding."""
        row = np.zeros(self.config.pages_per_slot, np.int32)
        row[:len(page_ids)] = np.asarray(page_ids, np.int32)
        return row
