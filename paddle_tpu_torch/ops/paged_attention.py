"""Paged decode attention: the hand-written Hopper kernel
(``csrc/paged_attention.cu``, the port of ``_decode_kernel`` in
``paddle_tpu/ops/paged_attention.py``), its plain PyTorch version
:func:`paged_attention_dense`, and the in-place token write.

One decode step, one layer: batch row ``b`` attends positions ``[0, t[b])``
of its slot, read page by page through its page-table row, plus the
current token's K/V at position ``t[b]``, which joins the softmax
unquantized. Then :func:`scatter_token_inplace` writes that token into the
page that holds position ``t[b]``.

Pool ``(num_pages, L, 2, H_kv, page_size, D)`` in float32, bfloat16 or
int8; the int8 leg carries fp32 scales ``(num_pages, L, 2, H_kv)`` (one per
page, layer, K/V and head; see ``serving/kv_cache.py::quantize_pages``).
Page 0 is the scratch page that padded rows and unused table entries point
at.

Unlike the JAX package, whose pool is functional state threaded through
each compiled step, the port updates the pool and scales **in place**:
:func:`scatter_token_inplace` writes into the tensors it is given and
returns them, so the serving engine never holds two copies of the pool.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from .. import _native

__all__ = ["PagedDecodeCache", "paged_attention", "paged_attention_dense",
           "scatter_token_inplace", "paged_decode_attention", "launches"]

launches = _native.LaunchCounter("paged_decode_attention")

_NEG_INF = -1e30  # the mask fill of the JAX reference
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)
_MAX_REP = 8
_MAX_PAGE = 256
_MAX_STAGED_BYTES = 192 * 1024   # shared memory for 2 x (K, V) pages


@dataclass
class PagedDecodeCache:
    """The page pool as a decode step's cache argument.

    * ``pool``   -- ``(num_pages, L, 2, H_kv, page_size, D)``
    * ``scales`` -- ``(num_pages, L, 2, H_kv)`` fp32 (int8 leg only)
    * ``tables`` -- ``(B, pages_per_slot)`` int32 page-table rows
    * ``t``      -- ``(B,)`` int32 per-row write position
    * ``layer``  -- the layer being decoded, set by :meth:`at_layer`

    The tensors are shared, not copied: the token write updates ``pool``
    and ``scales`` in place."""

    pool: torch.Tensor
    tables: torch.Tensor
    t: torch.Tensor
    page_size: int
    scales: Optional[torch.Tensor] = None
    layer: Optional[int] = None

    def at_layer(self, layer: int) -> "PagedDecodeCache":
        return replace(self, layer=layer)


# paged_decode(q, k_new, v_new, pool, scales, tables, t, out, B, H, Hkv, D,
#              L, ps, S, layer, q_dtype, pool_dtype, sm_scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _kernel():
    fn = _native.load("paged_attention").paged_decode
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def paged_attention_dense(q, k_new, v_new, pool, scales, tables, t, layer,
                          page_size: int) -> torch.Tensor:
    """Plain version for one layer: gather the rows' pages of this layer,
    insert the current token at ``t``, mask positions ``> t``, softmax in
    fp32. The kernel is held against it."""
    p_, l_, _, h_kv, ps, d = pool.shape
    b, s = tables.shape
    m = s * ps
    rep = q.shape[1] // h_kv
    idx = tables.long() * l_ + int(layer)
    taken = pool.reshape(p_ * l_, 2, h_kv, ps, d)[idx].float()
    if scales is not None:
        sc = scales.reshape(p_ * l_, 2, h_kv)[idx]
        taken = taken * sc[..., None, None]
    # (B, S, 2, H_kv, ps, D) -> k/v (B, H_kv, M, D)
    k = taken[:, :, 0].permute(0, 2, 1, 3, 4).reshape(b, h_kv, m, d)
    v = taken[:, :, 1].permute(0, 2, 1, 3, 4).reshape(b, h_kv, m, d)
    t64 = t.long()
    pos = torch.arange(m, device=q.device)
    at_t = (pos[None, :] == t64[:, None])[:, None, :, None]
    k = torch.where(at_t, k_new.float()[:, :, None, :], k)
    v = torch.where(at_t, v_new.float()[:, :, None, :], v)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhd,bhld->bhl", q.float(), k) / math.sqrt(d)
    span = pos[None, :] <= t64[:, None]
    logits = torch.where(span[:, None, :], logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhl,bhld->bhd", p, v).to(q.dtype)


def paged_attention(q, k_new, v_new, pool, scales, tables, t, layer: int, *,
                    page_size: int) -> torch.Tensor:
    """Decode attention for one layer: the kernel for CUDA tensors, the
    plain version for CPU tensors. q ``(B, H, D)``, k/v_new
    ``(B, H_kv, D)`` in q's dtype, tables ``(B, S)`` and t ``(B,)`` int32;
    returns ``(B, H, D)`` in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_dense(q, k_new, v_new, pool, scales, tables,
                                     t, layer, page_size)
    b, h, d = q.shape
    p_, l_, two, h_kv, ps, pd = pool.shape
    if two != 2 or ps != page_size or pd != d or h % h_kv != 0 \
            or k_new.shape != (b, h_kv, d) or v_new.shape != (b, h_kv, d) \
            or tables.dim() != 2 or tables.shape[0] != b or t.shape != (b,):
        raise ValueError(
            f"paged_attention: incompatible shapes q {tuple(q.shape)}, "
            f"k/v_new {tuple(k_new.shape)}/{tuple(v_new.shape)}, pool "
            f"{tuple(pool.shape)} (page_size {page_size}), tables "
            f"{tuple(tables.shape)}, t {tuple(t.shape)}")
    tensors = [q, k_new, v_new, pool, tables, t] + (
        [scales] if scales is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("paged_attention: every tensor must be on "
                         f"{q.device}")
    qc, pc = _Q_CODES.get(q.dtype), _POOL_CODES.get(pool.dtype)
    if qc is None or k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError(f"paged kernel takes float32/bfloat16 q, k_new, "
                        f"v_new of one dtype, got {q.dtype}/{k_new.dtype}/"
                        f"{v_new.dtype}")
    if pc is None or (pc == 2) != (scales is not None):
        raise TypeError(f"paged kernel pool must be float32, bfloat16 or "
                        f"int8 with scales; got {pool.dtype} with "
                        f"scales={'yes' if scales is not None else 'no'}")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (p_, l_, 2, h_kv)):
        raise TypeError(f"scales must be float32 {(p_, l_, 2, h_kv)}, got "
                        f"{scales.dtype} {tuple(scales.shape)}")
    if tables.dtype != torch.int32 or t.dtype != torch.int32:
        raise TypeError("tables and t must be int32")
    if d not in _HEAD_DIMS or h // h_kv > _MAX_REP or ps > _MAX_PAGE \
            or 4 * ps * d * pool.element_size() > _MAX_STAGED_BYTES \
            or not 0 <= int(layer) < l_:
        raise ValueError(
            f"paged kernel needs head_dim in {_HEAD_DIMS}, at most "
            f"{_MAX_REP} q heads per kv head, page_size <= {_MAX_PAGE}, "
            f"two staged K/V pages within {_MAX_STAGED_BYTES} bytes and "
            f"0 <= layer < {l_}; got D={d}, rep={h // h_kv}, ps={ps}, "
            f"pool {pool.dtype}, layer={layer}")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    pool, tables, t = pool.contiguous(), tables.contiguous(), t.contiguous()
    if pool.data_ptr() % 16:
        raise ValueError("paged kernel copies 16-byte chunks: the pool must "
                         "start on a 16-byte boundary")
    scales_ptr = scales.contiguous().data_ptr() if scales is not None \
        else None
    out = torch.empty_like(q)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                        pool.data_ptr(), scales_ptr, tables.data_ptr(),
                        t.data_ptr(), out.data_ptr(), b, h, h_kv, d, l_, ps,
                        tables.shape[1], int(layer), qc, pc,
                        1.0 / math.sqrt(d), stream)
    _native.check(err, "paged_attention kernel launch")
    launches.count += 1
    return out


def scatter_token_inplace(pool, scales, tables, t, layer: int, k_new, v_new,
                          page_size: int) -> Tuple[torch.Tensor,
                                                   Optional[torch.Tensor]]:
    """Write position ``t``'s K/V for one layer into the page that holds it,
    in place; returns ``(pool, scales)``.

    Float pools take a single-position write. The int8 leg re-quantizes
    the containing page: dequantize under its old scale, insert the token,
    zero positions ``> t``, quantize again -- the requantization contract
    of ``serving/kv_cache.py``."""
    ps = page_size
    t64 = t.long()
    pids = tables.long().gather(1, (t64 // ps)[:, None])[:, 0]
    off = t64 % ps
    kv_new = torch.stack([k_new, v_new], dim=1)          # (B, 2, H_kv, D)
    if scales is None:
        pool[pids, layer, :, :, off, :] = kv_new.to(pool.dtype)
        return pool, None
    from ..serving.kv_cache import quantize_pages
    p_, l_ = pool.shape[0], pool.shape[1]
    flat = pids * l_ + layer
    page = pool.reshape((p_ * l_,) + tuple(pool.shape[2:]))[flat].float()
    old_sc = scales.reshape((p_ * l_,) + tuple(scales.shape[2:]))[flat]
    page = page * old_sc[..., None, None]                # (B, 2, H, ps, D)
    lane = torch.arange(ps, device=pool.device)
    at_off = (lane[None, :] == off[:, None])[:, None, None, :, None]
    page = torch.where(at_off, kv_new.float()[..., None, :], page)
    valid = (t64 // ps * ps)[:, None] + lane[None, :] <= t64[:, None]
    page = torch.where(valid[:, None, None, :, None], page, 0.0)
    q8, sc = quantize_pages(page)
    pool[pids, layer] = q8
    scales[pids, layer] = sc
    return pool, scales


def paged_decode_attention(q, k_new, v_new, cache: PagedDecodeCache
                           ) -> Tuple[torch.Tensor, PagedDecodeCache]:
    """One layer's cached decode attention over the paged pool, then the
    token write. ``q`` ``(B, H, D)``, ``k_new``/``v_new`` ``(B, H_kv, D)``;
    ``cache`` must carry a ``layer``. Returns ``(out (B, H, D), cache)``;
    the pool in ``cache`` now holds position ``t``."""
    if cache.layer is None:
        raise ValueError("paged_decode_attention: cache.layer is unset -- "
                         "derive a per-layer view with cache.at_layer(i)")
    out = paged_attention(q, k_new, v_new, cache.pool, cache.scales,
                          cache.tables, cache.t, cache.layer,
                          page_size=cache.page_size)
    scatter_token_inplace(cache.pool, cache.scales, cache.tables, cache.t,
                          cache.layer, k_new, v_new, cache.page_size)
    return out, cache
