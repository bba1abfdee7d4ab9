"""Detection ops, the port of ``paddle_tpu/ops/vision.py``: IoU and GIoU,
the box codecs and static-shape greedy NMS, on the hand-written Hopper
kernel K11 (``csrc/nms.cu``) for the suppression sweep.

The contract is the JAX package's: :func:`nms` returns the kept indices in
descending-score order, compacted to the front and padded with -1 to
``top_k`` (or the box count); :func:`multiclass_nms` returns
``keep_top_k`` rows of ``[label, score, x1, y1, x2, y2]`` an image (label
-1 past the detections, those rows carrying the boxes of the first
zero-score candidates in class-major order, as there) and the count of
detections an image. Every sort is stable, as ``jnp.argsort`` is, so ties
keep index order.

:func:`nms_suppress` is K11's wrapper: ``(P, k, 4)`` fp32 boxes, each of
the P problems in score order, to ``keep`` ``(P, k)``. It runs
:func:`nms_suppress_reference` (the ``k x k`` IoU matrix, then the sweep)
for CPU tensors and the kernel for CUDA tensors; any other device raises.
The IoU is :func:`_pairwise_iou`'s in both, in the JAX package's order of
operations, so ``keep`` is bit-equal between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _native
from ._fused_io import cuda_device, plain_path, ptr, stream

__all__ = ["bbox2distance", "bbox_iou", "bind", "box_area", "distance2bbox",
           "launches", "multiclass_nms", "nms", "nms_cost", "nms_suppress",
           "nms_suppress_reference"]

# csrc/nms.cu: a mask word covers 64 candidates; the sweep keeps a
# problem's `removed` words in shared memory, at most 48 KB without an
# opt-in
WORD = 64
MAX_CANDIDATES = WORD * (48 * 1024 // 8)
# operations of one IoU and its test (4 max / min, 2 differences, 2 clips,
# the product, 2 areas' 2 differences, 2 clips and product each, the
# union's add and subtract, + eps, the division and the compare)
IOU_OPS = 23

launches = _native.LaunchCounter("nms")


def bind(lib):
    """The C entry point of a built ``nms`` library, typed."""
    fn = lib.nms_suppress
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernels():
    return bind(_native.load("nms"))


# ---------------------------------------------------------------------------
# plain helpers (also used by models/ppyoloe.py's loss)
# ---------------------------------------------------------------------------
def _box_area(boxes):
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))


def _pairwise_iou(a, b, mode: str = "iou", eps: float = 1e-9):
    """a: [..., M, 4], b: [..., N, 4] (xyxy) -> [..., M, N]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = _box_area(a)[..., :, None] + _box_area(b)[..., None, :] - inter
    iou = inter / (union + eps)
    if mode == "iou":
        return iou
    hull_lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    hull_rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    hull_wh = torch.clamp(hull_rb - hull_lt, min=0)
    hull = hull_wh[..., 0] * hull_wh[..., 1]
    return iou - (hull - union) / (hull + eps)


# ---------------------------------------------------------------------------
# K11: the suppression sweep
# ---------------------------------------------------------------------------
def nms_suppress_reference(boxes: torch.Tensor,
                           iou_threshold: float) -> torch.Tensor:
    """Plain version of K11: for each of the P problems of ``boxes`` (P, k,
    4), sorted by score, the ``k x k`` IoU matrix and the greedy sweep of
    the JAX package's ``_nms_suppress``: box i, if not yet suppressed,
    suppresses every later box j whose IoU with it is over the threshold.
    No score-positivity requirement. Returns ``keep`` (P, k) bool."""
    p, k = int(boxes.shape[0]), int(boxes.shape[1])
    idx = torch.arange(k, device=boxes.device)
    over = (_pairwise_iou(boxes, boxes) > iou_threshold) \
        & (idx[None, :] > idx[:, None])
    supp = torch.zeros(p, k, dtype=torch.bool, device=boxes.device)
    for i in range(k):
        supp |= over[:, i, :] & ~supp[:, i, None]
    return ~supp


def nms_cost(boxes, keep) -> Tuple[float, float]:
    """K11's ``(operations, bytes)``: IOU_OPS for each pair i < j of each
    problem, the boxes read once and ``keep`` written once (the mask
    scratch is the kernel's own traffic, not the function's)."""
    p, k = int(boxes.shape[0]), int(boxes.shape[1])
    return (float(IOU_OPS * p * k * (k - 1) // 2),
            float(_native.tensor_bytes(boxes, keep)))


def nms_suppress(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over P score-sorted problems: ``boxes`` (P, k, 4) fp32 to
    ``keep`` (P, k) bool. The plain version for CPU tensors, K11 (two
    launches: the suppression bitmask, then the sweep) for CUDA tensors."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms_suppress: boxes must be (P, k, 4), got "
                         f"{tuple(boxes.shape)}")
    if plain_path(boxes):
        return nms_suppress_reference(boxes, iou_threshold)
    dev = cuda_device("nms", boxes)
    if boxes.dtype != torch.float32:
        raise ValueError(f"nms kernel: boxes must be float32, got "
                         f"{boxes.dtype}")
    p, k = int(boxes.shape[0]), int(boxes.shape[1])
    if k > MAX_CANDIDATES or p >= 2 ** 31:
        raise ValueError(f"nms kernel: {p} problems of {k} candidates; it "
                         f"takes at most {MAX_CANDIDATES} a problem")
    keep = torch.empty(p, k, dtype=torch.bool, device=dev)
    if p == 0 or k == 0:
        return keep
    boxes = boxes.contiguous()
    words = -(-k // WORD)
    mask = torch.empty(p * k * words, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _kernels()(ptr(boxes), p, k, words, float(iou_threshold),
                         ptr(mask), ptr(keep), stream(dev))
    _native.check(err, "nms kernel launch")
    launches.launched(2, nms_cost, boxes, keep)
    return keep


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------
def bbox_iou(boxes1, boxes2, mode: str = "iou") -> torch.Tensor:
    """Pairwise IoU / GIoU between two box sets (xyxy)."""
    return _pairwise_iou(boxes1, boxes2, mode=mode)


def box_area(boxes) -> torch.Tensor:
    return _box_area(boxes)


def distance2bbox(points, distance, max_shape=None) -> torch.Tensor:
    """Decode (l, t, r, b) distances at anchor points into xyxy boxes,
    clipped to ``max_shape`` (h, w) where given."""
    out = torch.cat([points - distance[..., :2], points + distance[..., 2:]],
                    dim=-1)
    if max_shape is not None:
        h, w = max_shape
        hi = torch.tensor([w, h, w, h], dtype=out.dtype, device=out.device)
        out = torch.minimum(torch.clamp(out, min=0), hi)
    return out


def bbox2distance(points, bbox, reg_max: Optional[float] = None
                  ) -> torch.Tensor:
    """Encode xyxy boxes as (l, t, r, b) distances from anchor points,
    clipped to ``[0, reg_max - 0.01]`` where given."""
    out = torch.cat([points - bbox[..., :2], bbox[..., 2:] - points], dim=-1)
    if reg_max is not None:
        out = torch.clamp(out, 0, reg_max - 0.01)
    return out


def _argsort_desc(s: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(-s)``: stable, ties in index order."""
    return torch.sort(-s, dim=-1, stable=True).indices


def nms(boxes, iou_threshold: float = 0.3, scores=None, category_idxs=None,
        categories=None, top_k: Optional[int] = None) -> torch.Tensor:
    """``paddle.vision.ops.nms``, static-shape: the kept indices in
    descending-score order (the given order with ``scores=None``),
    compacted to the front and padded with -1 to ``top_k`` (else the box
    count). With ``category_idxs``, boxes of different categories never
    suppress each other: each category is moved into a disjoint window of
    span ``2 (max |b| + 1)``, one pass, as in the JAX package."""
    n = int(boxes.shape[0])
    k = min(int(top_k), n) if top_k is not None else n
    b = boxes
    if category_idxs is not None:
        span = 2.0 * (b.abs().max() + 1.0)
        b = b + category_idxs.to(b.dtype)[:, None] * span
    order = _argsort_desc(scores) if scores is not None \
        else torch.arange(n, device=b.device)
    keep = nms_suppress(b[order][None], iou_threshold)[0]
    kept = torch.where(keep, order, -1)
    pos = torch.where(keep, torch.arange(n, device=b.device), n)
    return kept[torch.sort(pos, stable=True).indices][:k]


def multiclass_nms(bboxes, scores, score_threshold: float = 0.05,
                   nms_top_k: int = 1000, keep_top_k: int = 100,
                   nms_threshold: float = 0.5, background_label: int = -1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class NMS with static output (``multiclass_nms3``): ``bboxes``
    (B, N, 4) xyxy, ``scores`` (B, C, N). Each class's ``nms_top_k`` best
    candidates (zeroed at or under ``score_threshold`` after the sweep, so
    they still suppress) go through one K11 call for all B C problems.
    Returns ``(out (B, keep_top_k, 6) fp32, nums (B,) int32)``."""
    bsz, n = int(bboxes.shape[0]), int(bboxes.shape[1])
    c = int(scores.shape[1])
    k = min(nms_top_k, n)
    if 0 <= background_label < c:
        scores = scores.clone()
        scores[:, background_label] = 0.0
    order = _argsort_desc(scores)[..., :k]                     # [B,C,k]
    s_k = torch.gather(scores, 2, order)
    bs = torch.gather(bboxes[:, None].expand(bsz, c, n, 4), 2,
                      order[..., None].expand(bsz, c, k, 4))   # [B,C,k,4]
    ss = torch.where(s_k > score_threshold, s_k, 0.0)
    keep = nms_suppress(bs.reshape(bsz * c, k, 4),
                        nms_threshold).view(bsz, c, k)
    flat_s = torch.where(keep, ss, 0.0).reshape(bsz, c * k)
    flat_b = bs.reshape(bsz, c * k, 4)
    flat_l = torch.arange(c, device=scores.device).repeat_interleave(
        k).expand(bsz, c * k)
    if c * k < keep_top_k:      # keep the static contract
        pad = keep_top_k - c * k
        flat_s = torch.nn.functional.pad(flat_s, (0, pad))
        flat_b = torch.nn.functional.pad(flat_b, (0, 0, 0, pad))
        flat_l = torch.nn.functional.pad(flat_l, (0, pad))
    top = _argsort_desc(flat_s)[:, :keep_top_k]
    sel_s = torch.gather(flat_s, 1, top)
    sel_b = torch.gather(flat_b, 1, top[..., None].expand(-1, -1, 4))
    sel_l = torch.where(sel_s > 0, torch.gather(flat_l, 1, top),
                        -1).to(torch.float32)
    out = torch.cat([sel_l[..., None], sel_s[..., None], sel_b], dim=-1)
    return out, (sel_s > 0).sum(-1).to(torch.int32)
