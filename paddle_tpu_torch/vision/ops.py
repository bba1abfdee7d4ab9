"""``paddle.vision.ops``, the port of ``paddle_tpu/vision/ops.py``: the
detection ops of A7 in plain PyTorch on tensors (no op here is on a
model's path of the port, so none has a kernel of its own), and the
re-exports of ``ops/vision.py`` (``nms``, ``multiclass_nms``, ``bbox_iou``,
``box_area``), whose suppression runs on K11 on a card.

The semantics are the JAX package's, static-shape where it is: ROI ops
sample a fixed grid per box (bilinear taps outside the map count 0),
deformable convolution samples at the offset-shifted taps and contracts
with the weight, candidate sets are padded to fixed sizes with validity
in scores and labels (``matrix_nms``, ``generate_proposals``), sorts are
stable. ``distribute_fpn_proposals`` and ``bipartite_match`` run on the
host, as there. Layouts are NCHW as there; gradients flow where the JAX
package differentiates (``roi_align``, ``roi_pool``, ``psroi_pool``,
``box_coder``, ``deform_conv2d``, ``yolo_loss``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..nn.initializer import XavierUniform
from ..nn.layer import Layer
from ..ops.vision import (_argsort_desc, bbox_iou, box_area, multiclass_nms,
                          nms, nms_suppress)

__all__ = ["roi_align", "roi_pool", "nms", "box_area", "bbox_iou",
           "box_coder", "DeformConv2D", "deform_conv2d", "RoIAlign",
           "RoIPool", "PSRoIPool", "psroi_pool", "multiclass_nms",
           "prior_box", "yolo_box", "yolo_loss", "matrix_nms",
           "generate_proposals", "distribute_fpn_proposals", "box_clip",
           "bipartite_match"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _bilinear_sample(feat, ys, xs):
    """feat (R, C, H, W); ys / xs (R, *grid) -> (R, C, *grid). Taps outside
    the map contribute zero (torchvision's and paddle's boundary rule)."""
    r, c, h, w = feat.shape
    flat = feat.reshape(r, c, h * w)
    grid = ys.shape[1:]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    out = 0.0
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy = torch.clamp(y0 + dy, 0, h - 1).long()
            xx = torch.clamp(x0 + dx, 0, w - 1).long()
            valid = ((y0 + dy >= 0) & (y0 + dy <= h - 1)
                     & (x0 + dx >= 0) & (x0 + dx <= w - 1))
            idx = (yy * w + xx).reshape(r, 1, -1).expand(r, c, -1)
            tap = flat.gather(2, idx).reshape(r, c, *grid)
            out = out + tap * (wy * wx * valid)[:, None]
    return out


def _image_ids(boxes_num, r: int, device):
    """The image of each of the r rois, from the rois an image."""
    ends = torch.cumsum(torch.as_tensor(boxes_num, device=device), 0)
    return (torch.arange(r, device=device)[:, None]
            >= ends[None, :]).sum(1)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = -1, aligned: bool = True, name=None):
    """ROI Align (reference: phi::RoiAlignKernel). ``x`` (N, C, H, W);
    ``boxes`` (R, 4) x1y1x2y2 in input coordinates; ``boxes_num`` (N,)
    rois an image. Each bin averages ``sampling_ratio`` (2 where not
    positive) squared bilinear samples."""
    ph, pw = _pair(output_size)
    r, c = int(boxes.shape[0]), int(x.shape[1])
    img_id = _image_ids(boxes_num, r, x.device)
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - offset
    y1 = boxes[:, 1] * spatial_scale - offset
    x2 = boxes[:, 2] * spatial_scale - offset
    y2 = boxes[:, 3] * spatial_scale - offset
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = torch.clamp(rw, min=1.0), torch.clamp(rh, min=1.0)
    bin_h, bin_w = rh / ph, rw / pw
    s = sampling_ratio if sampling_ratio > 0 else 2
    f32 = torch.float32
    gy = (torch.arange(ph * s, dtype=f32, device=x.device) + 0.5) / s
    gx = (torch.arange(pw * s, dtype=f32, device=x.device) + 0.5) / s
    fy = y1[:, None] + gy[None] * bin_h[:, None]                # (R, ph s)
    fx = x1[:, None] + gx[None] * bin_w[:, None]
    ys = fy[:, :, None].expand(r, ph * s, pw * s)
    xs = fx[:, None, :].expand(r, ph * s, pw * s)
    sampled = _bilinear_sample(x[img_id], ys, xs)
    return sampled.reshape(r, c, ph, s, pw, s).mean((3, 5))


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
             name=None):
    """ROI max-pool (reference: phi::RoiPoolKernel): each bin the maximum
    over the map's cells it covers (-inf where it covers none)."""
    ph, pw = _pair(output_size)
    n, c, h, w = (int(d) for d in x.shape)
    r = int(boxes.shape[0])
    img_id = _image_ids(boxes_num, r, x.device)
    x1 = torch.round(boxes[:, 0] * spatial_scale)
    y1 = torch.round(boxes[:, 1] * spatial_scale)
    x2 = torch.round(boxes[:, 2] * spatial_scale)
    y2 = torch.round(boxes[:, 3] * spatial_scale)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    f32 = torch.float32
    ys_all = torch.arange(h, dtype=f32, device=x.device)
    xs_all = torch.arange(w, dtype=f32, device=x.device)
    outs = []
    for i in range(r):
        bin_h, bin_w = rh[i] / ph, rw[i] / pw
        ys0 = y1[i] + torch.arange(ph, device=x.device) * bin_h
        xs0 = x1[i] + torch.arange(pw, device=x.device) * bin_w
        ymask = ((ys_all[None, :] >= torch.floor(ys0)[:, None])
                 & (ys_all[None, :] < torch.ceil(ys0 + bin_h)[:, None]))
        xmask = ((xs_all[None, :] >= torch.floor(xs0)[:, None])
                 & (xs_all[None, :] < torch.ceil(xs0 + bin_w)[:, None]))
        m = ymask[:, None, :, None] & xmask[None, :, None, :]
        big = torch.where(m[None], x[img_id[i]][:, None, None],
                          -torch.inf)
        outs.append(big.amax((-1, -2)))
    if not outs:
        return x.new_zeros(0, c, ph, pw)
    return torch.stack(outs)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
               name=None):
    """Position-sensitive ROI pooling (reference: phi::PsroiPoolKernel):
    channel group (i, j) feeds output bin (i, j), average-pooled."""
    ph, pw = _pair(output_size)
    c = int(x.shape[1])
    if c % (ph * pw) != 0:
        raise ValueError(f"channels {c} must be divisible by "
                         f"output_size^2 {ph * pw}")
    out_c = c // (ph * pw)
    a = roi_align(x, boxes, boxes_num, (ph, pw), spatial_scale,
                  sampling_ratio=2, aligned=False)
    r = a.shape[0]
    # paddle's channel layout: input channel (c ph + i) pw + j feeds
    # output channel c at bin (i, j)
    blocks = a.reshape(r, out_c, ph, pw, ph, pw)
    ii = torch.arange(ph, device=x.device)[:, None]
    jj = torch.arange(pw, device=x.device)[None, :]
    return blocks[:, :, ii, jj, ii, jj]


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size",
              box_normalized: bool = True, axis: int = 0, name=None):
    """Encode or decode boxes against priors (reference:
    phi::BoxCoderKernel)."""
    p, t = prior_box, target_box
    var = torch.ones_like(p) if prior_box_var is None else prior_box_var
    norm = 0.0 if box_normalized else 1.0
    pw = p[..., 2] - p[..., 0] + norm
    ph_ = p[..., 3] - p[..., 1] + norm
    pcx = p[..., 0] + pw * 0.5
    pcy = p[..., 1] + ph_ * 0.5
    if code_type == "encode_center_size":
        tw = t[..., 2] - t[..., 0] + norm
        th = t[..., 3] - t[..., 1] + norm
        tcx = t[..., 0] + tw * 0.5
        tcy = t[..., 1] + th * 0.5
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph_,
                           torch.log(tw / pw), torch.log(th / ph_)], dim=-1)
        return out / var
    d = t * var
    cx = d[..., 0] * pw + pcx
    cy = d[..., 1] * ph_ + pcy
    w = torch.exp(d[..., 2]) * pw
    h = torch.exp(d[..., 3]) * ph_
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5 - norm,
                        cy + h * 0.5 - norm], dim=-1)


def _deform_checks(x, offset, weight, groups, deformable_groups, mask,
                   stride, padding, dilation):
    """DeformableConvInferMeta's checks (paddle/phi/infermeta/
    multiary.cc): the op, the argument and got-vs-expected shapes."""
    def bad(arg, expected, got):
        raise ValueError(f"deform_conv2d: {arg} expected {expected}, got "
                         f"{got}")
    if x.dim() != 4:
        bad("x", "a 4-D NCHW tensor", f"rank {x.dim()} with shape "
                                      f"{list(x.shape)}")
    if weight.dim() != 4:
        bad("weight", "a 4-D (C_out, C_in/groups, kh, kw) tensor",
            f"rank {weight.dim()} with shape {list(weight.shape)}")
    if offset.dim() != 4:
        bad("offset", "a 4-D (N, 2*deformable_groups*kh*kw, H_out, W_out) "
            "tensor", f"rank {offset.dim()} with shape {list(offset.shape)}")
    kh, kw = int(weight.shape[2]), int(weight.shape[3])
    n, cin = int(x.shape[0]), int(x.shape[1])
    if cin % groups != 0:
        bad("x", f"channel count divisible by groups={groups}",
            f"{cin} channels")
    if cin % deformable_groups != 0:
        bad("x", f"channel count divisible by "
            f"deformable_groups={deformable_groups}", f"{cin} channels")
    if int(weight.shape[0]) % groups != 0:
        bad("weight", f"output channels divisible by groups={groups}",
            f"{int(weight.shape[0])} output channels")
    if int(weight.shape[1]) * groups != cin:
        bad("weight", f"shape[1] == C_in/groups = {cin // groups} "
            f"(C_in={cin}, groups={groups})",
            f"shape[1] == {int(weight.shape[1])}")
    if int(offset.shape[0]) != n:
        bad("offset", f"batch size {n} (matching x)",
            f"batch size {int(offset.shape[0])}")
    off_c = 2 * deformable_groups * kh * kw
    if int(offset.shape[1]) != off_c:
        bad("offset", f"shape[1] == 2 * deformable_groups * kh * kw = "
            f"{off_c} (deformable_groups={deformable_groups}, "
            f"kernel={kh}x{kw})", f"shape[1] == {int(offset.shape[1])}")
    hp = int(x.shape[2]) + 2 * padding[0]
    wp = int(x.shape[3]) + 2 * padding[1]
    out_hw = ((hp - (dilation[0] * (kh - 1) + 1)) // stride[0] + 1,
              (wp - (dilation[1] * (kw - 1) + 1)) // stride[1] + 1)
    if tuple(int(s) for s in offset.shape[2:]) != out_hw:
        bad("offset", f"spatial shape {list(out_hw)} (the conv output "
            f"H_out x W_out)",
            f"spatial shape {[int(s) for s in offset.shape[2:]]}")
    if mask is not None:
        want = (n, deformable_groups * kh * kw) + out_hw
        if mask.dim() != 4 or tuple(int(s) for s in mask.shape) != want:
            bad("mask", f"shape {list(want)} "
                f"(N, deformable_groups*kh*kw, H_out, W_out)",
                f"shape {[int(s) for s in mask.shape]}")
    return out_hw


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 / v2 (reference:
    phi::DeformableConvKernel): bilinear samples at the offset-shifted
    taps (times ``mask`` for v2), then the contraction with the weight per
    output pixel."""
    stride, padding, dilation = (_pair(stride), _pair(padding),
                                 _pair(dilation))
    out_h, out_w = _deform_checks(x, offset, weight, groups,
                                  deformable_groups, mask, stride, padding,
                                  dilation)
    n, cin = int(x.shape[0]), int(x.shape[1])
    kh, kw = int(weight.shape[2]), int(weight.shape[3])
    dg = deformable_groups
    dev = x.device
    inp = TF.pad(x, (padding[1], padding[1], padding[0], padding[0]))
    oy = torch.arange(out_h, device=dev) * stride[0]
    ox = torch.arange(out_w, device=dev) * stride[1]
    ky = torch.arange(kh, device=dev) * dilation[0]
    kx = torch.arange(kw, device=dev) * dilation[1]
    base_y = oy[:, None, None, None] + ky[None, None, :, None]
    base_x = ox[None, :, None, None] + kx[None, None, None, :]
    # (N, dg, kh kw, 2, oh, ow) -> dy, dx as (N, dg, oh, ow, kh, kw)
    off = offset.reshape(n, dg, kh * kw, 2, out_h, out_w)
    dy = off[:, :, :, 0].permute(0, 1, 3, 4, 2).reshape(
        n, dg, out_h, out_w, kh, kw)
    dx = off[:, :, :, 1].permute(0, 1, 3, 4, 2).reshape(
        n, dg, out_h, out_w, kh, kw)
    cg = cin // dg
    feats = inp.reshape(n * dg, cg, *inp.shape[2:])
    cols = _bilinear_sample(feats, (base_y + dy).reshape(n * dg, out_h,
                                                         out_w, kh, kw),
                            (base_x + dx).reshape(n * dg, out_h, out_w, kh,
                                                  kw))
    cols = cols.reshape(n, dg, cg, out_h, out_w, kh, kw)
    if mask is not None:
        mm = mask.reshape(n, dg, kh * kw, out_h, out_w).permute(
            0, 1, 3, 4, 2).reshape(n, dg, out_h, out_w, kh, kw)
        cols = cols * mm[:, :, None]
    cols = cols.reshape(n, cin, out_h, out_w, kh, kw)
    cout = int(weight.shape[0])
    cpi, cpo = cin // groups, cout // groups
    out = torch.cat([
        torch.einsum("nchwyx,ocyx->nohw", cols[:, g * cpi:(g + 1) * cpi],
                     weight[g * cpo:(g + 1) * cpo]) for g in range(groups)],
        dim=1)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class DeformConv2D(Layer):
    """``paddle.vision.ops.DeformConv2D`` (v2 when a mask is passed): the
    weight ``(out, in / groups, kh, kw)`` Xavier-uniform, the bias zero."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        k = _pair(kernel_size)
        self._cfg = dict(stride=stride, padding=padding, dilation=dilation,
                         deformable_groups=deformable_groups, groups=groups)
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, *k), attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter((out_channels,), attr=bias_attr,
                                          is_bias=True)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, mask=mask,
                             **self._cfg)


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._size = output_size
        self._scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self._size, self._scale)


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._size = output_size
        self._scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._size, self._scale)


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._size = output_size
        self._scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._size, self._scale)


# ---------------------------------------------------------------------------
# SSD / YOLO / RPN detection ops: candidate sets padded to fixed sizes,
# validity in scores and labels
# ---------------------------------------------------------------------------
def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior (anchor) boxes of one feature map: ``(boxes, vars)`` of
    shape (H, W, num_priors, 4), on ``input``'s device."""
    h, w = int(input.shape[2]), int(input.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    step_h = steps[1] or img_h / h
    step_w = steps[0] or img_w / w
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    whs = []    # (box_w, box_h) a prior, a min_size at a time
    for i, ms in enumerate(min_sizes):
        ms = float(ms)
        if min_max_aspect_ratios_order:
            # Caffe-SSD's order: min (ar 1), sqrt(min max), the other ars
            whs.append((ms, ms))
            if max_sizes:
                mm = (ms * float(max_sizes[i])) ** 0.5
                whs.append((mm, mm))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * (ar ** 0.5), ms / (ar ** 0.5)))
        else:   # every aspect ratio, then sqrt(min max)
            for ar in ars:
                whs.append((ms * (ar ** 0.5), ms / (ar ** 0.5)))
            if max_sizes:
                mm = (ms * float(max_sizes[i])) ** 0.5
                whs.append((mm, mm))
    whs_np = np.asarray(whs, np.float32)
    cy = (np.arange(h, dtype=np.float32) + offset) * step_h
    cx = (np.arange(w, dtype=np.float32) + offset) * step_w
    cxg, cyg = np.meshgrid(cx, cy)
    centers = np.stack([cxg, cyg], axis=-1)[:, :, None, :]
    half = whs_np[None, None, :, :] / 2.0
    scale = np.asarray([img_w, img_h], np.float32)
    boxes = np.concatenate([(centers - half) / scale,
                            (centers + half) / scale],
                           axis=-1).astype(np.float32)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    vars_ = np.broadcast_to(np.asarray(variance, np.float32), boxes.shape)
    dev = input.device
    return (torch.as_tensor(boxes, device=dev),
            torch.as_tensor(np.ascontiguousarray(vars_), device=dev))


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLOv3 head (B, A (5 + C), H, W): ``(boxes (B, A H W, 4)
    xyxy in image pixels, scores (B, A H W, C))``, predictions under
    ``conf_thresh`` with zero scores."""
    na = len(anchors) // 2
    anc = torch.as_tensor(np.asarray(anchors, np.float32).reshape(na, 2),
                          device=x.device)
    b, ch, h, w = (int(s) for s in x.shape)
    attrs = 5 + class_num
    with torch.no_grad():
        if iou_aware:
            # [na IoU channels][na (5 + C) yolo channels]
            ioup = torch.sigmoid(x[:, :na])[:, :, None]
            f = x[:, na:].reshape(b, na, attrs, h, w)
        else:
            f = x.reshape(b, na, attrs, h, w)
        gx = torch.arange(w, dtype=torch.float32, device=x.device)[
            None, None, None, :]
        gy = torch.arange(h, dtype=torch.float32, device=x.device)[
            None, None, :, None]
        sx = torch.sigmoid(f[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
        sy = torch.sigmoid(f[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
        bx, by = (gx + sx) / w, (gy + sy) / h
        input_w, input_h = w * downsample_ratio, h * downsample_ratio
        bw = torch.exp(f[:, :, 2]) * anc[None, :, 0, None, None] / input_w
        bh = torch.exp(f[:, :, 3]) * anc[None, :, 1, None, None] / input_h
        obj = torch.sigmoid(f[:, :, 4])
        if iou_aware:
            obj = obj ** (1 - iou_aware_factor) \
                * ioup[:, :, 0] ** iou_aware_factor
        score = obj[:, :, None] * torch.sigmoid(f[:, :, 5:])
        score = torch.where(score > conf_thresh, score, 0.0)
        imh = img_size[:, 0].float()[:, None, None, None]
        imw = img_size[:, 1].float()[:, None, None, None]
        x1, y1 = (bx - bw / 2) * imw, (by - bh / 2) * imh
        x2, y2 = (bx + bw / 2) * imw, (by + bh / 2) * imh
        if clip_bbox:
            x1 = torch.minimum(torch.clamp(x1, min=0.0), imw - 1)
            y1 = torch.minimum(torch.clamp(y1, min=0.0), imh - 1)
            x2 = torch.minimum(torch.clamp(x2, min=0.0), imw - 1)
            y2 = torch.minimum(torch.clamp(y2, min=0.0), imh - 1)
        boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(b, -1, 4)
        scores = torch.movedim(score, 2, -1).reshape(b, -1, class_num)
    return boxes, scores


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss of one detection head: ``x`` (B, A (5 + C), H,
    W), ``gt_box`` (B, G, 4) xywh in [0, 1] image coordinates, ``gt_label``
    (B, G); the loss an image (B,). Anchor assignment (best shape IoU over
    the whole anchor set, masked to this head) and the ignore-high-IoU
    objectness rule follow the reference kernel."""
    all_anc = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask = list(anchor_mask)
    na = len(mask)
    b, ch, h, w = (int(s) for s in x.shape)
    attrs = 5 + class_num
    input_w, input_h = w * downsample_ratio, h * downsample_ratio
    dev = x.device
    anc_this = torch.as_tensor(all_anc[mask], device=dev)
    f = x.reshape(b, na, attrs, h, w)
    tx, ty, tw, th = f[:, :, 0], f[:, :, 1], f[:, :, 2], f[:, :, 3]
    tobj, tcls = f[:, :, 4], f[:, :, 5:]
    gx, gy, gw, gh = (gt_box[..., i] for i in range(4))      # (B, G)
    valid = (gw > 1e-8) & (gh > 1e-8)
    with torch.no_grad():
        gxx = torch.arange(w, dtype=torch.float32, device=dev)[
            None, None, None, :]
        gyy = torch.arange(h, dtype=torch.float32, device=dev)[
            None, None, :, None]
        px = (gxx + torch.sigmoid(tx)) / w
        py = (gyy + torch.sigmoid(ty)) / h
        pw = torch.exp(tw) * anc_this[None, :, 0, None, None] / input_w
        ph = torch.exp(th) * anc_this[None, :, 1, None, None] / input_h

        def iou(px1, py1, pw1, ph1, qx, qy, qw, qh):
            l1, r1 = px1 - pw1 / 2, px1 + pw1 / 2
            t1, b1 = py1 - ph1 / 2, py1 + ph1 / 2
            l2, r2 = qx - qw / 2, qx + qw / 2
            t2, b2 = qy - qh / 2, qy + qh / 2
            iw = torch.clamp(torch.minimum(r1, r2) - torch.maximum(l1, l2),
                             min=0)
            ih = torch.clamp(torch.minimum(b1, b2) - torch.maximum(t1, t2),
                             min=0)
            inter = iw * ih
            return inter / (pw1 * ph1 + qw * qh - inter + 1e-10)

        g5 = (slice(None), None, None, None, slice(None))
        pious = iou(px[..., None], py[..., None], pw[..., None],
                    ph[..., None], gx[g5], gy[g5], gw[g5], gh[g5])
        pious = torch.where(valid[g5], pious, 0.0)
        ignore = pious.amax(-1) > ignore_thresh                 # (B, A, H, W)
        # each gt's anchor: best shape IoU over ALL anchors
        aw = torch.as_tensor(all_anc[:, 0] / input_w, device=dev)
        ah = torch.as_tensor(all_anc[:, 1] / input_h, device=dev)
        inter = (torch.minimum(gw[..., None], aw[None, None])
                 * torch.minimum(gh[..., None], ah[None, None]))
        shape_iou = inter / (gw[..., None] * gh[..., None]
                             + aw[None, None] * ah[None, None] - inter
                             + 1e-10)
        best_anchor = torch.argmax(shape_iou, dim=-1)           # (B, G)
        in_head = (best_anchor[..., None] == torch.as_tensor(
            mask, device=dev)[None, None]).to(torch.int32)
        head_slot = torch.argmax(in_head, dim=-1)
        assigned = (in_head.sum(-1) > 0) & valid
        gi = torch.clamp((gx * w).to(torch.int32), 0, w - 1).long()
        gj = torch.clamp((gy * h).to(torch.int32), 0, h - 1).long()
        flat = (head_slot * h + gj) * w + gi                    # (B, G)
        tgt_x, tgt_y = gx * w - gi, gy * h - gj
        ba = torch.clamp(best_anchor, 0, all_anc.shape[0] - 1)
        tgt_w = torch.log(torch.clamp(gw / torch.clamp(aw[ba], min=1e-10),
                                      min=1e-10))
        tgt_h = torch.log(torch.clamp(gh / torch.clamp(ah[ba], min=1e-10),
                                      min=1e-10))
        score_w = gt_score if gt_score is not None else torch.ones_like(gx)
        wgt = torch.where(assigned, (2.0 - gw * gh) * score_w, 0.0)
        # objectness targets: the gt score at assigned cells
        pos = torch.zeros(b, na * h * w, device=dev).scatter_reduce(
            1, flat, torch.where(assigned, score_w, 0.0), reduce="amax",
            include_self=True).reshape(b, na, h, w)
        obj_w = torch.where(pos > 0, 1.0, torch.where(ignore, 0.0, 1.0))
        sw = min(1.0 / class_num, 1.0 / 40.0) \
            if use_label_smooth and class_num > 1 else 0.0
        onehot = TF.one_hot(gt_label.long(), class_num).float()
        onehot = onehot * (1.0 - sw) + (1.0 - onehot) * sw

    def bce(logit, target):
        return TF.softplus(logit) - logit * target

    def gather_bg(t):               # (B, A, H, W) -> (B, G)
        return torch.gather(t.reshape(b, -1), 1, flat)

    loss_xy = (bce(gather_bg(tx), tgt_x) + bce(gather_bg(ty), tgt_y)) * wgt
    loss_wh = ((gather_bg(tw) - tgt_w).abs()
               + (gather_bg(th) - tgt_h).abs()) * wgt
    loss_obj = bce(tobj, pos) * obj_w
    tf = torch.movedim(tcls, 2, -1).reshape(b, -1, class_num)
    s_cls = torch.gather(tf, 1, flat[..., None].expand(-1, -1, class_num))
    loss_cls = bce(s_cls, onehot).sum(-1) * torch.where(assigned, score_w,
                                                        0.0)
    return (loss_xy.sum(1) + loss_wh.sum(1) + loss_obj.sum((1, 2, 3))
            + loss_cls.sum(1))


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): each candidate's score decays by its IoU with
    the higher-scored candidates of its class, from the pairwise IoU
    matrix, no sequential sweep. bboxes (B, N, 4); scores (B, C, N)."""
    bsz, n = int(bboxes.shape[0]), int(bboxes.shape[1])
    c = int(scores.shape[1])
    dev = scores.device
    outs, idxs, nums = [], [], []
    labels = torch.arange(c, device=dev).repeat_interleave(n)
    box_idx = torch.arange(n, device=dev).repeat(c)
    for i in range(bsz):
        sc = scores[i]
        if 0 <= background_label < c:
            sc = sc.clone()
            sc[background_label] = 0.0
        flat_s = sc.reshape(-1)
        flat_s = torch.where(flat_s > score_threshold, flat_s, 0.0)
        k = min(nms_top_k, flat_s.shape[0])
        order = _argsort_desc(flat_s)[:k]
        s_k, l_k = flat_s[order], labels[order]
        b_k = bboxes[i][box_idx[order]]
        x1, y1, x2, y2 = b_k[:, 0], b_k[:, 1], b_k[:, 2], b_k[:, 3]
        off = 0.0 if normalized else 1.0
        area = torch.clamp(x2 - x1 + off, min=0) \
            * torch.clamp(y2 - y1 + off, min=0)
        iw = torch.clamp(torch.minimum(x2[:, None], x2[None])
                         - torch.maximum(x1[:, None], x1[None]) + off, min=0)
        ih = torch.clamp(torch.minimum(y2[:, None], y2[None])
                         - torch.maximum(y1[:, None], y1[None]) + off, min=0)
        inter = iw * ih
        iou = inter / (area[:, None] + area[None] - inter + 1e-10)
        same = (l_k[:, None] == l_k[None]).to(iou.dtype)
        # [i, j]: j scored higher than i (j before i)
        upper = torch.triu(torch.ones_like(iou), 1).T
        ious = iou * same * upper
        max_iou = ious.amax(1)
        if use_gaussian:
            ratio = torch.exp(-(ious ** 2 - max_iou[None, :] ** 2)
                              / gaussian_sigma)
        else:
            ratio = (1 - ious) / (1 - max_iou[None, :])
        decay = torch.where((ious > 0).any(1),
                            torch.where(ious > 0, ratio, 1.0).amin(1), 1.0)
        new_s = s_k * decay
        new_s = torch.where(new_s > post_threshold, new_s, 0.0)
        kk = min(keep_top_k, new_s.shape[0])
        fin = _argsort_desc(new_s)[:kk]
        out_s = new_s[fin]
        outs.append(torch.cat([
            torch.where(out_s > 0, l_k[fin], -1).float()[:, None],
            out_s[:, None], b_k[fin]], dim=-1))
        idxs.append(torch.where(out_s > 0, box_idx[order][fin], -1))
        nums.append((out_s > 0).sum().to(torch.int32))
    res = [torch.stack(outs)]
    if return_index:
        res.append(torch.stack(idxs))
    if return_rois_num:
        res.append(torch.stack(nums))
    return tuple(res) if len(res) > 1 else res[0]


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=True, name=None):
    """RPN proposals: deltas decoded on the anchors, clipped to the image,
    tiny boxes zero-scored (shapes stay static), NMS (K11 on a card), the
    best ``post_nms_top_n`` kept. scores (B, A, H, W); bbox_deltas (B, 4A,
    H, W); anchors / variances (H, W, A, 4) or (H W A, 4). Returns ``(rois
    (B, post_nms_top_n, 4), roi_probs (B, post_nms_top_n, 1)[, rois_num
    (B,)])``."""
    bsz, a, h, w = (int(s) for s in scores.shape)
    n = a * h * w
    off = 1.0 if pixel_offset else 0.0
    with torch.no_grad():
        anc_f, var_f = anchors.reshape(-1, 4), variances.reshape(-1, 4)
        if anc_f.shape[0] == n:     # (H, W, A, 4): to A-major
            anc = torch.movedim(anc_f.reshape(h, w, a, 4), 2, 0).reshape(-1, 4)
            var = torch.movedim(var_f.reshape(h, w, a, 4), 2, 0).reshape(-1, 4)
        else:
            anc, var = anc_f, var_f
        s_f = scores.reshape(bsz, -1)                          # A-major
        d_f = torch.movedim(bbox_deltas.reshape(bsz, a, 4, h, w), 2,
                            -1).reshape(bsz, -1, 4)
        aw = anc[:, 2] - anc[:, 0] + off
        ah = anc[:, 3] - anc[:, 1] + off
        acx, acy = anc[:, 0] + aw * 0.5, anc[:, 1] + ah * 0.5
        cx = var[:, 0] * d_f[..., 0] * aw + acx
        cy = var[:, 1] * d_f[..., 1] * ah + acy
        bw = torch.exp(torch.clamp(var[:, 2] * d_f[..., 2], max=10.0)) * aw
        bh = torch.exp(torch.clamp(var[:, 3] * d_f[..., 3], max=10.0)) * ah
        wmax = (img_size[:, 1] - off)[:, None]
        hmax = (img_size[:, 0] - off)[:, None]

        def clip(v, hi):
            return torch.minimum(torch.clamp(v, min=0), hi)
        x1, y1 = clip(cx - bw * 0.5, wmax), clip(cy - bh * 0.5, hmax)
        x2 = clip(cx + bw * 0.5 - off, wmax)
        y2 = clip(cy + bh * 0.5 - off, hmax)
        boxes = torch.stack([x1, y1, x2, y2], dim=-1)
        keep_size = ((x2 - x1 + off) >= min_size) \
            & ((y2 - y1 + off) >= min_size)
        s_v = torch.where(keep_size, s_f, 0.0)
        k = min(pre_nms_top_n, n)
        order = _argsort_desc(s_v)[:, :k]
        bs = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        ss = torch.gather(s_v, 1, order)
        keep = nms_suppress(bs.contiguous(), nms_thresh) & (ss > 0)
        ss = torch.where(keep, ss, 0.0)
        kk = min(post_nms_top_n, k)
        fin = _argsort_desc(ss)[:, :kk]
        out_b = torch.gather(bs, 1, fin[..., None].expand(-1, -1, 4))
        out_s = torch.gather(ss, 1, fin)
        if kk < post_nms_top_n:
            pad = post_nms_top_n - kk
            out_b = TF.pad(out_b, (0, 0, 0, pad))
            out_s = TF.pad(out_s, (0, pad))
        nums = (out_s > 0).sum(1).to(torch.int32)
    if return_rois_num:
        return out_b, out_s[..., None], nums
    return out_b, out_s[..., None]


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Route RoIs to FPN levels by scale, on the host (data-dependent
    sizes). Returns ``(multi_rois, restore_index[, rois_num_per_level])``."""
    dev = fpn_rois.device
    rois = fpn_rois.detach().cpu().numpy()
    off = 1.0 if pixel_offset else 0.0
    scale = np.sqrt(np.clip(rois[:, 2] - rois[:, 0] + off, 0, None)
                    * np.clip(rois[:, 3] - rois[:, 1] + off, 0, None))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    multi_rois, nums, order = [], [], []
    for level in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == level)[0]
        multi_rois.append(torch.as_tensor(rois[idx], device=dev))
        nums.append(len(idx))
        order.append(idx)
    order_all = np.concatenate(order) if order else np.zeros((0,), np.int64)
    restore = np.empty_like(order_all)
    restore[order_all] = np.arange(order_all.shape[0])
    restore_t = torch.as_tensor(restore.reshape(-1, 1), device=dev)
    if rois_num is not None:
        return multi_rois, restore_t, [
            torch.as_tensor(np.asarray([nv], np.int32), device=dev)
            for nv in nums]
    return multi_rois, restore_t


def box_clip(input, im_info, name=None):
    """Clip boxes (..., 4) to the image: ``im_info`` (H, W, scale); x to
    [0, W / scale - 1], y to [0, H / scale - 1]."""
    info = im_info.reshape(-1)
    h, w = info[0], info[1]
    scale = info[2] if info.shape[0] > 2 else torch.ones((), dtype=info.dtype,
                                                         device=info.device)
    wmax, hmax = w / scale - 1.0, h / scale - 1.0

    def clip(v, hi):
        return torch.minimum(torch.clamp(v, min=0.0), hi)
    return torch.stack([clip(input[..., 0], wmax), clip(input[..., 1], hmax),
                        clip(input[..., 2], wmax), clip(input[..., 3], hmax)],
                       dim=-1)


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    """Greedy bipartite matching (the SSD target-assign op) on the host:
    ``dist_matrix`` (N, M) similarity, each column matched to at most one
    row, largest first; ``match_type="per_prediction"`` also matches an
    unmatched column to its best row where that reaches
    ``dist_threshold``. Returns ``(match_indices (1, M) int32, -1 where
    unmatched, match_dist (1, M))``."""
    d = np.array(dist_matrix.detach().cpu().numpy()
                 if isinstance(dist_matrix, torch.Tensor) else dist_matrix,
                 np.float32)
    if d.ndim != 2:
        raise ValueError("bipartite_match expects a 2-D distance matrix")
    n, m = d.shape
    idx = np.full((m,), -1, np.int32)
    dist = np.zeros((m,), np.float32)
    # consumed rows and columns as NaN: real -inf entries stay apart from
    # them, and NaN distances are never matched
    work = d.copy()
    work[~np.isfinite(work)] = np.nan
    for _ in range(min(n, m)):
        if not np.any(~np.isnan(work)):
            break
        r, c = np.unravel_index(np.nanargmax(work), work.shape)
        idx[c] = r
        dist[c] = d[r, c]
        work[r, :] = np.nan
        work[:, c] = np.nan
    if match_type == "per_prediction":
        for c in range(m):
            if idx[c] == -1:
                r = int(np.argmax(d[:, c]))
                if d[r, c] >= dist_threshold:
                    idx[c] = r
                    dist[c] = d[r, c]
    return torch.as_tensor(idx[None]), torch.as_tensor(dist[None])
