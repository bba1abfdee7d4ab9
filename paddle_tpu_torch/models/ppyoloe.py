"""PP-YOLOE, the port of ``paddle_tpu/models/ppyoloe.py`` (BASELINE config
#3, PaddleDetection's PP-YOLOE): the CSPResNet backbone, the CustomCSPPAN
neck and the ET-head (ESE attention, anchor-free distribution-focal
regression, task-aligned assignment, the VFL / GIoU / DFL losses and
multiclass NMS), NHWC end to end.

The layers and their names are the JAX package's, so its state dict (the
weights, the biases and every BN's ``_mean`` / ``_variance``) loads key
for key (``convert.load_ppyoloe_state_dict``). On a card the blocks' batch
norms run K10 with the fused swish tails: a ``ConvBNLayer`` is
``swish(bn(conv x))`` in one K10 call, a ``RepVggBlock`` ``swish(bn1(conv3
x) + bn2(conv1 x))`` with ``bn2`` plain and ``bn1`` taking ``bn2``'s
output as its residual; the same function as the JAX package's
``F.swish(bn(.))`` and ``F.swish(bn(.) + bn'(.))``. ``predict`` runs the
suppression of ``multiclass_nms`` on K11 (``ops/vision.py``).

The loss is the JAX package's ``_vfl_giou_dfl_loss`` step by step; the
task-aligned assignment runs under ``torch.no_grad()`` where the JAX
package stops gradients, so gradients reach the class logits through the
BCE term and the distances through the GIoU and DFL terms only, as there.
``PPYOLOE`` takes ``device`` (``cuda`` unless ``"cpu"``) and ``seed`` (the
initial weights' generator on that device) besides the configuration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from .. import nn
from ..nn.layer import build_scope
from ..ops.activation import hardsigmoid, sigmoid
from ..ops.conv_pool import interpolate
from ..ops.manipulation import concat
from ..ops.vision import _pairwise_iou, multiclass_nms

__all__ = ["CSPResNet", "CustomCSPPAN", "PPYOLOE", "PPYOLOEConfig",
           "PPYOLOEHead"]


# ---------------------------------------------------------------------------
# building blocks (NHWC)
# ---------------------------------------------------------------------------
class ConvBNLayer(nn.Layer):
    def __init__(self, ch_in, ch_out, k=3, stride=1, groups=1, padding=None,
                 act="swish"):
        super().__init__()
        self.conv = nn.Conv2D(ch_in, ch_out, k, stride=stride,
                              padding=(k - 1) // 2 if padding is None
                              else padding, groups=groups, bias_attr=False,
                              data_format="NHWC")
        self.bn = nn.BatchNorm2D(ch_out, data_format="NHWC")
        self.act = act

    def forward(self, x):
        """``swish(bn(conv x))`` (``act="swish"``), else ``bn(conv x)``."""
        return self.bn(self.conv(x),
                       act="swish" if self.act == "swish" else None)


class RepVggBlock(nn.Layer):
    """Train-time two-branch (3x3 + 1x1) conv, the RepVGG pattern of the
    reference's CSPResNet basic block: ``swish(bn1(conv3x3 x) + bn2(conv1x1
    x))``, the add and the swish fused into ``conv1``'s BN."""

    def __init__(self, ch_in, ch_out, act="swish"):
        super().__init__()
        self.conv1 = ConvBNLayer(ch_in, ch_out, 3, act="none")
        self.conv2 = ConvBNLayer(ch_in, ch_out, 1, act="none")
        self.act = act

    def forward(self, x):
        if self.act != "swish":
            return self.conv1(x) + self.conv2(x)
        y2 = self.conv2(x)
        c1 = self.conv1
        return c1.bn(c1.conv(x), residual=y2, act="swish")


class BasicBlock(nn.Layer):
    def __init__(self, ch_in, ch_out, shortcut=True):
        super().__init__()
        self.conv1 = ConvBNLayer(ch_in, ch_out, 3)
        self.conv2 = RepVggBlock(ch_out, ch_out)
        self.shortcut = shortcut and ch_in == ch_out

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.shortcut else y


class EffectiveSELayer(nn.Layer):
    """ESE channel attention (one fc, hardsigmoid gate)."""

    def __init__(self, channels):
        super().__init__()
        self.fc = nn.Conv2D(channels, channels, 1, data_format="NHWC")

    def forward(self, x):
        s = x.mean((1, 2), keepdim=True)
        return x * hardsigmoid(self.fc(s))


class CSPResStage(nn.Layer):
    def __init__(self, ch_in, ch_out, n_blocks, stride=2, use_attn=True):
        super().__init__()
        ch_mid = (ch_in + ch_out) // 2
        self.conv_down = ConvBNLayer(ch_in, ch_mid, 3, stride=stride) \
            if stride > 1 else None
        ch_half = ch_mid // 2
        self.conv1 = ConvBNLayer(ch_mid, ch_half, 1)
        self.conv2 = ConvBNLayer(ch_mid, ch_half, 1)
        self.blocks = nn.Sequential(*[
            BasicBlock(ch_half, ch_half) for _ in range(n_blocks)])
        self.attn = EffectiveSELayer(ch_mid) if use_attn else None
        self.conv3 = ConvBNLayer(ch_mid, ch_out, 1)

    def forward(self, x):
        if self.conv_down is not None:
            x = self.conv_down(x)
        y = concat([self.conv1(x), self.blocks(self.conv2(x))], axis=-1)
        if self.attn is not None:
            y = self.attn(y)
        return self.conv3(y)


class CSPResNet(nn.Layer):
    """Backbone. Channels and layers scale with width_mult / depth_mult
    (s / m / l / x)."""

    def __init__(self, width_mult=1.0, depth_mult=1.0,
                 return_idx=(1, 2, 3), use_large_stem=True):
        super().__init__()
        channels = [max(round(c * width_mult), 8)
                    for c in (64, 128, 256, 512, 1024)]
        layers = [max(round(n * depth_mult), 1) for n in (3, 6, 6, 3)]
        self.return_idx = list(return_idx)
        c0 = channels[0]
        self.stem = nn.Sequential(
            ConvBNLayer(3, c0 // 2, 3, stride=2),
            ConvBNLayer(c0 // 2, c0 // 2, 3, stride=1),
            ConvBNLayer(c0 // 2, c0, 3, stride=1),
        ) if use_large_stem else nn.Sequential(
            ConvBNLayer(3, c0 // 2, 3, stride=2),
            ConvBNLayer(c0 // 2, c0, 3, stride=1),
        )
        self.stages = nn.LayerList([
            CSPResStage(channels[i], channels[i + 1], layers[i], stride=2)
            for i in range(4)])
        self.out_channels = [channels[i + 1] for i in self.return_idx]
        # stem stride 2, then one stride-2 conv per stage: stage i is 4*2**i
        self.out_strides = [4 * 2 ** i for i in self.return_idx]

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i in self.return_idx:
                outs.append(x)
        return outs


class SPP(nn.Layer):
    def __init__(self, ch_in, ch_out, pool_sizes=(5, 9, 13)):
        super().__init__()
        self.pools = [nn.MaxPool2D(k, stride=1, padding=k // 2,
                                   data_format="NHWC") for k in pool_sizes]
        for i, p in enumerate(self.pools):
            self.add_sublayer(f"pool{i}", p)
        self.conv = ConvBNLayer(ch_in * (1 + len(pool_sizes)), ch_out, 1)

    def forward(self, x):
        return self.conv(concat([x] + [p(x) for p in self.pools], axis=-1))


class CSPStage(nn.Layer):
    def __init__(self, ch_in, ch_out, n_blocks, use_spp=False):
        super().__init__()
        ch_mid = ch_out // 2
        self.conv1 = ConvBNLayer(ch_in, ch_mid, 1)
        self.conv2 = ConvBNLayer(ch_in, ch_mid, 1)
        blocks = [BasicBlock(ch_mid, ch_mid, shortcut=False)
                  for _ in range(n_blocks)]
        if use_spp:
            blocks.insert(n_blocks // 2 + 1 if n_blocks else 0,
                          SPP(ch_mid, ch_mid))
        self.blocks = nn.Sequential(*blocks)
        self.conv3 = ConvBNLayer(ch_mid * 2, ch_out, 1)

    def forward(self, x):
        y1 = self.conv1(x)
        y2 = self.blocks(self.conv2(x))
        return self.conv3(concat([y1, y2], axis=-1))


class CustomCSPPAN(nn.Layer):
    """PAN neck: top-down FPN then bottom-up PAN, CSP stages at every
    merge."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 stage_num: int = 1, block_num: int = 3, spp: bool = True):
        super().__init__()
        n = len(in_channels)
        self.fpn_stages = nn.LayerList()
        self.fpn_routes = nn.LayerList()
        ch_pre = 0
        fpn_out = list(out_channels)
        # top-down: deepest level first
        for i, ch_in in enumerate(reversed(in_channels)):
            ch = ch_in + (ch_pre // 2 if i > 0 else 0)
            self.fpn_stages.append(CSPStage(ch, fpn_out[n - 1 - i],
                                            block_num,
                                            use_spp=spp and i == 0))
            if i < n - 1:
                self.fpn_routes.append(
                    ConvBNLayer(fpn_out[n - 1 - i],
                                fpn_out[n - 1 - i] // 2, 1))
            ch_pre = fpn_out[n - 1 - i]
        self.pan_stages = nn.LayerList()
        self.pan_routes = nn.LayerList()
        # bottom-up
        for i in range(n - 1):
            self.pan_routes.append(
                ConvBNLayer(fpn_out[i], fpn_out[i], 3, stride=2))
            self.pan_stages.append(
                CSPStage(fpn_out[i] + fpn_out[i + 1], fpn_out[i + 1],
                         block_num))
        self.out_channels = fpn_out

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        fpn_feats = []
        route = None
        for i, feat in enumerate(reversed(feats)):
            if i > 0:
                feat = concat([route, feat], axis=-1)
            feat = self.fpn_stages[i](feat)
            fpn_feats.append(feat)
            if i < len(feats) - 1:
                route = interpolate(self.fpn_routes[i](feat), scale_factor=2,
                                    mode="nearest", data_format="NHWC")
        fpn_feats = fpn_feats[::-1]  # shallow -> deep
        pan_feats = [fpn_feats[0]]
        for i in range(len(feats) - 1):
            down = self.pan_routes[i](pan_feats[-1])
            pan_feats.append(self.pan_stages[i](
                concat([down, fpn_feats[i + 1]], axis=-1)))
        return pan_feats


class ESEAttn(nn.Layer):
    def __init__(self, ch):
        super().__init__()
        self.fc = nn.Conv2D(ch, ch, 1, data_format="NHWC")
        self.conv = ConvBNLayer(ch, ch, 1)

    def forward(self, feat, avg_feat):
        return self.conv(feat * sigmoid(self.fc(avg_feat)))


# ---------------------------------------------------------------------------
# head + losses
# ---------------------------------------------------------------------------
def _decode(pred_dist, anchors, strides):
    """Distances (the bins' expectation) at the anchors, in pixels, as
    xyxy boxes: pred_dist [B, A, 4, R + 1] logits."""
    proj = torch.arange(pred_dist.shape[-1], dtype=pred_dist.dtype,
                        device=pred_dist.device)
    dist_px = (torch.softmax(pred_dist, -1) @ proj) * strides[None, :, None]
    return torch.cat([anchors[None] - dist_px[..., :2],
                      anchors[None] + dist_px[..., 2:]], dim=-1)


def _vfl_giou_dfl_loss(cls_logits, pred_dist, anchors, strides, gt_labels,
                       gt_boxes, gt_mask, *, num_classes, reg_max, tal_topk,
                       alpha, beta, loss_weights):
    """The PP-YOLOE detection loss: ``(total, loss_cls, loss_iou,
    loss_dfl)``.

    cls_logits [B, A, C]; pred_dist [B, A, 4, reg_max + 1] (logits over
    bins); anchors [A, 2] (centre points in input pixels); strides [A];
    gt_labels [B, M] int; gt_boxes [B, M, 4] xyxy; gt_mask [B, M] {0, 1}.
    """
    B, A, C = cls_logits.shape
    pred_boxes = _decode(pred_dist, anchors, strides)          # [B,A,4]
    scores = torch.sigmoid(cls_logits)

    # ---- task-aligned assignment (no gradients) --------------------------
    with torch.no_grad():
        ious = _pairwise_iou(gt_boxes, pred_boxes)              # [B,M,A]
        cx = anchors[None, None, :, 0]
        cy = anchors[None, None, :, 1]
        inside = ((cx >= gt_boxes[..., None, 0])
                  & (cx <= gt_boxes[..., None, 2])
                  & (cy >= gt_boxes[..., None, 1])
                  & (cy <= gt_boxes[..., None, 3]))
        lab = torch.clamp(gt_labels, min=0).long()
        gt_cls_score = torch.gather(
            scores.transpose(1, 2), 1,
            lab[..., None].expand(-1, -1, A))                   # [B,M,A]
        metric = torch.pow(gt_cls_score, alpha) * torch.pow(ious, beta)
        metric = torch.where(inside & (gt_mask[..., None] > 0), metric, 0.0)
        k = min(tal_topk, A)
        thresh = torch.topk(metric, k, dim=-1).values[..., k - 1:k]
        cand = (metric >= torch.clamp(thresh, min=1e-12)) & (metric > 0)
        # conflicts: an anchor goes to the gt of the largest IoU among its
        # candidates (the first one on a tie)
        cand_iou = torch.where(cand, ious, -1.0)
        best_gt = torch.argmax(cand_iou, dim=1)                 # [B,A]
        is_pos = cand_iou.max(dim=1).values > 0
        a_lab = torch.gather(gt_labels.long(), 1, best_gt)
        a_box = torch.gather(gt_boxes, 1, best_gt[..., None].expand(-1, -1, 4))
        a_metric = torch.gather(metric, 1, best_gt[:, None, :])[:, 0]
        # target score = metric / max metric of its gt * max IoU of its gt
        max_metric = torch.where(cand, metric, 0.0).max(-1, keepdim=True)[0]
        max_iou = torch.where(cand, ious, 0.0).max(-1, keepdim=True)[0]
        norm = torch.gather(max_iou / (max_metric + 1e-9), 1,
                            best_gt[..., None])[..., 0]
        t_score = torch.clamp(torch.where(is_pos, a_metric * norm, 0.0),
                              0.0, 1.0)                         # [B,A]
        one_hot = TF.one_hot(torch.where(is_pos, a_lab, C), C + 1)[
            ..., :C].to(scores.dtype)                           # [B,A,C]
        t_cls = one_hot * t_score[..., None]
        focal_w = torch.where(one_hot > 0, t_cls, 0.75 * scores.pow(2.0))
        w = torch.where(is_pos, t_score, 0.0)
        denom = torch.clamp(t_score.sum(), min=1.0)

    # ---- varifocal classification loss -----------------------------------
    bce = -(t_cls * TF.logsigmoid(cls_logits)
            + (1 - t_cls) * TF.logsigmoid(-cls_logits))
    loss_cls = (focal_w * bce).sum() / denom

    # ---- GIoU box loss (positives, weighted by target score) -------------
    loss_iou = ((1.0 - _diag_giou(pred_boxes, a_box)) * w).sum() / denom

    # ---- distribution focal loss -----------------------------------------
    t_dist = torch.cat([anchors[None] - a_box[..., :2],
                        a_box[..., 2:] - anchors[None]], dim=-1) \
        / strides[None, :, None]
    t_dist = torch.clamp(t_dist, 0, reg_max - 0.01)             # [B,A,4]
    tl = torch.floor(t_dist).long()
    tr = tl + 1
    wl = tr.to(t_dist.dtype) - t_dist
    wr = 1.0 - wl
    logp = TF.log_softmax(pred_dist, dim=-1)                    # [B,A,4,R+1]
    dfl = -(torch.gather(logp, -1, tl[..., None])[..., 0] * wl
            + torch.gather(logp, -1, tr[..., None])[..., 0] * wr)
    loss_dfl = (dfl.mean(-1) * w).sum() / denom

    wc, wi, wd = loss_weights
    total = wc * loss_cls + wi * loss_iou + wd * loss_dfl
    return total, loss_cls, loss_iou, loss_dfl


def _diag_giou(a, b, eps=1e-9):
    """Elementwise GIoU between matched box pairs a, b: [..., 4]."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) \
        * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) \
        * torch.clamp(b[..., 3] - b[..., 1], min=0)
    union = area_a + area_b - inter
    iou = inter / (union + eps)
    hull_wh = torch.clamp(torch.maximum(a[..., 2:], b[..., 2:])
                          - torch.minimum(a[..., :2], b[..., :2]), min=0)
    hull = hull_wh[..., 0] * hull_wh[..., 1]
    return iou - (hull - union) / (hull + eps)


class PPYOLOEHead(nn.Layer):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 strides: Sequence[int] = (8, 16, 32), reg_max: int = 16,
                 tal_topk: int = 13, tal_alpha: float = 1.0,
                 tal_beta: float = 6.0,
                 loss_weights: Tuple[float, float, float] = (1.0, 2.5, 0.5)):
        super().__init__()
        self.num_classes = num_classes
        self.strides = list(strides)
        self.reg_max = reg_max
        self.tal_topk = tal_topk
        self.tal_alpha = tal_alpha
        self.tal_beta = tal_beta
        self.loss_weights = loss_weights
        self.stem_cls = nn.LayerList([ESEAttn(c) for c in in_channels])
        self.stem_reg = nn.LayerList([ESEAttn(c) for c in in_channels])
        self.pred_cls = nn.LayerList([
            nn.Conv2D(c, num_classes, 3, padding=1, data_format="NHWC")
            for c in in_channels])
        self.pred_reg = nn.LayerList([
            nn.Conv2D(c, 4 * (reg_max + 1), 3, padding=1, data_format="NHWC")
            for c in in_channels])
        # cls bias at the focal prior logit log(p / (1 - p)), p = 0.01
        prior_logit = float(math.log(0.01 / 0.99))
        with torch.no_grad():
            for conv in self.pred_cls:
                conv.bias.fill_(prior_logit)

    def _anchors(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        """Anchor centres [A, 2] and strides [A] in input pixels, fp32 on
        the features' device."""
        pts, strs = [], []
        for f, s in zip(feats, self.strides):
            h, w = int(f.shape[1]), int(f.shape[2])
            ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            p = (np.stack([xs, ys], -1).reshape(-1, 2) + 0.5) * s
            pts.append(p.astype(np.float32))
            strs.append(np.full((h * w,), s, np.float32))
        dev = feats[0].device
        return (torch.as_tensor(np.concatenate(pts), device=dev),
                torch.as_tensor(np.concatenate(strs), device=dev))

    def forward(self, feats):
        cls_list, reg_list = [], []
        for i, f in enumerate(feats):
            avg = f.mean((1, 2), keepdim=True)
            c = self.pred_cls[i](self.stem_cls[i](f, avg) + f)
            r = self.pred_reg[i](self.stem_reg[i](f, avg))
            b = f.shape[0]
            cls_list.append(c.reshape(b, -1, self.num_classes))
            reg_list.append(r.reshape(b, -1, 4 * (self.reg_max + 1)))
        return concat(cls_list, axis=1), concat(reg_list, axis=1)

    def _reg4(self, reg_dist):
        b, a, _ = reg_dist.shape
        return reg_dist.reshape(b, a, 4, self.reg_max + 1)

    def loss(self, feats, gt_labels, gt_boxes, gt_mask):
        cls_logits, reg_dist = self.forward(feats)
        anchors, strides = self._anchors(feats)
        total, l_cls, l_iou, l_dfl = _vfl_giou_dfl_loss(
            cls_logits, self._reg4(reg_dist), anchors, strides, gt_labels,
            gt_boxes, gt_mask, num_classes=self.num_classes,
            reg_max=self.reg_max, tal_topk=self.tal_topk,
            alpha=self.tal_alpha, beta=self.tal_beta,
            loss_weights=self.loss_weights)
        return {"loss": total, "loss_cls": l_cls, "loss_iou": l_iou,
                "loss_dfl": l_dfl}

    def post_process(self, feats, score_threshold=0.05, nms_threshold=0.6,
                     nms_top_k=1000, keep_top_k=100):
        cls_logits, reg_dist = self.forward(feats)
        anchors, strides = self._anchors(feats)
        with torch.no_grad():
            boxes = _decode(self._reg4(reg_dist), anchors, strides)
            scores = torch.sigmoid(cls_logits).transpose(1, 2)  # [B, C, A]
            return multiclass_nms(boxes, scores,
                                  score_threshold=score_threshold,
                                  nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                                  nms_threshold=nms_threshold)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
@dataclass
class PPYOLOEConfig:
    num_classes: int = 80
    width_mult: float = 1.0
    depth_mult: float = 1.0
    # shallow -> deep neck widths; None: the reference's (192, 384, 768)
    # scaled by width_mult
    neck_out_channels: Optional[Sequence[int]] = None
    strides: Sequence[int] = (8, 16, 32)
    reg_max: int = 16

    @staticmethod
    def l(num_classes=80):
        return PPYOLOEConfig(num_classes=num_classes)

    @staticmethod
    def s(num_classes=80):
        return PPYOLOEConfig(num_classes=num_classes, width_mult=0.50,
                             depth_mult=0.33)

    @staticmethod
    def tiny(num_classes=4):
        return PPYOLOEConfig(num_classes=num_classes, width_mult=0.25,
                             depth_mult=0.33)


class PPYOLOE(nn.Layer):
    """backbone -> neck -> head; NHWC input [B, H, W, 3], H and W
    multiples of 32. Built on ``device`` with initial weights drawn from a
    generator seeded with ``seed`` (``nn.build_scope``)."""

    def __init__(self, config: PPYOLOEConfig, device=None,
                 seed: Optional[int] = None):
        with build_scope(device, seed):
            super().__init__()
            self.config = config
            self.backbone = CSPResNet(config.width_mult, config.depth_mult)
            neck_out = list(config.neck_out_channels) \
                if config.neck_out_channels is not None else \
                [max(round(c * config.width_mult), 8) for c in (192, 384, 768)]
            self.neck = CustomCSPPAN(self.backbone.out_channels, neck_out)
            self.head = PPYOLOEHead(neck_out, config.num_classes,
                                    strides=config.strides,
                                    reg_max=config.reg_max)

    def forward(self, images):
        return self.head.forward(self.neck(self.backbone(images)))

    def loss(self, images, gt_labels, gt_boxes, gt_mask):
        feats = self.neck(self.backbone(images))
        return self.head.loss(feats, gt_labels, gt_boxes, gt_mask)

    def predict(self, images, **nms_kwargs):
        feats = self.neck(self.backbone(images))
        return self.head.post_process(feats, **nms_kwargs)
