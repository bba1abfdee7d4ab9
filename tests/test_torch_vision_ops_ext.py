"""The port's ``paddle.vision.ops`` (``paddle_tpu_torch.vision.ops``)
against ``paddle_tpu.vision.ops`` on the CPU, inputs from seeded numpy
generators.

Held: every op's outputs within rtol 1e-5 plus 1e-6 of each output's
largest element (fp32, the same operations, sums in other orders), index
and count outputs equal; the gradients where the JAX package
differentiates (``roi_align``, ``roi_pool``, ``psroi_pool``,
``box_coder``, ``deform_conv2d`` v1 and v2, ``yolo_loss``) of ``sum(out *
cot)`` within rtol 1e-5 plus 1e-5 of each gradient's largest element;
``deform_conv2d``'s shape checks raising the JAX package's messages.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as JO
from paddle_tpu_torch.nn import build_scope
from paddle_tpu_torch.vision import ops as TO


def _j(t):
    return np.asarray(t._data)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else _j(t)


def _close(got, want, rtol=1e-5, frac=1e-6):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = np.abs(want[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=frac * scale + 1e-30)


def _pair(*arrays, grad=()):
    """Each array as a JAX-package leaf and a torch leaf (those whose index
    is in ``grad`` requiring gradients)."""
    js = [paddle.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(arrays)]
    ts = [torch.tensor(a, requires_grad=i in grad) for i, a in
          enumerate(arrays)]
    return js, ts


def _grads_close(js, ts, grad):
    for i in grad:
        _close(ts[i].grad, js[i].grad, 1e-5, 1e-5)


def _backward(jout, tout, cot):
    (jout * paddle.to_tensor(cot)).sum().backward()
    (tout * torch.tensor(cot)).sum().backward()


def _rois(rng, r, hw=(20.0, 24.0)):
    lo = rng.uniform(0, 0.6, (r, 2)) * np.array(hw[::-1])
    size = rng.uniform(2, 10, (r, 2))
    return np.concatenate([lo, lo + size], 1).astype(np.float32)


ROI_CASES = {
    # name: output_size, spatial_scale, sampling_ratio, aligned
    "aligned_default": (3, 0.5, -1, True),
    "unaligned_sr2": ((2, 3), 0.5, 2, False),
    "aligned_sr1": ((3, 2), 1.0, 1, True),
}


@pytest.mark.parametrize("case", sorted(ROI_CASES))
def test_roi_align(case):
    size, scale, sr, aligned = ROI_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 10, 12)).astype(np.float32)
    boxes = _rois(rng, 5)
    num = np.array([2, 3], np.int32)
    js, ts = _pair(x, boxes, num, grad=(0,))
    jo = JO.roi_align(*js, size, scale, sr, aligned)
    to = TO.roi_align(*ts, size, scale, sr, aligned)
    _close(to, jo)
    _backward(jo, to, rng.standard_normal(tuple(to.shape)).astype(np.float32))
    _grads_close(js, ts, (0,))


def test_roi_pool():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 10, 12)).astype(np.float32)
    boxes = _rois(rng, 4)
    num = np.array([1, 3], np.int32)
    js, ts = _pair(x, boxes, num, grad=(0,))
    jo = JO.roi_pool(*js, (2, 3), 0.5)
    to = TO.roi_pool(*ts, (2, 3), 0.5)
    _close(to, jo)
    cot = rng.standard_normal(tuple(to.shape)).astype(np.float32)
    cot[~np.isfinite(_np(to))] = 0.0
    jo = JO.roi_pool(*js, (2, 3), 0.5)
    jm = paddle.to_tensor(np.isfinite(_j(jo)).astype(np.float32))
    (paddle.where(jm > 0, jo, paddle.zeros_like(jo))
     * paddle.to_tensor(cot)).sum().backward()
    (torch.where(torch.isfinite(to), to, 0.0) * torch.tensor(cot)).sum(
    ).backward()
    _grads_close(js, ts, (0,))


def test_psroi_pool():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 10, 12)).astype(np.float32)
    boxes = _rois(rng, 3)
    num = np.array([2, 1], np.int32)
    js, ts = _pair(x, boxes, num, grad=(0,))
    jo = JO.psroi_pool(*js, 2, 0.5)
    to = TO.psroi_pool(*ts, 2, 0.5)
    assert tuple(to.shape) == (3, 2, 2, 2)
    _close(to, jo)
    _backward(jo, to, rng.standard_normal(tuple(to.shape)).astype(np.float32))
    _grads_close(js, ts, (0,))
    with pytest.raises(ValueError, match="divisible"):
        TO.psroi_pool(ts[0][:, :7], ts[1], ts[2], 2)


@pytest.mark.parametrize("code", ["encode_center_size",
                                  "decode_center_size"])
@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("with_var", [True, False])
def test_box_coder(code, normalized, with_var):
    rng = np.random.default_rng(3)
    prior = _rois(rng, 6)
    target = (_rois(rng, 6) if code.startswith("encode")
              else rng.standard_normal((6, 4)).astype(np.float32) * 0.3)
    var = np.abs(rng.standard_normal((6, 4))).astype(np.float32) + 0.1
    arrays = (prior, target) + ((var,) if with_var else ())
    js, ts = _pair(*arrays, grad=(1,))
    jv, tv = (js[2], ts[2]) if with_var else (None, None)
    jo = JO.box_coder(js[0], jv, js[1], code, normalized)
    to = TO.box_coder(ts[0], tv, ts[1], code, normalized)
    _close(to, jo)
    _backward(jo, to, rng.standard_normal((6, 4)).astype(np.float32))
    _grads_close(js, ts, (1,))


DEFORM_CASES = {
    # name: N, Cin, H, W, Cout, k, stride, padding, dilation, dg, groups,
    #       mask (v2), bias
    "v1": (2, 4, 7, 8, 6, 3, 1, 1, 1, 1, 1, False, True),
    "v2_groups": (1, 4, 8, 7, 4, 3, 2, 1, 1, 2, 2, True, True),
    "v2_dilated_no_bias": (1, 2, 9, 9, 3, 3, 1, 2, 2, 1, 1, True, False),
}


@pytest.mark.parametrize("case", sorted(DEFORM_CASES))
def test_deform_conv2d(case):
    n, cin, h, w, cout, k, st, pad, dil, dg, g, with_mask, with_bias = \
        DEFORM_CASES[case]
    rng = np.random.default_rng(4)
    oh = (h + 2 * pad - (dil * (k - 1) + 1)) // st + 1
    ow = (w + 2 * pad - (dil * (k - 1) + 1)) // st + 1
    x = rng.standard_normal((n, cin, h, w)).astype(np.float32)
    off = (rng.standard_normal((n, 2 * dg * k * k, oh, ow)) * 1.5).astype(
        np.float32)
    wt = rng.standard_normal((cout, cin // g, k, k)).astype(np.float32)
    arrays = [x, off, wt]
    if with_mask:
        arrays.append(rng.uniform(0, 1, (n, dg * k * k, oh, ow)).astype(
            np.float32))
    if with_bias:
        arrays.append(rng.standard_normal(cout).astype(np.float32))
    grad = tuple(range(len(arrays)))
    js, ts = _pair(*arrays, grad=grad)

    def call(mod, t):
        mask = t[3] if with_mask else None
        bias = t[-1] if with_bias else None
        return mod.deform_conv2d(t[0], t[1], t[2], bias, st, pad, dil, dg, g,
                                 mask)
    jo, to = call(JO, js), call(TO, ts)
    assert tuple(to.shape) == (n, cout, oh, ow)
    _close(to, jo)
    _backward(jo, to, rng.standard_normal(tuple(to.shape)).astype(np.float32))
    _grads_close(js, ts, grad)


def test_deform_conv2d_shape_checks():
    x = torch.zeros(1, 4, 6, 6)
    w = torch.zeros(2, 4, 3, 3)
    for off, mask in ((torch.zeros(1, 17, 4, 4), None),
                      (torch.zeros(1, 18, 5, 4), None),
                      (torch.zeros(1, 18, 4, 4), torch.zeros(1, 8, 4, 4))):
        with pytest.raises(ValueError) as want:
            JO.deform_conv2d(paddle.to_tensor(x.numpy()),
                             paddle.to_tensor(off.numpy()),
                             paddle.to_tensor(w.numpy()),
                             mask=None if mask is None else paddle.to_tensor(
                                 mask.numpy()))
        with pytest.raises(ValueError) as got:
            TO.deform_conv2d(x, off, w, mask=mask)
        assert str(got.value) == str(want.value)


def test_layers():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 10, 12)).astype(np.float32)
    boxes = _rois(rng, 3)
    num = np.array([1, 2], np.int32)
    js, ts = _pair(x, boxes, num)
    for name in ("RoIAlign", "RoIPool", "PSRoIPool"):
        _close(getattr(TO, name)(2, 0.5)(*ts),
               getattr(JO, name)(2, 0.5)(*js))
    with build_scope("cpu", seed=0):
        layer = TO.DeformConv2D(8, 4, 3, padding=1, deformable_groups=2)
    jl = JO.DeformConv2D(8, 4, 3, padding=1, deformable_groups=2)
    assert sorted(layer.state_dict()) == sorted(jl.state_dict())
    jl.set_state_dict({k: v.numpy() for k, v in layer.state_dict().items()})
    off = (rng.standard_normal((2, 36, 10, 12))).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 18, 10, 12)).astype(np.float32)
    _close(layer(ts[0], torch.tensor(off), torch.tensor(mask)),
           jl(js[0], paddle.to_tensor(off), paddle.to_tensor(mask)))


PRIOR_CASES = {
    # name: min_sizes, max_sizes, aspect_ratios, flip, clip, steps, order
    "plain": ([4.0], None, (1.0,), False, False, (0.0, 0.0), False),
    "flip_clip_max": ([4.0, 8.0], [9.0, 14.0], (1.0, 2.0, 3.0), True, True,
                      (0.0, 0.0), False),
    "caffe_order_steps": ([6.0], [12.0], (2.0,), True, False, (4.0, 4.0),
                          True),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_prior_box(case):
    mins, maxs, ars, flip, clip, steps, order = PRIOR_CASES[case]
    feat = np.zeros((1, 3, 5, 6), np.float32)
    img = np.zeros((1, 3, 20, 24), np.float32)
    js, ts = _pair(feat, img)
    kw = dict(max_sizes=maxs, aspect_ratios=ars, flip=flip, clip=clip,
              steps=steps, min_max_aspect_ratios_order=order)
    jb, jv = JO.prior_box(*js, mins, **kw)
    tb, tv = TO.prior_box(*ts, mins, **kw)
    _close(tb, jb)
    _close(tv, jv)


@pytest.mark.parametrize("iou_aware", [False, True])
@pytest.mark.parametrize("clip_bbox", [True, False])
def test_yolo_box(iou_aware, clip_bbox):
    rng = np.random.default_rng(6)
    anchors, c = [10, 13, 16, 30, 33, 23], 3
    ch = 3 * (5 + c) + (3 if iou_aware else 0)
    x = rng.standard_normal((2, ch, 4, 5)).astype(np.float32)
    size = np.array([[128, 160], [96, 120]], np.int32)
    js, ts = _pair(x, size)
    kw = dict(clip_bbox=clip_bbox, scale_x_y=1.05, iou_aware=iou_aware,
              iou_aware_factor=0.4)
    jb, js_ = JO.yolo_box(*js, anchors, c, 0.3, 32, **kw)
    tb, ts_ = TO.yolo_box(*ts, anchors, c, 0.3, 32, **kw)
    _close(tb, jb)
    _close(ts_, js_)


@pytest.mark.parametrize("with_score", [False, True])
@pytest.mark.parametrize("smooth", [True, False])
def test_yolo_loss(with_score, smooth):
    rng = np.random.default_rng(7)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    mask, c, g = [0, 1, 2], 4, 5
    x = rng.standard_normal((2, 3 * (5 + c), 6, 6)).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.1, 0.9, (2, g, 2)),
                         rng.uniform(0.05, 0.4, (2, g, 2))], -1).astype(
        np.float32)
    gt[1, -1] = 0.0                         # a padded gt
    lab = rng.integers(0, c, (2, g)).astype(np.int32)
    arrays = [x, gt, lab] + ([rng.uniform(0.5, 1, (2, g)).astype(
        np.float32)] if with_score else [])
    js, ts = _pair(*arrays, grad=(0,))

    def call(mod, t):
        return mod.yolo_loss(t[0], t[1], t[2], anchors, mask, c, 0.5, 32,
                             gt_score=t[3] if with_score else None,
                             use_label_smooth=smooth)
    jo, to = call(JO, js), call(TO, ts)
    assert tuple(to.shape) == (2,)
    _close(to, jo)
    _backward(jo, to, np.array([1.0, -0.5], np.float32))
    _grads_close(js, ts, (0,))


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("normalized", [True, False])
def test_matrix_nms(gaussian, normalized):
    rng = np.random.default_rng(8)
    b = np.stack([_rois(rng, 30, (40.0, 40.0)) for _ in range(2)])
    s = rng.uniform(0, 1, (2, 4, 30)).astype(np.float32)
    js, ts = _pair(b, s)
    kw = dict(post_threshold=0.1, nms_top_k=50, keep_top_k=20,
              use_gaussian=gaussian, normalized=normalized,
              return_index=True)
    jr = JO.matrix_nms(*js, 0.2, **kw)
    tr = TO.matrix_nms(*ts, 0.2, **kw)
    _close(tr[0], jr[0])
    np.testing.assert_array_equal(_np(tr[1]), _j(jr[1]))
    np.testing.assert_array_equal(_np(tr[2]), _j(jr[2]))
    only = TO.matrix_nms(*ts, 0.2, keep_top_k=20, return_rois_num=False)
    assert isinstance(only, torch.Tensor)


@pytest.mark.parametrize("pixel_offset", [False, True])
def test_generate_proposals(pixel_offset):
    rng = np.random.default_rng(9)
    a, h, w = 3, 4, 5
    scores = rng.uniform(0, 1, (2, a, h, w)).astype(np.float32)
    deltas = (rng.standard_normal((2, 4 * a, h, w)) * 0.2).astype(np.float32)
    size = np.array([[40, 50], [36, 44]], np.float32)
    ctr = np.stack(np.meshgrid(np.arange(w) * 10.0 + 5, np.arange(h) * 10.0
                               + 5), -1)[:, :, None, :]
    half = np.array([4.0, 8.0, 12.0])[None, None, :, None]
    anchors = np.concatenate([ctr - half, ctr + half], -1).astype(np.float32)
    var = np.broadcast_to(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                          anchors.shape).copy()
    js, ts = _pair(scores, deltas, size, anchors, var)
    kw = dict(pre_nms_top_n=30, post_nms_top_n=40, nms_thresh=0.5,
              min_size=2.0, pixel_offset=pixel_offset)
    jr = JO.generate_proposals(*js, **kw)
    tr = TO.generate_proposals(*ts, **kw)
    _close(tr[0], jr[0])
    _close(tr[1], jr[1])
    np.testing.assert_array_equal(_np(tr[2]), _j(jr[2]))
    assert len(TO.generate_proposals(*ts, **kw,
                                     return_rois_num=False)) == 2


@pytest.mark.parametrize("with_num", [False, True])
def test_distribute_fpn_proposals(with_num):
    rng = np.random.default_rng(10)
    lo = rng.uniform(0, 200, (12, 2))
    rois = np.concatenate([lo, lo + rng.uniform(4, 300, (12, 2))],
                          1).astype(np.float32)
    num = np.array([12], np.int32) if with_num else None
    jr = JO.distribute_fpn_proposals(paddle.to_tensor(rois), 2, 5, 4, 224,
                                     rois_num=num)
    tr = TO.distribute_fpn_proposals(torch.tensor(rois), 2, 5, 4, 224,
                                     rois_num=num)
    assert len(tr) == len(jr) == (3 if with_num else 2)
    for a, b in zip(tr[0], jr[0]):
        np.testing.assert_array_equal(_np(a), _j(b))
    np.testing.assert_array_equal(_np(tr[1]), _j(jr[1]))
    if with_num:
        assert [int(_np(v)[0]) for v in tr[2]] == [int(_j(v)[0])
                                                  for v in jr[2]]


@pytest.mark.parametrize("info", [(30.0, 40.0, 1.0), (30.0, 40.0, 2.0),
                                  (30.0, 40.0)])
def test_box_clip(info):
    rng = np.random.default_rng(11)
    b = (rng.standard_normal((2, 7, 4)) * 30 + 15).astype(np.float32)
    im = np.array([info], np.float32)
    js, ts = _pair(b, im)
    _close(TO.box_clip(*ts), JO.box_clip(*js))


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match(match_type):
    rng = np.random.default_rng(12)
    d = rng.uniform(0, 1, (4, 7)).astype(np.float32)
    d[1, 2] = -np.inf
    d[2, 5] = np.nan
    ji, jd = JO.bipartite_match(paddle.to_tensor(d), match_type, 0.3)
    ti, td = TO.bipartite_match(torch.tensor(d), match_type, 0.3)
    assert ti.dtype == torch.int32 and tuple(ti.shape) == (1, 7)
    np.testing.assert_array_equal(ti.numpy(), _j(ji))
    np.testing.assert_array_equal(td.numpy(), _j(jd))


def test_reexports_are_the_ops_module():
    from paddle_tpu_torch.ops import vision as V
    assert TO.nms is V.nms and TO.multiclass_nms is V.multiclass_nms
    assert TO.bbox_iou is V.bbox_iou and TO.box_area is V.box_area
