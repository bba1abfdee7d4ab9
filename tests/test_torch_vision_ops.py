"""The port's detection ops (``paddle_tpu_torch.ops.vision``) against
``paddle_tpu.ops.vision`` on the CPU, inputs from seeded numpy generators.

Held: IoU and GIoU (rtol 1e-5, atol 1e-6: the same fp32 operations in the
same order; the gradients of ``sum(iou * cot)`` rtol 1e-5 plus 1e-5 of the
largest), ``box_area``, ``distance2bbox`` with and without ``max_shape``
and ``bbox2distance`` with and without ``reg_max`` (rtol 1e-5);
``nms`` (the given order, scores, ``top_k``, categories, non-positive
scores) and ``multiclass_nms`` (a background label, padding to
``keep_top_k`` with the boxes of the first zero-score candidates, scores
exactly at the threshold, tied scores, ``nms_top_k`` past the box count)
equal, padding rows included; K11's plain version (``nms_suppress`` on
CPU tensors) equal to the JAX package's sweep ``_nms_suppress`` on each
problem, ``k = 1`` and a ``k`` that is not a multiple of 64 among them.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import vision as JV
from paddle_tpu_torch.ops import vision as TV


def _boxes(rng, shape, lo=0.0, hi=100.0, wmin=4.0, wmax=20.0):
    c = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(wmin, wmax, shape + (2,))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _j(t):
    return np.asarray(t._data)


def _jt(a, grad=False):
    return paddle.to_tensor(a, stop_gradient=not grad)


@pytest.mark.parametrize("mode", ["iou", "giou"])
@pytest.mark.parametrize("batched", [False, True])
def test_bbox_iou_and_its_gradient(mode, batched):
    rng = np.random.default_rng(0)
    lead = (2,) if batched else ()
    a = _boxes(rng, lead + (5,), wmin=-2.0)   # some degenerate boxes
    b = _boxes(rng, lead + (7,))
    cot = rng.standard_normal(lead + (5, 7)).astype(np.float32)
    ja, jb = _jt(a, True), _jt(b, True)
    jo = JV.bbox_iou(ja, jb, mode=mode)
    (jo * paddle.to_tensor(cot)).sum().backward()
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    to = TV.bbox_iou(ta, tb, mode=mode)
    (to * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), _j(jo), rtol=1e-5,
                               atol=1e-6)
    for t, j in ((ta, ja), (tb, jb)):
        g = _j(j.grad)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())


def test_box_area():
    rng = np.random.default_rng(1)
    b = _boxes(rng, (3, 9), wmin=-3.0)
    np.testing.assert_allclose(TV.box_area(torch.tensor(b)).numpy(),
                               _j(JV.box_area(_jt(b))), rtol=1e-5)


@pytest.mark.parametrize("max_shape", [None, (48, 60)])
def test_distance2bbox(max_shape):
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 64, (2, 30, 2)).astype(np.float32)
    dist = rng.uniform(0, 20, (2, 30, 4)).astype(np.float32)
    got = TV.distance2bbox(torch.tensor(pts), torch.tensor(dist), max_shape)
    want = _j(JV.distance2bbox(_jt(pts), _jt(dist), max_shape))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("reg_max", [None, 16])
def test_bbox2distance(reg_max):
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 64, (30, 2)).astype(np.float32)
    b = _boxes(rng, (30,), 0, 64, 2, 50)
    got = TV.bbox2distance(torch.tensor(pts), torch.tensor(b), reg_max)
    want = _j(JV.bbox2distance(_jt(pts), _jt(b), reg_max))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


NMS_CASES = {
    # name: keyword arguments besides boxes and the threshold
    "given_order": {},
    "scores": {"scores": True},
    "top_k": {"scores": True, "top_k": 9},
    "top_k_past_n": {"scores": True, "top_k": 500},
    "categories": {"scores": True, "categories": True},
    "categories_top_k": {"scores": True, "categories": True, "top_k": 12},
    "non_positive_scores": {"scores": "signed"},
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms(case):
    kw = NMS_CASES[case]
    rng = np.random.default_rng(4)
    n = 70
    b = _boxes(rng, (n,), 0, 60, 8, 30)
    args_t, args_j = {}, {}
    if kw.get("scores"):
        s = rng.uniform(0, 1, n).astype(np.float32)
        if kw["scores"] == "signed":
            s = s - 0.5
            s[:5] = 0.0
        s[10:14] = s[9]      # ties keep index order
        args_t["scores"], args_j["scores"] = torch.tensor(s), _jt(s)
    if kw.get("categories"):
        cat = rng.integers(0, 3, n).astype(np.int64)
        args_t["category_idxs"] = torch.tensor(cat)
        args_j["category_idxs"] = _jt(cat)
        args_t["categories"] = args_j["categories"] = [0, 1, 2]
    if "top_k" in kw:
        args_t["top_k"] = args_j["top_k"] = kw["top_k"]
    got = TV.nms(torch.tensor(b), 0.4, **args_t)
    want = _j(JV.nms(_jt(b), 0.4, **args_j))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).sum() > 1 and (got < 0).any() or "top_k" in kw


MC_CASES = {
    # name: B, N, C, keyword arguments
    "plain": (2, 60, 5, dict(score_threshold=0.3, nms_top_k=20,
                             keep_top_k=10, nms_threshold=0.5)),
    "background_padding": (2, 60, 5, dict(score_threshold=0.3,
                                          nms_top_k=20, keep_top_k=150,
                                          nms_threshold=0.5,
                                          background_label=0)),
    "top_k_past_n": (2, 30, 3, dict(score_threshold=0.2, nms_top_k=100,
                                    keep_top_k=40, nms_threshold=0.45)),
    "high_threshold": (1, 50, 4, dict(score_threshold=0.9, nms_top_k=40,
                                      keep_top_k=300, nms_threshold=0.3)),
}


@pytest.mark.parametrize("case", sorted(MC_CASES))
def test_multiclass_nms(case):
    bsz, n, c, kw = MC_CASES[case]
    rng = np.random.default_rng(5)
    b = _boxes(rng, (bsz, n), 10, 90, 6, 40)
    s = rng.uniform(0, 1, (bsz, c, n)).astype(np.float32)
    s[:, :, :6] = np.float32(kw["score_threshold"])   # exactly at it
    s[:, :, 6:9] = s[:, :, 9:10]                       # ties
    to, tn = TV.multiclass_nms(torch.tensor(b), torch.tensor(s), **kw)
    jo, jn = JV.multiclass_nms(_jt(b), _jt(s), **kw)
    assert to.dtype == torch.float32 and tn.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), _j(jo))
    np.testing.assert_array_equal(tn.numpy(), _j(jn))
    k = kw["keep_top_k"]
    assert to.shape == (bsz, k, 6)
    pad = to[..., 0] < 0
    assert (to[..., 1][pad] == 0).all() and (to[..., 1][~pad] > 0).all()
    assert pad.any() == (case in ("background_padding", "high_threshold"))
    if case == "background_padding":
        assert (to[..., 0] != 0).all()


@pytest.mark.parametrize("k", [1, 5, 64, 100])
def test_plain_sweep_equals_the_jax_sweep(k):
    rng = np.random.default_rng(6)
    b = _boxes(rng, (3, k), 0, 50, 5, 30)
    got = TV.nms_suppress(torch.tensor(b), 0.5)
    assert got.dtype == torch.bool and got.shape == (3, k)
    for p in range(3):
        want = np.asarray(JV._nms_suppress(b[p], 0.5))
        np.testing.assert_array_equal(got[p].numpy(), want)


def test_nms_suppress_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=r"\(P, k, 4\)"):
        TV.nms_suppress(torch.zeros(3, 4), 0.5)
    x = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        TV.cuda_device("nms", x)
    assert TV.nms_cost(torch.zeros(2, 10, 4), torch.zeros(2, 10,
                                                           dtype=torch.bool)
                       ) == (TV.IOU_OPS * 2 * 45, 2 * 10 * 16 + 20)
