"""Every function of the port's ``ops/conv_pool.py`` against
``paddle_tpu.ops.conv_pool`` on the CPU in fp32, inputs and cotangents
from a seeded numpy generator: the output and the gradients of ``sum(out *
cot)`` with respect to each float input, within 1e-5 of each element plus
1e-5 of the largest (the products and window sums run in another order in
XLA and oneDNN). Convolutions over strides, int / per-axis / per-side
padding, ``SAME`` and ``VALID``, dilation, groups and channels-last;
transposed convolutions over the same and ``output_padding`` (and the 3-D
``output_size``); pools over ``ceil_mode``, ``exclusive``,
``divisor_override``, ``return_mask`` and channels-last; adaptive pools at
sizes that do not divide the input; ``interpolate`` in every mode up and
down; the shuffles, ``unfold`` and ``fold``."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import conv_pool as J
from paddle_tpu_torch.ops import conv_pool as T


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _run_j(fn, arrays, kw, cot_seed):
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts, **kw)
    main = out[0] if isinstance(out, tuple) else out
    cot = _arr(main._data.shape, cot_seed)
    (main * paddle.to_tensor(cot)).sum().backward()
    extra = [np.asarray(o._data) for o in out[1:]] \
        if isinstance(out, tuple) else []
    return (np.asarray(main._data), [np.asarray(t.grad._data) for t in ts],
            extra)


def _run_t(fn, arrays, kw, cot_seed):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts, **kw)
    main = out[0] if isinstance(out, tuple) else out
    cot = _arr(tuple(main.shape), cot_seed)
    (main * torch.from_numpy(cot)).sum().backward()
    extra = [o.numpy() for o in out[1:]] if isinstance(out, tuple) else []
    return main.detach().numpy(), [t.grad.numpy() for t in ts], extra


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()),
                                               1e-30))


def _check(name, arrays, kw, seed=0):
    jo, jg, je = _run_j(getattr(J, name), arrays, kw, 100 + seed)
    to, tg, te = _run_t(getattr(T, name), arrays, kw, 100 + seed)
    _close(to, jo)
    for a, b in zip(tg, jg):
        _close(a, b)
    for a, b in zip(te, je):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


CONV_CASES = {
    # name: fn, x shape, w shape, bias, kwargs
    "1d_stride2_pad1": ("conv1d", (2, 4, 11), (6, 4, 3), True,
                        dict(stride=2, padding=1)),
    "1d_same_dil2": ("conv1d", (2, 4, 11), (6, 4, 3), False,
                     dict(padding="SAME", dilation=2)),
    "1d_nlc": ("conv1d", (2, 11, 4), (6, 4, 3), True,
               dict(padding=1, data_format="NLC")),
    "2d_stride2_pad3": ("conv2d", (2, 3, 13, 12), (8, 3, 7, 7), False,
                        dict(stride=2, padding=3)),
    "2d_list_pad": ("conv2d", (2, 4, 9, 10), (6, 4, 3, 2), True,
                    dict(padding=[1, 0])),
    "2d_per_side_pad": ("conv2d", (2, 4, 9, 10), (6, 4, 3, 3), True,
                        dict(padding=[0, 2, 1, 1], stride=(2, 1))),
    "2d_same_stride2": ("conv2d", (2, 4, 9, 10), (6, 4, 3, 3), True,
                        dict(padding="SAME", stride=2)),
    "2d_valid": ("conv2d", (2, 4, 9, 10), (6, 4, 3, 3), False,
                 dict(padding="VALID")),
    "2d_dilation_groups": ("conv2d", (2, 6, 11, 11), (9, 2, 3, 3), True,
                           dict(padding=2, dilation=2, groups=3)),
    "2d_depthwise": ("conv2d", (2, 4, 8, 8), (4, 1, 3, 3), False,
                     dict(padding=1, groups=4)),
    "2d_nhwc": ("conv2d", (2, 9, 10, 4), (6, 4, 3, 3), True,
                dict(padding=1, stride=2, data_format="NHWC")),
    "3d_stride": ("conv3d", (2, 3, 6, 7, 5), (4, 3, 3, 3, 2), True,
                  dict(stride=(1, 2, 1), padding=1)),
    "3d_ndhwc_same": ("conv3d", (1, 6, 7, 5, 3), (4, 3, 3, 3, 3), False,
                      dict(padding="SAME", data_format="NDHWC")),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_jax(case):
    fn, xs, ws, bias, kw = CONV_CASES[case]
    arrays = [_arr(xs, 1), _arr(ws, 2) * 0.3]
    if bias:
        arrays.append(_arr((ws[0],), 3))
    _check(fn, arrays, kw)


TRANSPOSE_CASES = {
    # name: fn, x shape, w shape (in, out / groups, *k), bias, kwargs
    "2d_stride2": ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3), True,
                   dict(stride=2, padding=1)),
    "2d_output_padding": ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3),
                          False, dict(stride=2, padding=1,
                                      output_padding=1)),
    "2d_groups_dilation": ("conv2d_transpose", (2, 4, 5, 5), (4, 2, 3, 3),
                           True, dict(stride=2, groups=2, dilation=2)),
    "2d_per_side_pad": ("conv2d_transpose", (2, 3, 5, 5), (3, 2, 3, 3),
                        False, dict(padding=[1, 0, 0, 1], stride=2)),
    "3d_stride": ("conv3d_transpose", (1, 3, 3, 4, 3), (3, 2, 3, 3, 3),
                  True, dict(stride=2, padding=1)),
    "3d_output_size": ("conv3d_transpose", (1, 3, 3, 4, 3), (3, 2, 3, 3, 3),
                       False, dict(stride=2, padding=1,
                                   output_size=[6, 8, 6])),
}


@pytest.mark.parametrize("case", sorted(TRANSPOSE_CASES))
def test_conv_transpose_matches_jax(case):
    fn, xs, ws, bias, kw = TRANSPOSE_CASES[case]
    arrays = [_arr(xs, 4), _arr(ws, 5) * 0.3]
    if bias:
        arrays.append(_arr((ws[1] * kw.get("groups", 1),), 6))
    _check(fn, arrays, kw)


def test_conv_transpose_refuses_string_padding_as_jax_does():
    x, w = _arr((1, 3, 5, 5), 4), _arr((3, 2, 3, 3), 5)
    with pytest.raises(ValueError, match="String padding"):
        J.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                           padding="SAME", stride=2)
    with pytest.raises(ValueError, match="string padding"):
        T.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                           padding="SAME", stride=2)


POOL_CASES = {
    # name: fn, x shape, kwargs
    "max1d": ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                            padding=1)),
    "max1d_ceil": ("max_pool1d", (2, 3, 10), dict(kernel_size=3, stride=2,
                                                 ceil_mode=True)),
    "max1d_mask": ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                                 padding=1,
                                                 return_mask=True)),
    "max2d_resnet_stem": ("max_pool2d", (2, 3, 12, 12),
                          dict(kernel_size=3, stride=2, padding=1)),
    "max2d_ceil": ("max_pool2d", (2, 3, 11, 10),
                   dict(kernel_size=3, stride=2, ceil_mode=True)),
    "max2d_same": ("max_pool2d", (2, 3, 11, 10),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "max2d_big_pad": ("max_pool2d", (2, 3, 9, 9),
                      dict(kernel_size=2, stride=2, padding=[1, 0])),
    "max2d_nhwc": ("max_pool2d", (2, 9, 8, 3),
                   dict(kernel_size=2, data_format="NHWC")),
    "max2d_mask": ("max_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding=1,
                        return_mask=True)),
    "max3d": ("max_pool3d", (1, 2, 6, 7, 5),
              dict(kernel_size=2, stride=2, ceil_mode=True)),
    "avg1d_exclusive_pad": ("avg_pool1d", (2, 3, 11),
                            dict(kernel_size=3, stride=2, padding=1)),
    "avg1d_inclusive_ceil": ("avg_pool1d", (2, 3, 10),
                             dict(kernel_size=3, stride=2, padding=1,
                                  exclusive=False, ceil_mode=True)),
    "avg2d_plain": ("avg_pool2d", (2, 3, 8, 8), dict(kernel_size=2)),
    "avg2d_exclusive_pad_ceil": ("avg_pool2d", (2, 3, 11, 10),
                                 dict(kernel_size=3, stride=2, padding=1,
                                      ceil_mode=True)),
    "avg2d_inclusive_pad": ("avg_pool2d", (2, 3, 11, 10),
                            dict(kernel_size=3, stride=2, padding=1,
                                 exclusive=False)),
    "avg2d_divisor": ("avg_pool2d", (2, 3, 11, 10),
                      dict(kernel_size=3, stride=2, padding=1,
                           divisor_override=4)),
    "avg2d_same": ("avg_pool2d", (2, 3, 11, 10),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "avg2d_nhwc": ("avg_pool2d", (2, 9, 8, 3),
                   dict(kernel_size=3, stride=2, padding=1,
                        data_format="NHWC")),
    "avg3d": ("avg_pool3d", (1, 2, 6, 7, 5),
              dict(kernel_size=2, stride=2, padding=1, ceil_mode=True)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_jax(case):
    fn, xs, kw = POOL_CASES[case]
    _check(fn, [_arr(xs, 7)], kw)


ADAPTIVE_CASES = {
    "avg1d_7_to_3": ("adaptive_avg_pool1d", (2, 3, 7), dict(output_size=3)),
    "avg2d_resnet_head": ("adaptive_avg_pool2d", (2, 8, 7, 7),
                          dict(output_size=(1, 1))),
    "avg2d_10x9_to_4x5": ("adaptive_avg_pool2d", (2, 3, 10, 9),
                          dict(output_size=(4, 5))),
    "avg2d_nhwc": ("adaptive_avg_pool2d", (2, 10, 9, 3),
                   dict(output_size=(3, 4), data_format="NHWC")),
    "avg3d": ("adaptive_avg_pool3d", (1, 2, 5, 7, 6),
              dict(output_size=(2, 3, 4))),
    "max1d": ("adaptive_max_pool1d", (2, 3, 9), dict(output_size=4)),
    "max2d": ("adaptive_max_pool2d", (2, 3, 10, 9),
              dict(output_size=(3, 4))),
    "max3d": ("adaptive_max_pool3d", (1, 2, 5, 7, 6),
              dict(output_size=(2, 3, 4))),
}


@pytest.mark.parametrize("case", sorted(ADAPTIVE_CASES))
def test_adaptive_pool_matches_jax(case):
    fn, xs, kw = ADAPTIVE_CASES[case]
    _check(fn, [_arr(xs, 8)], kw)


def test_adaptive_max_refuses_return_mask_as_jax_does():
    x = torch.zeros(1, 1, 4, 4)
    for fn in (T.adaptive_max_pool1d, T.adaptive_max_pool2d,
               T.adaptive_max_pool3d):
        with pytest.raises(NotImplementedError):
            fn(x, 2, return_mask=True)
    with pytest.raises(NotImplementedError):
        T.max_pool2d(x, 2, return_mask=True, ceil_mode=True)


INTERP_CASES = {
    "nearest_up": ((2, 3, 5, 6), dict(size=(9, 13), mode="nearest")),
    "nearest_down": ((2, 3, 9, 8), dict(size=(4, 3), mode="nearest")),
    "bilinear_up": ((2, 3, 5, 6), dict(scale_factor=2, mode="bilinear")),
    "bilinear_down": ((2, 3, 11, 9), dict(size=(4, 5), mode="bilinear")),
    "bicubic_up": ((2, 3, 5, 6), dict(size=(8, 11), mode="bicubic")),
    "bicubic_down": ((2, 3, 11, 9), dict(size=(5, 4), mode="bicubic")),
    "area": ((2, 3, 8, 8), dict(size=(3, 3), mode="area")),
    "linear_1d": ((2, 3, 7), dict(size=12, mode="linear",
                                  data_format="NCW")),
    "trilinear": ((1, 2, 4, 5, 3), dict(size=(6, 3, 5), mode="trilinear",
                                        data_format="NCDHW")),
    "bilinear_nhwc": ((2, 5, 6, 3), dict(size=(7, 4), mode="bilinear",
                                         data_format="NHWC")),
}


@pytest.mark.parametrize("case", sorted(INTERP_CASES))
def test_interpolate_matches_jax(case):
    xs, kw = INTERP_CASES[case]
    _check("interpolate", [_arr(xs, 9)], kw)
    _check("upsample", [_arr(xs, 9)], kw)


SHUFFLE_CASES = {
    "pixel_shuffle": ("pixel_shuffle", (2, 8, 3, 4), dict(upscale_factor=2)),
    "pixel_unshuffle": ("pixel_unshuffle", (2, 2, 6, 4),
                        dict(downscale_factor=2)),
    "channel_shuffle": ("channel_shuffle", (2, 6, 3, 4), dict(groups=3)),
    "unfold": ("unfold", (2, 3, 7, 6),
               dict(kernel_sizes=3, strides=2, paddings=1, dilations=1)),
    "unfold_dilated": ("unfold", (2, 2, 8, 8),
                       dict(kernel_sizes=[2, 3], strides=1, paddings=0,
                            dilations=2)),
    "fold": ("fold", (2, 3 * 3 * 3, 16),
             dict(output_sizes=(7, 7), kernel_sizes=3, strides=2,
                  paddings=1)),
}


@pytest.mark.parametrize("case", sorted(SHUFFLE_CASES))
def test_shuffles_unfold_fold_match_jax(case):
    fn, xs, kw = SHUFFLE_CASES[case]
    _check(fn, [_arr(xs, 10)], kw)


def test_shuffles_refuse_channels_last_as_jax_does():
    x = torch.zeros(1, 4, 4, 4)
    for fn, arg in ((T.pixel_shuffle, 2), (T.pixel_unshuffle, 2),
                    (T.channel_shuffle, 2)):
        with pytest.raises(ValueError, match="layout"):
            fn(x, arg, data_format="NHWC")
