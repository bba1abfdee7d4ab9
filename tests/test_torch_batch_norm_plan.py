"""K10's launch planner (``ops/batch_norm.py``: ``bn_plan`` and the
backward's choice of paths), held on the CPU: a numpy walk of the map the
kernels in ``csrc/batch_norm.cu`` follow, from (block, thread, vector lane)
to element, covers every element of the view exactly once, with the
element's channel the one whose statistics the thread keeps, for

* every BN shape of ResNet-50 at batch 64, 224 x 224 (NCHW) and of
  PP-YOLOE-l (``PPYOLOEConfig.l(80)``) at batch 8, 640 x 640 (NHWC), in
  fp32 and in O2's bf16, written out below and held against the shapes the
  two models' batch norms see (at a smaller image, scaled);
* odd shapes: 3, 5 and 33 channels, S of 49 and 1, a misaligned base;

every main-path shape takes its mode's 16-byte vectors; grids and shared
memory stay within the card's limits; and the backward writes the
residual's gradient from its reduce only where it is exact.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import batch_norm as K10

BF16, F32 = torch.bfloat16, torch.float32

# the distinct input shapes of ResNet-50's 53 batch norms at batch 64,
# 224 x 224 (N, C, H, W)
RESNET50_BN = (
    (64, 64, 112, 112), (64, 64, 56, 56), (64, 128, 56, 56),
    (64, 256, 56, 56), (64, 128, 28, 28), (64, 256, 28, 28),
    (64, 512, 28, 28), (64, 256, 14, 14), (64, 512, 14, 14),
    (64, 1024, 14, 14), (64, 512, 7, 7), (64, 2048, 7, 7))
# the distinct input shapes of PP-YOLOE-l's 144 batch norms at batch 8,
# 640 x 640 (N, H, W, C)
PPYOLOE_L_BN = (
    (8, 320, 320, 32), (8, 320, 320, 64), (8, 160, 160, 48),
    (8, 160, 160, 96), (8, 160, 160, 128), (8, 80, 80, 96),
    (8, 80, 80, 192), (8, 80, 80, 256), (8, 40, 40, 192),
    (8, 40, 40, 384), (8, 40, 40, 512), (8, 20, 20, 384),
    (8, 20, 20, 768), (8, 20, 20, 1024))
# the modes of the main paths: PP-YOLOE trains and serves in fp32, ResNet
# under O2 (x bf16, the norm's rounding points fp32, the tail bf16)
MODE_OF = {F32: "fp32", BF16: "bf16"}
# resident blocks the walk assumes for the card (the kernels take the
# occupancy of each kernel on the card itself)
RESIDENT = (528, 7)


def _geo(shape, fmt):
    return K10.bn_geometry(torch.empty(shape, device="meta"), fmt)


def _grid_x(chunks: int, fit: int) -> int:
    """``grid_of``'s blocks a channel or group: the fewest rounds of chunks
    the resident blocks allow, the fewest blocks for that many rounds."""
    fit = max(1, fit)
    rounds = -(-chunks // fit)
    return -(-chunks // rounds)


def _blocks_take_each_chunk_once(chunks: int, gx: int) -> None:
    taken = np.concatenate([np.arange(x, chunks, gx) for x in range(gx)])
    np.testing.assert_array_equal(np.sort(taken), np.arange(chunks))
    counts = [len(range(x, chunks, gx)) for x in range(gx)]
    assert max(counts) - min(counts) <= 1


def _walk_col(plan) -> None:
    """The col kernels' rows and columns (``ColPos``, the chunk loop):
    thread row ty of the block for chunk q takes rows q rpc + ty, + ty_n,
    ... below the chunk's end; thread tx the columns grp W + tx V + lane of
    its group, live below C S. Rows and live columns each once, the row
    stride C S, a column's channel grp k + (tx V + lane) // S that of its
    element, and each channel's partial written by one thread of one
    group."""
    n, s, c = plan.n, plan.s, plan.c
    assert plan.rstride == c * s and plan.rows * c * s == n * c
    q = np.arange(plan.chunks)[:, None, None]
    ty = np.arange(plan.ty)[None, :, None]
    m = np.arange(-(-plan.rpc // plan.ty))[None, None, :]
    r = q * plan.rpc + ty + m * plan.ty
    end = np.minimum((q + 1) * plan.rpc, plan.rows)
    rows = r[r < end]
    np.testing.assert_array_equal(np.sort(rows), np.arange(plan.rows))
    grp = np.arange(plan.groups)[:, None, None]
    tx = np.arange(plan.tx)[None, :, None]
    lane = np.arange(plan.vec)[None, None, :]
    col = grp * plan.width + tx * plan.vec + lane
    chan = grp * plan.k + (tx * plan.vec + lane) // s
    live = col < c * s
    assert (live == (col - (col % plan.vec) < c * s)).all()  # whole vectors
    np.testing.assert_array_equal(np.sort(col[live]), np.arange(c * s))
    np.testing.assert_array_equal(chan[live], col[live] // s)
    # the partials: thread t < chs of group grp writes channel grp k + t
    slots = np.concatenate([grp_ * plan.k + np.arange(min(plan.k,
                                                          c - grp_ * plan.k))
                            for grp_ in range(plan.groups)])
    np.testing.assert_array_equal(slots, np.arange(c))


def _walk_run(plan, seen: np.ndarray) -> None:
    """The run kernels' elements (``Walk``): chunk k's thread t, vector i
    and lane take element j = k RUN_CHUNK + i 256 V + t V + lane of each
    channel, valid below n; the element at ((j // S) C + c) S + j % S of
    the NCHW tensor. Every element of every channel once (``seen``, a
    bitmap of the tensor)."""
    n, s, c, v = plan.n, plan.s, plan.c, plan.vec
    assert s % v == 0 and K10.RUN_CHUNK % (K10.THREADS * v) == 0
    k = np.arange(plan.chunks)[:, None, None, None]
    i = np.arange(K10.RUN_CHUNK // (K10.THREADS * v))[None, :, None, None]
    t = np.arange(K10.THREADS)[None, None, :, None]
    lane = np.arange(v)[None, None, None, :]
    j = (k * K10.RUN_CHUNK + i * K10.THREADS * v + t * v + lane).ravel()
    j = j[j < n]
    np.testing.assert_array_equal(np.sort(j), np.arange(n))
    # a vector never leaves its image's run
    first = j[j % v == 0]
    assert ((first % s) + v <= s).all()
    total = 0
    for ch in range(c):
        addr = ((j // s) * c + ch) * s + j % s
        assert ((addr // s) % c == ch).all()
        seen[addr] = True
        total += addr.size
    assert total == seen.size and seen.all()


def _check_plan(plan, numel: int) -> None:
    assert plan.n * plan.c == numel
    # the card's limits: a grid's y holds 65535 blocks, a block at most
    # THREADS (the kernels' launch bound), shared memory 227 KB
    assert plan.grid[1] <= 65535 and plan.grid[0] < 2 ** 31
    assert 1 <= plan.threads <= K10.THREADS
    assert K10.COL_SMEM_BYTES <= 48 * 1024 <= 227 * 1024
    if plan.route != "run":
        assert plan.tx * plan.vec == plan.width == plan.k * plan.s
        assert plan.ty >= 1 and plan.tx * plan.ty <= K10.THREADS
        # the col kernels keep V values a thread of the block in shared
        # memory (COL_SMEM = THREADS 8 floats a row)
        assert plan.tx * plan.ty * plan.vec <= K10.THREADS * 8
    for fit in RESIDENT:
        gx = _grid_x(plan.chunks, fit // plan.grid[1])
        assert 1 <= gx <= plan.chunks
        _blocks_take_each_chunk_once(plan.chunks, gx)
        # the partials the reduce writes fit the buffer the wrapper sizes
        assert gx * plan.c * 3 <= plan.partials(3)


def _walk(plan, numel: int) -> None:
    _check_plan(plan, numel)
    if plan.route == "run":
        _walk_run(plan, np.zeros(numel, dtype=bool))
    else:
        _walk_col(plan)


MAIN = [("resnet50", s, "NCHW", dt) for s in RESNET50_BN
        for dt in (BF16, F32)] \
    + [("ppyoloe_l", s, "NHWC", dt) for s in PPYOLOE_L_BN
       for dt in (F32, BF16)]


@pytest.mark.parametrize(
    "model,shape,fmt,dtype", MAIN,
    ids=[f"{m}-{'x'.join(map(str, s))}-{str(d)[6:]}" for m, s, _, d in MAIN])
def test_main_path_plans_cover_every_element_once_at_16_bytes(model, shape,
                                                             fmt, dtype):
    geo = _geo(shape, fmt)
    plan = K10.bn_plan(geo, MODE_OF[dtype], (16,) * 3)
    assert plan.mode == MODE_OF[dtype]
    assert plan.vec * torch.empty(0, dtype=dtype).element_size() == 16
    assert plan.route == ("cl" if fmt == "NHWC" else
                          "run" if geo[1] >= K10.RUN_MIN_S else "group")
    _walk(plan, math.prod(shape))


ODD = {
    # name: shape, data_format, mode, alignments, route, vec
    "nhwc_c3": ((2, 5, 7, 3), "NHWC", "fp32", (16, 16), "cl", 1),
    "nhwc_c5_bf16": ((2, 5, 7, 5), "NHWC", "bf16", (16, 16), "cl", 1),
    "nhwc_c33": ((2, 5, 7, 33), "NHWC", "fp32", (16, 16), "cl", 1),
    "nhwc_c36": ((2, 5, 7, 36), "NHWC", "fp32", (16, 16), "cl", 4),
    "nchw_c3_s49": ((4, 3, 7, 7), "NCHW", "fp32", (16, 16), "group", 1),
    "nchw_c5_s49_bf16": ((4, 5, 7, 7), "NCHW", "bf16", (16, 16), "group",
                         1),
    "nchw_c33_s49": ((4, 33, 7, 7), "NCHW", "fp32", (16, 16), "group", 1),
    "nchw_c32_s49": ((4, 32, 7, 7), "NCHW", "fp32", (16, 16), "group", 4),
    "nc_s1": ((16, 6), "NCL", "fp32", (16, 16), "cl", 1),
    "nchw_s300": ((2, 3, 20, 15), "NCHW", "fp32", (16, 16), "group", 4),
    "nchw_s289": ((2, 4, 17, 17), "NCHW", "bf16", (16, 16), "run", 1),
    "nchw_s1024": ((2, 8, 32, 32), "NCHW", "bf16", (16, 16), "run", 8),
    "misaligned_nhwc": ((8, 20, 20, 32), "NHWC", "fp32", (16, 8), "cl", 1),
    "misaligned_nchw": ((4, 64, 28, 28), "NCHW", "bf16", (4, 16), "run",
                        1),
    "fp16_generic": ((4, 64, 28, 28), "NCHW", "generic", (16, 16), "run",
                     1),
}


@pytest.mark.parametrize("case", sorted(ODD))
def test_odd_shapes_narrow_the_vector_and_still_cover(case):
    shape, fmt, mode, aligns, route, vec = ODD[case]
    plan = K10.bn_plan(_geo(shape, fmt), mode, aligns)
    assert (plan.route, plan.vec) == (route, vec)
    assert plan.mode == (mode if vec > 1 else "generic")
    _walk(plan, math.prod(shape))


def _bn_input_shapes(model, x, scale, batch):
    from paddle_tpu_torch.nn.norm import _BatchNormBase
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod.data_format,
                                       tuple(args[0].shape))))
        for m in model.modules() if isinstance(m, _BatchNormBase)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return seen, {(batch, s[1], s[2] * scale, s[3] * scale)
                  if fmt.startswith("NC") else
                  (batch, s[1] * scale, s[2] * scale, s[3])
                  for fmt, s in seen}


def test_written_shapes_are_resnet50s_batch_norms():
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(num_classes=10, device="cpu", seed=0).eval()
    seen, shapes = _bn_input_shapes(model, torch.zeros(1, 3, 32, 32), 7,
                                    64)
    assert len(seen) == 53 and {f for f, _ in seen} == {"NCHW"}
    assert shapes == set(RESNET50_BN)


def test_written_shapes_are_ppyoloe_ls_batch_norms():
    from paddle_tpu_torch.models import PPYOLOE, PPYOLOEConfig
    model = PPYOLOE(PPYOLOEConfig.l(80), device="cpu", seed=0).eval()
    seen, shapes = _bn_input_shapes(model, torch.zeros(1, 64, 64, 3), 10, 8)
    assert len(seen) == 144 and {f for f, _ in seen} == {"NHWC"}
    assert shapes == set(PPYOLOE_L_BN)


@pytest.mark.parametrize("S,step", [(3136, 2048), (784, 2048), (300, 256),
                                    (12544, 1024), (49, 256)])
def test_walk_advances_as_a_divide_would(S, step):
    """``Walk``: one divide for a thread's first vector, then the image and
    offset advanced by additions, equal to j // S and j % S throughout."""
    for j0 in (0, 8, 12344, 98303):
        nn, s = divmod(j0, S)
        j = j0
        for _ in range(40):
            assert (nn, s) == divmod(j, S)
            j += step
            s += step
            while s >= S:
                s -= S
                nn += 1


def test_modes_of_the_launch_dtypes():
    o2 = dict(x=BF16, w=BF16, b=BF16, out=BF16, dy=BF16, dx=BF16, r=BF16,
              dres=BF16, norm=F32, wmul=F32, badd=F32, act=BF16)
    assert K10._mode(o2) == "bf16"
    assert K10._mode({**o2, "out": F32, "act": None}) == "bf16"
    assert K10._mode({k: F32 for k in o2}) == "fp32"
    assert K10._mode({**o2, "norm": BF16}) == "generic"
    assert K10._mode({**o2, "x": torch.float16, "out": torch.float16,
                      "act": torch.float16}) == "generic"
    assert K10._mode({**o2, "dres": torch.float16}) == "generic"
    # the weight's and bias's dtypes are read once a thread: any
    assert K10._mode({**o2, "w": torch.float16, "dw": torch.float16}) \
        == "bf16"
    codes, mode = K10._codes("add_relu", **o2)
    assert mode == "bf16" and list(codes) == [
        1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 1, K10.TAILS.index("add_relu")]


def test_backward_takes_g_from_the_residuals_gradient_only_where_exact():
    x = torch.zeros(2, 3, 4, 4)
    t = torch.zeros(3)
    spec = K10.bn_spec(x, t, t, x, "relu")
    assert spec.tail == "add_relu" and spec.act == F32
    r16 = torch.zeros(2, 3, 4, 4, dtype=BF16)
    # the reduce runs (batch statistics, or dw / db) and dres has the
    # tail's dtype: g goes through dres
    assert K10._gres(spec, t, t, x, x, True)
    assert K10._gres(spec, None, None, x, x, True)
    assert K10._gres(spec, t, None, None, x, False)
    # no reduce, no dres, or a narrower dres: the apply computes g
    assert not K10._gres(spec, None, None, x, x, False)
    assert not K10._gres(spec, t, t, x, None, True)
    assert not K10._gres(spec, t, t, x, r16, True)
    assert not K10._reduces(None, None, x, False)
    assert K10._reduces(None, None, x, True)
