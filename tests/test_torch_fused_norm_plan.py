"""The launch plan of the norm kernel (``ops/fused_norm.py::launch_plan``)
and the order in which its backward sums the weight, bias and pre-bias
gradients, on the CPU (the kernels run only on a card, where
``chip_smoke.py``'s ``fused_ops_check`` holds them against their plain
versions).

* the plan for every row width from 1 to ``MAX_COLS``, a range of row
  counts and SM counts, forward and backward, fp32 and bf16 rows: shared
  memory within the 227 KB a block can have and a CTA that fits an SM, the
  row-group ("ring") kernel only for 16-byte vectors and under its limits
  (chunks a thread, warps a group, two stages of rows in shared memory),
  its CTAs' row chunks covering every row exactly once;
* a plain model of the backward's order (each row group's rows in order,
  the CTA's groups in order, then the fold's eight lanes over the
  partials), built from the plan, against ``fused_norm_bwd_reference``'s
  dw, db and dpb within ``chip_smoke.FUSED_TOL``'s "sum" bound (the same
  sums in another order), RMS and LN, plain and fused orders; and the
  JAX package's ``fused_rms_norm`` / ``fused_layer_norm`` gradients of
  the weight and bias against the model, fp32, to summation order.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as paddle
from paddle_tpu.incubate import nn_functional as JF
from paddle_tpu_torch.ops import fused_norm as fn

f32, bf = torch.float32, torch.bfloat16
SMS = (3, 12, 132)
ROWS = (1, 5, 16, 100, 1000, 24576)


def _inputs(rows, cols, *, row_bytes, backward):
    """The plan's sizing inputs of the common specs: fp32 or bf16 rows,
    weight, bias and pre-bias (forward) or the three sums (backward)."""
    if backward:
        return dict(backward=True, row_bytes=row_bytes, cta_vecs=1,
                    group_vecs=3)
    return dict(row_bytes=row_bytes, cta_vecs=3)


def _check_plan(plan, rows, cols, vec, sms, backward):
    assert 0 < plan.smem <= fn.SMEM_BLOCK
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.grid >= 1 and plan.rows_per_cta >= 1
    # every row in exactly one CTA's chunk, no CTA without a row
    assert plan.grid * plan.rows_per_cta >= rows
    assert (plan.grid - 1) * plan.rows_per_cta < rows
    if not plan.ring:
        assert plan.threads == (32 * fn.group_warps(cols) if vec == 8
                                else fn._threads_for(cols))
        if not backward:
            assert plan.grid == rows and plan.rows_per_cta == 1
            if vec == 8 and plan.threads <= 512:
                # a row in registers: nc chunks a thread
                assert 1 <= plan.nc <= fn.NC_MAX
                assert plan.nc * plan.threads * 8 >= cols
            else:
                assert plan.nc == 0 and plan.smem == (cols + 32) * 4
        else:
            assert plan.smem == (5 * cols + 32) * 4
        return
    # the row-group kernel: 16-byte vectors, within its register limits
    assert vec == 8 and cols % 8 == 0
    assert plan.group_warps in (1, 2, 4, 8, 16)
    assert 1 <= plan.nc <= fn.NC_MAX
    assert 32 * plan.group_warps * plan.nc * 8 >= cols
    assert 32 * plan.group_warps * (plan.nc - 1) * 8 < cols
    assert plan.stages in (1, *fn.STAGES)
    assert plan.stages <= max(1, -(-plan.rows_per_cta // plan.groups))
    regs = fn.REGS_BWD if backward else fn.REGS_FWD
    assert plan.threads == plan.groups * plan.group_warps * 32 <= 256
    assert fn._ctas_an_sm(plan.threads, plan.smem, regs) >= 1
    assert plan.grid <= sms * fn._ctas_an_sm(plan.threads, plan.smem, regs)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("row_bytes", [2, 4], ids=["bf16", "fp32"])
def test_plan_for_every_width(sms, backward, row_bytes):
    rb = row_bytes * (3 if backward else 2)
    rings = 0
    for cols in range(1, fn.MAX_COLS + 1):
        for rows in ROWS[cols % len(ROWS):] + ROWS[:cols % len(ROWS)][:1]:
            for vec in ((8, 1) if cols % 8 == 0 else (1,)):
                plan = fn.launch_plan(rows, cols, vec, sms,
                                      **_inputs(rows, cols, row_bytes=rb,
                                                backward=backward))
                _check_plan(plan, rows, cols, vec, sms, backward)
                rings += plan.ring
        fn.launch_plan.cache_clear()
    assert rings > 0


@pytest.mark.parametrize("rows", [1, 7, 64, 333, 4096])
@pytest.mark.parametrize("cols", [8, 96, 768, 2560, 4096, 11264])
def test_ring_groups_cover_each_row_once(rows, cols):
    plan = fn.launch_plan(rows, cols, 8, 132, row_bytes=4, cta_vecs=3)
    seen = []
    for cta in range(plan.grid):
        first = cta * plan.rows_per_cta
        end = min(first + plan.rows_per_cta, rows)
        for g in range(plan.groups if plan.ring else 1):
            step = plan.groups if plan.ring else 1
            seen += range(first + g, end, step)
    assert sorted(seen) == list(range(rows))


@pytest.mark.parametrize("name,rows,cols,row_bytes,cta_vecs,group_vecs,ring", [
    # chip_smoke's cases: the row groups where 8-element vectors, rows for
    # every SM (a forward) and their shared memory fit, else the
    # block-per-row kernels
    ("llama_o2_residual_fwd", 24576, 2560, 4, 3, None, True),
    ("llama_o2_residual_bwd", 24576, 2560, 8, 1, 1, True),
    ("ernie_o2_residual_fwd", 4096, 768, 6, 3, None, True),
    ("ernie_o2_residual_bwd", 4096, 768, 8, 1, 2, True),
    ("fmt_prefill_ln", 512, 2560, 2, 3, None, True),
    ("serve_decode_bf16_residual", 16, 4096, 4, 3, None, False),
    ("serve_prefill_bf16", 1000, 4096, 2, 3, None, True),
    ("narrow_o2_residual_fwd", 16384, 512, 4, 3, None, True),
    ("narrow_o2_residual_bwd", 16384, 512, 8, 1, 1, True),
    ("wide_ln_bf16_residual_fwd", 2048, 2048, 4, 3, None, True),
    ("wide_ln_bf16_residual_bwd", 2048, 2048, 6, 1, 2, True),
    ("max_cols_fp32_fwd", 512, fn.MAX_COLS, 8, 3, None, False),
    ("max_cols_fp32_bwd", 512, fn.MAX_COLS, 12, 1, 2, False),
])
def test_plan_routes_the_card_cases(name, rows, cols, row_bytes, cta_vecs,
                                    group_vecs, ring):
    kw = dict(row_bytes=row_bytes, cta_vecs=cta_vecs)
    if group_vecs is not None:
        kw.update(backward=True, group_vecs=group_vecs)
    plan = fn.launch_plan(rows, cols, 8, 132, **kw)
    assert plan.ring is ring
    # rows of 770: no 8-element vectors, never the row groups
    assert not fn.launch_plan(rows, 770, 1, 132, **kw).ring


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("rows,cols", [(1, 2560), (16, 2560), (16, 4096),
                                       (131, 4096)])
def test_decode_rows_take_a_block_a_row(rows, cols, backward):
    # fewer rows than SMs: the forward a block a row, the row in registers;
    # the backward one row a CTA of the row groups, no prefetch
    p = fn.launch_plan(rows, cols, 8, 132, **_inputs(rows, cols, row_bytes=4,
                                                      backward=backward))
    assert p.threads == 32 * fn.group_warps(cols) == 256
    if backward:
        assert p.ring
        assert (p.grid, p.rows_per_cta, p.groups, p.stages) == (rows, 1, 1, 1)
    else:
        assert not p.ring and (p.grid, p.nc) == (rows, 2)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_row_layout_depends_on_cols_alone(backward):
    # a thread holds chunks t, t + T, ... of a row (T its block's or row
    # group's threads) and the warps' sums are added in order, so a row's
    # bits follow from T alone: T must not move with the rows in the call
    # (a tail prefill's rows are held against the full prompt's)
    for cols in range(8, fn.MAX_COLS + 1, 8):
        widths = set()
        for rows in (1, 16, 131, 132, 1000, 24576):
            for rb in (2, 4, 8):
                p = fn.launch_plan(rows, cols, 8, 132,
                                   **_inputs(rows, cols, row_bytes=rb,
                                             backward=backward))
                widths.add(32 * p.group_warps if p.ring else p.threads)
                if p.ring:
                    assert p.nc == -(-cols // (256 * p.group_warps))
        assert widths == {32 * fn.group_warps(cols)}, cols
        fn.launch_plan.cache_clear()


def fold_model(contrib: torch.Tensor, plan) -> torch.Tensor:
    """The backward's sum over rows of ``contrib`` (rows, cols) fp32 in
    the kernels' order: each row group's rows in order (the block-per-row
    kernel: the block's rows), the CTA's groups in order into its partial,
    then ``partial_fold_kernel``: lane j of eight adds partials j, j + 8,
    ... in order, the lanes are added in order."""
    rows, cols = contrib.shape
    zero = torch.zeros(cols, dtype=f32)
    parts = []
    groups = plan.groups if plan.ring else 1
    for cta in range(plan.grid):
        first = cta * plan.rows_per_cta
        end = min(first + plan.rows_per_cta, rows)
        part = None
        for g in range(groups):
            s = zero
            for r in range(first + g, end, groups):
                s = s + contrib[r]
            part = s if part is None else part + s
        parts.append(part)
    lanes = []
    for j in range(8):
        s = zero
        for i in range(j, len(parts), 8):
            s = s + parts[i]
        lanes.append(s)
    out = lanes[0]
    for s in lanes[1:]:
        out = out + s
    return out


SPECS = {
    "rms_o2_residual": (fn.NormSpec("rms", 1e-5, f32, f32, bf, f32), bf,
                        bf, None, None),
    "ln_o2_residual_prebias": (fn.NormSpec("ln", 1e-12, f32, f32, bf, f32,
                                           f32), bf, bf, bf, bf),
    "ln_bf16": (fn.NormSpec("ln", 1e-5, bf, bf, None, bf, bf), bf, None,
                None, bf),
    "rms_fused_bf16": (fn.NormSpec("rms", 1e-6, bf, bf, bf, bf, bf, True),
                       bf, bf, bf, bf),
    "ln_fused_fp32": (fn.NormSpec("ln", 1e-5, f32, f32, f32, f32, f32,
                                  True), f32, f32, f32, f32),
}


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_fold_order_model_matches_the_plain_backward(spec_name, sms):
    spec, xd, rd, pbd, bd = SPECS[spec_name]
    rows, cols = 300, 64
    rng = np.random.default_rng(7)

    def arr(shape, dt, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                                .astype(np.float32)).to(dt)
    x = arr((rows, cols), xd)
    res = None if rd is None else arr((rows, cols), rd)
    pb = None if pbd is None else arr((cols,), pbd, 0.1)
    w = arr((cols,), xd, 0.1, 1.0)
    dy = arr((rows, cols), spec.out)
    dres = None if spec.add is None else arr((rows, cols), spec.add)
    _, h = fn.fused_norm_reference(x, w, None, res, pb, spec=spec)
    h = x if h is None else h
    dx_dtype = xd if spec.add is None else spec.add
    dx, dw, db, dpb = fn.fused_norm_bwd_reference(
        dy, dres, h, w, spec=spec, dx_dtype=dx_dtype, bias_dtype=bd,
        pre_bias_dtype=pbd)
    sizes = [t.element_size() for t in (dy, h, dres) if t is not None]
    plan = fn.launch_plan(rows, cols, 8, sms, backward=True,
                          row_bytes=sum(sizes), cta_vecs=1,
                          group_vecs=1 + (bd is not None) + (pbd is not None))
    # the rows' contributions as the kernels form them
    hn = h.to(spec.norm).float()
    n, _ = fn._stats(hn, fn.NormSpec(spec.kind, spec.eps, spec.norm,
                                     spec.out))
    g = dy.float()
    wv = g * n if spec.fused else \
        (g * n.to(spec.norm).float()).to(spec.out).float()
    p_dt = f32 if spec.fused else spec.out
    got = fold_model(wv, plan).to(p_dt).to(spec.weight).to(w.dtype)
    ok, err = chip_smoke.fused_close(torch, got, dw, "sum")
    assert ok, (spec_name, err)
    if bd is not None:
        got = fold_model(g, plan).to(p_dt).to(spec.bias).to(bd)
        ok, err = chip_smoke.fused_close(torch, got, db, "sum")
        assert ok, (spec_name, err)
    if pbd is not None:
        got = fold_model(dx.float(), plan).to(spec.add).to(pbd)
        ok, err = chip_smoke.fused_close(torch, got, dpb, "sum")
        assert ok, (spec_name, err)


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("sms", SMS)
def test_fold_order_model_matches_jax_gradients(kind, sms):
    # the JAX package's fused_rms_norm / fused_layer_norm, fp32: the
    # weight (and bias) gradients against the model's sums of the rows'
    # contributions, to summation order
    rows, cols = 200, 96
    rng = np.random.default_rng(11)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    w = (rng.standard_normal(cols) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(cols) * 0.1).astype(np.float32)
    dy = rng.standard_normal((rows, cols)).astype(np.float32)
    jw, jb = paddle.to_tensor(w), paddle.to_tensor(b)
    jw.stop_gradient = jb.stop_gradient = False
    jfn = JF.fused_rms_norm if kind == "rms" else JF.fused_layer_norm
    y = jfn(paddle.to_tensor(x), jw, jb if kind == "ln" else None,
            epsilon=1e-5)
    (y * paddle.to_tensor(dy)).sum().backward()
    spec = fn.NormSpec(kind, 1e-5, f32, f32, None, f32,
                       f32 if kind == "ln" else None, True)
    n, _ = fn._stats(torch.from_numpy(x), spec)
    plan = fn.launch_plan(rows, cols, 8, sms, backward=True, row_bytes=8,
                          cta_vecs=1, group_vecs=1 + (kind == "ln"))
    g = torch.from_numpy(dy)
    np.testing.assert_allclose(fold_model(g * n, plan).numpy(),
                               np.asarray(jw.grad._data, np.float32),
                               rtol=1e-4, atol=1e-4)
    if kind == "ln":
        np.testing.assert_allclose(fold_model(g, plan).numpy(),
                                   np.asarray(jb.grad._data, np.float32),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("est_ms,calls", [(0.001, 64), (0.004, 64),
                                          (0.05, 20), (0.26, 4), (0.7, 3),
                                          (5.0, 3)])
def test_timing_graph_holds_about_a_millisecond(est_ms, calls):
    # chip_smoke.graph_ms times a captured graph of calls: enough calls for
    # about GRAPH_MS of the card's time, at least 3 and at most
    # GRAPH_CALLS_MAX (its outputs stay in the graph's pool)
    assert chip_smoke.graph_calls(est_ms) == calls


def test_variant_tool_covers_every_timed_case():
    # tools/ab_norm_variants.py names the instantiation each of K1's timed
    # cases takes; the plan must route each case where the name says
    from paddle_tpu_torch.tools import ab_norm_variants as abv
    cases = chip_smoke.norm_timed_cases(torch, fn)
    assert set(abv.FIXED) == {c[0] for c in cases}
    for name, rows, cols, xd, rd, wd, bd, spec, bwd in cases:
        row_bytes = xd.itemsize + (0 if rd is None else rd.itemsize)
        plan = fn.launch_plan(rows, cols, 8, 132, row_bytes=row_bytes,
                              cta_vecs=3)
        fwd, back = abv.FIXED[name]
        assert fwd.endswith("ring") is plan.ring, name
        assert (back is not None) <= bwd, name


@pytest.mark.parametrize("rows,cols,warps", [(16384, 512, 1),
                                             (2048, 2048, 4),
                                             (4096, 768, 2),
                                             (24576, 2560, 8)])
def test_card_cases_prefetch_at_each_group_width(rows, cols, warps):
    # chip_smoke.check_fused_norm's forwards reach the bulk-copy ring with
    # rows ahead (stages > 1) at groups of one, two, four and eight warps
    # (one warp: its stage reuse waits on __syncwarp, not the exchange)
    plan = fn.launch_plan(rows, cols, 8, 132, row_bytes=4, cta_vecs=3)
    assert plan.ring and plan.group_warps == warps and plan.stages > 1
