"""The launch plans of the masked-softmax and bias-activation kernels
(``ops/softmax_mask.py::launch_plan``, ``ops/bias_act.py::launch_plan``) on
the CPU, where the kernels do not run (``chip_smoke.py``'s
``ernie_ops_check`` holds them against their plain versions on a card).

* softmax_mask: a model of the kernel's mapping (a warp an item of ``rpw``
  rows, consecutive or one (b, q) over ``rpw`` heads; lane L holding keys
  L + 32 k) built from the plan, at the check's shapes (Lk 128, 200 and 77,
  a 3-D mask) and at the edges (Lk 1, 32, 33, 1024 and 1025), forward and
  backward, every plan the kernels are built for: every (row, key) owned
  exactly once, by lane ``key mod 32``; a head-major item's rows share
  their mask row;
* bias_act: the model of the grid (CTAs of a column strip by ``ty`` warps
  of ``rt`` rows, runs that never cross a bias period): every (row,
  column) covered exactly once, forward and backward, at vector 8 and
  vector 1 (width 1001), with one bias row and with period 512 over 8192
  rows; each row's partial lands in its own period's slots, the fold reads
  a bias row's slots in a fixed order, and that order's sums give the
  plain version's bias gradient; the wrapper hands the plan to the C entry
  points with a bias and without one;
* both wrappers raise for a tensor of 2^31 elements or more.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import bias_act as ba
from paddle_tpu_torch.ops import softmax_mask as sm

f32, bf = torch.float32, torch.bfloat16
SMS = (3, 132)


# ---------------------------------------------------------------------------
# softmax_mask
# ---------------------------------------------------------------------------

def sm_item_rows(plan, heads, lq):
    """The kernel's ``item_rows`` for every item at once: ``(row, b, h,
    q)``, each ``(items, rpw)``, the first row found by division, the
    others by stepping."""
    r = plan.rpw
    item = np.arange(plan.items, dtype=np.int64)
    if plan.head_major:
        q, g = item % lq, item // lq
        b = g * r // heads
        h = g * r - b * heads
    else:
        row = item * r
        bh = row // lq
        q = row - bh * lq
        b, h = bh // heads, bh % heads
    cols = []
    for _ in range(r):
        cols.append(((b * heads + h) * lq + q, b, h, q))
        if plan.head_major:
            h = h + 1
        else:
            q = q + 1
            wrap = q == lq
            q = np.where(wrap, 0, q)
            h = h + wrap
            wrap_h = h == heads
            h = np.where(wrap_h, 0, h)
            b = b + wrap_h
    return tuple(np.stack([c[i] for c in cols], 1) for i in range(4))


def sm_keys(plan, lk):
    """``(lane, key)`` of every key a lane holds in a row: keys lane + 32 k
    for k < elems (the looping kernel: every k that reaches a key)."""
    ks = plan.elems if plan.elems else -(-lk // 32)
    lane = np.repeat(np.arange(32), ks)
    key = lane + 32 * np.tile(np.arange(ks), 32)
    keep = key < lk
    return lane[keep], key[keep]


def sm_check(plan, rows, lk, heads, lq):
    """Every (row, key) owned once, by lane key mod 32; returns the items'
    ``(row, b, h, q)``."""
    assert plan.threads % 32 == 0 and plan.threads <= sm.MAX_THREADS
    warps = plan.grid * (plan.threads // 32)
    assert warps >= plan.items and warps - plan.threads // 32 < plan.items
    its = sm_item_rows(plan, heads, lq)
    row = its[0]
    live = row[row < rows]
    # each row in exactly one item's live rows, ...
    assert np.array_equal(np.bincount(live, minlength=rows),
                          np.ones(rows, dtype=np.int64))
    # ... and in that row each key held once, by lane key mod 32 (the
    # plain sum's order: lane L adds keys L, L + 32, ...)
    lane, key = sm_keys(plan, lk)
    assert np.array_equal(np.bincount(key, minlength=lk),
                          np.ones(lk, dtype=np.int64))
    assert (lane == key % 32).all()
    if plan.elems:
        assert lk <= 32 * plan.elems
        assert plan.elems == min(e for e in sm.ELEMS if lk <= 32 * e)
    else:
        assert lk > 32 * sm.ELEMS[-1] and plan.rpw == 1
    assert plan.rpw in sm.RPW_CHOICES[plan.elems]
    return its


# (name, x shape, mask shape or None (the upper triangle)): the check's
SM_CASES = [("ernie", (32, 12, 128, 128), (32, 1, 128, 128)),
            ("ernie_heads_mask", (2, 12, 128, 128), (2, 12, 128, 128)),
            ("upper_triangle", (8, 12, 128, 128), None),
            ("upper_triangle_lq_lt_lk", (2, 4, 64, 200), None),
            ("mask_3d_width_77", (3, 50, 77), (3, 50, 77))]


def _as4d(shape):
    return tuple(sm._as4d(torch.empty(shape, device="meta")).shape)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("name,shape,mshape", SM_CASES,
                         ids=[c[0] for c in SM_CASES])
def test_softmax_mask_plan_owns_each_key_once_at_the_checks(
        name, shape, mshape, backward):
    _, heads, lq, lk = _as4d(shape)
    rows = int(np.prod(shape)) // lk
    masked = mshape is not None
    shared = masked and not backward and len(mshape) == 4 and mshape[1] == 1
    plan = sm.launch_plan(rows, lk, heads, masked=masked,
                          shared_mask=shared, backward=backward)
    for rpw in sm.RPW_CHOICES[plan.elems]:
        p = sm.launch_plan(rows, lk, heads, masked=masked,
                           shared_mask=shared, backward=backward, rpw=rpw)
        _, b, _, q = sm_check(p, rows, lk, heads, lq)
        if p.head_major:
            # one mask row for an item's rows: the heads of one (b, q)
            assert (b == b[:, :1]).all() and (q == q[:, :1]).all()
    # ERNIE's scores: four heads of a (b, q) a warp, their mask row once;
    # the backward and the upper triangle a row a warp
    assert plan.head_major == (name == "ernie" and not backward)
    if name == "ernie" and not backward:
        assert plan.rpw == 4 and plan.elems == 4
    if backward or not masked:
        assert plan.rpw == 1


@pytest.mark.parametrize("threads", [128, 256])
@pytest.mark.parametrize("lk", [1, 32, 33, 1024, 1025])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_softmax_mask_plan_owns_each_key_once_at_the_edges(lk, backward,
                                                           threads):
    b, heads, lq = 2, 3, 5
    rows = b * heads * lq
    plan = sm.launch_plan(rows, lk, heads, backward=backward,
                          threads=threads)
    sm_check(plan, rows, lk, heads, lq)
    assert plan.elems == (0 if lk > 1024 else 4 if lk <= 128 else 32)


@pytest.mark.parametrize("rpw", [1, 2, 4])
@pytest.mark.parametrize("heads,lq", [(12, 128), (4, 3), (8, 1)])
def test_softmax_mask_head_major_items_cover_each_row_once(heads, lq, rpw):
    rows = 3 * heads * lq
    plan = sm.launch_plan(rows, 64, heads, shared_mask=True, rpw=rpw)
    assert plan.head_major == (rpw > 1)
    row, b, h, q = sm_check(plan, rows, 64, heads, lq)
    assert (row == (b * heads + h) * lq + q).all()
    assert ((0 <= h) & (h < heads)).all()


def test_softmax_mask_plan_refuses_what_is_not_built():
    with pytest.raises(ValueError, match="not built"):
        sm.launch_plan(64, 128, 4, rpw=3)
    with pytest.raises(ValueError, match="not built"):
        sm.launch_plan(64, 2000, 4, rpw=2)
    with pytest.raises(ValueError, match="head-major"):
        sm.launch_plan(64, 128, 4, backward=True, head_major=True)
    with pytest.raises(ValueError, match="head-major"):
        sm.launch_plan(60, 128, 3, rpw=2, head_major=True)


# ---------------------------------------------------------------------------
# bias_act
# ---------------------------------------------------------------------------

def ba_runs(plan, rows):
    """The kernel's runs as the CTAs walk them (CTA x of a strip takes runs
    x, x + grid_x, ...), through ``run_of``: ``(run, e, r0, r1)`` of each
    warp, its bias row and its rows."""
    out = []
    for bx in range(plan.grid_x):
        for run in range(bx, plan.runs, plan.grid_x):
            e = run // plan.bpp
            p0 = e * plan.period
            start = p0 + (run - e * plan.bpp) * plan.ty * plan.rt
            for ty in range(plan.ty):
                r0 = start + ty * plan.rt
                r1 = min(r0 + plan.rt, p0 + plan.period, rows)
                out.append((run, e, r0, max(r0, r1)))
    return out


def ba_columns(plan, n):
    """Every thread's first column, over the column strips."""
    c = (np.arange(plan.grid_y)[:, None] * ba.TX
         + np.arange(ba.TX)[None, :]).ravel() * plan.vec
    return c[c < n]


def ba_check(plan, rows, n, period):
    assert plan.threads == ba.TX * plan.ty <= ba.TX * ba.MAX_TY
    assert plan.grid_y <= ba.MAX_GRID_Y
    assert plan.period == (period or rows)
    assert plan.runs == (rows // plan.period) * plan.bpp
    assert 1 <= plan.grid_x <= plan.runs
    runs = ba_runs(plan, rows)
    # every run walked by exactly one CTA of a strip
    assert sorted({r[0] for r in runs}) == list(range(plan.runs))
    assert len(runs) == plan.runs * plan.ty
    row_count = np.zeros(rows, dtype=np.int64)
    for run, e, r0, r1 in runs:
        row_count[r0:r1] += 1
        # a run never crosses a period: its bias row and its partial's slot
        # (the run) are its rows' own
        assert all(r // plan.period == e for r in range(r0, r1))
        assert run // plan.bpp == e
    col_count = np.zeros(n, dtype=np.int64)
    for c in ba_columns(plan, n):
        col_count[c:c + plan.vec] += 1
    # coverage of (row, column) is the product of the two
    assert (row_count == 1).all() and (col_count == 1).all()
    # 32-bit indices
    assert rows * n < 2 ** 31 and plan.runs * n < 2 ** 31


BA_CASES = [
    # (rows, n, vec, period): ERNIE's linear1 epilogue, FMT prefill and
    # decode, nn_ops' no-bias GELU, the odd width, the MoE's period, edges
    (4096, 3072, 8, None), (512, 6912, 8, None), (16, 6912, 8, None),
    (4096, 768, 8, None), (1000, 1001, 1, None), (8192, 14336, 8, 512),
    (1, 8, 8, None), (7, 24, 8, 7), (30, 5, 1, 3), (100, 1001, 1, 25),
    (33, 4104, 8, 11), (64, 256, 8, 1)]


@pytest.mark.parametrize("table", [False, True], ids=["direct", "table"])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("rows,n,vec,period", BA_CASES)
def test_bias_act_plan_covers_each_element_once(rows, n, vec, period,
                                                backward, sms, table):
    plan = ba.launch_plan(rows, n, vec, sms, period=period,
                          backward=backward, table=table)
    ba_check(plan, rows, n, period)
    # a table from TABLE_MIN elements in vectors of 8: no more CTAs than fit
    # at once, its runs in one wave of them where some rows a warp of
    # RT_STAGED allow it; any other launch a CTA a run
    assert plan.table == (table and vec == 8 and rows * n >= ba.TABLE_MIN)
    if plan.table:
        cap = max(1, ba.STAGED_CTAS[backward] * sms // plan.grid_y)
        assert plan.grid_x == min(plan.runs, cap)
        if plan.runs > cap:
            assert plan.rt == ba.RT_WALK[backward]
        else:
            assert plan.rt in ba.RT_STAGED
    else:
        assert plan.rt in (ba.RT_BWD if backward else ba.RT_FWD)
        assert plan.grid_x == plan.runs


@pytest.mark.parametrize("rt,ty,ctas,table", [
    (1, 8, None, True), (2, 8, 3, True), (8, 8, None, False),
    (16, 8, 1, True), (4, 4, 2, False), (3, 2, 5, True), (4, 1, 64, True)])
@pytest.mark.parametrize("rows,n,vec,period", [(4096, 3072, 8, None),
                                               (8192, 14336, 8, 512),
                                               (1000, 1001, 1, None),
                                               (30, 5, 1, 3)])
def test_bias_act_variant_plans_cover_each_element_once(rows, n, vec,
                                                        period, rt, ty,
                                                        ctas, table):
    plan = ba.launch_plan(rows, n, vec, 132, period=period, backward=True,
                          rt=rt, ty=ty, ctas=ctas, table=table)
    assert (plan.rt, plan.ty) == (rt, ty)
    ba_check(plan, rows, n, period)
    # CTAs walk runs in a lookup launch only
    assert plan.table or plan.grid_x == plan.runs


def test_bias_act_plans_at_the_paths():
    # a warp takes four rows where that still fills the card, one where
    # it would not (FMT's prefill and decode epilogues)
    assert ba.launch_plan(4096, 3072, 8, 132).rt == 4
    assert ba.launch_plan(4096, 3072, 8, 132, backward=True).rt == 4
    assert ba.launch_plan(8192, 14336, 8, 132, period=512).rt == 4
    assert ba.launch_plan(512, 6912, 8, 132).rt == 1
    assert ba.launch_plan(16, 6912, 8, 132).rt == 1
    # ERNIE's fp32 epilogue: a row in flight a thread, a row a warp forward
    assert ba.launch_plan(4096, 3072, 8, 132, wide=True).rt == 1
    assert ba.launch_plan(4096, 3072, 8, 132, wide=True,
                          backward=True).rt == 4
    # the backward's run of rows is longer than 16
    for table in (False, True):
        plan = ba.launch_plan(4096, 3072, 8, 132, backward=True, table=table)
        assert plan.ty * plan.rt > 16
    # ERNIE's O2 epilogue looks GELU up through the ring, forward and
    # backward, its 32 runs of 128 rows a strip in one wave; the MoE's 128
    # runs a strip walked by the CTAs that fit; the decode step's too small
    for backward in (False, True):
        plan = ba.launch_plan(4096, 3072, 8, 132, table=True,
                              backward=backward)
        assert plan.table and (plan.rt, plan.runs) == (16, 32)
        assert plan.grid_x == plan.runs
        plan = ba.launch_plan(8192, 14336, 8, 132, period=512, table=True,
                              backward=backward)
        assert plan.rt == ba.RT_WALK[backward] and plan.grid_x < plan.runs
        assert plan.grid_x == ba.STAGED_CTAS[backward] * 132 // 56
    assert not ba.launch_plan(16, 6912, 8, 132, table=True).table


@pytest.mark.parametrize("dtypes,act,want", [
    ((bf, bf, bf, bf), "gelu", True), ((bf, None, bf, bf), "gelu_tanh", True),
    ((bf, f32, f32, f32), "gelu", False), ((f32, f32, f32, f32), "gelu", False),
    ((bf, bf, bf, bf), "relu", False), ((bf, bf, bf, bf), "none", False)])
def test_bias_act_table_only_for_bf16_gelu(dtypes, act, want):
    y = torch.empty(4, 8, dtype=dtypes[0])
    b = None if dtypes[1] is None else torch.empty(8, dtype=dtypes[1])
    assert ba._table_ok(y, b, ba.ActSpec(act, dtypes[2], dtypes[3])) is want


def fold_order(bpp):
    """The fold kernel's reads of a bias row's ``bpp`` partials: warp w
    sums slots w, w + 8, ... in order, then warp 0 sums the 8 in order."""
    return [list(range(w, bpp, 8)) for w in range(8)]


@pytest.mark.parametrize("bpp", [1, 2, 7, 8, 9, 64, 128, 1000])
def test_bias_act_fold_reads_each_slot_once_in_a_fixed_order(bpp):
    order = fold_order(bpp)
    flat = [i for w in order for i in w]
    assert sorted(flat) == list(range(bpp))
    assert all(w == sorted(w) for w in order)


def model_db(plan, gh, rows, n):
    """The bias gradient by the kernel's order: each warp sums its rows in
    order (fp32), a CTA its warps in order into its slot, the fold a bias
    row's slots by :func:`fold_order`."""
    part = torch.zeros((plan.runs, n), dtype=f32)
    walked = ba_runs(plan, rows)
    for run in range(plan.runs):
        t = torch.zeros(n, dtype=f32)
        for _, _, r0, r1 in (w for w in walked if w[0] == run):
            acc = torch.zeros(n, dtype=f32)
            for r in range(r0, r1):
                acc = acc + gh[r]
            t = t + acc
        part[run] = t
    out = []
    for e in range(plan.runs // plan.bpp):
        slots = part[e * plan.bpp:(e + 1) * plan.bpp]
        sums = [torch.zeros(n, dtype=f32) for _ in range(8)]
        for w, idx in enumerate(fold_order(plan.bpp)):
            for i in idx:
                sums[w] = sums[w] + slots[i]
        t = torch.zeros(n, dtype=f32)
        for s in sums:
            t = t + s
        out.append(t)
    return torch.stack(out)


@pytest.mark.parametrize("rows,n,period,rt,ctas", [(96, 24, None, None, None),
                                                   (96, 24, 32, None, 1),
                                                   (90, 5, 30, 3, None),
                                                   (64, 16, None, 1, 2)])
def test_bias_act_partials_and_fold_give_the_plain_bias_gradient(
        rows, n, period, rt, ctas):
    g = torch.Generator().manual_seed(rows + n)
    y = torch.randn((rows, n), generator=g)
    nb = rows // period if period else 1
    b = torch.randn((nb, 1, n) if period else (n,), generator=g)
    dy = torch.randn((rows, n), generator=g)
    spec = ba.ActSpec("gelu", f32, f32)
    dyy, db = ba.bias_act_bwd_reference(y, b, dy, spec, period)
    plan = ba.launch_plan(rows, n, 1, 132, period=period, backward=True,
                          rt=rt, ctas=ctas)
    got = model_db(plan, dyy, rows, n)
    assert torch.allclose(got, db.reshape(nb, n), rtol=1e-5, atol=1e-5)
    # a fixed order: the same bits every time
    assert torch.equal(got, model_db(plan, dyy, rows, n))


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _on_meta(monkeypatch, mod):
    monkeypatch.setattr(mod, "cuda_device",
                        lambda *a, **k: torch.device("meta"))
    monkeypatch.setattr(mod, "ptr", lambda t: None if t is None else 1)
    monkeypatch.setattr(mod, "stream", lambda dev: 0)
    monkeypatch.setattr(mod.torch.cuda, "device", lambda dev: _Null())


@pytest.mark.parametrize("with_bias,period", [(True, None), (False, None),
                                               (True, 512)],
                         ids=["bias", "none", "bias_period"])
def test_bias_act_wrapper_hands_the_plan_to_the_kernels(monkeypatch,
                                                        with_bias, period):
    _on_meta(monkeypatch, ba)
    monkeypatch.setattr(ba, "_sm_count", lambda i: 132)
    monkeypatch.setattr(ba, "aligned16", lambda *ts: True)
    monkeypatch.setattr(ba, "_tables", lambda i, act: ("fwd", "bwd"))
    monkeypatch.setattr(ba, "ptr", lambda t: None if t is None else t)
    calls = {}
    fns = {k: (lambda k: lambda *a: calls.setdefault(k, a) and 0)(k)
           for k in ("bias_act_fwd", "bias_act_bwd")}
    rows, n = 8192, 14336
    y = torch.empty((rows, n), dtype=bf, device="meta")
    b = None
    if with_bias:
        b = torch.empty((rows // period, 1, n) if period else (n,),
                        dtype=bf, device="meta")
    spec = ba.ActSpec("gelu_tanh", bf, bf)
    ba._launch_fwd(y, b, spec, period, fns=fns)
    dyy, db = ba._launch_bwd(y, b, y, spec, period, fns=fns)
    for name, backward in (("bias_act_fwd", False), ("bias_act_bwd", True)):
        plan = ba.launch_plan(rows, n, 8, 132, period=period,
                              backward=backward, table=True)
        args = calls[name]
        assert args[-8:-1] == (plan.vec, plan.runs, plan.grid_x,
                               plan.grid_y, plan.threads, plan.bpp, plan.rt)
        lead = 4 if name == "bias_act_fwd" else 7
        # bf16 GELU (tanh form) of 117 M elements: the table
        assert plan.table and args[lead - 1] == ("bwd" if backward
                                                 else "fwd")
        assert args[lead:lead + 3] == (rows, plan.period, n)
        if backward and with_bias:   # the partial scratch: a run's row each
            assert tuple(args[4].shape) == (plan.runs, n)
    # the partial scratch (the fifth pointer) only with a bias
    assert (calls["bias_act_bwd"][4] is None) == (not with_bias)
    assert (db is None) == (not with_bias)


@pytest.mark.parametrize("causal", [False, True], ids=["mask", "causal"])
def test_softmax_mask_wrapper_hands_the_plan_to_the_kernels(monkeypatch,
                                                            causal):
    _on_meta(monkeypatch, sm)
    from paddle_tpu_torch.ops._fused_io import divider
    calls = {}
    fns = {k: (lambda k: lambda *a: calls.setdefault(k, a) and 0)(k)
           for k in ("softmax_mask_fwd", "softmax_mask_bwd")}
    x = torch.empty((32, 12, 128, 128), dtype=bf, device="meta")
    mask = None if causal else torch.empty((32, 1, 128, 128), dtype=bf,
                                           device="meta")
    y = sm._launch_fwd(x, mask, causal, fns=fns)
    sm._launch_bwd(y, y, fns=fns)
    rows = 32 * 12 * 128
    plan = sm.launch_plan(rows, 128, 12, masked=not causal,
                          shared_mask=not causal)
    args = calls["softmax_mask_fwd"]
    assert args[3:10] == (rows, 128, 128, 12,
                          *((0, 0, 0) if causal else (16384, 0, 128)))
    # the dividers of lq (128) and heads (12), as C ints
    (lm, ls), (hm, hs) = divider(128), divider(12)
    assert args[13:17] == (lm - 2 ** 32 if lm >= 2 ** 31 else lm, ls,
                           hm - 2 ** 32 if hm >= 2 ** 31 else hm, hs)
    assert args[-7:-1] == (plan.items, plan.elems, plan.rpw,
                           int(plan.head_major), plan.grid, plan.threads)
    assert plan.head_major is (not causal)
    bplan = sm.launch_plan(rows, 128, backward=True)
    assert calls["softmax_mask_bwd"][-6:-1] == (
        bplan.items, bplan.elems, bplan.rpw, bplan.grid, bplan.threads)


# ---------------------------------------------------------------------------
# 32-bit indices: the wrappers raise beyond them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("rows,raises", [(2 ** 16, True),
                                         (2 ** 16 - 1, False)])
def test_bias_act_wrapper_raises_at_2_31_elements(monkeypatch, rows, raises,
                                                  backward):
    _on_meta(monkeypatch, ba)
    monkeypatch.setattr(ba, "_sm_count", lambda i: 132)
    monkeypatch.setattr(ba, "_tables", lambda i, act: (None, None))
    called = []
    fns = {k: lambda *a: called.append(a) or 0
           for k in ("bias_act_fwd", "bias_act_bwd")}
    y = torch.empty((rows, 2 ** 15), dtype=bf, device="meta")
    b = torch.empty((2 ** 15,), dtype=bf, device="meta")
    spec = ba.ActSpec("gelu", bf, bf)

    def call():
        if backward:
            return ba._launch_bwd(y, b, y, spec, fns=fns)
        return ba._launch_fwd(y, b, spec, fns=fns)
    if raises:
        with pytest.raises(ValueError, match="2\\^31"):
            call()
        assert not called
    else:
        call()
        assert len(called) == 1


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("heads,raises", [(2 ** 8, True),
                                          (2 ** 8 - 1, False)])
def test_softmax_mask_wrapper_raises_at_2_31_elements(monkeypatch, heads,
                                                      raises, backward):
    _on_meta(monkeypatch, sm)
    called = []
    fns = {k: lambda *a: called.append(a) or 0
           for k in ("softmax_mask_fwd", "softmax_mask_bwd")}
    x = torch.empty((2 ** 7, heads, 2 ** 8, 2 ** 8), dtype=bf, device="meta")

    def call():
        if backward:
            return sm._launch_bwd(x, x, fns=fns)
        return sm._launch_fwd(x, None, True, fns=fns)
    if raises:
        with pytest.raises(ValueError, match="2\\^31"):
            call()
        assert not called
    else:
        call()
        assert len(called) == 1
