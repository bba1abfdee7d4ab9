"""The launch plans of the RoPE and SwiGLU kernels (``ops/rope.py::
launch_plan``, ``ops/swiglu.py::launch_plan``) on the CPU, where the kernels
do not run (``chip_smoke.py``'s ``fused_ops_check`` holds them against their
plain versions on a card).

* RoPE: a model of the kernel's mapping (a warp an item: a position and a
  run of its heads; a lane a chunk of ``vec`` pairs of ``hpw`` heads a
  step) built from the plan, at the paths' shapes and at edge shapes (one
  position, odd head counts, GQA q/k head counts, D = 16 to 128, vectors of
  8 pairs and of 1): every (b, l, head, pair) exactly once; run through
  the model's offsets, the tensors give ``rope_reference``'s bits;
* SwiGLU: the model of the grid (a vector a thread), contiguous and
  packed (row-strided) rows, every (row, column) exactly once; the multiply-high row division equal to ``//`` on every row
  boundary; each element of y read from the g and u elements that the
  plain version pairs;
* both plans keep their indices within 32 bits, and the wrappers raise for
  a tensor of 2^31 elements or more.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import rope as rp
from paddle_tpu_torch.ops import swiglu as sw

f32, bf = torch.float32, torch.bfloat16
SMS = (3, 132)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tasks(plan, heads: int, items=None):
    """``(position row, head, chunk)`` of every lane's every turn, in the
    kernel's order, over ``items`` (default all)."""
    out = []
    for item in (range(plan.items) if items is None else items):
        bl, part = divmod(item, plan.parts)
        first = part * plan.heads_per_part
        end = min(first + plan.heads_per_part, heads)
        for lane in range(32):
            slot, sub = divmod(lane, plan.lph)
            if slot >= plan.hpw:
                continue
            for c in range(sub, plan.cph, plan.lph):
                for h in range(first + slot, end, plan.hpw):
                    out.append((bl, h, c))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


def check_rope_plan(plan, positions, heads, d, vec):
    assert plan.threads == rp.THREADS and plan.threads % 32 == 0
    assert plan.items == positions * plan.parts
    assert plan.grid * rp.WARPS >= plan.items
    assert (plan.grid - 1) * rp.WARPS < plan.items
    assert plan.cph * vec == d // 2
    # the C entry point's own check
    assert plan.nch * plan.lph * vec >= d // 2
    assert 1 <= plan.lph <= 32 and plan.hpw * plan.lph <= 32
    assert plan.heads_per_part % plan.hpw == 0
    assert (plan.parts - 1) * plan.heads_per_part < heads
    assert plan.parts * plan.heads_per_part >= heads
    # 32-bit: items and the largest element offset
    assert plan.items < 2 ** 32 and plan.grid < 2 ** 31


def covered_once(tasks, positions, heads, d, vec, rows=None):
    seen = np.zeros((positions, heads, d // 2), dtype=np.int64)
    for j in range(vec):
        np.add.at(seen, (tasks[:, 0], tasks[:, 1], tasks[:, 2] * vec + j), 1)
    rows = range(positions) if rows is None else rows
    assert (seen[list(rows)] == 1).all()


@pytest.mark.parametrize("name,b,n,heads,d,sp", [
    # the paths: Llama training's q and k, the 7B decode step and tail
    # prefill; and the incubate checks' q, k and v
    ("llama_o2", 6, 4096, (20, 20), 128, 10),
    ("serve_decode", 16, 1, (32, 32), 128, 1),
    ("serve_prefill_tail", 1, 1000, (32, 32), 128, 3),
    ("fp32_gqa", 2, 512, (8, 2), 128, 1),
    ("incubate_qkv", 2, 256, (4, 4, 4), 64, 1),
])
def test_rope_plan_at_the_paths(name, b, n, heads, d, sp):
    plan = rp.launch_plan(b * n, sum(heads), d, 8, 132)
    check_rope_plan(plan, b * n, sum(heads), d, 8)
    # a warp takes all of Llama's heads; decode splits them to a step each
    assert plan.heads_per_part == sp * plan.hpw
    positions = b * n
    ends = sorted({0, 1, positions - 2, positions - 1} & set(
        range(positions)))
    items = [bl * plan.parts + p for bl in ends for p in range(plan.parts)]
    covered_once(rope_tasks(plan, sum(heads), items), positions, sum(heads),
                 d, 8, rows=ends)


EDGE = [
    # (b, n, heads, d, vec): one position, odd heads, GQA, D 16-128, V 1
    (1, 1, (1,), 128, 8),
    (1, 1, (32, 8), 128, 8),
    (2, 3, (5, 3), 64, 8),
    (3, 7, (7, 1, 1), 128, 8),
    (1, 9, (3,), 16, 8),
    (2, 5, (6, 2), 48, 8),
    (2, 4, (3, 3), 128, 1),
    (1, 6, (5, 1), 80, 1),
    (2, 2, (2, 2, 2), 64, 1),
    (1, 300, (9, 3), 64, 8),
]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b,n,heads,d,vec", EDGE)
def test_rope_plan_covers_each_pair_once(b, n, heads, d, vec, sms):
    plan = rp.launch_plan(b * n, sum(heads), d, vec, sms)
    check_rope_plan(plan, b * n, sum(heads), d, vec)
    covered_once(rope_tasks(plan, sum(heads)), b * n, sum(heads), d, vec)


def rope_model(xs, cos, sin, *, offset=0, positions=None, neox=True,
               dtype=None, table_dtype=None, backward=False, vec=8,
               sms=132):
    """The kernel's turns at the plan's offsets, on flat tensors: each
    lane's heads and pairs, its position's table slice rounded to the
    table cast once, products and sums in fp32, rounded to the cast and
    then to the output dtype. Returns the outputs and how often each
    element was written."""
    b, n, _, d = xs[0].shape
    heads = [x.shape[2] for x in xs]
    plan = rp.launch_plan(b * n, sum(heads), d, vec, sms)
    t = torch.from_numpy(rope_tasks(plan, sum(heads)))
    bl, h, c = t[:, 0], t[:, 1], t[:, 2]
    starts = torch.tensor(np.cumsum([0] + heads[:-1]))
    which = (h[:, None] >= starts[None]).sum(1) - 1
    dt = dtype or xs[0].dtype
    flat = [x.to(dt).float().flatten() for x in xs]
    outs = [torch.zeros(x.numel()) for x in xs]
    writes = [torch.zeros(x.numel(), dtype=torch.int64) for x in xs]
    pos = (offset + bl % n) if positions is None \
        else positions.flatten().long()[bl]
    cs = cos.to(table_dtype or cos.dtype).float()
    sn = sin.to(table_dtype or sin.dtype).float()
    w, half = cos.shape[1], d // 2
    for j in range(vec):
        p = c * vec + j
        if w == half:
            i1 = i2 = p
        elif neox:
            i1, i2 = p, p + half
        else:
            i1, i2 = 2 * p, 2 * p + 1
        c1, c2, s1, s2 = cs[pos, i1], cs[pos, i2], sn[pos, i1], sn[pos, i2]
        for k in range(len(xs)):
            m = which == k
            base = (bl[m] * heads[k] + h[m] - starts[k]) * d
            e1 = base + (p[m] if neox else 2 * p[m])
            e2 = base + (p[m] + half if neox else 2 * p[m] + 1)
            a1, a2 = flat[k][e1], flat[k][e2]
            if backward:
                y1 = a1 * c1[m] + a2 * s2[m]
                y2 = a2 * c2[m] - a1 * s1[m]
            else:
                y1 = a1 * c1[m] - a2 * s1[m]
                y2 = a2 * c2[m] + a1 * s2[m]
            outs[k][e1] = y1.to(dt).float()
            outs[k][e2] = y2.to(dt).float()
            writes[k][e1] += 1
            writes[k][e2] += 1
    return ([o.reshape(x.shape).to(dt) for o, x in zip(outs, xs)], writes)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("case", [
    # (b, n, heads, d, vec, table width, neox, x dtype, dtype, table
    # dtype, positions): O2 / serving / fp32 / incubate's full tables
    (2, 5, (4, 4), 128, 8, 64, True, bf, bf, bf, None),
    (3, 1, (4, 2), 128, 8, 64, True, bf, None, None, torch.int32),
    (1, 7, (3, 1), 64, 8, 32, True, f32, None, None, None),
    (2, 4, (2, 2, 2), 64, 8, 64, False, bf, bf, bf, torch.int64),
    (2, 4, (3, 1), 64, 8, 64, True, f32, None, None, None),
    (2, 3, (5, 3), 48, 8, 24, True, bf, bf, bf, None),
    (1, 6, (5, 1), 80, 1, 80, False, f32, None, None, torch.int64),
])
def test_rope_model_gives_the_plain_bits(case, backward):
    b, n, heads, d, vec, width, neox, xd, dt, tdt, pdt = case
    g = torch.Generator().manual_seed(sum(heads) + d)
    xs = [torch.randn((b, n, hh, d), generator=g).to(xd) for hh in heads]
    ang = torch.rand((40, width), generator=g) * 6.3
    cos, sin = ang.cos(), ang.sin()
    pos = None if pdt is None else torch.randint(0, 40, (b, n), generator=g,
                                                 dtype=pdt)
    kw = dict(offset=2 if pos is None else 0, positions=pos, neox=neox,
              dtype=dt, table_dtype=tdt, backward=backward)
    got, writes = rope_model(xs, cos, sin, vec=vec, **kw)
    want = rp.rope_reference(xs, cos, sin, **kw)
    for w in writes:
        assert (w == 1).all()
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and torch.equal(a, r)


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------

def swiglu_vectors(plan):
    """Every vector index a thread takes, in the grid's order (CTA,
    thread), below ``plan.vecs``."""
    v = (np.arange(plan.grid)[:, None] * plan.threads
         + np.arange(plan.threads)[None, :]).ravel()
    assert v.max() < 2 ** 32
    return v[v < plan.vecs]


def row_of(plan, v):
    return (v.astype(np.uint64) * np.uint64(plan.magic)) >> np.uint64(
        31 + plan.shift)


def check_swiglu_plan(plan, rows, d, vec):
    assert plan.vecs == rows * (d // vec)
    assert plan.threads in (128, 256) and plan.threads <= sw.MAX_THREADS
    assert plan.grid * plan.threads >= plan.vecs
    assert (plan.grid - 1) * plan.threads < max(plan.vecs, 1)
    if plan.strided:
        assert 0 < plan.magic < 2 ** 32


@pytest.mark.parametrize("name,rows,d,packed,threads", [
    ("llama", 24576, 6912, False, 256),
    ("serve", 16, 11008, False, 128),
    ("fp32", 4096, 1024, False, 256),
    ("packed_bf16", 4096, 1024, True, 256),
])
def test_swiglu_plan_at_the_paths(name, rows, d, packed, threads):
    plan = sw.launch_plan(rows, d, 8, 132, strided=packed)
    check_swiglu_plan(plan, rows, d, 8)
    assert plan.threads == threads and plan.strided is packed
    # the row of the first and last vector of every row
    if packed:
        per = d // 8
        r = np.arange(rows, dtype=np.int64)
        for v in (r * per, r * per + per - 1):
            assert (row_of(plan, v) == r.astype(np.uint64)).all()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("rows,d,vec,packed", [
    (1, 8, 8, False), (3, 24, 8, True), (17, 1024, 8, False),
    (5, 1000, 8, True), (2, 7, 1, False), (9, 13, 1, True),
    (700, 64, 8, True), (4096, 96, 8, False), (33, 11008, 8, False),
])
def test_swiglu_plan_covers_each_element_once(rows, d, vec, packed, sms):
    plan = sw.launch_plan(rows, d, vec, sms, strided=packed)
    check_swiglu_plan(plan, rows, d, vec)
    v = swiglu_vectors(plan)
    assert len(v) == len(np.unique(v)) == plan.vecs
    seen = np.zeros((rows, d), dtype=np.int64)
    if packed:
        row = row_of(plan, v).astype(np.int64)
        assert (row == v // (d // vec)).all()
        col = v * vec - row * d
    else:
        row, col = divmod(v * vec, d)
    for j in range(vec):
        np.add.at(seen, (row, col + j), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 96, 127, 128, 864, 1376, 12345,
                               2 ** 20 + 1, 2 ** 28 - 3])
def test_divider_is_floor_division_below_2_31(n):
    magic, shift = sw.divider(n)
    assert 2 ** 30 <= magic < 2 ** 32 or n == 1
    rng = np.random.default_rng(n)
    v = np.concatenate([
        rng.integers(0, 2 ** 31, 20000), np.arange(0, min(3 * n, 9999)),
        2 ** 31 - 1 - np.arange(min(3 * n, 9999)),
        (np.arange(1, 2000) * n) - 1, np.arange(1, 2000) * n])
    v = v[(v >= 0) & (v < 2 ** 31)].astype(np.uint64)
    got = (v * np.uint64(magic)) >> np.uint64(31 + shift)
    assert (got == v // np.uint64(n)).all()


def swiglu_model(g, u=None, *, vec=8, sms=132):
    """The forward's reads at the plan's offsets on flat tensors: for each
    element of y, the g and u elements that vector v's lane reads (g and u
    at their row strides; packed: u d elements past g), y at v x vec."""
    packed = u is None
    d = g.shape[-1] // 2 if packed else g.shape[-1]
    rows = g.numel() // g.shape[-1]
    plan = sw.launch_plan(rows, d, vec, sms, strided=packed)
    v = torch.from_numpy(swiglu_vectors(plan).astype(np.int64))
    gf = g.flatten()
    uf = gf[d:] if packed else u.flatten()
    rs = 2 * d if packed else d
    got_g = torch.full((rows * d,), float("nan"), dtype=g.dtype)
    got_u = got_g.clone()
    writes = torch.zeros(rows * d, dtype=torch.int64)
    if packed:
        row = torch.from_numpy(row_of(plan, v.numpy()).astype(np.int64))
        col = v * vec - row * d
    for j in range(vec):
        yo = v * vec + j
        go = row * rs + col + j if packed else yo
        got_g[yo], got_u[yo] = gf[go], uf[go]
        writes[yo] += 1
    shape = (*g.shape[:-1], d)
    return got_g.reshape(shape), got_u.reshape(shape), writes


@pytest.mark.parametrize("rows,d,vec,packed", [
    (5, 24, 8, False), (6, 40, 8, True), (3, 7, 1, False), (4, 9, 1, True),
])
def test_swiglu_model_reads_each_element_once(rows, d, vec, packed):
    # each element of y from the g and u elements the plain version pairs
    # (torch's CPU silu itself differs by an ulp between its vector and
    # scalar loops, so the offsets are held, not silu's bits)
    gen = torch.Generator().manual_seed(rows * d)
    if packed:
        x = torch.randn((rows, 2 * d), generator=gen)
        args, want = (x,), (x[:, :d], x[:, d:])
    else:
        args = want = tuple(torch.randn((rows, d), generator=gen)
                            for _ in range(2))
    got_g, got_u, writes = swiglu_model(*args, vec=vec)
    assert (writes == 1).all()
    assert torch.equal(got_g, want[0]) and torch.equal(got_u, want[1])


# ---------------------------------------------------------------------------
# 32-bit indices: the wrappers raise beyond them
# ---------------------------------------------------------------------------

def _on_meta(monkeypatch, mod):
    monkeypatch.setattr(mod, "cuda_device",
                        lambda *a, **k: torch.device("meta"))


@pytest.mark.parametrize("shape,raises", [
    ((1, 2 ** 16, 2 ** 8, 128), True),        # 2^31 elements
    ((1, 2 ** 16, 2 ** 8 - 1, 128), False),
])
def test_rope_wrapper_raises_at_2_31_elements(monkeypatch, shape, raises):
    _on_meta(monkeypatch, rp)
    called = []
    fns = {"rope": lambda *a: called.append(a) or 0}
    monkeypatch.setattr(rp, "aligned16", lambda *ts: True)
    monkeypatch.setattr(rp, "ptr", lambda t: None)
    monkeypatch.setattr(rp, "stream", lambda dev: 0)
    monkeypatch.setattr(rp, "_sm_count", lambda i: 132)
    monkeypatch.setattr(rp.torch.cuda, "device", lambda dev: _Null())
    x = torch.empty(shape, dtype=bf, device="meta")
    cos = torch.empty((2 ** 16, 64), device="meta")
    kw = dict(offset=0, positions=None, neox=True, dtype=None,
              table_dtype=None, backward=False, out_dtypes=[bf], fns=fns)
    if raises:
        with pytest.raises(ValueError, match="2\\^31"):
            rp._launch([x], cos, cos, **kw)
        assert not called
    else:
        rp._launch([x], cos, cos, **kw)
        (args,) = called
        plan = rp.launch_plan(2 ** 16, shape[2], 128, 8, 132)
        assert args[6:12] == (2 ** 16, shape[2], 0, 0, 2 ** 16, 128)
        assert args[-8:-1] == (plan.grid, plan.threads, plan.parts,
                               plan.heads_per_part, plan.lph, plan.hpw,
                               plan.nch)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("packed", [False, True], ids=["two", "packed"])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_swiglu_wrapper_raises_at_2_31_elements(monkeypatch, packed,
                                                backward):
    _on_meta(monkeypatch, sw)
    monkeypatch.setattr(sw, "_kernels", lambda: pytest.fail("launched"))
    cols = 2 ** 16 if packed else 2 ** 15
    g = torch.empty((2 ** 16, cols), dtype=bf, device="meta")
    u = None if packed else torch.empty_like(g)
    with pytest.raises(ValueError, match="2\\^31"):
        if backward:
            dy = torch.empty((2 ** 16, 2 ** 15), dtype=bf, device="meta")
            sw._launch_bwd(g, u, dy, packed)
        else:
            sw._launch_fwd(g, u, packed)
