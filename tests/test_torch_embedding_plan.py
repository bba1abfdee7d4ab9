"""The embedding backward's launches (``ops/embedding.py::launch_plan`` and
``_launch_bwd``) on the CPU, where its kernels do not run
(``chip_smoke.py``'s ``check_embedding`` holds them against the plain
version on a card, bit for bit).

* a model of the sort's kernels (a stable LSD radix sort, 8 bits a pass,
  over tiles of sorted positions, each key placed after the smaller digits
  and its digit's keys in earlier tiles) gives numpy's stable sort by key,
  and the index kernel's row pointer (each row's entry written
  once, by the position where the keys step past it) equals
  ``torch.searchsorted`` on the sorted ids;
* a model of the window and zero-row kernels (windows of CHUNK sorted
  positions streaming the segments that start in them, a long run folded
  by the CTA of its last piece, CTAs of ROWS_PER_CTA rows for the rows no
  token hit, column strips of ``threads`` vectors) writes every (row,
  column) of the gradient exactly once, and its sums give
  ``embedding_bwd_reference``'s bits at the check's cases: padding 0,
  positions hit 32 times, 4096 all-zero ids, mixed short and long runs, ids
  outside the table, widths 90 and 99;
* the wrapper hands the plan and its scratch to the C entry point, never
  zero-fills the gradient, and raises where 32-bit positions or rows would
  not do.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import embedding as em
from paddle_tpu_torch.ops._fused_io import DTYPE_CODES

f32, bf = torch.float32, torch.bfloat16
CHUNK = em.CHUNK


# ---------------------------------------------------------------------------
# the table pass's mapping
# ---------------------------------------------------------------------------

def column_cover(d, vec):
    """How many times the table pass's threads (strips of ``threads``
    vectors, V columns each) cover each column, and the plan."""
    plan = em.launch_plan(1, d, vec)
    hits = np.zeros(d + vec, dtype=np.int64)
    for by in range(plan.strips):
        c = (by * plan.threads + np.arange(plan.threads)) * vec
        for j in range(vec):
            np.add.at(hits, c[c < d] + j, 1)
    return plan, hits


# (d, vec): ERNIE's and Llama's widths, the check's odd widths at vector 1,
# and edges
WIDTHS = [(768, 8), (2560, 8), (90, 1), (99, 1), (8, 8), (4096, 8),
          (8192, 8), (8200, 8), (1, 1), (513, 1)]


@pytest.mark.parametrize("d,vec", WIDTHS, ids=[f"{d}_v{v}" for d, v in WIDTHS])
def test_table_pass_covers_each_column_once(d, vec):
    plan, hits = column_cover(d, vec)
    assert (hits[:d] == 1).all() and not hits[d:].any()
    assert plan.threads % 32 == 0 and plan.threads <= em.MAX_THREADS
    # a strip beyond the first only past MAX_THREADS vectors, the strips
    # even, and no strip a warp that holds no column
    vecs = -(-d // vec)
    assert plan.strips == -(-vecs // em.MAX_THREADS)
    assert plan.threads * plan.strips - vecs < 32 * plan.strips


def test_plans_at_the_paths():
    # ERNIE's 768 wide tables: a CTA of 3 warps; Llama's 2560: two strips
    # of 5 warps
    assert em.launch_plan(4096, 768, 8) == em.Plan(8, 96, 1, 256)
    assert em.launch_plan(24576, 2560, 8) == em.Plan(8, 160, 2, 1536)
    assert em.launch_plan(4096, 99, 1) == em.Plan(1, 128, 1, 256)
    # a window's shared rows (WINDOW + CHUNK positions) by one pass of its
    # threads at every path's width
    for d, vec in ((768, 8), (2560, 8), (90, 1), (99, 1)):
        assert em.launch_plan(1, d, vec).threads >= em.WINDOW + CHUNK
    assert em.launch_plan(0, 16, 8).windows == 0


# ---------------------------------------------------------------------------
# the sort kernel and its row pointer
# ---------------------------------------------------------------------------

def keys_of(ids, rows, pad):
    """The sort's keys: id + 1, 0 for the padding id and ids outside
    [0, rows)."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    drop = (ids < 0) | (ids >= rows)
    if pad is not None:
        drop |= ids == pad
    return np.where(drop, 0, ids + 1)


def radix_sort_model(keys, rows):
    """The sort's kernels: 8 bits a pass, a pass for each byte of ``rows``,
    over tiles of SORT_TILE positions. A key of digit g in tile t goes to
    the keys of smaller digits (over all tiles) + the keys of digit g in
    the tiles before t (the pass's counts by digit and tile) + those before
    it in its tile; the next pass's counts are taken by the tile each key
    lands in, and must equal the counts of the pass's output. Returns
    (sorted keys, tokens)."""
    n, T = len(keys), em.SORT_TILE
    tiles = -(-n // T)
    k, tok = keys.copy(), np.arange(n)
    passes = -(-int(rows).bit_length() // 8)
    hist = np.zeros((em.RADIX, tiles), dtype=np.int64)
    np.add.at(hist, (k & 255, np.arange(n) // T), 1)
    for p in range(passes):
        dg = (k >> (8 * p)) & 255
        total = hist.sum(1)
        first = np.cumsum(total) - total          # smaller digits
        before = np.cumsum(hist, 1) - hist        # earlier tiles
        at = np.empty(n, dtype=np.int64)
        nxt = {}
        for e in range(n):   # a tile's warps, batches and lanes: in order
            t = e // T
            at[e] = first[dg[e]] + before[dg[e], t] + nxt.get((dg[e], t), 0)
            nxt[dg[e], t] = nxt.get((dg[e], t), 0) + 1
        assert np.array_equal(np.sort(at), np.arange(n))
        k2, t2 = np.empty_like(k), np.empty_like(tok)
        k2[at], t2[at] = k, tok
        if p + 1 < passes:
            hist = np.zeros((em.RADIX, tiles), dtype=np.int64)
            np.add.at(hist, ((k >> (8 * p + 8)) & 255, at // T), 1)
            check = np.zeros_like(hist)
            np.add.at(check, ((k2 >> (8 * p + 8)) & 255, np.arange(n) // T),
                      1)
            assert np.array_equal(hist, check)
        k, tok = k2, t2
    return k, tok


def row_pointer_model(keys_sorted, rows):
    """The index kernel's row pointer: position k (0..n) writes rp[r] = k for
    the rows r in [keys[k - 1], keys[k]) (keys[-1] = 0, keys[n] = rows + 1);
    returns rp and how many times each entry was written."""
    n = len(keys_sorted)
    rp = np.full(rows + 1, -1, dtype=np.int64)
    writes = np.zeros(rows + 1, dtype=np.int64)
    for k in range(n + 1):
        r0 = 0 if k == 0 else keys_sorted[k - 1]
        r1 = rows + 1 if k == n else keys_sorted[k]
        rp[r0:r1] = k
        writes[r0:r1] += 1
    return rp, writes


def ids_case(name, rng):
    """(ids, rows, pad) of a case: the check's and edges."""
    if name == "word_padding_0":
        ids = rng.integers(1, 40000, (32, 128))
        ids[:, -8:] = 0
        return ids, 40000, 0
    if name == "positions_hit_32_times":
        return np.broadcast_to(np.arange(128), (32, 128)), 2048, None
    if name == "all_zero_4096_rows_4":
        return np.zeros((32, 128), dtype=np.int64), 4, None
    if name == "all_zero_4096_rows_3":
        return np.zeros((32, 128), dtype=np.int64), 3, None
    if name == "mixed_short_and_long_runs":
        # runs of 1..200 tokens (several longer than CHUNK, one of 128 and
        # one of 65), shuffled into token order
        lens = [1, 2, 64, 65, 128, 3, 200, 1, 130, 7, 63]
        ids = np.concatenate([np.full(n, 3 * i + 1) for i, n in
                              enumerate(lens)])
        return rng.permutation(ids), 40, None
    if name == "outside_the_table":
        return rng.integers(-3, 23, (7, 50)), 20, 5
    if name == "int32_width_90":
        return (rng.integers(1, 40000, (32, 128)) % 500).astype(np.int32), \
            500, 3
    if name == "width_99":
        return rng.integers(1, 40000, (32, 128)) % 700, 700, None
    if name == "llama_6x4096":
        return rng.integers(0, 32000, (6, 4096)), 32000, None
    if name == "one_row":
        return np.zeros((3, 5), dtype=np.int64), 1, None
    raise KeyError(name)


SORT_CASES = ["word_padding_0", "positions_hit_32_times",
              "all_zero_4096_rows_4", "all_zero_4096_rows_3",
              "mixed_short_and_long_runs", "outside_the_table",
              "int32_width_90", "width_99", "llama_6x4096", "one_row"]


@pytest.mark.parametrize("name", SORT_CASES)
def test_sort_and_row_pointer_give_each_rows_run(name):
    ids, rows, pad = ids_case(name, np.random.default_rng(0))
    keys = keys_of(ids, rows, pad)
    ks, tok = radix_sort_model(keys, rows)
    # the radix passes are numpy's stable sort by key
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(tok, order) and np.array_equal(ks, keys[order])
    rp, writes = row_pointer_model(ks, rows)
    assert (writes == 1).all()
    # row r's run [rp[r], rp[r + 1]) is where searchsorted puts it in the
    # sorted ids (dropped tokens, key 0, sorting first as id -1)
    s = torch.from_numpy(ks - 1)
    want = torch.searchsorted(s, torch.arange(rows + 1)).numpy()
    assert np.array_equal(rp, want)
    flat = np.asarray(ids).reshape(-1)
    for r in np.unique(flat):
        if 0 <= r < rows and r != pad:
            assert np.array_equal(tok[rp[r]:rp[r + 1]],
                                  np.nonzero(flat == r)[0])


def test_empty_ids_give_an_all_zero_row_pointer():
    ks, tok = radix_sort_model(np.zeros(0, dtype=np.int64), 7)
    rp, writes = row_pointer_model(ks, 7)
    assert (rp == 0).all() and (writes == 1).all()


# ---------------------------------------------------------------------------
# the kernels' sums against the plain version
# ---------------------------------------------------------------------------

def table_pass_model(ids, dy, rows, pad, dtype):
    """The gradient as the table pass computes it after the sort and the
    index kernel (modelled above), and how many times each row is written.
    Window j (sorted positions [k0, k0 + WINDOW)): position k with a key is
    a boundary where (k - rs) % CHUNK == 0 (rs its run's start); the
    window's stream is [b0, b1), b0 its first boundary, b1 the first at or
    past k0 + WINDOW (or n); each segment of it (a run of at most CHUNK
    rows, or a piece of a longer one) is summed from 0 in token order and
    written at its end: the run's row, or slot 2 j + (is the run's last
    piece); a long
    run's pieces are added in piece order from 0 into its row by the window
    that takes the run's last ticket. CTAs of ROWS_PER_CTA rows write 0 into
    each row whose run is empty. Every add in fp32 rounded to ``dtype``."""
    n, d = dy.shape

    def add(acc, x):
        return (acc + x).to(dtype).float()
    keys = keys_of(ids, rows, pad)
    ks, tok = radix_sort_model(keys, rows)
    rp, _ = row_pointer_model(ks, rows)
    out = torch.empty(rows, d)
    writes = np.zeros(rows, dtype=np.int64)
    part, tickets, folds = {}, {}, []
    W = em.WINDOW
    for j in range(-(-n // W)):
        k0 = j * W
        run = lambda k: (rp[ks[k] - 1], rp[ks[k]])   # noqa: E731
        bounds = [k for k in range(k0, min(k0 + W + CHUNK, n))
                  if ks[k] and (k - run(k)[0]) % CHUNK == 0]
        b0 = min([k for k in bounds if k < k0 + W],
                 default=min(k0 + W, n))
        b1 = min([k for k in bounds if k >= k0 + W],
                 default=min(k0 + W + CHUNK, n))
        if b0 >= k0 + W:
            continue
        assert b1 - k0 < W + CHUNK   # the window's shared rows hold it
        acc, seen = torch.zeros(d), {}
        for k in range(b0, b1):
            acc = add(acc, dy[tok[k]].float())
            rs, re = run(k)
            if k + 1 != re and (k + 1 - rs) % CHUNK:
                continue
            if re - rs <= CHUNK:
                out[ks[k] - 1] = acc
                writes[ks[k] - 1] += 1
            else:
                ps = k - (k - rs) % CHUNK
                q = int(ps + CHUNK >= re)
                assert k0 <= ps < k0 + W and q not in seen
                seen[q] = (rs, re, ks[k] - 1)
                part[2 * j + q] = acc
            acc = torch.zeros(d)
        for rs, re, r in seen.values():   # the ticket of the run
            tickets[rs] = tickets.get(rs, 0) + 1
            if tickets[rs] == -(-(re - rs) // CHUNK):
                folds.append((rs, re, r))
    for rs, re, r in folds:
        acc = torch.zeros(d)
        for p in range(rs, re, CHUNK):
            acc = add(acc, part[2 * (p // W) + int(p + CHUNK >= re)])
        out[r] = acc
        writes[r] += 1
    for r0 in range(0, rows, em.ROWS_PER_CTA):
        for r in range(r0, min(r0 + em.ROWS_PER_CTA, rows)):
            if rp[r] == rp[r + 1]:
                out[r] = 0.0
                writes[r] += 1
    return out.to(dtype), writes


# (case, width, dtype): the check's ids at narrow widths (the columns do
# not meet), and its odd widths
SUM_CASES = [("word_padding_0", 8, bf), ("word_padding_0", 8, f32),
             ("positions_hit_32_times", 16, bf),
             ("all_zero_4096_rows_4", 8, bf),
             ("all_zero_4096_rows_3", 8, f32),
             ("mixed_short_and_long_runs", 16, bf),
             ("mixed_short_and_long_runs", 8, f32),
             ("int32_width_90", 90, f32), ("width_99", 99, bf)]


@pytest.mark.parametrize("name,d,dtype", SUM_CASES,
                         ids=[f"{c}_{d}_{str(t)[6:]}"
                              for c, d, t in SUM_CASES])
def test_table_pass_writes_each_row_once_with_the_plain_versions_bits(
        name, d, dtype):
    rng = np.random.default_rng(1)
    ids, rows, pad = ids_case(name, rng)
    dy = torch.from_numpy(rng.standard_normal((np.size(ids), d)).astype(
        np.float32)).to(dtype)
    got, writes = table_pass_model(ids, dy, rows, pad, dtype)
    assert (writes == 1).all()
    want = em.embedding_bwd_reference(torch.from_numpy(np.array(ids)), dy,
                                      rows, pad, dtype)
    assert torch.equal(got, want)


def test_table_pass_drops_ids_outside_the_table():
    # the plain version raises on them; the kernels leave them out, as if
    # the tokens were absent
    rng = np.random.default_rng(2)
    ids, rows, pad = ids_case("outside_the_table", rng)
    dy = torch.from_numpy(rng.standard_normal((ids.size, 8)).astype(
        np.float32))
    got, writes = table_pass_model(ids, dy, rows, pad, f32)
    assert (writes == 1).all()
    keep = (ids >= 0) & (ids < rows)
    want = em.embedding_bwd_reference(torch.from_numpy(ids[keep]),
                                      dy[torch.from_numpy(keep.reshape(-1))],
                                      rows, pad, f32)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _on_meta(monkeypatch):
    monkeypatch.setattr(em, "cuda_device",
                        lambda *a, **k: torch.device("meta"))
    monkeypatch.setattr(em, "ptr", lambda t: t)
    monkeypatch.setattr(em, "stream", lambda dev: 0)
    monkeypatch.setattr(em, "aligned16", lambda *ts: True)
    monkeypatch.setattr(em.torch.cuda, "device", lambda dev: _Null())

    def no_zero_fill(*a, **k):
        raise AssertionError("the gradient is written by the kernels")
    monkeypatch.setattr(em.torch, "zeros", no_zero_fill)


# (ids shape, ids dtype, rows, width, dy dtype, weight dtype, pad): ERNIE's
# word table, Llama's, the check's int32 width 90 and width 99
WRAPPER_CASES = [((32, 128), torch.int64, 40000, 768, bf, bf, 0),
                 ((6, 4096), torch.int64, 32000, 2560, bf, bf, None),
                 ((32, 128), torch.int32, 500, 90, f32, f32, 3),
                 ((32, 128), torch.int64, 700, 99, bf, bf, None),
                 ((32, 128), torch.int64, 40000, 768, f32, bf, None)]


@pytest.mark.parametrize("shape,idt,rows,d,dyt,wt,pad", WRAPPER_CASES,
                         ids=["ernie_word", "llama", "int32_w90", "w99",
                              "fp32_dy_bf16_table"])
def test_wrapper_hands_the_plan_to_the_kernel(monkeypatch, shape, idt, rows,
                                              d, dyt, wt, pad):
    _on_meta(monkeypatch)
    calls = []
    fns = {"emb_bwd": lambda *a: calls.append(a) or 0}
    ids = torch.empty(shape, dtype=idt, device="meta")
    dy = torch.empty((*shape, d), dtype=dyt, device="meta")
    before = em.launches.count
    dw = em._launch_bwd(ids, dy, rows, pad, wt, fns=fns)
    assert em.launches.count == before + 1
    assert dw.shape == (rows, d) and dw.dtype == wt
    (args,) = calls
    n = int(np.prod(shape))
    ids_p, dy_p, dw_p, idx, part = args[:5]
    assert ids_p.dtype == idt and ids_p.shape == (n,)   # read as given
    assert dy_p.shape == (n, d) and dw_p is dw
    plan = em.launch_plan(n, d, 8 if d % 8 == 0 else 1)
    # sorted keys and tokens, the row pointer, a ticket a window and strip,
    # the sort's counts by pass, digit and tile
    passes = -(-rows.bit_length() // 8)
    assert idx.dtype == torch.int32 and idx.shape == (
        2 * n + rows + 1 + plan.windows * plan.strips
        + passes * 256 * -(-n // 512),)
    # a piece's two slots a window, or the sort's 2 n ints where more
    assert part.dtype == f32 and part.shape == (max(2 * plan.windows * d,
                                                    2 * n),)
    assert args[5:12] == (n, rows, d, int(idt == torch.int64),
                          DTYPE_CODES[dyt],
                          DTYPE_CODES[wt], -1 if pad is None else pad)
    assert args[12:15] == (plan.vec, plan.threads, plan.strips)
    assert args[15] == 0


@pytest.mark.parametrize("what", ["tokens", "rows"])
@pytest.mark.parametrize("over", [True, False], ids=["at_limit", "below"])
def test_wrapper_raises_where_32_bit_indices_would_not_do(monkeypatch, what,
                                                          over):
    _on_meta(monkeypatch)
    called = []
    fns = {"emb_bwd": lambda *a: called.append(a) or 0}
    big = em.INDEX_LIMIT if over else em.INDEX_LIMIT - 1
    n, rows = (big, 16) if what == "tokens" else (16, big)
    ids = torch.empty((n,), dtype=torch.int64, device="meta")
    dy = torch.empty((n, 8), dtype=bf, device="meta")
    if over:
        with pytest.raises(ValueError, match="2\\^31"):
            em._launch_bwd(ids, dy, rows, None, bf, fns=fns)
        assert not called
    else:
        em._launch_bwd(ids, dy, rows, None, bf, fns=fns)
        assert len(called) == 1
