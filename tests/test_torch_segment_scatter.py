"""The sorted-segment engine of K3 and K18 (``csrc/segment_scatter.cuh``)
as a numpy emulation of its plan, held to the JAX package's
``SparseSGD.apply_rows`` / ``_sorted_scatter_add`` and to the port's
plain versions on the same numpy inputs, on the CPU.

The emulation follows the kernels step by step:
  - keys: each id to its row under JAX indexing, dropped ids compacted
    out by the first pass (the histogram counts kept ids only);
  - the digit passes: 8-bit digits over ceil(log2(rows)) bits, each pass
    tile by tile (a tile's stable local ranks, its digit counts, the
    earlier tiles' counts as the look-back gives them, the histogram's
    digit bases);
  - the segment lists: run starts, lengths by gallop and bisection, the
    length classes taken longest first, K3's chunks of L = ``SPLIT`` and
    their fixed combine order;
  - the rows pass's arithmetic in float32 with bfloat16 rounding where
    the chain rounds.

Bounds: where no row has more than ``SPLIT`` hits the emulated K3 equals
the plain version and JAX BITWISE (NaN positions compared as NaN); a row
hit more often is within k ulps of its dtype of |old| + sum |update|,
and a control that drops every other position must fail that bound.
K18's chain (never split) equals JAX's promoted scatter bitwise. The
launch-record keys hold every fact a record rests on: a changed fact
misses, a new address of the same layout hits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.parallel import optimizers as jax_opt
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseSGD as JaxSparseSGD)

from distributed_embeddings_torch.ops import _kernels
from distributed_embeddings_torch.ops import scatter_add as sa
from distributed_embeddings_torch.ops.scatter_add import (
    LONG_SEGMENT, SORT_TILE, SPLIT, sgd_scatter_plain,
    sgd_scatter_promoted_plain)

torch.set_num_threads(1)

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


# ---------------------------------------------------------------- numpy

def bf16(x) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    x = np.asarray(x, np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    out = r.view(np.float32).copy()
    out[np.isnan(x)] = np.nan
    return out


def rnd(x, dtype) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return bf16(x) if dtype == torch.bfloat16 else x


def key_bits(rows: int) -> int:
    return int(rows - 1).bit_length()


def passes_of(rows: int) -> int:
    return max(1, -(-key_bits(rows) // 8))


def emulate_sort(ids: np.ndarray, rows: int, tile: int = SORT_TILE):
    """The engine's sort: ``(sorted rows, their stream positions, kept)``
    through the histogram and the tile-by-tile digit passes."""
    g = ids.astype(np.int64)
    g = np.where(g < 0, g + rows, g)
    keep = (g >= 0) & (g < rows)
    m = int(keep.sum())
    npass = passes_of(rows)
    hist = [np.bincount((g[keep] >> (8 * q)) & 255, minlength=256)
            for q in range(npass)]
    keys, pos, valid = g, np.arange(len(ids)), keep
    tiles = max(1, -(-len(ids) // tile))  # every pass's grid: n's tiles
    for q in range(npass):
        excl = np.cumsum(hist[q]) - hist[q]
        out_k = np.full(m, -1, np.int64)
        out_p = np.full(m, -1, np.int64)
        prefix = np.zeros(256, np.int64)  # what the look-back gives
        for t in range(tiles):
            lo = t * tile
            if q > 0 and lo >= m:
                break  # a later pass's tiles past the kept pairs exit
            sl = slice(lo, lo + tile)
            tv = valid[sl]
            tk, tp = keys[sl][tv], pos[sl][tv]
            td = (tk >> (8 * q)) & 255
            counts = np.bincount(td, minlength=256)
            order = np.argsort(td, kind="stable")  # the warps' ranks
            local = np.cumsum(counts) - counts
            d = td[order]
            dst = excl[d] + prefix[d] + (np.arange(len(d)) - local[d])
            out_k[dst] = tk[order]
            out_p[dst] = tp[order]
            prefix += counts
        assert (out_k >= 0).all()
        keys, pos, valid = out_k, out_p, np.ones(m, bool)
    return keys, pos, m


def run_length(sk: np.ndarray, j: int, m: int) -> int:
    """``csrc/segment_scatter.cuh:run_length``: gallop, then bisect."""
    key = sk[j]
    lo, hi, step = j, j + 1, 1
    while hi < m and sk[hi] == key:
        lo, step = hi, step * 2
        hi = j + step
    hi = min(hi, m)
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        if sk[mid] == key:
            lo = mid
        else:
            hi = mid
    return hi - j


def emulate_lists(sk: np.ndarray, m: int, split: int, long_class=32):
    """The segment launch and the rows pass's order: ``(units, combs,
    chunks)``. units: ``(start, length, chunk or -1)`` in the order the
    rows pass takes them (K18's block-path classes first, then K3's
    chunks, then the classes below ``long_class`` longest first); combs:
    per long segment its chunks in combine order."""
    starts = np.flatnonzero(np.r_[True, sk[1:m] != sk[:m - 1]]) if m \
        else np.zeros(0, np.int64)
    lens = np.diff(np.r_[starts, m]).astype(np.int64)
    classes = {c: [] for c in range(32)}
    chunks, combs = [], []
    for j, n in zip(starts.tolist(), lens.tolist()):
        if split and n > split:
            first = len(chunks)
            for c in range(-(-n // split)):
                chunks.append((j + c * split, min(split, n - c * split)))
            combs.append(list(range(first, len(chunks))))
        else:
            classes[n.bit_length() - 1].append((j, n))
    units = [(s, n, -1) for c in range(31, long_class - 1, -1)
             for s, n in classes[c]]
    units += [(s, n, k) for k, (s, n) in enumerate(chunks)]
    units += [(s, n, -1) for c in range(min(long_class, 32) - 1, -1, -1)
              for s, n in classes[c]]
    return units, combs, chunks


def update_rows(vals, nl, slab_dtype, vals_dtype, chain, lr_on_card):
    """Every stream row's update as the engine computes it (float32)."""
    x = rnd(np.asarray(vals, np.float32), vals_dtype)
    nl = np.float32(nl)
    if chain == "promoted":
        return (nl * bf16(x)).astype(np.float32)
    if chain == "cast":
        return rnd(nl * rnd(x, slab_dtype), slab_dtype)
    q = (nl * x).astype(np.float32)
    return rnd(q if lr_on_card else rnd(q, vals_dtype), slab_dtype)


def _chains(acc, u, sp, starts, lens, step):
    """Every unit's chain, the units side by side (their rows are
    distinct, so only each chain's own order matters): entry k of every
    unit longer than k, in stream order, through ``step``."""
    for k in range(int(lens.max()) if len(lens) else 0):
        sel = lens > k
        acc[sel] = step(acc[sel], u[sp[starts[sel] + k]])
    return acc


def emulate_engine(slab, ids, vals, nl, slab_dtype, vals_dtype,
                   chain="cast", lr_on_card=False, split=SPLIT):
    """The slab after one engine call (float32 values; bfloat16 slabs
    hold bfloat16 values): the sort, the lists, each unit's chain as its
    lanes run it, then K3's partials combined in chunk order."""
    slab = np.array(slab, np.float32)
    rows = slab.shape[0]
    sk, sp, m = emulate_sort(ids, rows)
    k18 = chain == "promoted"
    units, combs, chunks = emulate_lists(sk, m, 0 if k18 else split)
    u = update_rows(vals, nl, slab_dtype, vals_dtype, chain, lr_on_card)
    f32 = np.float32
    with np.errstate(invalid="ignore", over="ignore"):
        direct = np.array([(s, n) for s, n, c in units if c < 0],
                          np.int64).reshape(-1, 2)
        r = sk[direct[:, 0]]
        acc = _chains(slab[r].copy(), u, sp, direct[:, 0], direct[:, 1],
                      (lambda a, x: (a + x).astype(f32)) if k18 else
                      (lambda a, x: rnd((a + x).astype(f32), slab_dtype)))
        slab[r] = bf16(acc) if k18 else acc
        if chunks:
            ch = np.array(chunks, np.int64)
            part = _chains(u[sp[ch[:, 0]]].copy(), u, sp, ch[:, 0] + 1,
                           ch[:, 1] - 1, lambda a, x: (a + x).astype(f32))
            for cm in combs:
                row = sk[chunks[cm[0]][0]]
                a = slab[row].copy()
                for c in cm:
                    a = rnd((a + part[c]).astype(f32), slab_dtype)
                slab[row] = a
    return slab


# ------------------------------------------------------------ references

def _jax(slab, ids, vals, lr, slab_dtype, vals_dtype):
    out, _ = JaxSparseSGD().apply_rows(
        jnp.asarray(slab, JNP[slab_dtype]), (), jnp.asarray(ids),
        jnp.asarray(vals, JNP[vals_dtype]), lr)
    return np.asarray(out).astype(np.float32)


def _plain(slab, ids, vals, lr, slab_dtype, vals_dtype, cast=True):
    s = torch.from_numpy(np.array(slab, np.float32)).to(slab_dtype)
    sgd_scatter_plain(s, torch.from_numpy(ids),
                      torch.from_numpy(vals).to(vals_dtype), lr,
                      cast_vals=cast)
    return s.float().numpy()


def _neg(lr, dtype):
    return float(sa._neg_lr(lr, dtype))


def assert_bitwise(got, want, what=""):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    gn, wn = np.isnan(g), np.isnan(w)
    np.testing.assert_array_equal(gn, wn, err_msg=what)
    bad = (g.view(np.uint32) != w.view(np.uint32)) & ~gn
    assert not bad.any(), f"{what}: {int(bad.sum())} of {g.size} differ"


def within_k_ulps(got, want, slab, ids, vals, lr, dtype):
    """Whether every value is within k ulps of its dtype of |old| + sum
    |lr x update| (k: the row's hits)."""
    rows = slab.shape[0]
    g = ids.astype(np.int64)
    g = np.where(g < 0, g + rows, g)
    keep = (g >= 0) & (g < rows)
    k = np.bincount(g[keep], minlength=rows)[:, None].astype(np.float64)
    mag = np.abs(np.asarray(slab, np.float64))
    np.add.at(mag, g[keep], np.abs(lr * np.asarray(vals, np.float64)[keep]))
    bits = 8 if dtype == torch.bfloat16 else 24
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - bits + 1)
    return bool((np.abs(np.asarray(got, np.float64) - want)
                 <= k * ulp).all())


def _stream(rng, n, rows, hot=(), neg=False, cap=SPLIT):
    """Ids spread over ``rows`` with no row past ``cap`` hits, then
    ``hot`` = ((row, hits), ...) rows at disjoint random positions (their
    other hits moved to a row that is not hot); with ``neg`` negative
    ids, the sentinel and ids past the slab at the end."""
    ids = rng.integers(0, rows, size=n)
    hot_rows = {r for r, _ in hot}
    spare = next(r for r in range(rows) if r not in hot_rows)
    for row in hot_rows:
        ids[ids == row] = spare
    assert np.bincount(ids, minlength=rows).max() <= cap
    perm, at = rng.permutation(n), 0
    for row, hits in hot:
        ids[perm[at:at + hits]] = row
        at += hits
    if neg:
        ids = np.concatenate([ids, [-1, -rows, rows, rows + 3, -rows - 1,
                                    10 ** 6]])
    return ids


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("rows,bits,npass", [
    (1, 0, 1), (256, 8, 1), (257, 9, 2), (60_336, 16, 2),
    (10_569_296, 24, 3), (187_767_425, 28, 4), (2 ** 32 - 1, 32, 4)])
def test_key_bits_and_digit_passes(rows, bits, npass):
    """ceil(log2(rows)) key bits in 8-bit digits: the zoo's w8 slab 2
    passes, the capped Kaggle slab 3, Criteo-1TB 4."""
    assert key_bits(rows) == bits
    assert passes_of(rows) == npass


@pytest.mark.parametrize("n,rows,ids64", [
    (10_000, 300, False), (9_000, 70_000, True), (5, 40, False),
    (SORT_TILE * 3 + 17, 1_000, True)])
def test_sort_plan_is_stable_and_compacts(n, rows, ids64):
    """The tile-by-tile passes equal a stable sort of the kept (row,
    position) pairs: dropped ids (past the slab, below -rows, the
    sentinel) are gone, negative ids wrapped once, equal rows in stream
    order; every run length the gallop finds is the run's."""
    rng = np.random.default_rng(n)
    ids = rng.integers(-rows - 5, rows + 5, size=n)
    ids[rng.permutation(n)[:n // 3]] = rows  # the sentinel
    ids = ids.astype(np.int64 if ids64 else np.int32)
    sk, sp, m = emulate_sort(ids, rows)
    g = ids.astype(np.int64)
    g = np.where(g < 0, g + rows, g)
    keep = np.flatnonzero((g >= 0) & (g < rows))
    order = np.argsort(g[keep], kind="stable")
    assert m == len(keep)
    np.testing.assert_array_equal(sk, g[keep][order])
    np.testing.assert_array_equal(sp, keep[order])
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]]) if m else []
    ends = np.r_[starts[1:], m] if m else []
    for j, e in zip(starts, ends):
        assert run_length(sk, int(j), m) == e - j


def test_lists_longest_first_and_the_split():
    """Units come longest first (by length class); K3 cuts a segment of
    more than L entries into chunks of L (the last one shorter) combined
    in chunk order; K18 never cuts and takes its block-path classes
    (``LONG_SEGMENT`` entries and more) before all others."""
    rng = np.random.default_rng(5)
    ids = _stream(rng, 30_000, 5_000, hot=((3, 3 * SPLIT + 5),
                                           (9, SPLIT), (12, 2_000)))
    sk, sp, m = emulate_sort(ids, 5_000)
    units, combs, chunks = emulate_lists(sk, m, SPLIT)
    lens = [n for _, n, c in units if c < 0]
    cls = [n.bit_length() - 1 for n in lens]
    assert cls == sorted(cls, reverse=True)
    assert [units[i][2] for i in range(len(chunks))] == list(
        range(len(chunks)))  # chunks first
    by_row = {sk[chunks[cm[0]][0]]: [chunks[c] for c in cm] for cm in combs}
    assert sorted(by_row) == [3, 12]
    ch3 = by_row[3]
    assert [n for _, n in ch3] == [SPLIT] * 3 + [5]
    assert [s for s, _ in ch3] == [ch3[0][0] + k * SPLIT for k in range(4)]
    assert (9, SPLIT) in [(sk[s], n) for s, n, _ in units]
    units18, combs18, _ = emulate_lists(
        sk, m, 0, long_class=LONG_SEGMENT.bit_length() - 1)
    assert not combs18
    assert [(sk[s], n) for s, n, _ in units18[:2]] == [(12, 2_000),
                                                       (3, 3 * SPLIT + 5)]


@pytest.mark.parametrize("slab_dtype,vals_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("w", [3, 8])
def test_k3_engine_bitwise_up_to_the_split(slab_dtype, vals_dtype, w):
    """At most L hits a row (one row at exactly L): the emulated K3, the
    plain version and JAX's ``SparseSGD.apply_rows`` (constant lr) agree
    bitwise, with negative ids, the sentinel, ids past the slab, a NaN
    and an Inf in hit rows; so do the emulation and the plain version
    with a tensor lr and in the dedup chain (``cast_vals=False``)."""
    rng = np.random.default_rng(w)
    R = 2_000
    ids = _stream(rng, 6_000, R, hot=((5, SPLIT),), neg=True)
    slab = rnd(rng.normal(size=(R, w)), slab_dtype)
    slab[ids[0], 0] = np.nan
    vals = rnd(rng.normal(scale=2.0, size=(len(ids), w)), vals_dtype)
    vals[1, -1] = np.inf
    ids = ids.astype(np.int32)
    lr = 0.37
    got = emulate_engine(slab, ids, vals, _neg(lr, slab_dtype), slab_dtype,
                         vals_dtype)
    assert_bitwise(got, _plain(slab, ids, vals, lr, slab_dtype, vals_dtype),
                   "plain")
    assert_bitwise(got, _jax(slab, ids, vals, lr, slab_dtype, vals_dtype),
                   "jax")
    t_lr = torch.tensor(0.0123)
    for chain, cast, t in (("cast", True, t_lr), ("dedup", False, t_lr),
                           ("dedup", False, lr)):
        if cast and slab_dtype == torch.bfloat16:
            continue  # a tensor lr into a bf16 slab: the promoted chain
        on_card = isinstance(t, torch.Tensor)
        nl = float(-t) if on_card else _neg(t, vals_dtype)
        got = emulate_engine(slab, ids, vals, nl, slab_dtype, vals_dtype,
                             chain=chain, lr_on_card=on_card)
        assert_bitwise(got, _plain(slab, ids, vals, t, slab_dtype,
                                   vals_dtype, cast=cast), f"{chain} {t}")


def test_k3_engine_inside_jax_sort_window():
    """A stream of 260,000 ids at width 2, inside ``_sorted_scatter_add``'s
    sort window (JAX sorts, then scatters): the emulated K3 equals JAX
    bitwise with at most L hits a row, and with rows hit 3L + 5 and
    20,000 times it is within k ulps of JAX on those rows (bit-exact on
    the rest); a control dropping every other position fails that
    bound."""
    assert jax_opt._SORT_STREAM_MIN <= 260_000 <= jax_opt._SORT_STREAM_MAX
    rng = np.random.default_rng(11)
    R, w = 60_336, 2
    dt = torch.float32
    for hot in ((), ((7, 3 * SPLIT + 5), (8, 20_000))):
        ids = _stream(rng, 260_000, R, hot=hot).astype(np.int32)
        slab = rng.normal(size=(R, w)).astype(np.float32)
        vals = rng.normal(size=(len(ids), w)).astype(np.float32)
        lr = 0.05
        want = _jax(slab, ids, vals, lr, dt, dt)
        assert_bitwise(want, _plain(slab, ids, vals, lr, dt, dt), "plain")
        got = emulate_engine(slab, ids, vals, _neg(lr, dt), dt, dt)
        few = np.bincount(ids, minlength=R) <= SPLIT
        assert_bitwise(got[few], want[few], f"rows <= L, hot {hot}")
        assert within_k_ulps(got, want, slab, ids, vals, lr, dt)
        if hot:
            assert not np.array_equal(got[~few], want[~few])
            half = emulate_engine(slab, ids[::2], vals[::2], _neg(lr, dt),
                                  dt, dt)
            assert not within_k_ulps(half, want, slab, ids, vals, lr, dt)


@pytest.mark.parametrize("slab_dtype", [torch.float32, torch.bfloat16])
def test_k3_engine_hot_rows_within_k_ulps(slab_dtype):
    """Rows hit 5,000 times and more at w16, bf16 and fp32 slabs: the
    emulated K3 (chunks of L summed in float32, combined in chunk order)
    is within k ulps of the plain version and of JAX; the control that
    drops every other position is not."""
    rng = np.random.default_rng(17)
    R, w = 500, 16
    ids = _stream(rng, 12_000, R, hot=((2, 5_000),)).astype(np.int64)
    slab = rnd(rng.normal(size=(R, w)), slab_dtype)
    vals = rnd(rng.normal(size=(len(ids), w)), slab_dtype)
    lr = 0.05
    nl = _neg(lr, slab_dtype)
    want = _plain(slab, ids, vals, lr, slab_dtype, slab_dtype)
    assert_bitwise(want, _jax(slab, ids.astype(np.int32), vals, lr,
                              slab_dtype, slab_dtype), "plain vs jax")
    got = emulate_engine(slab, ids, vals, nl, slab_dtype, slab_dtype)
    assert within_k_ulps(got, want, slab, ids, vals, lr, slab_dtype)
    few = np.bincount(ids, minlength=R) <= SPLIT
    assert_bitwise(got[few], want[few], "rows <= L")
    half = emulate_engine(slab, ids[::2], vals[::2], nl, slab_dtype,
                          slab_dtype)
    assert not within_k_ulps(half, want, slab, ids, vals, lr, slab_dtype)


@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_k18_engine_bitwise_to_jax_promoted(vals_dtype):
    """K18's chain through the engine (never split; a row hit 3,000
    times takes the block path, one hit ``LONG_SEGMENT - 1`` times the
    group path) equals JAX's promoted scatter into a
    bf16 slab under a float32 lr, and the plain version, bitwise."""
    rng = np.random.default_rng(23)
    R, w = 800, 16
    ids = _stream(rng, 8_000, R, hot=((4, 3_000), (6, LONG_SEGMENT - 1)),
                  neg=False).astype(np.int32)
    slab = bf16(rng.normal(size=(R, w)))
    vals = rnd(rng.normal(scale=3.0, size=(len(ids), w)), vals_dtype)
    lr = np.float32(0.0173)
    got = emulate_engine(slab, ids, vals, -lr, torch.bfloat16, vals_dtype,
                         chain="promoted")
    want = _jax(slab, ids, vals, jnp.float32(lr), torch.bfloat16, vals_dtype)
    assert_bitwise(got, want, "jax promoted")
    plain = sgd_scatter_promoted_plain(
        torch.from_numpy(slab).to(torch.bfloat16), torch.from_numpy(ids),
        torch.from_numpy(vals).to(vals_dtype), torch.tensor(lr))
    assert_bitwise(got, plain.float().numpy(), "plain promoted")


def _tensors(R=50, w=8, n=30, slab_dtype=torch.float32,
             vals_dtype=torch.float32, ids_dtype=torch.int32):
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.normal(size=(R, w)).astype(np.float32)
                             ).to(slab_dtype),
            torch.from_numpy(rng.integers(0, R, n)).to(ids_dtype),
            torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)
                             ).to(vals_dtype))


def test_k3_record_keys():
    """K3's record is found again for new tensors of the same layouts
    (their addresses are read per call) and missed when any fact it rests
    on changes: the slab's shape or dtype, the ids' dtype or length, the
    vals' dtype or strides, the constant lr's value, a tensor lr's dtype
    or shape, the chain. Invalid calls raise as the wrapper always has."""
    cache = _kernels.LaunchCache()
    slab, ids, vals = _tensors()
    rec = sa.find_sgd_record(cache, slab, ids, vals, 0.1,
                             build_on_cpu=True)
    assert rec.calls == [] or rec.calls == ()
    assert cache.builds == 1
    s2, i2, v2 = (t.clone() for t in (slab, ids, vals))
    assert sa.find_sgd_record(cache, s2, i2, v2, 0.1,
                              build_on_cpu=True) is rec
    t_lr = torch.tensor(0.1)
    changed = [
        (_tensors(R=51)[0], ids, vals, 0.1, True),
        (slab.to(torch.bfloat16), ids, vals, 0.1, True),
        (slab, ids.long(), vals, 0.1, True),
        (slab, ids[:-1], vals[:-1], 0.1, True),
        (slab, ids, vals.to(torch.bfloat16), 0.1, True),
        (slab, ids, vals, 0.2, True),
        (slab, ids, vals, 0.1, False),
        (slab, ids, vals, t_lr, True),
        (slab, ids, vals, t_lr.double(), True),
        (slab, ids, vals, t_lr.reshape(1), True)]
    keys = {sa.sgd_record_key(slab, ids, vals, 0.1, True)}
    for k, args in enumerate(changed):
        key = sa.sgd_record_key(*args)
        assert key not in keys, k
        keys.add(key)
        sa.find_sgd_record(cache, *args, build_on_cpu=True)
        assert cache.builds == k + 2
    # a tensor lr's address is not in the key
    assert sa.sgd_record_key(slab, ids, vals, t_lr) == sa.sgd_record_key(
        slab, ids, vals, t_lr.clone())
    wide = torch.zeros(vals.shape[0], 2 * vals.shape[1])
    for bad in ((slab.t(), ids, vals), (slab, ids[None], vals),
                (slab, ids, wide[:, ::2]), (slab, ids.float(), vals)):
        with pytest.raises(ValueError):
            sa.find_sgd_record(cache, *bad, 0.1, build_on_cpu=True)


def test_k18_record_keys():
    """K18's record key: the same facts (the lr always a tensor)."""
    cache = _kernels.LaunchCache()
    slab, ids, vals = _tensors(slab_dtype=torch.bfloat16)
    lr = torch.tensor(0.5)
    rec = sa.find_promoted_record(cache, slab, ids, vals, lr,
                                  build_on_cpu=True)
    assert sa.find_promoted_record(cache, slab.clone(), ids.clone(),
                                   vals.clone(), lr.clone(),
                                   build_on_cpu=True) is rec
    for k, args in enumerate([
            (slab, ids.long(), vals, lr),
            (slab, ids, vals.to(torch.bfloat16), lr),
            (_tensors(R=60, slab_dtype=torch.bfloat16)[0], ids, vals, lr),
            (slab, ids, vals, lr.double())]):
        sa.find_promoted_record(cache, *args, build_on_cpu=True)
        assert cache.builds == k + 2
    with pytest.raises(ValueError):
        sa.find_promoted_record(cache, slab.float(), ids, vals, lr,
                                build_on_cpu=True)
    with pytest.raises(TypeError):
        sa.find_promoted_record(cache, slab, ids, vals, 0.5,
                                build_on_cpu=True)
