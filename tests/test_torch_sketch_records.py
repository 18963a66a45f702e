"""The launch records of K13 (``ops/sketch.py:cms_update``), K15
(``topk_merge``) and a width's fold (``fold_ids``: K13, K14's pool and
K15 from one record) on CPU tensors: the records are built without a
launch (``build_on_cpu``), so their keys, their reuse and every raise
run here; and the arithmetic the kernels rest on, transcribed.

What is held, all exactly (integers):
  - each key holds the layouts (shapes, strides, dtypes, devices) and
    ``candidates``, and no address: fresh tensors of the same layouts
    find the record, a changed layout builds another;
  - each build validates as the wrappers always have, raising the same
    errors;
  - the fold's path (``analysis/telemetry.py:_record``) gives
    ``record_ids_plain``'s state and count on the CPU, its count set
    into or added to ``total`` as ``update_telemetry`` sums the widths;
  - the column without a division (``csrc/sketch.cu:fast_col``: a mask,
    or Lemire's fastmod) equals ``h % buckets`` for edge hashes and
    bucket counts;
  - K15's two designs, transcribed in numpy (one CTA: the unique pool by
    counting earlier equal entries and kept values below, the selection
    by each key's rank among all keys; past one CTA, tiles sorted alone
    and each key ranked by binary searches in the other tiles, the pool
    and the carried ids sorted as one list whose neighbours give the
    unique candidates and the repeated carried ids), equal
    ``topk_merge_plain``.
"""

import numpy as np
import pytest
import torch

from distributed_embeddings_torch.analysis import telemetry as tel
from distributed_embeddings_torch.ops import _kernels
from distributed_embeddings_torch.ops import sketch as sk

torch.set_num_threads(1)

PAD = 2 ** 31 - 1
SORT_TILE = 1024  # kSortTile of csrc/sketch.cu
BLOCK_KEYS = 512  # kBlockKeys


def _state(topk=8, depth=3, buckets=61, seed=0):
    g = torch.Generator().manual_seed(seed)
    tids = torch.full((topk,), -1, dtype=torch.int32)
    tids[:topk // 2] = torch.randperm(500, generator=g)[:topk // 2].int()
    return {"cms": torch.randint(0, 9, (depth, buckets), generator=g,
                                 dtype=torch.int32),
            "topk_ids": tids,
            "topk_est": torch.randint(0, 20, (topk,), generator=g,
                                      dtype=torch.int32),
            "ids": torch.tensor([3.0])}


def _stream(n=700, seed=1):
    rng = np.random.default_rng(seed)
    ids = ((rng.zipf(1.3, n) - 1) % 400).astype(np.int32)
    ids[rng.random(n) < 0.03] = -7
    ids[rng.random(n) < 0.02] = PAD
    return (torch.from_numpy(ids), torch.from_numpy(rng.random(n) < 0.9))


def _addresses(t):
    return {x.data_ptr() for x in t if isinstance(x, torch.Tensor)}


# ------------------------------------------------------------- the keys


def test_keys_hold_layouts_and_no_addresses():
    ws, (ids, live) = _state(), _stream()
    counts = sk.cms_update_plain(ws["cms"].clone(), ids, live)
    pool = sk.topk_pool_plain(ws["cms"], ids, live, 16)
    keys = {
        "update": sk.update_key(ws["cms"], ids, live),
        "merge": sk.merge_key(ws["cms"], pool, counts, ws["topk_ids"],
                              ws["topk_est"], ws["ids"], 16),
        "fold": sk.fold_key(ws["cms"], ids, live, ws["topk_ids"],
                            ws["topk_est"], ws["ids"], torch.empty(1), 16)}
    ptrs = _addresses([*ws.values(), ids, live, counts, pool])
    for name, key in keys.items():
        flat = [k for k in key if isinstance(k, int)]
        assert not ptrs & set(flat), name
    w2, (i2, l2) = _state(seed=5), _stream(seed=9)
    assert sk.update_key(w2["cms"], i2, l2) == keys["update"]
    assert sk.fold_key(w2["cms"], i2, l2, w2["topk_ids"], w2["topk_est"],
                       w2["ids"], torch.empty(1), 16) == keys["fold"]
    assert sk.fold_key(w2["cms"], i2, l2, w2["topk_ids"], w2["topk_est"],
                       w2["ids"], None, 16) != keys["fold"]
    assert sk.fold_key(w2["cms"], i2, l2, w2["topk_ids"], w2["topk_est"],
                       w2["ids"], torch.empty(1), 17) != keys["fold"]


@pytest.mark.parametrize("change", ["n", "buckets", "topk", "candidates",
                                    "total"])
def test_fold_record_found_again_and_rebuilt_on_a_new_layout(change):
    cache = sk._FOLD
    ws, (ids, live) = _state(), _stream()
    total = torch.empty(1)
    rec = sk.find_fold_record(ws, ids, live, 16, total, build_on_cpu=True)
    builds = cache.builds
    w2, (i2, l2) = _state(seed=3), _stream(seed=4)
    assert sk.find_fold_record(w2, i2, l2, 16, torch.empty(1),
                               build_on_cpu=True) is rec
    assert cache.builds == builds and rec.payload[0] == 16
    cand = 16
    if change == "n":
        i2, l2 = i2[:699], l2[:699]
    elif change == "buckets":
        w2 = _state(buckets=62)
    elif change == "topk":
        w2 = _state(topk=9)
    elif change == "candidates":
        cand = 15
    else:
        total = None
    other = sk.find_fold_record(w2, i2, l2, cand,
                                None if change == "total" else total,
                                build_on_cpu=True)
    assert other is not rec and cache.builds == builds + 1


def test_k13_and_k15_records_found_again():
    ws, (ids, live) = _state(), _stream()
    args = (ws["cms"], ids, live)
    cache = _kernels.LaunchCache()

    def find(key, build, *a):
        return _kernels.find_or_build(cache, key, build, True, True, *a)

    rec = find(sk.update_key(*args), sk.build_update_record, *args)
    w2, (i2, l2) = _state(seed=2), _stream(seed=2)
    assert find(sk.update_key(w2["cms"], i2, l2), sk.build_update_record,
                w2["cms"], i2, l2) is rec
    counts = torch.zeros(1, dtype=torch.int64)
    pool = torch.zeros(16, dtype=torch.int32)
    margs = (ws["cms"], pool, counts, ws["topk_ids"], ws["topk_est"],
             ws["ids"], 16)
    mrec = find(sk.merge_key(*margs), sk.build_merge_record, *margs)
    margs2 = (w2["cms"], pool.clone(), counts.clone(), w2["topk_ids"],
              w2["topk_est"], w2["ids"], 16)
    assert find(sk.merge_key(*margs2), sk.build_merge_record,
                *margs2) is mrec
    assert cache.builds == 2


# ------------------------------------------------------------- the raises


def _bad_fold_calls():
    ws, (ids, live) = _state(), _stream()
    meta = torch.empty((3, 61), dtype=torch.int32, device="meta")
    yield "unsupported device meta", ({**ws, "cms": meta}, ids, live, 16)
    yield "cms: expected a contiguous 2-D", (
        {**ws, "cms": ws["cms"].long()}, ids, live, 16)
    yield "cms: expected a contiguous 2-D", (
        {**ws, "cms": ws["cms"].t()}, ids, live, 16)
    yield "ids: expected a contiguous 1-D", (ws, ids.long(), live, 16)
    yield "ids: expected a contiguous 1-D", (ws, ids[::2], live[::2], 16)
    yield "live: expected a contiguous 1-D", (ws, ids, live.int(), 16)
    yield r"live \(699,\) != ids \(700,\)", (ws, ids, live[:699], 16)
    yield "topk_ids: expected", ({**ws, "topk_ids": ws["topk_ids"].long()},
                                 ids, live, 16)
    yield "topk_est: expected", ({**ws, "topk_est": ws["topk_est"][None]},
                                 ids, live, 16)
    yield "ids: expected a contiguous 1-D torch.float32", (
        {**ws, "ids": ws["ids"].double()}, ids, live, 16)
    yield "topk_est must match topk_ids", (
        {**ws, "topk_est": ws["topk_est"][:3]}, ids, live, 16)
    yield "topk_est must match topk_ids", (
        {**ws, "ids": torch.zeros(2)}, ids, live, 16)


@pytest.mark.parametrize("match,args", list(_bad_fold_calls()))
def test_fold_build_raises_as_the_wrappers_do(match, args):
    with pytest.raises(ValueError, match=match):
        sk.find_fold_record(*args, build_on_cpu=True)


def test_update_and_merge_builds_raise_as_before():
    ws, (ids, live) = _state(), _stream()
    counts = torch.zeros(1, dtype=torch.int64)
    pool = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"live \(3,\) != ids"):
        sk.build_update_record(ws["cms"], ids, live[:3])
    with pytest.raises(ValueError, match="ids: expected"):
        sk.build_update_record(ws["cms"], ids.float(), live)
    with pytest.raises(ValueError, match="a pool of 16 for 15 candidates"):
        sk.build_merge_record(ws["cms"], pool, counts, ws["topk_ids"],
                              ws["topk_est"], ws["ids"], 15)
    with pytest.raises(ValueError, match="counts: expected"):
        sk.build_merge_record(ws["cms"], pool, counts.int(), ws["topk_ids"],
                              ws["topk_est"], ws["ids"], 16)
    with pytest.raises(ValueError, match="total: expected"):
        sk.find_fold_record(ws, ids, live, 16, torch.empty(1).double(),
                            build_on_cpu=True)
    with pytest.raises(ValueError, match="total holds one value"):
        sk.find_fold_record(ws, ids, live, 16, torch.empty(2),
                            build_on_cpu=True)
    # the wrappers on the CPU are the plain versions, as they always were:
    # no record, no launch counted
    before = (sk._FOLD.builds, sk.cms_update.launches,
              sk.topk_pool.launches, sk.topk_merge.launches)
    sk.fold_ids(ws, ids, live, 16)
    assert (sk._FOLD.builds, sk.cms_update.launches, sk.topk_pool.launches,
            sk.topk_merge.launches) == before


# -------------------------------------------------------- the fold's path


@pytest.mark.parametrize("cand", [16, 700, 1000])
def test_fold_path_gives_record_ids_plain_state(cand):
    """``_record`` (the fold record's path) against ``record_ids_plain``
    over three steps on the CPU, ``total`` set by the first width and
    added by the second, as ``update_telemetry`` sums them."""
    cfg = tel.TelemetryConfig(depth=3, buckets=61, topk=8, candidates=cand)
    got, want = _state(), _state()
    for step in range(3):
        ids, live = _stream(seed=10 + step)
        total = torch.empty(1)
        tel._record(got, ids, live, cfg, total, first=True)
        tel._record(got, ids.flip(0), live, cfg, total, first=False)
        c1 = sk.record_ids_plain(want, ids, live, cand)
        c2 = sk.record_ids_plain(want, ids.flip(0), live, cand)
        for k in got:
            assert torch.equal(got[k], want[k]), (step, k)
        assert torch.equal(total, c1 + c2)
    assert tel.record_ids(got, ids, live, cfg) is got


# -------------------------------------------------- the kernels' arithmetic


def _fast_col(h, buckets):
    """``csrc/sketch.cu:fast_col`` in Python integers."""
    if buckets & (buckets - 1) == 0:
        return h & (buckets - 1)
    mult = ((2 ** 64 - 1) // buckets + 1) % 2 ** 64
    return (((mult * h) % 2 ** 64) * buckets) >> 64


@pytest.mark.parametrize("buckets", [1, 2, 3, 7, 61, 2047, 2048, 65_535,
                                     1_000_003, 2 ** 31 - 1, 2 ** 31 + 1,
                                     2 ** 32 - 1])
def test_fast_col_is_the_remainder(buckets):
    rng = np.random.default_rng(buckets % 1000)
    hs = [0, 1, buckets - 1, buckets, buckets + 1, 2 ** 31, 2 ** 32 - 1,
          2 ** 32 - 2, (2 ** 32 - 1) // buckets * buckets,
          *rng.integers(0, 2 ** 32, 3000).tolist()]
    for h in hs:
        h %= 2 ** 32
        assert _fast_col(h, buckets) == h % buckets, (h, buckets)


def _query(cms, ids):
    return sk.cms_query_plain(torch.from_numpy(cms),
                              torch.from_numpy(ids.astype(np.int32))
                              ).numpy()


def _sel_key(score, index):
    """``sel_key``: (INT32_MAX - score) << 32 | index, unsigned 64-bit."""
    high = (0x7FFFFFFF - score.astype(np.int64)).astype(np.uint64)
    return (high << np.uint64(32)) | index.astype(np.uint64)


def _result(keys, all_ids, topk):
    score = 0x7FFFFFFF - (keys[:topk] >> np.uint64(32)).astype(np.int64)
    ix = (keys[:topk] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    ids = np.where(score >= 0, all_ids[ix], -1)
    return ids.astype(np.int32), np.maximum(score, 0).astype(np.int32)


def _merge_block(cms, pool, tids, test, cand_n):
    """K15's one-CTA design (topk + cand_n <= 512): a thread an entry."""
    topk, P = tids.size, pool.size
    M = topk + cand_n
    pool = pool.astype(np.int64)
    # an entry is kept where no earlier entry holds its value; a kept
    # value's place is the number of kept values below it
    keep = np.array([not (pool[:j] == pool[j]).any() for j in range(P)],
                    bool)
    kept = np.where(keep, pool, PAD)
    s_ids = np.full(M, PAD, np.int64)
    s_ids[:topk] = tids
    for j in np.nonzero(keep)[0]:
        s_ids[topk + int((kept < pool[j]).sum())] = pool[j]
    e = np.arange(M)
    need = np.where(e < topk, s_ids >= 0, s_ids != PAD)
    need &= ~((e >= topk) & np.isin(s_ids, tids))
    est = np.where(need, _query(cms, s_ids), -1)
    est = np.where((e < topk) & need, np.maximum(est, np.pad(
        test, (0, cand_n))), est)
    keys = _sel_key(est, e)
    # a key's rank is the number of keys below it; ranks below topk write
    rank = np.array([(keys < k).sum() for k in keys])
    order = np.empty(M, np.uint64)
    order[rank] = keys
    return _result(order, s_ids, topk)


def _tile_rank_sort(keys):
    """Past the warp: sorted tiles of SORT_TILE keys, each key placed at
    its rank in its own tile plus its lower bound in every other tile."""
    m = keys.size
    tiles = [np.sort(keys[b:b + SORT_TILE]) for b in range(0, m, SORT_TILE)]
    out = np.empty(m, keys.dtype)
    for own, t in enumerate(tiles):
        for j, key in enumerate(t):
            rank = j
            for u, other in enumerate(tiles):
                if u != own:
                    pos, step = 0, SORT_TILE
                    while step:  # the kernel's branchless lower bound
                        if pos + step <= other.size and \
                                other[pos + step - 1] < key:
                            pos += step
                        step >>= 1
                    rank += pos
            out[rank] = key
    return out


def _merge_device(cms, pool, tids, test, cand_n):
    """K15's design past one CTA: [pool | carried ids] sorted as one list
    (tiles, then ranks); a pool key whose value differs from the key
    before it starts a candidate, a carried key right after a pool key of
    its value marks that candidate a repeat; then the scores, and the
    selection keys sorted the same way."""
    topk, P = tids.size, pool.size
    M = topk + cand_n
    both = np.concatenate([pool, tids]).astype(np.int64)
    flipped = (both + 2 ** 31).astype(np.uint64)
    keys = (flipped << np.uint64(32)) | np.arange(both.size, dtype=np.uint64)
    srt = _tile_rank_sort(keys)
    vals = (srt >> np.uint64(32)).astype(np.int64) - 2 ** 31
    idx = (srt & np.uint64(0xFFFFFFFF)).astype(np.int64)
    cand = np.full(cand_n, PAD, np.int64)
    dup = np.zeros(cand_n, bool)
    at = 0
    for j in range(srt.size):
        same = j > 0 and vals[j] == vals[j - 1]
        if idx[j] < P:
            if not same:
                cand[at] = vals[j]
                at += 1
        elif same and idx[j - 1] < P:
            dup[at - 1] = True
    all_ids = np.concatenate([tids.astype(np.int64), cand])
    e = np.arange(M)
    q = _query(cms, all_ids)
    est = np.where(e < topk, np.where(all_ids >= 0, np.maximum(
        q, np.pad(test, (0, cand_n))), -1), -1)
    c_ok = (cand != PAD) & ~dup
    est[topk:] = np.where(c_ok, q[topk:], -1)
    return _result(_tile_rank_sort(_sel_key(est, e)), all_ids, topk)


@pytest.mark.parametrize("topk,cand_n,k_pool", [
    (32, 128, 128), (32, 128, 60), (4, 7, 7), (100, 412, 412),
    (200, 313, 300), (2048, 8192, 8192), (32, 16384, 16384),
    (64, 5000, 0)])
def test_k15_designs_equal_the_plain_merge(topk, cand_n, k_pool):
    rng = np.random.default_rng(topk + cand_n + k_pool)
    cms = rng.integers(0, 50, (4, 61)).astype(np.int32)
    # a pool with repeats, the pad id, negative ids and carried ids
    pool = rng.integers(-20, 3 * cand_n, k_pool).astype(np.int32)
    pool[rng.random(k_pool) < 0.05] = PAD
    tids = np.full(topk, -1, np.int32)
    tids[:topk // 2] = rng.integers(-3, 3 * cand_n, topk // 2)
    if k_pool:  # carried ids that the pool repeats, one of them twice
        tids[topk // 2:topk // 2 + 2] = pool[:2]
        tids[-1] = pool[0]
    test = rng.integers(0, 60, topk).astype(np.int32)
    t = {"cms": torch.from_numpy(cms), "ids": torch.zeros(1),
         "topk_ids": torch.from_numpy(tids.copy()),
         "topk_est": torch.from_numpy(test.copy())}
    sk.topk_merge_plain(t["cms"], torch.from_numpy(pool),
                        torch.zeros(1, dtype=torch.int64), t["topk_ids"],
                        t["topk_est"], t["ids"], cand_n)
    designs = [_merge_device]
    if topk + cand_n <= BLOCK_KEYS:
        designs.append(_merge_block)
    for design in designs:
        got_ids, got_est = design(cms, pool, tids, test, cand_n)
        np.testing.assert_array_equal(got_ids, t["topk_ids"].numpy(),
                                      err_msg=design.__name__)
        np.testing.assert_array_equal(got_est, t["topk_est"].numpy(),
                                      err_msg=design.__name__)
