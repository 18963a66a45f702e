"""K1 (``gather_combine``) and the three K10 wrappers
(``lengths_to_splits``, ``row_to_split``, ``ragged_row_ids``) on the
shared launch path (``ops/_kernels.py``), on CPU tensors: the records
are built without a launch (``build_on_cpu``), so their keys, their
reuse and every rebuild or raise run here.

What is held, all exactly (keys are integers, shapes and dtypes):
  - a second call with the same fixed tensors (K1's slab and slot
    metadata, the lengths' ``valid``) and new per-call tensors of the
    same layout finds the record: the build counter stays;
  - every changed key fact (a keyed tensor's address, a shape, a stride,
    a dtype, ``dim_0``, ``capacity``, the output dtype) rebuilds the
    record, or raises as the wrapper always has;
  - a CPU call through the wrapper runs the plain version and keeps no
    record in the wrapper's cache;
  - the key holds every fact the checks read; the payload's output shape
    and dtype, K1's lane load width and the scan's scratch size follow
    from them.
"""

import importlib

import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import _kernels

el = importlib.import_module(
    "distributed_embeddings_torch.ops.embedding_lookup")

torch.set_num_threads(1)


def _k1(seed=0, n=3, b=7, hot=2, w=16, dtype=torch.float32, mask=True,
        weights=True):
    """K1's fixed tensors and a call's per-call tensors."""
    rng = np.random.default_rng(seed)
    fixed = dict(
        slab=torch.from_numpy(rng.normal(size=(n * 10, w)).astype(
            np.float32)).to(dtype),
        rows=torch.full((n,), 10, dtype=torch.int64),
        roff=torch.arange(n, dtype=torch.int64) * 10,
        div=torch.ones(n),
        mask=torch.ones(n, dtype=torch.int32) if mask else None)
    per = dict(ids=torch.from_numpy(rng.integers(-2, 12, (n, b, hot))
                                    .astype(np.int32)),
               weights=(torch.from_numpy(rng.uniform(0.5, 2, (n, b, hot))
                                         .astype(np.float32))
                        if weights else None))
    return fixed, per


def _gfind(cache, fixed, per):
    return el.find_gather_record(
        cache, fixed["slab"], per["ids"], fixed["rows"], fixed["roff"],
        fixed["div"], fixed["mask"], per["weights"], build_on_cpu=True)


# ------------------------------------------------------------------- K1


def test_k1_second_call_reuses_the_record():
    cache = _kernels.LaunchCache()
    fixed, per = _k1()
    rec = _gfind(cache, fixed, per)
    for seed in (1, 2, 3):  # new ids and weights of the same layout
        _, per2 = _k1(seed)
        assert _gfind(cache, fixed, per2) is rec
    assert cache.builds == 1
    assert rec.calls == () and rec.device == -1
    shape, dtype, dev, vb, prepared = rec.payload
    assert (shape, dtype, dev, vb, prepared) == ((3, 7, 16), torch.float32,
                                                 torch.device("cpu"), 16,
                                                 None)


@pytest.mark.parametrize("change", [
    "slab_address", "slab_dtype", "slab_shape", "rows_address",
    "roff_address", "div_address", "mask_address", "mask_removed",
    "ids_shape", "ids_dtype", "ids_strided", "weights_removed",
    "weights_shape", "rows_dtype", "div_device_shape"])
def test_k1_every_changed_fact_rebuilds_or_raises(change):
    cache = _kernels.LaunchCache()
    fixed, per = _k1()
    base = _gfind(cache, fixed, per)
    fixed, per = dict(fixed), dict(per)
    match = None
    if change == "slab_address":
        fixed["slab"] = fixed["slab"].clone()
    elif change == "slab_dtype":
        fixed["slab"] = fixed["slab"].to(torch.bfloat16)
    elif change == "slab_shape":
        fixed["slab"] = fixed["slab"].reshape(15, 32)
    elif change == "rows_address":
        fixed["rows"] = fixed["rows"].clone()
    elif change == "roff_address":
        fixed["roff"] = fixed["roff"].clone()
    elif change == "div_address":
        fixed["div"] = fixed["div"].clone()
    elif change == "mask_address":
        fixed["mask"] = fixed["mask"].clone()
    elif change == "mask_removed":
        fixed["mask"] = None
    elif change == "ids_shape":
        per["ids"] = per["ids"][:, :5].contiguous()
        per["weights"] = per["weights"][:, :5].contiguous()
    elif change == "ids_dtype":
        per["ids"] = per["ids"].long()
    elif change == "ids_strided":
        per["ids"] = per["ids"].transpose(0, 1).contiguous().transpose(0, 1)
        match = "ids: expected a contiguous"
    elif change == "weights_removed":
        per["weights"] = None
    elif change == "weights_shape":
        per["weights"] = per["weights"][:, :, :1].contiguous()
        match = "weights: expected"
    elif change == "rows_dtype":
        fixed["rows"] = fixed["rows"].int()
        match = "rows: expected"
    else:
        fixed["div"] = torch.ones(4)
        match = "div: expected"
    before = cache.builds
    if match:
        with pytest.raises(ValueError, match=match):
            _gfind(cache, fixed, per)
    else:
        rec = _gfind(cache, fixed, per)
        assert rec is not base and cache.builds == before + 1
        assert _gfind(cache, fixed, per) is rec
    assert base in cache.records.values()


def test_k1_key_holds_every_fact():
    fixed, per = _k1()
    key = el.gather_record_key(fixed["slab"], per["ids"], fixed["rows"],
                               fixed["roff"], fixed["div"], fixed["mask"],
                               per["weights"])
    for name in ("slab", "rows", "roff", "div", "mask"):
        t = fixed[name]
        assert t.data_ptr() in key and t.shape in key and t.dtype in key
        assert t.stride() in key
    assert _kernels.layout_key(per["ids"]) in key
    assert _kernels.layout_key(per["weights"]) in key
    assert per["ids"].data_ptr() not in key  # read per call
    nomask = el.gather_record_key(fixed["slab"], per["ids"], fixed["rows"],
                                  fixed["roff"], fixed["div"], None, None)
    assert nomask != key and nomask[0] == 4 and key[0] == 5


def test_k1_lane_load_follows_the_slab():
    """16 B lanes where a row and the slab's address allow it, down to one
    element for a view one element past an allocation; the dtype code
    comes with the slab's dtype."""
    for dtype, w, want in ((torch.float32, 16, 16), (torch.float32, 3, 4),
                           (torch.float32, 6, 8), (torch.bfloat16, 128, 16),
                           (torch.bfloat16, 3, 2), (torch.bfloat16, 12, 8)):
        slab = torch.zeros(5, w, dtype=dtype)
        assert el.vector_bytes(slab) == want
        flat = torch.zeros(5 * w + 1, dtype=dtype)
        assert el.vector_bytes(flat[1:].view(5, w)) == slab.element_size()


def test_k1_cpu_call_keeps_no_record():
    fixed, per = _k1()
    before = (el._GATHER.builds, el.gather_combine.launches)
    got = el.gather_combine(fixed["slab"], per["ids"], fixed["rows"],
                            fixed["roff"], fixed["div"], fixed["mask"],
                            per["weights"])
    want = el.gather_combine_plain(fixed["slab"], per["ids"], fixed["rows"],
                                   fixed["roff"], fixed["div"],
                                   fixed["mask"], per["weights"])
    assert torch.equal(got, want)
    assert (el._GATHER.builds, el.gather_combine.launches) == before
    with pytest.raises(ValueError, match=r"ids must be \[n, b, hot\]"):
        el.gather_combine(fixed["slab"], per["ids"][0], fixed["rows"],
                          fixed["roff"], fixed["div"])


# ------------------------------------------------------------------ K10


def _block(n=3, b=9, cap=20, dtype=torch.int32, seed=0):
    """An id block ``[n, cap + b]`` and its lengths view (rows strided
    by ``cap + b``), as the lookup reads them."""
    rng = np.random.default_rng(seed)
    block = torch.from_numpy(rng.integers(0, 5, (n, cap + b))).to(dtype)
    return block, block[:, cap:]


@pytest.mark.parametrize("valid", [False, True])
def test_lengths_second_call_reuses_the_record(valid):
    cache = _kernels.LaunchCache()
    v = torch.tensor([1, 0, 1], dtype=torch.int32) if valid else None
    _, lengths = _block()
    rec = el.find_splits_record(cache, lengths, v, build_on_cpu=True)
    for seed in (1, 2):  # a new block of the same layout
        _, again = _block(seed=seed)
        assert el.find_splits_record(cache, again, v,
                                     build_on_cpu=True) is rec
    assert cache.builds == 1
    shape, dtype, dev, scratch, prepared = rec.payload
    assert (shape, dtype, dev) == ((3, 10), torch.int64, torch.device("cpu"))
    assert scratch is None and prepared is None and rec.calls == ()


@pytest.mark.parametrize("change", [
    "valid_address", "valid_added", "lengths_shape", "lengths_stride",
    "lengths_dtype", "lengths_element_stride", "valid_shape",
    "lengths_3d"])
def test_lengths_every_changed_fact_rebuilds_or_raises(change):
    cache = _kernels.LaunchCache()
    valid = torch.tensor([1, 0, 1], dtype=torch.int32)
    block, lengths = _block()
    base = el.find_splits_record(cache, lengths, valid, build_on_cpu=True)
    match = None
    if change == "valid_address":
        valid = valid.clone()
    elif change == "valid_added":
        valid = None
    elif change == "lengths_shape":
        lengths = block[:, 21:]
    elif change == "lengths_stride":
        lengths = lengths.contiguous()
    elif change == "lengths_dtype":
        lengths = _block(dtype=torch.int64)[1]
    elif change == "lengths_element_stride":
        lengths = block[:, ::2]
        match = "unit element stride"
    elif change == "valid_shape":
        valid = torch.ones(2, dtype=torch.int32)
        match = "valid: expected"
    else:
        lengths = block[None]
        match = r"lengths must be \[n, b\]"
    before = cache.builds
    if match:
        with pytest.raises(ValueError, match=match):
            el.find_splits_record(cache, lengths, valid, build_on_cpu=True)
    else:
        rec = el.find_splits_record(cache, lengths, valid,
                                    build_on_cpu=True)
        assert rec is not base and cache.builds == before + 1
    assert base in cache.records.values()


def test_lengths_key_and_scratch():
    valid = torch.tensor([1, 0, 1], dtype=torch.int32)
    _, lengths = _block()
    key = el.splits_record_key(lengths, valid)
    assert key == (_kernels.tensor_key((valid,)),
                   _kernels.layout_key(lengths))
    assert lengths.data_ptr() not in key[0]
    assert el.splits_record_key(lengths, None)[0] is None
    # an aggregate, an inclusive prefix and a status word (int64) a tile
    # of 4,096 lengths, and the 64-bit tile counter
    tile = el.SCAN_TILE
    assert tile == 4096
    for n, b, tiles in ((26, 65536, 416), (1, 1, 1), (2, 0, 2),
                        (3, 4097, 6), (2, 300001, 148)):
        assert el.scan_scratch_bytes(n, b) == tiles * 24 + 8


def _coo(dtype=torch.int64, nnz=30, dim0=8):
    rows = torch.sort(torch.randint(-2, dim0 + 3, (nnz,),
                                    generator=torch.Generator().manual_seed(
                                        nnz))).values.to(dtype)
    return torch.stack([rows, torch.zeros_like(rows)], 1)


def test_row_to_split_second_call_reuses_the_record():
    cache = _kernels.LaunchCache()
    rec = el.find_row_split_record(cache, _coo(), 8, build_on_cpu=True)
    for _ in range(3):  # new indices of the same layout
        assert el.find_row_split_record(cache, _coo(), 8,
                                        build_on_cpu=True) is rec
    assert cache.builds == 1
    assert rec.payload[:3] == ((9,), torch.int64, torch.device("cpu"))


@pytest.mark.parametrize("change", [
    "dim_0", "out_dtype", "indices_shape", "indices_dtype", "rows_form",
    "indices_strided", "indices_3_cols", "out_float"])
def test_row_to_split_every_changed_fact_rebuilds_or_raises(change):
    cache = _kernels.LaunchCache()
    idx, dim0, dtype = _coo(), 8, None
    base = el.find_row_split_record(cache, idx, dim0, dtype,
                                    build_on_cpu=True)
    match = None
    if change == "dim_0":
        dim0 = 9
    elif change == "out_dtype":
        dtype = torch.int32
    elif change == "indices_shape":
        idx = _coo(nnz=31)
    elif change == "indices_dtype":
        idx = _coo(torch.int32)
    elif change == "rows_form":
        idx = idx[:, 0].contiguous()
    elif change == "indices_strided":
        idx = torch.stack([idx[:, 1], idx[:, 0]]).t()
        match = "contiguous"
    elif change == "indices_3_cols":
        idx = torch.zeros(30, 3, dtype=torch.int64)
        match = r"indices must be \[nnz\] or \[nnz, 2\]"
    else:
        dtype = torch.float32
        match = "is not int32/int64"
    before = cache.builds
    if match:
        with pytest.raises(ValueError, match=match):
            el.find_row_split_record(cache, idx, dim0, dtype,
                                     build_on_cpu=True)
    else:
        rec = el.find_row_split_record(cache, idx, dim0, dtype,
                                       build_on_cpu=True)
        assert rec is not base and cache.builds == before + 1
        assert rec.payload[:2] == ((dim0 + 1,), dtype or idx.dtype)
    assert base in cache.records.values()


def test_ragged_row_ids_records():
    """Reuse on new splits of one layout; a capacity, a shape, a dtype
    or leading dims rebuild; a strided or float splits tensor raises."""
    cache = _kernels.LaunchCache()
    sp = torch.tensor([[0, 2, 2, 5], [0, 1, 4, 4]], dtype=torch.int64)
    rec = el.find_row_ids_record(cache, sp, 7, build_on_cpu=True)
    assert el.find_row_ids_record(cache, sp.clone(), 7,
                                  build_on_cpu=True) is rec
    assert rec.payload[:3] == ((2, 7), torch.int64, torch.device("cpu"))
    assert el.row_ids_record_key(sp, 7) == (_kernels.layout_key(sp), 7)
    for other, cap in ((sp, 8), (sp.int(), 7), (sp[:, :3].contiguous(), 7),
                       (sp.reshape(2, 1, 4), 7), (sp[0].contiguous(), 7)):
        n0 = cache.builds
        got = el.find_row_ids_record(cache, other, cap, build_on_cpu=True)
        assert got is not rec and cache.builds == n0 + 1
        assert got.payload[0] == (*other.shape[:-1], cap)
    for bad in (sp.t(), sp.float()):
        with pytest.raises(ValueError, match="row_splits: expected"):
            el.find_row_ids_record(cache, bad, 7, build_on_cpu=True)


def test_k10_cpu_calls_keep_no_record():
    caches = (el._SPLITS, el._ROW_SPLITS, el._ROW_IDS)
    before = [c.builds for c in caches] + [
        el.lengths_to_splits.launches, el.row_to_split.launches,
        el.ragged_row_ids.launches]
    _, lengths = _block()
    sp = el.lengths_to_splits(lengths)
    assert torch.equal(sp, el.lengths_to_splits_plain(lengths))
    idx = _coo()
    assert torch.equal(el.row_to_split(idx, 8),
                       el.row_to_split_plain(idx, 8))
    assert torch.equal(el.ragged_row_ids(sp, 12),
                       el.ragged_row_ids_plain(sp, 12))
    after = [c.builds for c in caches] + [
        el.lengths_to_splits.launches, el.row_to_split.launches,
        el.ragged_row_ids.launches]
    assert after == before
    with pytest.raises(ValueError, match=r"indices must be"):
        el.row_to_split(torch.zeros(4, 3, dtype=torch.int64), 8)
    with pytest.raises(ValueError, match=r"lengths must be \[n, b\]"):
        el.lengths_to_splits(lengths[0])


def _fill(bnd, total, entries):
    """``csrc/csr.cu``'s fill_kernel in numpy: entries k = 0..m (m =
    len(bnd)) with B(-1) = 0, B(k) = bnd[k], B(m) = total; each block of
    ``entries`` writes [B(k0 - 1), B(k0 + c - 1)), each position p the
    value k0 - 1 + i for the first i in [1, c] with B(k0 - 1 + i) > p
    (a binary search). -1 marks a position no block wrote."""
    b = np.concatenate([[0], bnd, [total]])  # b[k + 1] = B(k)
    m = len(bnd)
    out = np.full(total, -1, np.int64)
    for k0 in range(0, m + 1, entries):
        c = min(entries, m + 1 - k0)
        loc = b[k0:k0 + c + 1]            # loc[i] = B(k0 - 1 + i)
        for p in range(loc[0], loc[c]):
            lo, up = 1, c
            while lo < up:
                mid = (lo + up) // 2
                if loc[mid] > p:
                    up = mid
                else:
                    lo = mid + 1
            out[p] = k0 - 1 + lo
    return out


@pytest.mark.parametrize("entries", [1, 3, 1024])
def test_k10_fill_rule_equals_the_plain_versions(entries):
    """The kernels' write rule (:func:`_fill`): for row_to_split B(k) =
    clip(row_k + 1, 0, dim0 + 1), for ragged_row_ids B(r) =
    clip(splits[r + 1], 0, cap). It equals the plain versions on
    ascending input (empty, negative and padding rows, ``nnz`` 0 and 1,
    capacities below and above the total), and on input that does not
    ascend it still writes every entry, each a value in [0, m]."""
    rng = np.random.default_rng(5)
    dim0 = 40
    rows = np.sort(rng.integers(-5, dim0 + 5, 200))
    for r in (rows, rows[:0], rows[:1], np.full(9, dim0), np.full(4, -3),
              np.concatenate([np.full(50, -1), np.full(60, 30)])):
        got = _fill(np.clip(r + 1, 0, dim0 + 1), dim0 + 1, entries)
        want = el.row_to_split_plain(torch.from_numpy(r), dim0).numpy()
        np.testing.assert_array_equal(got, want)
    lengths = rng.integers(0, 6, (3, 50))
    splits = torch.from_numpy(np.concatenate(
        [np.zeros((3, 1), np.int64), np.cumsum(lengths, 1)], 1))
    for cap in (1, 40, int(splits[:, -1].max()), 300):
        for k in range(3):
            got = _fill(np.clip(splits[k, 1:].numpy(), 0, cap), cap, entries)
            want = el.ragged_row_ids_plain(splits[k], cap).numpy()
            np.testing.assert_array_equal(got, want)
    for _ in range(5):
        shuffled = rng.permutation(rows)
        got = _fill(np.clip(shuffled + 1, 0, dim0 + 1), dim0 + 1, entries)
        assert (got >= 0).all() and (got <= len(rows)).all()
