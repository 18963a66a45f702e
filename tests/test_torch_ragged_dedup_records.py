"""K8 (``ragged_combine``) and K5 (``dedup_sparse_grad``) on the shared
launch path (``ops/_kernels.py``), on CPU tensors: the records are built
without a launch (``build_on_cpu``), so their keys, their reuse and every
rebuild or raise run here.

What is held, all exactly (keys are integers, shapes and dtypes):
  - a second call with the same fixed tensors (K8's slab and slot
    metadata) and new per-call tensors of the same layout (K8's values,
    splits and weights; K5's ids, rows and mask) finds the record: the
    build counter stays;
  - every changed key fact (a keyed tensor's address, a shape, a stride,
    a dtype, which optional tensors are given, the output dtype, the pad
    id, the bound) rebuilds the record, or raises as the wrapper always
    has;
  - a CPU call through the wrapper runs the plain version and keeps no
    record in the wrapper's cache;
  - the payload's output shape and dtype follow from the key.
"""

import importlib

import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import _kernels

el = importlib.import_module(
    "distributed_embeddings_torch.ops.embedding_lookup")
sg = importlib.import_module("distributed_embeddings_torch.ops.sparse_grad")

torch.set_num_threads(1)


# ------------------------------------------------------------------- K8


def _k8(seed=0, n=3, b=6, cap=20, w=16, dtype=torch.float32, mean=True,
        mask=True, weights=True, ids_dtype=torch.int32):
    """K8's fixed tensors and a call's per-call tensors: values and
    in-block weight bits as strided views of one id block."""
    rng = np.random.default_rng(seed)
    fixed = dict(
        slab=torch.from_numpy(rng.normal(size=(n * 10, w)).astype(
            np.float32)).to(dtype),
        rows=torch.full((n,), 10, dtype=torch.int64),
        roff=torch.arange(n, dtype=torch.int64) * 10,
        mean=torch.tensor([1, 0, 1][:n], dtype=torch.int32) if mean
        else None,
        mask=torch.ones(n, dtype=torch.int32) if mask else None)
    lengths = rng.integers(0, 4, size=(n, b))
    splits = np.zeros((n, b + 1), np.int64)
    np.cumsum(lengths, axis=1, out=splits[:, 1:])
    block = torch.from_numpy(np.concatenate(
        [rng.integers(-2, 12, (n, cap)),
         rng.uniform(0.5, 2, (n, cap)).astype(np.float32).view(np.int32)],
        1)).to(ids_dtype)
    per = dict(values=block[:, :cap], splits=torch.from_numpy(splits),
               weights=block[:, cap:] if weights else None)
    return fixed, per


def _kfind(cache, fixed, per, out_dtype=None):
    return el.find_ragged_record(
        cache, fixed["slab"], per["values"], per["splits"], fixed["rows"],
        fixed["roff"], fixed["mean"], fixed["mask"], per["weights"],
        out_dtype, build_on_cpu=True)


def test_k8_second_call_reuses_the_record():
    cache = _kernels.LaunchCache()
    fixed, per = _k8()
    rec = _kfind(cache, fixed, per)
    for seed in (1, 2, 3):  # new values, splits and weights, one layout
        _, per2 = _k8(seed)
        assert _kfind(cache, fixed, per2) is rec
    assert cache.builds == 1
    assert rec.calls == () and rec.device == -1
    assert rec.payload == ((3, 6, 16), torch.float32, torch.device("cpu"),
                           None)


@pytest.mark.parametrize("change", [
    "slab_address", "slab_dtype", "slab_shape", "rows_address",
    "roff_address", "mean_address", "mean_removed", "mask_address",
    "mask_removed", "values_shape", "values_dtype", "values_stride",
    "splits_shape", "weights_removed", "weights_f32", "out_dtype",
    "values_strided_elements", "weights_short", "splits_dtype",
    "mean_dtype", "slab_strided"])
def test_k8_every_changed_fact_rebuilds_or_raises(change):
    cache = _kernels.LaunchCache()
    fixed, per = _k8()
    base = _kfind(cache, fixed, per)
    fixed, per = dict(fixed), dict(per)
    out_dtype, match = None, None
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
    elif change == "mean_address":
        fixed["mean"] = fixed["mean"].clone()
    elif change == "mean_removed":
        fixed["mean"] = None
    elif change == "mask_address":
        fixed["mask"] = fixed["mask"].clone()
    elif change == "mask_removed":
        fixed["mask"] = None
    elif change == "values_shape":
        per["values"] = per["values"][:, :15]
    elif change == "values_dtype":
        _, per = _k8(ids_dtype=torch.int64)
    elif change == "values_stride":
        per["values"] = per["values"].contiguous()
    elif change == "splits_shape":
        per["splits"] = per["splits"][:, :4].contiguous()
    elif change == "weights_removed":
        per["weights"] = None
    elif change == "weights_f32":
        per["weights"] = per["weights"].view(torch.float32).contiguous()
    elif change == "out_dtype":
        out_dtype = torch.bfloat16
    elif change == "values_strided_elements":
        per["values"] = per["values"].t().contiguous().t()
        match = "values: expected"
    elif change == "weights_short":
        per["weights"] = per["weights"][:, :10]
        match = "weights: 10 per slot"
    elif change == "splits_dtype":
        per["splits"] = per["splits"].int()
        match = "splits: expected"
    elif change == "mean_dtype":
        fixed["mean"] = fixed["mean"].long()
        match = "mean: expected"
    else:
        fixed["slab"] = fixed["slab"][:, :8]
        match = "slab must be a contiguous"
    before = cache.builds
    if match:
        with pytest.raises(ValueError, match=match):
            _kfind(cache, fixed, per, out_dtype)
    else:
        rec = _kfind(cache, fixed, per, out_dtype)
        assert rec is not base and cache.builds == before + 1
        assert _kfind(cache, fixed, per, out_dtype) is rec
    assert base in cache.records.values()


def test_k8_key_holds_every_fact():
    fixed, per = _k8()
    args = (fixed["slab"], per["values"], per["splits"], fixed["rows"],
            fixed["roff"])
    key = el.ragged_record_key(*args, fixed["mean"], fixed["mask"],
                               per["weights"], torch.bfloat16)
    for name in ("slab", "rows", "roff", "mean", "mask"):
        t = fixed[name]
        assert t.data_ptr() in key and t.shape in key and t.dtype in key
        assert t.stride() in key
    for name in ("values", "splits", "weights"):
        assert _kernels.layout_key(per[name]) in key
        assert per[name].data_ptr() not in key  # read per call
    assert key[0] == 3 and torch.bfloat16 in key
    # which of mean / mask are given leads the key
    only_mean = el.ragged_record_key(*args, fixed["mean"], None)
    only_mask = el.ragged_record_key(*args, None, fixed["mean"])
    assert only_mean[0] == 1 and only_mask[0] == 2
    assert only_mean != only_mask
    assert el.ragged_record_key(*args)[0] == 0
    # the output dtype is its own record
    assert el.ragged_record_key(*args, out_dtype=torch.bfloat16) != \
        el.ragged_record_key(*args)


def test_k8_cpu_call_keeps_no_record():
    fixed, per = _k8()
    args = (fixed["slab"], per["values"], per["splits"], fixed["rows"],
            fixed["roff"])
    kw = dict(mean=fixed["mean"], mask=fixed["mask"],
              weights=per["weights"])
    before = (el._RAGGED.builds, el.ragged_combine.launches)
    got = el.ragged_combine(*args, **kw)
    assert torch.equal(got, el.ragged_combine_plain(*args, **kw))
    assert (el._RAGGED.builds, el.ragged_combine.launches) == before
    with pytest.raises(ValueError, match=r"values must be \[n, cap\]"):
        el.ragged_combine(fixed["slab"], per["values"][0], *args[2:])


# ------------------------------------------------------------------- K5


def _k5(seed=0, n=50, w=16, dtype=torch.float32, ids_dtype=torch.int32,
        valid=False):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(-3, 30, n)).to(ids_dtype)
    grads = torch.from_numpy(rng.normal(size=(n, w)).astype(
        np.float32)).to(dtype)
    v = torch.from_numpy(rng.random(n) < 0.7) if valid else None
    return ids, grads, v


def _dfind(cache, ids, grads, v, pad_id=30, max_unique=None):
    return sg.find_dedup_record(cache, ids, grads, pad_id, v, max_unique,
                                build_on_cpu=True)


@pytest.mark.parametrize("valid", [False, True])
def test_k5_second_call_reuses_the_record(valid):
    cache = _kernels.LaunchCache()
    rec = _dfind(cache, *_k5(valid=valid), max_unique=31)
    for seed in (1, 2):  # new ids, rows and mask of the same layout
        assert _dfind(cache, *_k5(seed, valid=valid), max_unique=31) is rec
    assert cache.builds == 1 and rec.calls == () and rec.device == -1
    u, idt, gdt, w, dev, scratch, prepared = rec.payload
    assert (u, idt, gdt, w, dev) == (31, torch.int32, torch.float32, 16,
                                     torch.device("cpu"))
    assert scratch is None and prepared is None


@pytest.mark.parametrize("change", [
    "ids_dtype", "ids_shape", "grads_dtype", "grads_width", "valid_added",
    "pad_id", "max_unique", "max_unique_none", "ids_strided",
    "grads_2d_ids", "grads_rows", "valid_dtype", "max_unique_negative"])
def test_k5_every_changed_fact_rebuilds_or_raises(change):
    cache = _kernels.LaunchCache()
    ids, grads, v = _k5()
    base = _dfind(cache, ids, grads, v, max_unique=31)
    pad, mu, match = 30, 31, None
    if change == "ids_dtype":
        ids = ids.long()
    elif change == "ids_shape":
        ids, grads = ids[:40].clone(), grads[:40].clone()
    elif change == "grads_dtype":
        grads = grads.to(torch.bfloat16)
    elif change == "grads_width":
        grads = grads[:, :8].contiguous()
    elif change == "valid_added":
        v = torch.ones(50, dtype=torch.bool)
    elif change == "pad_id":
        pad = 31
    elif change == "max_unique":
        mu = 12
    elif change == "max_unique_none":
        mu = None
    elif change == "ids_strided":
        ids = torch.stack([ids, ids], 1)[:, 0]
        match = "must be contiguous"
    elif change == "grads_2d_ids":
        ids = ids.reshape(5, 10)
        match = r"ids: expected \[n\]"
    elif change == "grads_rows":
        grads = grads[:40]
        match = r"grads: expected \[50, w\]"
    elif change == "valid_dtype":
        v = torch.ones(50, dtype=torch.int32)
        match = "valid: expected"
    else:
        mu = -1
        match = "negative"
    before = cache.builds
    if match:
        with pytest.raises(ValueError, match=match):
            _dfind(cache, ids, grads, v, pad, mu)
    else:
        rec = _dfind(cache, ids, grads, v, pad, mu)
        assert rec is not base and cache.builds == before + 1
        assert _dfind(cache, ids, grads, v, pad, mu) is rec
    assert base in cache.records.values()


def test_k5_key_holds_every_fact():
    ids, grads, v = _k5(valid=True)
    key = sg.dedup_record_key(ids, grads, 30, v, 31)
    for t in (ids, grads, v):
        assert _kernels.layout_key(t) in key
        assert t.data_ptr() not in key  # read per call
    assert key[-2:] == (30, 31)
    assert sg.dedup_record_key(ids, grads, 30, None, None)[-3:] == (
        None, 30, None)


def test_k5_cpu_call_keeps_no_record():
    ids, grads, v = _k5(valid=True)
    before = (sg._DEDUP.builds, sg.dedup_sparse_grad.launches)
    got = sg.dedup_sparse_grad(ids, grads, pad_id=30, valid=v,
                               max_unique=12)
    want = sg.dedup_sparse_grad_plain(ids, grads, pad_id=30, valid=v,
                                      max_unique=12)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (12,) and got[1].shape == (12, 16)
    assert (sg._DEDUP.builds, sg.dedup_sparse_grad.launches) == before
