"""K16's and K17's launch records (``ops/streaming.py``) on CPU tensors,
the views of an update call's one allocation, and the plain remap against
the JAX package's ``remap_width`` where claims crowd one row.

What is held, all exactly (integers and addresses):
  - K16's key, in both modes, holds the layouts of the tensors the call
    reads (so ``n``, the id dtype, ``rows_cap`` and the sketch's shape)
    and, for the update, ``admit_min_count`` and ``evict_margin``; no
    address: fresh tensors of the same layouts find the record, each
    changed fact builds another, and the read-only key ignores the
    sketch and the policy;
  - K17's key holds the leaves' count, dtypes and fills, ``finalize``,
    whether ``enable`` is given, and the layouts of every tensor the call
    passes (the slab, the leaves, the ``pend`` views, the slot map, the
    sketch and its staged copy, totals, counters, ``steps``, ``enable``);
    no address: fresh tensors of the same layouts find the record and each
    changed fact builds another; a call passes one address a tensor, in
    the kernel's order, padded with nulls to the launch's five slots for
    the leaves and ``enable``;
  - the records validate as the wrappers always have, raising the same
    errors;
  - an update call's outputs are views of one allocation at the kernel's
    offsets (``csrc/streaming.cu:detpu_stream_remap_launch``): 16-byte
    aligned, disjoint, int32 ``[n]`` each and int64 counts;
  - the plain remap (the kernel's yardstick on the card) equals JAX's
    ``remap_width`` with int32 ids and with int64 ids below 2^31 (JAX runs
    without x64 here: it takes the same ids as int32), on streams where
    many claims fall on one row and claims tie on (estimate,
    fingerprint), so the position decides; a control that drops the
    position tie-break must differ from JAX.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.parallel import streaming as js

from distributed_embeddings_torch.ops import _kernels
from distributed_embeddings_torch.ops import remap_stage
from distributed_embeddings_torch.ops import sketch as sk
from distributed_embeddings_torch.parallel import StreamingConfig
from distributed_embeddings_torch.parallel import streaming as ts

som = importlib.import_module("distributed_embeddings_torch.ops.streaming")

torch.set_num_threads(1)

CFG = StreamingConfig(admit_min_count=2, evict_margin=1, depth=3,
                      buckets=61)


def _args(seed=0, n=40, rows_cap=64, ids=torch.int32, depth=3, buckets=61,
          admit=2, margin=1, update=True):
    g = torch.Generator().manual_seed(seed)
    i32 = torch.int32
    return (torch.randint(0, 1000, (n,), generator=g).to(ids),
            torch.ones(n, dtype=torch.bool), torch.full((n,), 20, dtype=i32),
            torch.full((n,), 4, dtype=i32), torch.full((n,), 3, dtype=i32),
            torch.zeros(n, dtype=i32), torch.full((rows_cap,), -1, dtype=i32),
            torch.zeros(rows_cap, dtype=i32),
            torch.zeros((depth, buckets), dtype=i32), admit, margin, update)


def _find(cache, args):
    return _kernels.find_or_build(cache, som.remap_key(*args),
                                  som.build_remap_record, True, True, *args)


@pytest.mark.parametrize("update", [True, False])
def test_keys_hold_no_addresses_and_fresh_tensors_hit(update):
    cache = _kernels.LaunchCache()
    a, b = _args(0, update=update), _args(1, update=update)
    assert som.remap_key(*a) == som.remap_key(*b)
    ptrs = {t.data_ptr() for t in a[:9] + b[:9]}
    assert not ptrs & {k for k in som.remap_key(*a) if isinstance(k, int)}
    rec = _find(cache, a)
    assert _find(cache, b) is rec and cache.builds == 1
    assert rec.calls == () and rec.payload == (None, None)


@pytest.mark.parametrize("update", [True, False])
@pytest.mark.parametrize("change", [
    dict(n=41), dict(ids=torch.int64), dict(rows_cap=65), dict(depth=4),
    dict(buckets=62), dict(admit=3), dict(margin=0)])
def test_each_fact_builds_a_new_record(update, change):
    """n, the id dtype and rows_cap key both modes; the sketch's shape and
    the policy key the update only."""
    cache = _kernels.LaunchCache()
    _find(cache, _args(update=update))
    _find(cache, _args(update=update, **change))
    policy = set(change) & {"depth", "buckets", "admit", "margin"}
    assert cache.builds == (2 if update or not policy else 1)
    _find(cache, _args(update=not update))
    assert cache.builds == (3 if update or not policy else 2)


def test_read_only_key_ignores_the_sketch_and_policy():
    a = _args(update=False)
    b = list(a)
    b[7], b[8], b[9], b[10] = None, None, 7, -3
    assert som.remap_key(*a) == som.remap_key(*b)
    assert som.remap_key(*a) != som.remap_key(*_args(update=True))


def test_records_validate_and_raise_as_before():
    def raises(match, changes, update=True):
        args = list(_args(update=update))
        for k, v in changes.items():
            args[k] = v
        with pytest.raises(ValueError, match=match):
            som.find_remap_record(*args, build_on_cpu=True)

    i32 = torch.int32
    raises("ext: expected a contiguous", {0: torch.zeros(40, 2, dtype=i32)})
    raises("ext: expected a contiguous", {0: torch.zeros(40)})
    raises("live: expected a contiguous", {1: torch.ones(40, dtype=i32)})
    raises("cap: expected a contiguous", {2: torch.zeros(80, dtype=i32)[::2]})
    raises("roff: expected a contiguous", {5: torch.zeros(39, dtype=i32)})
    raises("slot_fp: expected a contiguous",
           {6: torch.zeros(64, dtype=torch.int64)}, update=False)
    raises("slot_freq: expected a contiguous", {7: torch.zeros(63,
                                                               dtype=i32)})
    raises(r"cms: expected \[depth, buckets\]", {8: torch.zeros(9,
                                                                dtype=i32)})
    raises("an update needs slot_freq and cms", {8: None})
    m = torch.zeros(4, dtype=i32, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        remap_stage(m, m.bool(), m, m, m, m, m, m, None, 2, 1,
                    update=False)
    # the CPU wrapper runs the plain version, builds nothing
    before = (remap_stage.launches, som._CACHE.builds)
    remap_stage(*_args())
    remap_stage(*_args(update=False))
    assert (remap_stage.launches, som._CACHE.builds) == before


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4097, 327_680])
def test_update_outputs_are_views_of_one_allocation(n):
    buf, r = som.update_outputs(n, "cpu")
    n4 = som.out_stride(n)
    assert n4 % 4 == 0 and n <= n4 < n + 4
    assert buf.dtype == torch.int32 and buf.numel() == 8 + 5 * n4
    views = list(r)
    assert [f for f in som.Remap._fields] == [
        "local_rows", "fp", "est", "scrub_rows", "hit_rows", "counts"]
    assert [v.dtype for v in views] == [torch.int32] * 5 + [torch.int64]
    assert [tuple(v.shape) for v in views] == [(n,)] * 5 + [(4,)]
    assert all(v.untyped_storage().data_ptr() ==
               buf.untyped_storage().data_ptr() for v in views)
    assert buf.data_ptr() % 16 == 0

    def at(v):  # byte offset in the allocation
        return v.storage_offset() * v.element_size()

    # the kernel's offsets: counts at 0, view k at 32 + 4 * k * n4 bytes
    # (an empty view holds no bytes to place)
    assert at(r.counts) == 0
    for k, v in enumerate(views[:5]):
        assert v.is_contiguous()
        if n:
            assert at(v) == 32 + 4 * k * n4 and at(v) % 16 == 0
    spans = sorted((at(v), at(v) + v.numel() * v.element_size())
                   for v in views if v.numel())
    assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= buf.numel() * 4


# ------------------------------------------------------- K17's records


def _commit_args(seed=0, n=40, rows_cap=64, w=8, sdt=torch.float32,
                 leaves=((torch.float32, 0.1),), enable=True, finalize=True):
    """One ``commit_rows`` call's positional arguments (CPU tensors) and
    its keywords."""
    g = torch.Generator().manual_seed(seed)
    i32 = torch.int32
    lv = [(torch.rand((rows_cap, w), generator=g).to(dt), f)
          for dt, f in leaves]
    pend = som.Remap(torch.zeros(n, dtype=i32),
                     torch.randint(0, 2 ** 31 - 1, (n,), generator=g,
                                   dtype=i32),
                     torch.randint(0, 9, (n,), generator=g, dtype=i32),
                     torch.randint(0, rows_cap + 1, (n,), generator=g,
                                   dtype=i32),
                     torch.randint(0, rows_cap + 1, (n,), generator=g,
                                   dtype=i32),
                     torch.zeros(4, dtype=torch.int64))
    args = (torch.randn((rows_cap, w), generator=g).to(sdt), lv, pend,
            torch.full((rows_cap,), -1, dtype=i32),
            torch.zeros(rows_cap, dtype=i32), torch.zeros((3, 61), dtype=i32),
            torch.zeros((3, 61), dtype=i32), torch.zeros(4),
            [torch.zeros(1) for _ in range(4)], torch.zeros(1, dtype=i32))
    kw = {"enable": torch.tensor(True) if enable else None,
          "finalize": finalize}
    return args, kw


def _find_commit(cache, args, kw):
    return _kernels.find_or_build(
        cache, som.commit_key(*args, **kw), som.build_commit_record, True,
        True, *args, kw["enable"], kw["finalize"])


@pytest.mark.parametrize("enable", [True, False])
def test_k17_key_holds_no_addresses_and_fresh_tensors_hit(enable):
    cache = _kernels.LaunchCache()
    (a, kw), (b, kwb) = (_commit_args(0, enable=enable),
                         _commit_args(1, enable=enable))
    assert som.commit_key(*a, **kw) == som.commit_key(*b, **kwb)
    ts = som._commit_tensors(*a, kw["enable"])
    assert len(ts) == 16 + 1 + enable
    ptrs = {t.data_ptr() for t in ts}
    assert not ptrs & {k for k in som.commit_key(*a, **kw)
                       if isinstance(k, int)}
    rec = _find_commit(cache, a, kw)
    assert _find_commit(cache, b, kwb) is rec and cache.builds == 1
    prepared, pad = rec.payload
    assert rec.calls == () and prepared is None
    assert len(ts) + len(pad) == 21 and set(pad) <= {None}


@pytest.mark.parametrize("change", [
    dict(n=41), dict(n=0), dict(rows_cap=65), dict(w=16),
    dict(sdt=torch.bfloat16), dict(leaves=()),
    dict(leaves=((torch.bfloat16, 0.1),)), dict(leaves=((torch.float32, 0.0),)),
    dict(leaves=((torch.float32, 0.1), (torch.float32, 0.1))),
    dict(leaves=((torch.float32, 0.1),) * 4), dict(enable=False),
    dict(finalize=False)])
def test_k17_each_fact_builds_a_new_record(change):
    """n, rows_cap, the width, the slab's dtype, the leaves' count, dtypes
    and fills, whether enable is given, and finalize each key the record."""
    cache = _kernels.LaunchCache()
    _find_commit(cache, *_commit_args())
    _find_commit(cache, *_commit_args(**change))
    assert cache.builds == 2
    _find_commit(cache, *_commit_args(seed=5))
    _find_commit(cache, *_commit_args(seed=6, **change))
    assert cache.builds == 2


@pytest.mark.parametrize("leaves,enable", [
    (((torch.float32, 0.1), (torch.bfloat16, 0.0)), True),
    ((), False), (((torch.float32, 0.1),) * 4, True)])
def test_k17_argument_block_holds_the_call_addresses(leaves, enable):
    """A call passes one address a tensor, in the kernel's order
    (``detpu_stream_commit_launch``): scrub_rows, fp, est, hit_rows,
    counts, slot_fp, slot_freq, cms, staged, totals, the four counters,
    steps, the slab, then five slots for the leaves and ``enable``, the
    record's pad filling those left with nulls."""
    args, kw = _commit_args(leaves=leaves, enable=enable)
    rec = som.find_commit_record(*args, **kw, build_on_cpu=True)
    _, pad = rec.payload
    slab, lv, pend, slot_fp, slot_freq, cms, staged, totals, counters, \
        steps = args
    want = ([pend.scrub_rows, pend.fp, pend.est, pend.hit_rows, pend.counts,
             slot_fp, slot_freq, cms, staged, totals] + counters
            + [steps, slab] + [t for t, _ in lv]
            + ([kw["enable"]] if enable else []))
    ts = som._commit_tensors(*args, kw["enable"])
    assert len(ts) == len(want) == 16 + len(leaves) + enable
    assert all(a is b for a, b in zip(ts, want))
    tail = (*(t.data_ptr() for t in ts), *pad)
    assert len(tail) == 21 and tail[len(ts):] == (None,) * len(pad)


def test_k17_validates_and_raises_as_before():
    def raises(match, k=None, v=None, **change):
        args, kw = _commit_args(**change)
        args = list(args)
        if k is not None:
            args[k] = v
        with pytest.raises(ValueError, match=match):
            som.find_commit_record(*args, **kw, build_on_cpu=True)

    i32 = torch.int32
    args, _ = _commit_args()
    pend = args[2]
    raises(r"slab: expected a \[rows, w\] float32/bfloat16", 0,
           torch.zeros(64))
    raises(r"slab: expected a \[rows, w\] float32/bfloat16", 0,
           torch.zeros((64, 8), dtype=torch.float64))
    raises("slab: expected a contiguous", 0, torch.zeros(8, 64).t())
    raises("leaf: expected a contiguous", 1, [(torch.zeros(64, 4), 0.1)])
    raises("5 leaves: the kernel takes at most 4", 1,
           [(torch.zeros(64, 8), 0.1)] * 5)
    raises("scrub_rows: expected a contiguous", 2,
           pend._replace(scrub_rows=torch.zeros(40)))
    raises("hit_rows: expected a contiguous", 2,
           pend._replace(hit_rows=torch.zeros(39, dtype=i32)))
    raises("counts: expected a contiguous", 2,
           pend._replace(counts=torch.zeros(4, dtype=i32)))
    raises("slot_fp: expected a contiguous", 3, torch.zeros(63, dtype=i32))
    raises("slot_freq: expected a contiguous", 4,
           torch.zeros(64, dtype=torch.int64))
    raises("cms: expected a contiguous", 5, torch.zeros((3, 61)))
    raises("staged: expected a contiguous", 6, torch.zeros((3, 60),
                                                           dtype=i32))
    raises("totals: expected a contiguous", 7, torch.zeros(5))
    raises("counter: expected a contiguous", 8,
           [torch.zeros(1) for _ in range(3)] + [torch.zeros(2)])
    raises("3 counters: expected the four", 8,
           [torch.zeros(1) for _ in range(3)])
    raises("steps: expected a contiguous", 9, torch.zeros(1))
    args, kw = _commit_args()
    with pytest.raises(ValueError, match="enable: expected a contiguous"):
        som.find_commit_record(*args, enable=torch.tensor([True]),
                               build_on_cpu=True)
    m = torch.zeros((64, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        som.commit_rows(m, *args[1:])
    # the CPU wrapper runs the plain version, builds nothing
    before = (som.commit_rows.launches, som._COMMIT.builds)
    som.commit_rows(*args, **kw)
    assert (som.commit_rows.launches, som._COMMIT.builds) == before


# ----------------------------------------- the plain remap against JAX


def _crowded_stream(kind, rng, step, rows_cap):
    """One step's ``(ext, live, cap, nb, tid, roff)`` where claims crowd
    one row: ``one_slot`` (distinct ids, one slot a table), ``repeats``
    (a few ids, each many times: equal (estimate, fingerprint), so the
    position decides), ``mixed`` (both, with dead and negative ids)."""
    n = 90
    if kind == "one_slot":
        ext = 10 ** 6 + rng.integers(0, 12, n)
    elif kind == "repeats":
        ext = 10 ** 6 + np.repeat(rng.integers(0, 4, 9), 10)
    else:
        ext = 10 ** 6 + np.concatenate([np.repeat(rng.integers(0, 3, 5), 9),
                                        rng.integers(0, 30, n - 45)])
        ext[::11] = -rng.integers(1, 5, ext[::11].size)
    live = np.ones(n, bool)
    if kind == "mixed":
        live[3::8] = False
    first = np.arange(n) < n // 2
    cap = np.where(first, 1, 2 if kind == "mixed" else 1)
    return (ext, live, *(a.astype(np.int32) for a in (
        cap, np.where(first, 3, 2), np.where(first, 5, 9),
        np.where(first, 0, rows_cap // 2))))


def _without_position(wstate, stream, rows_cap, cfg):
    """The plain remap's scrub rows with the position tie-break dropped:
    every claim holding its row's best (estimate, fingerprint) wins."""
    ext, live, cap, nb, tid, roff = stream
    live = live & (ext >= 0)
    fp = som.fingerprint_plain(ext, tid)
    slot, _ = som.slot_bucket_plain(ext, tid, cap, nb)
    row = roff + slot
    rowc = torch.where(live, row, 0).long()
    occ = wstate["slot_fp"][rowc]
    cms = wstate["cms"].clone()
    sk.cms_update_plain(cms, fp, live)
    est = sk.cms_query_plain(cms, fp)
    claim = live & (occ != fp) & (est >= cfg.admit_min_count) & (
        (occ == som.SLOT_FREE)
        | (est >= wstate["slot_freq"][rowc] + cfg.evict_margin))
    neg = torch.full((rows_cap,), -1, dtype=torch.int32)
    best = (lambda v: neg.scatter_reduce(0, rowc, v, "amax")[rowc])
    cand = claim & (est == best(torch.where(claim, est, -1)))
    cand = cand & (fp == best(torch.where(cand, fp, -1)))
    return torch.where(cand, row, rows_cap)


@pytest.mark.parametrize("ids", ["int32", "int64"])
@pytest.mark.parametrize("kind", ["one_slot", "repeats", "mixed"])
def test_plain_remap_matches_jax_where_claims_crowd_a_row(kind, ids):
    """Four steps of one width from a free slot map: local rows, scrub
    rows, the staged slot map and sketch and the counts bitwise against
    JAX's ``remap_width``; the control without the position tie-break
    differs from JAX on some step."""
    rng = np.random.default_rng(len(kind) + 7 * (ids == "int64"))
    rows_cap = 16
    jw = {"slot_fp": jnp.full((rows_cap,), -1, jnp.int32),
          "slot_freq": jnp.zeros((rows_cap,), jnp.int32),
          "cms": jnp.zeros((CFG.depth, CFG.buckets), jnp.int32)}
    tw = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
    control_differs = tied = False
    for step in range(4):
        arrays = _crowded_stream(kind, rng, step, rows_cap)
        ext = arrays[0].astype(np.int64 if ids == "int64" else np.int32)
        tstream = ts.WidthStream(torch.from_numpy(ext),
                                 *(torch.from_numpy(a.copy())
                                   for a in arrays[1:]))
        jl, (jnew, jscrub, jstats) = js.remap_width(
            jw, js.WidthStream(jnp.asarray(arrays[0].astype(np.int32)),
                               *(jnp.asarray(a) for a in arrays[1:])),
            rows_cap, js.StreamingConfig(*CFG))
        tl, tp = ts.remap_width(tw, tstream, rows_cap, CFG)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tp[1].scrub_rows.numpy(),
                                      np.asarray(jscrub))
        tnew = ts.staged_wstate(tw, tp, rows_cap)
        for k in ("slot_fp", "slot_freq", "cms"):
            np.testing.assert_array_equal(tnew[k].numpy(),
                                          np.asarray(jnew[k]), err_msg=k)
        for k, v in ts.step_stats(tp).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jstats[k]))
        ctrl = _without_position(tw, tuple(tstream), rows_cap, CFG)
        if not torch.equal(ctrl, tp[1].scrub_rows):
            control_differs = True
        # a tie the position broke: two claims of one (estimate,
        # fingerprint) on the winner's row
        r = tp[1]
        won = r.scrub_rows < rows_cap
        for i in torch.nonzero(won).flatten().tolist():
            same = (r.fp == r.fp[i]) & (r.est == r.est[i])
            if int(same.sum()) > 1:
                tied = True
        jw, tw = jnew, tnew
    if kind != "one_slot":
        assert tied and control_differs
    assert float(ts.step_stats(tp)["admitted"][0]) >= 0
