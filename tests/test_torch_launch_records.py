"""The shared launch path (``ops/_kernels.py``: ``LaunchRecord``,
``LaunchCache``, ``tensor_key``) as K22 (``ops/dense_update.py``) and
K19/K20 (``ops/exchange_pack.py``) use it, on CPU tensors: the records
are built without a launch (``build_on_cpu``), so their descriptor
tables, their reuse and every rebuild or raise run here.

What is held, all exactly (they are integers and addresses):
  - K22's table equals the one the per-call loop built before records
    (p, g, s0, s1, numel, first tile), at the tile ``pick_tile`` chooses;
  - K19's and K20's chunks equal ``descriptors()`` with each chunk's
    first tiles counted from its start;
  - a second call with the same tensors finds the record (the build
    counter stays), and a changed address, shape, dtype, stride or list
    length rebuilds it or raises as the wrappers always have;
  - ``ok``, ``nlr``, ``bp`` and the counts are read per call: a new
    tensor of the same layout is a hit, and its address is in no key.
"""

import importlib

import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import _kernels
from distributed_embeddings_torch.ops import exchange_pack as xp
from distributed_embeddings_torch.ops.dense_update import (
    MAX_TENSORS, TILES, build_record, find_record, launch_tables, pick_tile,
    record_key)

torch.set_num_threads(1)

#: the DLRM dense half's parameter shapes (bottom 512-256-128 over 13
#: features, top 1024-1024-512-256-1 over 479 inputs)
DLRM_SHAPES = ((512, 13), (512,), (256, 512), (256,), (128, 256), (128,),
               (1024, 479), (1024,), (1024, 1024), (1024,), (512, 1024),
               (512,), (256, 512), (256,), (1, 256), (1,))
H100_SMS = 132
N_STATE = {"sgd": 0, "momentum": 1, "nesterov": 1, "adagrad": 1, "adam": 2}


def _case(kind, shapes=((7, 5), (5,), (1,), (4099,)), seed=0):
    rng = np.random.default_rng(seed)

    def t(s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    params = [t(s) for s in shapes]
    grads = [t(s) for s in shapes]
    states = [[t(s) for s in shapes] for _ in range(N_STATE[kind])]
    return params, grads, states


def _args(kind, params, grads, states, nlr=-0.01, sched=False):
    """``find_record``'s arguments after the cache: the per-call tensors
    made anew, as a step makes them."""
    s0 = states[0] if states else None
    s1 = states[1] if len(states) > 1 else None
    bp = torch.tensor([0.9, 0.999]) if kind == "adam" else None
    ok = torch.ones((), dtype=torch.bool)
    counts = (torch.zeros((), dtype=torch.int32),) if sched else ()
    if sched:
        nlr = torch.tensor(nlr, dtype=torch.float32)
    hyper = {"momentum": 0.9, "eps": 1e-8, "b1": 0.9, "b2": 0.999,
             "eps_root": 0.0}
    return (kind, params, grads, s0, s1, nlr, hyper, bp, ok, counts)


def _find(cache, args):
    return find_record(cache, *args, build_on_cpu=True)


def _loop_table(params, grads, states, tile):
    """The descriptor table as the wrapper's per-call loop built it."""
    descs = np.zeros((max(len(params), 1), 6), np.int64)
    tiles = 0
    for i, p in enumerate(params):
        descs[i] = (p.data_ptr(), grads[i].data_ptr(),
                    states[0][i].data_ptr() if len(states) > 0 else 0,
                    states[1][i].data_ptr() if len(states) > 1 else 0,
                    p.numel(), tiles)
        tiles += -(-p.numel() // tile)
    return descs


# ------------------------------------------------------------------- K22


def test_pick_tile_keeps_two_blocks_an_sm():
    """The DLRM SGD set (2,368,897 floats) keeps 4096-element tiles (587
    blocks, each tensor rounded up to whole tiles); a set of ~0.2M floats
    (the zoo's Adam) takes 1024; in between, the largest tile that still
    gives 264 blocks."""
    dlrm = [int(np.prod(s)) for s in DLRM_SHAPES]
    assert sum(dlrm) == 2_368_897
    assert pick_tile(dlrm, H100_SMS) == 4096
    assert sum(-(-n // 4096) for n in dlrm) == 587
    assert pick_tile([207_873], H100_SMS) == 1024
    assert pick_tile([2048 * 264], H100_SMS) == 2048
    assert pick_tile([2048 * 263], H100_SMS) == 1024
    assert pick_tile([], H100_SMS) == TILES[-1]


@pytest.mark.parametrize("kind", sorted(N_STATE))
@pytest.mark.parametrize("shapes", ["small", "dlrm"])
def test_k22_table_equals_the_per_call_loop(kind, shapes):
    shapes = DLRM_SHAPES if shapes == "dlrm" else ((7, 5), (5,), (1,))
    params, grads, states = _case(kind, shapes)
    rec, _, _ = build_record(kind, params, grads, states, -0.01,
                             {"momentum": 0.9}, torch.zeros(2), None, (),
                             sms=H100_SMS)
    tables, _, _ = rec.payload
    (descs, tile), = tables
    assert tile == pick_tile([p.numel() for p in params], H100_SMS)
    np.testing.assert_array_equal(
        descs, _loop_table(params, grads, states, tile))
    assert rec.calls == () and rec.device == -1 and rec.keep


def test_k22_tables_split_past_the_launch_cap():
    n = MAX_TENSORS + 3
    params, grads, states = _case("adam", [(3,)] * n)
    tables = launch_tables(params, grads, states, H100_SMS)
    assert [len(d) for d, _ in tables] == [MAX_TENSORS, 3]
    lo = 0
    for descs, tile in tables:
        k = len(descs)
        np.testing.assert_array_equal(descs, _loop_table(
            params[lo:lo + k], grads[lo:lo + k],
            [s[lo:lo + k] for s in states], tile))
        lo += k


@pytest.mark.parametrize("kind,sched", [("sgd", False), ("sgd", True),
                                        ("momentum", True),
                                        ("adagrad", False), ("adam", True)])
def test_k22_second_call_reuses_the_record(kind, sched):
    """The same parameter, state and gradient tensors find the record;
    ``ok``, ``nlr``, ``bp`` and the counts are new tensors each call and
    come back as passed (the launch reads them), and no key holds their
    addresses."""
    cache = _kernels.LaunchCache()
    params, grads, states = _case(kind)
    first = _find(cache, _args(kind, params, grads, states, sched=sched))
    assert cache.builds == 1 and len(cache.records) == 1
    for _ in range(3):
        args = _args(kind, params, grads, states, sched=sched)
        rec, nlr, bp = _find(cache, args)
        assert rec is first[0] and cache.builds == 1
        assert nlr is args[5] and bp is args[7]
        per_call = [t.data_ptr() for t in (args[5], args[7], args[8],
                                           *args[9])
                    if isinstance(t, torch.Tensor)]
        assert not set(per_call) & set(next(iter(cache.records)))


def _rebuilt_or_raises(cache, args, match=None):
    before = cache.builds
    if match is not None:
        with pytest.raises(ValueError, match=match):
            _find(cache, args)
        return
    rec, _, _ = _find(cache, args)
    assert cache.builds == before + 1
    return rec


@pytest.mark.parametrize("change", [
    "grad_address", "grad_shape", "grad_dtype", "param_strided_view",
    "grad_strided_view", "param_list_length", "state_address",
    "param_address", "constant_lr", "hyper", "ok_layout", "bp_dtype",
    "nlr_dtype"])
def test_k22_every_changed_fact_rebuilds_or_raises(change):
    """Each fact a record rests on, changed alone: a new address, a
    view of another layout at the same address or new per-call layouts
    build a new record (what the launch reads is then right); a call
    the wrapper refuses raises as it always has."""
    kind = "adam"
    cache = _kernels.LaunchCache()
    params, grads, states = _case(kind)
    args = list(_args(kind, params, grads, states, sched=True))
    base, _, _ = _find(cache, tuple(args))
    if change == "grad_address":
        args[2] = [g.clone() for g in grads]
        rec = _rebuilt_or_raises(cache, tuple(args))
        assert rec.payload[0][0][0][0, 1] == args[2][0].data_ptr()
    elif change == "grad_shape":
        args[2] = [grads[0].view(5, 7)] + grads[1:]
        _rebuilt_or_raises(cache, tuple(args), match="grad 0: shape")
    elif change == "grad_dtype":
        args[2] = [grads[0].view(torch.int32)] + grads[1:]
        _rebuilt_or_raises(cache, tuple(args), match="grad 0")
    elif change == "param_strided_view":
        # same address, same shape, transposed strides: not contiguous
        args[1] = [params[0].view(5, 7).t()] + params[1:]
        args[2] = [grads[0].view(5, 7).t()] + grads[1:]
        _rebuilt_or_raises(cache, tuple(args), match="param 0")
    elif change == "grad_strided_view":
        # a non-contiguous gradient is copied (as always) and the record,
        # resting on the copy, is not kept
        args[2] = [grads[0].t().contiguous().t()] + grads[1:]
        assert args[2][0].shape == grads[0].shape
        assert not args[2][0].is_contiguous()
        rec = _rebuilt_or_raises(cache, tuple(args))
        assert not rec.keep and len(cache.records) == 1
        assert rec.payload[0][0][0][0, 1] != args[2][0].data_ptr()
    elif change == "param_list_length":
        args[1] = params[:-1]
        _rebuilt_or_raises(cache, tuple(args), match="must match")
        args[1], args[2] = params[:-1], grads[:-1]
        args[3], args[4] = states[0][:-1], states[1][:-1]
        rec = _rebuilt_or_raises(cache, tuple(args))
        assert len(rec.payload[0][0][0]) == len(params) - 1
    elif change == "state_address":
        args[4] = [s.clone() for s in states[1]]
        rec = _rebuilt_or_raises(cache, tuple(args))
        assert rec.payload[0][0][0][0, 3] == args[4][0].data_ptr()
    elif change == "param_address":
        args[1] = [p.clone() for p in params]
        _rebuilt_or_raises(cache, tuple(args))
    elif change == "constant_lr":
        args[5], args[9] = -0.01, ()
        _rebuilt_or_raises(cache, tuple(args))
        args[5] = -0.02
        _rebuilt_or_raises(cache, tuple(args))
    elif change == "hyper":
        args[6] = dict(args[6], b1=0.8)
        _rebuilt_or_raises(cache, tuple(args))
    elif change == "ok_layout":
        args[8] = torch.ones((1,), dtype=torch.bool)
        _rebuilt_or_raises(cache, tuple(args))
        args[8] = torch.ones((), dtype=torch.int32)
        _rebuilt_or_raises(cache, tuple(args), match="ok: expected one bool")
    elif change == "bp_dtype":
        args[7] = torch.tensor([0.9, 0.999], dtype=torch.float64)
        _rebuilt_or_raises(cache, tuple(args), match="adam: bp")
    else:
        # a float64 lr is converted for the launch, and such a record is
        # not kept
        args[5] = torch.tensor(-0.01, dtype=torch.float64)
        rec, nlr, _ = _find(cache, tuple(args))
        assert nlr.dtype == torch.float32 and not rec.keep
    assert cache.records[next(iter(cache.records))] is base


def test_k22_cache_is_bounded():
    cache = _kernels.LaunchCache()
    params, grads, states = _case("sgd")
    # every gradient set stays alive, so each lies at new addresses
    sets = [[g.clone() for g in grads]
            for _ in range(_kernels.LAUNCH_CACHE + 3)]
    for gs in sets:
        _find(cache, _args("sgd", params, gs, states))
    assert cache.builds == _kernels.LAUNCH_CACHE + 3
    assert len(cache.records) == _kernels.LAUNCH_CACHE


def test_k22_key_holds_every_tensor_fact():
    params, grads, states = _case("momentum")
    args = _args("momentum", params, grads, states)
    key = record_key("momentum", params, grads, [states[0]], args[5],
                     args[6], args[7], args[8], args[9])
    ts = [*params, *grads, *states[0]]
    for t in ts:
        assert t.data_ptr() in key and t.shape in key
    assert key.count(torch.float32) >= len(ts)
    assert key.count(-1) >= len(ts)  # device index off the card


def test_k22_cpu_call_builds_no_record():
    """The wrapper keeps no record for CPU tensors: it runs the plain
    version every call."""
    from distributed_embeddings_torch.ops import dense_update as du
    mod = importlib.import_module("distributed_embeddings_torch.ops."
                                  "dense_update")
    params, grads, _ = _case("sgd")
    before = (mod._CACHE.builds, du.launches)
    want = [p - 0.5 * g for p, g in zip(params, grads)]
    du("sgd", params, grads, None, None, -0.5, {})
    assert (mod._CACHE.builds, du.launches) == before
    for p, w in zip(params, want):
        assert torch.equal(p, w)


# ---------------------------------------------------------------- K19/K20


def _id_plan(world=8, n_src=26, b=64, seed=0):
    """A K19-like plan: ``n_src`` id tensors of ``b`` ids each into a
    ``[world, l_max]`` block, each source split over the ranks, with
    zero-filled dead cells."""
    rng = np.random.default_rng(seed)
    per = b // world
    copies, off = [], 0
    for r in range(world):
        for s in range(n_src):
            if rng.random() < 0.1:
                copies.append((-1, 0, per, 0, off, per, 1, per))
            else:
                copies.append((s, r * per, per, 0, off, per, 1, per))
            off += per
    srcs = [torch.from_numpy(rng.integers(0, 1000, b).astype(np.int32))
            for _ in range(n_src)]
    return xp.CopyPlan(copies), srcs, torch.empty(off, dtype=torch.int32)


def _want_chunks(plan, srcs, dsts, sdt, ddt):
    desc = xp.descriptors(plan, srcs, dsts, sdt, ddt)
    out = []
    for s in range(0, len(desc), xp.MAX_DESCS):
        d = desc[s:s + xp.MAX_DESCS].copy()
        t = -(-(d[:, 4] * d[:, 5]) // xp.TILE_UNITS)
        d[:, 6] = np.cumsum(t) - t
        out.append((d, int(t.sum())))
    return out


def _same_chunks(got, want):
    assert len(got) == len(want)
    for (g, gt), (w, wt) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert gt == wt


@pytest.mark.parametrize("n_src", [26, 70])
def test_k19_chunks_equal_descriptors(n_src):
    """At 26 sources one launch; at 70 (560 copies) two."""
    plan, srcs, out = _id_plan(n_src=n_src)
    rec = xp.find_record(plan, "pack_ids", srcs, [out], build_on_cpu=True)
    _same_chunks(rec.payload, _want_chunks(plan, srcs, [out], torch.int32,
                                           torch.int32))
    assert len(rec.payload) == -(-len(plan) // xp.MAX_DESCS)
    assert rec.calls == ()


def test_k20_chunks_equal_descriptors_with_row_wise_sources():
    """A cast pack from column slices of a wider tensor (row-wise
    sources, read in place through their row stride)."""
    b, widths = 6, (3, 5)
    wide = torch.randn(b, 11)
    srcs = [wide[:, 1:4], wide[:, 4:9]]
    copies = [(i, 0, w, 0, 8 * 0 + sum(widths[:i]), 8, b, w)
              for i, w in enumerate(widths)]
    plan = xp.CopyPlan(copies, src_width=widths)
    out = torch.empty(b * 8, dtype=torch.bfloat16)
    rec = xp.find_record(plan, "pack_columns", srcs, [out],
                         build_on_cpu=True)
    _same_chunks(rec.payload, _want_chunks(plan, srcs, [out], torch.float32,
                                           torch.bfloat16))
    # the same columns read from another row stride: a new record
    wider = torch.randn(b, 13)
    srcs2 = [wider[:, 1:4], wider[:, 4:9]]
    rec2 = xp.find_record(plan, "pack_columns", srcs2, [out],
                          build_on_cpu=True)
    assert rec2 is not rec and plan.launch_cache.builds == 2
    _same_chunks(rec2.payload, _want_chunks(plan, srcs2, [out],
                                            torch.float32, torch.bfloat16))


def test_k19_second_call_reuses_the_record():
    plan, srcs, out = _id_plan()
    rec = xp.find_record(plan, "pack_ids", srcs, [out], build_on_cpu=True)
    for _ in range(3):
        assert xp.find_record(plan, "pack_ids", list(srcs), [out],
                              build_on_cpu=True) is rec
    assert plan.launch_cache.builds == 1


@pytest.mark.parametrize("change", [
    "src_address", "src_shape", "src_dtype", "src_strided_view",
    "out_address", "out_dtype", "source_count", "sources_to_dests"])
def test_k19_every_changed_fact_rebuilds_or_raises(change):
    plan, srcs, out = _id_plan()
    base = xp.find_record(plan, "pack_ids", srcs, [out], build_on_cpu=True)
    srcs, dsts, what, match = list(srcs), [out], "pack_ids", None
    if change == "src_address":
        srcs[3] = srcs[3].clone()
    elif change == "src_shape":
        srcs[3] = srcs[3].view(8, 8)
    elif change == "src_dtype":
        srcs[3] = srcs[3].view(torch.float32)
        match = "must have the block's dtype"
    elif change == "src_strided_view":
        srcs[3] = torch.empty(128, dtype=torch.int32)[::2]
        srcs[3].copy_(torch.arange(64, dtype=torch.int32))
        match = "must be contiguous"
    elif change == "out_address":
        dsts = [out.clone()]
    elif change == "out_dtype":
        dsts = [out.view(torch.float32)]
        match = "must have the block's dtype"
    elif change == "source_count":
        srcs = srcs[:20]
        match = "the plan reads 26 sources"
    else:
        # one tensor moved from the sources to the destinations: the
        # same flat list of tensors, another call
        srcs, dsts = srcs[:-1], [srcs[-1], out]
        match = "the plan reads 26 sources"
    before = plan.launch_cache.builds
    if match:
        with pytest.raises(ValueError, match=match):
            xp.find_record(plan, what, srcs, dsts, build_on_cpu=True)
    else:
        rec = xp.find_record(plan, what, srcs, dsts, build_on_cpu=True)
        assert rec is not base and plan.launch_cache.builds == before + 1
        _same_chunks(rec.payload, _want_chunks(plan, srcs, dsts,
                                               torch.int32, torch.int32))
    assert base in plan.launch_cache.records.values()


def test_k19_cpu_wrapper_keeps_no_record_and_still_checks():
    plan, srcs, out = _id_plan()
    got = xp.pack_ids(plan, srcs, out)
    want = xp.pack_ids_plain(plan, srcs, torch.empty_like(out))
    assert torch.equal(got, want) and plan.launch_cache.builds == 0
    with pytest.raises(ValueError, match="the plan reads"):
        xp.pack_ids(plan, srcs[:3], out)


def test_tensor_key_facts():
    a = torch.zeros(4, 6)
    key = _kernels.tensor_key([a, a.t()])
    assert key == (a.data_ptr(), a.data_ptr(), (4, 6), (6, 4), (6, 1),
                   (1, 6), torch.float32, torch.float32, -1, -1)
    assert _kernels.layout_key(None) is None
    assert _kernels.layout_key(a[:, 1]) == ((4,), (6,), torch.float32, -1)


def test_shared_cache_under_threads_never_crosses_records():
    """16 threads (more than the cores) look up and add records in one
    cache of 8 under a short switch interval: every record a thread gets
    holds its own tensors' addresses, and nothing raises."""
    import sys
    import threading

    cache = _kernels.LaunchCache()
    sets = [_case("sgd", ((3, 4), (5,)), seed=k) for k in range(16)]
    bad, errors = [], []

    def work(k):
        params, grads, states = sets[k]
        try:
            for _ in range(150):
                rec, _, _ = _find(cache, _args("sgd", params, grads, states))
                descs = rec.payload[0][0][0]
                if (descs[0, 0] != params[0].data_ptr()
                        or descs[1, 1] != grads[1].data_ptr()):
                    bad.append(k)
        except Exception as e:  # reported below with the thread's index
            errors.append((k, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not bad
    assert len(cache.records) <= _kernels.LAUNCH_CACHE
