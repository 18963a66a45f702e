"""The access-telemetry sketch on the hand-written kernels K13 (count-min
sketch update), K14 (sketch query and the hot-row candidate pool) and K15
(top-k merge), all in ``csrc/sketch.cu``, with their plain PyTorch
versions.

Counterpart of the math of ``distributed_embeddings_tpu/analysis/
telemetry.py`` (``_buckets_of``, ``cms_update``, ``cms_query``,
``record_ids``), split at the kernels' seams:

* :func:`cms_update` (K13) adds each live position into its column of
  every depth row of the ``[depth, buckets]`` int32 sketch, IN PLACE (the
  JAX step donates the state), and returns the live count (``[1]``
  int64);
* :func:`cms_query` (K14) is the count-min estimate of ids;
* :func:`topk_pool` (K14) gives JAX's candidate ``pool``: the
  ``k_pool`` distinct live ids with the largest sketch estimates, ties to
  the smaller id, padded with the pad id ``INT32_MAX``. JAX sorts the
  ids (dead positions as the pad id) and scores each id's first sorted
  occurrence, so one more entry can take a place: the first pad-valued
  position in stream order scores the pad id's estimate when it is a
  live ``INT32_MAX`` (its pool value is the pad id, after every other
  id of its estimate), and nothing when it is dead;
* :func:`topk_merge` (K15) merges the unique pool into the carried top-k,
  IN PLACE, and adds the live count, rounded once to float32, to the
  width's ``ids`` accumulator;
* :func:`fold_ids` runs the three for one width's ``record_ids`` from one
  launch record (K13's record, K14's pool and K15's record, replayed in
  order on buffers the record owns).

K13 and K15 launch through the shared launch path
(``_kernels.LaunchRecord``) on records keyed on LAYOUTS (shapes, strides,
dtypes, devices; no address: each call passes its own), built with the
checks that raise; a record owns its scratch. K14's pool takes any size
(past its shared-memory tile it sorts in device memory); K15 merges in
one CTA up to the ``topk + candidates`` of :func:`merge_path`'s
``"block"`` and over the SMs past it, with the same result.

Everything is integer arithmetic, so each kernel equals its plain
version bit for bit, and both equal JAX's ``record_ids`` for live
counts below 2^24 (JAX sums the live mask in float32: beyond that its
sum is not the count in any order, and the port rounds the exact count
once).
``lax.top_k`` keeps the lower index first among equal values and
``torch.topk`` does not, so the plain versions select with a stable sort
on the negated score.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises. Each wrapper counts its launches (:func:`fold_ids` counts
each of the three it launches).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np

import torch

from . import _kernels

#: xxhash/murmur-style odd multipliers (``telemetry.py:_MULTS``); depth d
#: uses ``MULTS[d % 8] ^ d``
MULTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1,
         0xD3A2646D, 0xFD7046C5, 0xB55A4F09)
MIX = 0x2C1B3C6D
#: the pad id of dead positions and unfilled candidates (sorts last)
PAD = 2 ** 31 - 1
#: the dead slot marker of the carried top-k ids
TOPK_EMPTY = -1
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a * m mod 2^32`` for int64 ``a`` in ``[0, 2^32)``, without an
    int64 overflow (the product is taken in two 16-bit halves of m)."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def buckets_of_plain(ids: torch.Tensor, depth: int,
                     buckets: int) -> torch.Tensor:
    """``[depth, n]`` sketch columns (int64) of ``ids [n]``: one
    multiply-xorshift hash per depth row in uint32 arithmetic, done in
    int64 (PyTorch's uint32 lacks the shifts on the CPU)."""
    h0 = ids.long() & _M32
    cols = []
    for d in range(depth):
        h = _mul32(h0, MULTS[d % len(MULTS)] ^ d)
        h = h ^ (h >> 15)
        h = _mul32(h, MIX)
        h = h ^ (h >> 13)
        cols.append(h % buckets)
    return torch.stack(cols)


def _flat(cols: torch.Tensor, buckets: int) -> torch.Tensor:
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None]
    return (rows * buckets + cols).reshape(-1)


def cms_update_plain(cms: torch.Tensor, ids: torch.Tensor,
                     live: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cms_update` (``index_add_`` on the
    flattened sketch). Returns the live count as a ``[1]`` int64."""
    depth, buckets = cms.shape
    cols = buckets_of_plain(torch.where(live, ids, 0), depth, buckets)
    inc = live.to(torch.int32)[None].expand(depth, -1).reshape(-1)
    cms.view(-1).index_add_(0, _flat(cols, buckets), inc)
    return live.sum().reshape(1)


def cms_query_plain(cms: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cms_query`."""
    depth, buckets = cms.shape
    cols = buckets_of_plain(ids.clamp(min=0), depth, buckets)
    vals = cms.reshape(-1)[_flat(cols, buckets)].reshape(depth, -1)
    return vals.min(dim=0).values


def _select(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores, ``lax.top_k``'s order: score
    descending, the lower index first among equals."""
    return torch.sort(-score.long(), stable=True).indices[:k]


def topk_pool_plain(cms: torch.Tensor, ids: torch.Tensor,
                    live: torch.Tensor, k_pool: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`topk_pool`: the distinct live ids
    (ascending) and the pad id where the first pad-valued position is
    live, ordered by (estimate descending, id ascending)."""
    keys = torch.where(live, ids, PAD)
    pads = (keys == PAD).nonzero()
    cand = torch.unique(keys[keys != PAD])
    if pads.numel() and bool(live[pads[0, 0]]):
        cand = torch.cat([cand, cand.new_full((1,), PAD)])
    order = _select(cms_query_plain(cms, cand), k_pool)
    pool = torch.full((k_pool,), PAD, dtype=torch.int32, device=ids.device)
    pool[:order.numel()] = cand[order]
    return pool


def topk_merge_plain(cms: torch.Tensor, pool: torch.Tensor,
                     counts: torch.Tensor, topk_ids: torch.Tensor,
                     topk_est: torch.Tensor, ids_acc: torch.Tensor,
                     candidates: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`topk_merge`."""
    cand = torch.full((candidates,), PAD, dtype=torch.int32,
                      device=pool.device)
    uniq = torch.unique(pool)[:candidates]  # sorted
    cand[:uniq.numel()] = uniq
    dup = (cand[:, None] == topk_ids[None, :]).any(dim=1)
    cand_est = torch.where((cand != PAD) & ~dup, cms_query_plain(cms, cand),
                           -1)
    old_est = torch.where(topk_ids >= 0, torch.maximum(
        cms_query_plain(cms, topk_ids), topk_est), -1)
    all_ids = torch.cat([topk_ids, cand])
    all_est = torch.cat([old_est, cand_est])
    ix = _select(all_est, topk_ids.numel())
    top_est = all_est[ix]
    topk_ids.copy_(torch.where(top_est >= 0, all_ids[ix], TOPK_EMPTY))
    topk_est.copy_(top_est.clamp(min=0))
    count = counts.sum().to(torch.float32).reshape(1)
    ids_acc.add_(count)
    return count


def record_ids_plain(wstate: Dict[str, torch.Tensor], ids: torch.Tensor,
                     live: torch.Tensor, candidates: int) -> torch.Tensor:
    """The three plain versions in a row: one step's fold of ``ids [n]``
    (int32) and ``live [n]`` (bool) into one width's state, in place.
    Returns the live count as a ``[1]`` float32."""
    counts = cms_update_plain(wstate["cms"], ids, live)
    pool = topk_pool_plain(wstate["cms"], ids, live,
                           min(candidates, ids.numel()))
    return topk_merge_plain(wstate["cms"], pool, counts, wstate["topk_ids"],
                            wstate["topk_est"], wstate["ids"], candidates)


def fold_ids_plain(wstate: Dict[str, torch.Tensor], ids: torch.Tensor,
                   live: torch.Tensor, candidates: int,
                   total: Optional[torch.Tensor] = None,
                   first: bool = True) -> None:
    """Plain PyTorch version of :func:`fold_ids`: :func:`record_ids_plain`,
    its count set into (``first``) or added to ``total``."""
    count = record_ids_plain(wstate, ids, live, candidates)
    if total is not None:
        if first:
            total.copy_(count)
        else:
            total.add_(count)


# ----------------------------------------------------------- the kernels


def _check(t: torch.Tensor, dtype, dim: int, device, what: str) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{what}: expected a contiguous {dim}-D {dtype} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_cms(cms: torch.Tensor) -> None:
    if cms.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cms.device}")
    _check(cms, torch.int32, 2, cms.device, "cms")


def _check_inputs(cms, ids, live=None):
    _check_cms(cms)
    _check(ids, torch.int32, 1, cms.device, "ids")
    if live is not None:
        _check(live, torch.bool, 1, cms.device, "live")
        if live.shape != ids.shape:
            raise ValueError(f"live {tuple(live.shape)} != ids "
                             f"{tuple(ids.shape)}")
    if ids.numel() >= 2 ** 31:
        raise ValueError(f"{ids.numel()} ids: at most 2^31 - 1")


def _check_merge(cms, pool, counts, topk_ids, topk_est, ids_acc,
                 candidates):
    if pool.numel() > candidates:
        raise ValueError(f"a pool of {pool.numel()} for {candidates} "
                         "candidates")
    _check_cms(cms)
    dev = cms.device
    _check(pool, torch.int32, 1, dev, "pool")
    if counts is not None:
        _check(counts, torch.int64, 1, dev, "counts")
    _check(topk_ids, torch.int32, 1, dev, "topk_ids")
    _check(topk_est, torch.int32, 1, dev, "topk_est")
    _check(ids_acc, torch.float32, 1, dev, "ids")
    if topk_est.shape != topk_ids.shape or ids_acc.numel() != 1:
        raise ValueError("topk_est must match topk_ids, and ids hold one "
                         "value")


def _layouts(*ts) -> tuple:
    """The layouts of ``ts`` in one flat tuple: the first's device type
    (device index -1 does not tell the CPU from another device), then
    their shapes, strides, dtypes and device indices, each fact for all
    tensors in one pass."""
    return (ts[0].device.type, *map(_kernels._SHAPE, ts),
            *map(_kernels._STRIDE, ts), *map(_kernels._DTYPE, ts),
            *map(_kernels._DEVICE, ts))


def _prepared(lib, what: str) -> np.ndarray:
    return np.zeros(getattr(lib, f"detpu_{what}_prepared_bytes")(), np.uint8)


#: K13's, K15's and the width fold's launch records, by layout
_UPDATE = _kernels.LaunchCache()
_MERGE = _kernels.LaunchCache()
_FOLD = _kernels.LaunchCache()


def update_key(cms: torch.Tensor, ids: torch.Tensor,
               live: torch.Tensor) -> tuple:
    """Every fact K13's record rests on: the layouts of the sketch, the
    ids and the live flags. No address: each call passes its own (and
    the 16-byte loads are chosen from them each call)."""
    return _layouts(cms, ids, live)


def build_update_record(cms: torch.Tensor, ids: torch.Tensor,
                        live: torch.Tensor) -> _kernels.LaunchRecord:
    """Validate a call as :func:`cms_update` always has (raising the same
    errors) and build its record: the prepared launch over every SM and
    its scratch (the ticket and the CTAs' partial counts, zeroed once;
    ``record.payload``: ``(prepared, scratch)``). CPU tensors (the tests)
    get a record without launches."""
    _check_inputs(cms, ids, live)
    if cms.device.type != "cuda":
        return _kernels.LaunchRecord(None, "cms_update", (), -1)
    lib = _kernels.library("sketch")
    sms = _kernels.sm_count(cms.device.index or 0)
    scratch = torch.zeros(lib.detpu_cms_update_scratch_bytes(sms),
                          dtype=torch.uint8, device=cms.device)
    prepared = _prepared(lib, "cms_update")
    _kernels.check(lib, lib.detpu_cms_update_prepare(
        cms.shape[0], cms.shape[1], ids.numel(), sms, scratch.data_ptr(),
        prepared.ctypes.data), "cms_update")
    return _kernels.LaunchRecord(
        lib, "cms_update", [(lib.detpu_cms_update_launch,
                             (prepared.ctypes.data,))],
        _kernels.device_index(cms.device), payload=(prepared, scratch))


def cms_update(cms: torch.Tensor, ids: torch.Tensor,
               live: torch.Tensor) -> torch.Tensor:
    """K13: add ``live [n]`` (bool) into ``cms [depth, buckets]`` (int32,
    in place) at each depth row's column of ``ids [n]`` (int32; a dead
    position hashes id 0 and adds 0). Returns the live count as a ``[1]``
    int64.

    On the card the launch record of the layouts replays with this
    call's addresses and a count tensor allocated for this call: the
    record's scratch holds only the ticket and the CTAs' partials, which
    the call's last CTA folds into that tensor, so no later call
    overwrites a count a caller holds. One stream at a time a record:
    two calls of one layout queued on different streams at once would
    share its ticket and partials and mix their counts."""
    if cms.device.type == "cpu":
        return cms_update_plain(cms, ids, live)
    rec = _kernels.find_or_build(_UPDATE, update_key(cms, ids, live),
                                 build_update_record, False, False, cms,
                                 ids, live)
    count = torch.empty((1,), dtype=torch.int64, device=cms.device)
    cms_update.launches += rec.replay(cms.data_ptr(), ids.data_ptr(),
                                      live.data_ptr(), count.data_ptr())
    return count


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cms_query(cms: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K14's query: the count-min estimate ``[n]`` (int32) of ``ids [n]``
    (int32): the minimum over depth rows of each id's column (a negative
    id queries id 0, as JAX's ``max(ids, 0)``)."""
    if cms.device.type == "cpu":
        return cms_query_plain(cms, ids)
    _check_inputs(cms, ids)
    est = torch.empty_like(ids)
    if ids.numel() == 0:
        return est
    lib = _kernels.library("sketch")
    err = lib.detpu_cms_query(cms.data_ptr(), cms.shape[0], cms.shape[1],
                              ids.data_ptr(), ids.numel(), est.data_ptr(),
                              _stream(cms))
    _kernels.check(lib, err, "cms_query")
    cms_query.launches += 1
    return est


@functools.lru_cache(maxsize=None)
def _pool_max() -> int:
    """The largest ``k_pool`` whose select tile fits in shared memory
    (once per process)."""
    return _kernels.library("sketch").detpu_topk_pool_max()


@functools.lru_cache(maxsize=None)
def _merge_max() -> int:
    """The largest ``topk + candidates`` K15 merges in one CTA."""
    return _kernels.library("sketch").detpu_topk_merge_max()


def pool_path(k_pool: int) -> str:
    """Where K14's pool selects on the card: ``"tile"`` (tournament
    rounds in shared memory) or ``"device"`` (a radix sort of the list in
    device memory, above the tile)."""
    return "tile" if k_pool <= _pool_max() else "device"


def merge_path(topk: int, candidates: int) -> str:
    """Where K15 merges on the card: ``"block"`` (one CTA, a thread an
    entry, by counting and ranks) or ``"device"`` (tiles sorted in shared
    memory over the SMs, ranked by binary searches)."""
    return "block" if topk + candidates <= _merge_max() else "device"


def topk_pool(cms: torch.Tensor, ids: torch.Tensor, live: torch.Tensor,
              k_pool: int) -> torch.Tensor:
    """K14's candidate pool of ``record_ids`` (see the module docstring)
    from the updated sketch, ``ids [n]`` (int32) and ``live [n]`` (bool):
    ``[k_pool]`` int32, ``k_pool <= n``."""
    if not 0 <= k_pool <= ids.numel():
        raise ValueError(f"k_pool {k_pool} outside [0, {ids.numel()}]")
    if cms.device.type == "cpu":
        return topk_pool_plain(cms, ids, live, k_pool)
    _check_inputs(cms, ids, live)
    pool = torch.empty((k_pool,), dtype=torch.int32, device=cms.device)
    if k_pool == 0:
        return pool
    lib = _kernels.library("sketch")
    n = ids.numel()
    scratch = torch.empty((lib.detpu_topk_pool_scratch_bytes(n, k_pool),),
                          dtype=torch.uint8, device=cms.device)
    err = lib.detpu_topk_pool(cms.data_ptr(), cms.shape[0], cms.shape[1],
                              ids.data_ptr(), live.data_ptr(), n, k_pool,
                              pool.data_ptr(), scratch.data_ptr(),
                              _stream(cms))
    _kernels.check(lib, err, "topk_pool")
    topk_pool.launches += 1
    return pool


def merge_key(cms, pool, counts, topk_ids, topk_est, ids_acc,
              candidates: int) -> tuple:
    """Every fact K15's record rests on: ``candidates`` and the layouts of
    the sketch, the pool, the counts, the carried top-k and the
    accumulator. No address."""
    return (candidates, *_layouts(cms, pool, counts, topk_ids, topk_est,
                                  ids_acc))


def build_merge_record(cms, pool, counts, topk_ids, topk_est, ids_acc,
                       candidates: int) -> _kernels.LaunchRecord:
    """Validate a call as :func:`topk_merge` always has (raising the same
    errors) and build its record: the prepared launch (one CTA, or the
    path over the SMs on a device scratch the record owns;
    ``record.payload``: ``(prepared, scratch)``). CPU tensors (the tests)
    get a record without launches."""
    _check_merge(cms, pool, counts, topk_ids, topk_est, ids_acc, candidates)
    if cms.device.type != "cuda":
        return _kernels.LaunchRecord(None, "topk_merge", (), -1)
    lib = _kernels.library("sketch")
    nbytes = lib.detpu_topk_merge_scratch_bytes(topk_ids.numel(), candidates)
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=cms.device)
               if nbytes else None)
    prepared = _prepared(lib, "topk_merge")
    _kernels.check(lib, lib.detpu_topk_merge_prepare(
        cms.shape[0], cms.shape[1], pool.numel(), candidates,
        topk_ids.numel(), counts.numel(),
        None if scratch is None else scratch.data_ptr(),
        prepared.ctypes.data), "topk_merge")
    return _kernels.LaunchRecord(
        lib, "topk_merge", [(lib.detpu_topk_merge_launch,
                             (prepared.ctypes.data,))],
        _kernels.device_index(cms.device), payload=(prepared, scratch))


def topk_merge(cms: torch.Tensor, pool: torch.Tensor, counts: torch.Tensor,
               topk_ids: torch.Tensor, topk_est: torch.Tensor,
               ids_acc: torch.Tensor, candidates: int) -> torch.Tensor:
    """K15: merge the unique ``pool`` (padded to ``candidates``) into the
    carried ``topk_ids``/``topk_est`` (int32 ``[topk]``, in place), and
    add the live count (the sum of ``counts``, int64), rounded once to
    float32, to ``ids_acc`` (float32 ``[1]``, in place). Returns that
    count as a ``[1]`` float32 (allocated for this call). On the card it
    replays the launch record of the layouts and ``candidates``."""
    if pool.numel() > candidates:
        raise ValueError(f"a pool of {pool.numel()} for {candidates} "
                         "candidates")
    if cms.device.type == "cpu":
        return topk_merge_plain(cms, pool, counts, topk_ids, topk_est,
                                ids_acc, candidates)
    args = (cms, pool, counts, topk_ids, topk_est, ids_acc, candidates)
    rec = _kernels.find_or_build(_MERGE, merge_key(*args),
                                 build_merge_record, False, False, *args)
    count = torch.empty((1,), dtype=torch.float32, device=cms.device)
    topk_merge.launches += rec.replay(
        cms.data_ptr(), pool.data_ptr(), topk_ids.data_ptr(),
        topk_est.data_ptr(), ids_acc.data_ptr(), counts.data_ptr(),
        count.data_ptr(), 1)
    return count


def fold_key(cms, ids, live, topk_ids, topk_est, ids_acc, total,
             candidates: int) -> tuple:
    """Every fact the width fold's record rests on: ``candidates`` and
    the layouts of the width's state (sketch, carried top-k,
    accumulator), of its stream (ids, live) and of ``total`` (or None).
    No address."""
    return (candidates, _kernels.layout_key(total),
            *_layouts(cms, ids, live, topk_ids, topk_est, ids_acc))


def build_fold_record(cms, ids, live, topk_ids, topk_est, ids_acc, total,
                      candidates: int) -> _kernels.LaunchRecord:
    """Validate a fold as :func:`cms_update`, :func:`topk_pool` and
    :func:`topk_merge` always have (raising the same errors) and build
    its record: K13's record, K15's, and the buffers between them,
    allocated once and kept with the record (the pool, K14's pool
    scratch of ``detpu_topk_pool_scratch_bytes(n, k_pool)``, about 19 B a
    position, and the count K13 leaves for K15). ``record.payload``:
    ``(k_pool, update record, merge record, buffers, their addresses)``.
    CPU tensors (the tests) get records without launches."""
    dev = cms.device
    update = build_update_record(cms, ids, live)
    k_pool = min(candidates, ids.numel())
    pool = torch.empty((k_pool,), dtype=torch.int32, device=dev)
    count = torch.zeros((1,), dtype=torch.int64, device=dev)
    merge = build_merge_record(cms, pool, count, topk_ids, topk_est, ids_acc,
                               candidates)
    if total is not None:
        _check(total, torch.float32, 1, dev, "total")
        if total.numel() != 1:
            raise ValueError("total holds one value")
    scratch = None
    if dev.type == "cuda" and k_pool:
        scratch = torch.empty(
            (update.lib.detpu_topk_pool_scratch_bytes(ids.numel(), k_pool),),
            dtype=torch.uint8, device=dev)
    bufs = (pool, scratch, count)
    return _kernels.LaunchRecord(
        update.lib, "fold_ids", (), update.device,
        payload=(k_pool, update, merge, bufs,
                 tuple(None if t is None else t.data_ptr() for t in bufs)))


def find_fold_record(wstate, ids, live, candidates: int,
                     total: Optional[torch.Tensor] = None,
                     build_on_cpu: bool = False
                     ) -> Optional[_kernels.LaunchRecord]:
    """The fold's record, found in :data:`_FOLD` by :func:`fold_key` or
    built (:func:`build_fold_record`) and kept. A miss on CPU tensors is
    validated and gives None unless ``build_on_cpu``."""
    args = (wstate["cms"], ids, live, wstate["topk_ids"],
            wstate["topk_est"], wstate["ids"], total, candidates)
    return _kernels.find_or_build(_FOLD, fold_key(*args), build_fold_record,
                                  args[0].device.type == "cpu",
                                  build_on_cpu, *args)


def fold_ids(wstate: Dict[str, torch.Tensor], ids: torch.Tensor,
             live: torch.Tensor, candidates: int,
             total: Optional[torch.Tensor] = None,
             first: bool = True) -> None:
    """One step's fold of ``ids [n]`` (int32) and ``live [n]`` (bool) into
    one width's state (``record_ids``), in place: K13, K14's pool and
    K15 from one launch record, in one call with no check and no
    allocation on a hit (three ``ctypes`` calls). The live count,
    rounded once to float32, is added to ``wstate["ids"]`` and written
    into ``total`` (float32 ``[1]``; set when ``first``, else added), or
    nowhere when ``total`` is None.

    K13 leaves the count in a slot the record owns, and K15 reads it next
    on the same stream: a later fold on the record, queued after, cannot
    overwrite it first, and no caller holds it. One stream at a time a
    record (its buffers are the record's). Each of the three wrappers'
    counts goes up by its launch (the pool's not where ``n`` is 0)."""
    cms = wstate["cms"]
    if cms.device.type == "cpu":
        fold_ids_plain(wstate, ids, live, candidates, total, first)
        return
    tk_ids, tk_est, acc = wstate["topk_ids"], wstate["topk_est"], wstate["ids"]
    rec = _kernels.find_or_build(
        _FOLD, fold_key(cms, ids, live, tk_ids, tk_est, acc, total,
                        candidates),
        build_fold_record, False, False, cms, ids, live, tk_ids, tk_est, acc,
        total, candidates)
    k_pool, update, merge, _, (pool, scratch, count) = rec.payload
    c, i, l = cms.data_ptr(), ids.data_ptr(), live.data_ptr()
    cms_update.launches += update.replay(c, i, l, count)
    if k_pool:
        _kernels.check(rec.lib, rec.lib.detpu_topk_pool(
            c, cms.shape[0], cms.shape[1], i, l, ids.numel(), k_pool, pool,
            scratch, _kernels.stream_handle(rec.device)), "topk_pool")
        topk_pool.launches += 1
    topk_merge.launches += merge.replay(
        c, pool, tk_ids.data_ptr(), tk_est.data_ptr(), acc.data_ptr(), count,
        None if total is None else total.data_ptr(), int(first))


cms_update.launches = 0
cms_query.launches = 0
topk_pool.launches = 0
topk_merge.launches = 0
