"""The access-telemetry sketch on the hand-written kernels K13 (count-min
sketch update), K14 (sketch query and the hot-row candidate pool) and K15
(top-k merge), all in ``csrc/sketch.cu``, with their plain PyTorch
versions.

Counterpart of the math of ``distributed_embeddings_tpu/analysis/
telemetry.py`` (``_buckets_of``, ``cms_update``, ``cms_query``,
``record_ids``), split at the kernels' seams:

* :func:`cms_update` (K13) adds each live position into its column of
  every depth row of the ``[depth, buckets]`` int32 sketch, IN PLACE (the
  JAX step donates the state), and returns the live count as int64
  partial sums;
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
  width's ``ids`` accumulator.

Everything is integer arithmetic, so each kernel equals its plain
version bit for bit, and both equal JAX's ``record_ids`` for live
counts below 2^24 (JAX sums the live mask in float32: beyond that its
sum is not the count in any order, and the port rounds the exact count
once).
``lax.top_k`` keeps the lower index first among equal values and
``torch.topk`` does not, so the plain versions select with a stable sort
on the negated score.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises. Each wrapper counts its launches.
"""

from __future__ import annotations

import functools
from typing import Dict

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


# ----------------------------------------------------------- the kernels


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, dtype, dim: int, device, what: str) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{what}: expected a contiguous {dim}-D {dtype} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _cuda(cms: torch.Tensor) -> None:
    if cms.device.type != "cuda":
        raise ValueError(f"unsupported device {cms.device}")
    _check(cms, torch.int32, 2, cms.device, "cms")


def _check_inputs(cms, ids, live=None):
    _cuda(cms)
    _check(ids, torch.int32, 1, cms.device, "ids")
    if live is not None:
        _check(live, torch.bool, 1, cms.device, "live")
        if live.shape != ids.shape:
            raise ValueError(f"live {tuple(live.shape)} != ids "
                             f"{tuple(ids.shape)}")
    if ids.numel() >= 2 ** 31:
        raise ValueError(f"{ids.numel()} ids: at most 2^31 - 1")


def cms_update(cms: torch.Tensor, ids: torch.Tensor,
               live: torch.Tensor) -> torch.Tensor:
    """K13: add ``live [n]`` (bool) into ``cms [depth, buckets]`` (int32,
    in place) at each depth row's column of ``ids [n]`` (int32; a dead
    position hashes id 0 and adds 0). Returns the live count as int64
    partial sums (their sum is the count; one per kernel block, one for
    the plain version)."""
    if cms.device.type == "cpu":
        return cms_update_plain(cms, ids, live)
    _check_inputs(cms, ids, live)
    lib = _kernels.library("sketch")
    n = ids.numel()
    counts = torch.empty(lib.detpu_cms_update_blocks(n), dtype=torch.int64,
                         device=cms.device)
    err = lib.detpu_cms_update(cms.data_ptr(), cms.shape[0], cms.shape[1],
                               ids.data_ptr(), live.data_ptr(), n,
                               counts.data_ptr(), _stream(cms))
    _kernels.check(lib, err, "cms_update")
    cms_update.launches += 1
    return counts


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
    """The largest ``k_pool`` the kernel takes (once per process)."""
    return _kernels.library("sketch").detpu_topk_pool_max()


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
    if k_pool > _pool_max():
        raise ValueError(f"k_pool {k_pool}: the kernel takes at most "
                         f"{_pool_max()}")
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


def topk_merge(cms: torch.Tensor, pool: torch.Tensor, counts: torch.Tensor,
               topk_ids: torch.Tensor, topk_est: torch.Tensor,
               ids_acc: torch.Tensor, candidates: int) -> torch.Tensor:
    """K15: merge the unique ``pool`` (padded to ``candidates``) into the
    carried ``topk_ids``/``topk_est`` (int32 ``[topk]``, in place), and
    add the live count (the sum of ``counts``, int64), rounded once to
    float32, to ``ids_acc`` (float32 ``[1]``, in place). Returns that
    count as a ``[1]`` float32."""
    if pool.numel() > candidates:
        raise ValueError(f"a pool of {pool.numel()} for {candidates} "
                         "candidates")
    if cms.device.type == "cpu":
        return topk_merge_plain(cms, pool, counts, topk_ids, topk_est,
                                ids_acc, candidates)
    _cuda(cms)
    dev = cms.device
    _check(pool, torch.int32, 1, dev, "pool")
    _check(counts, torch.int64, 1, dev, "counts")
    _check(topk_ids, torch.int32, 1, dev, "topk_ids")
    _check(topk_est, torch.int32, 1, dev, "topk_est")
    _check(ids_acc, torch.float32, 1, dev, "ids")
    if topk_est.shape != topk_ids.shape or ids_acc.numel() != 1:
        raise ValueError("topk_est must match topk_ids, and ids hold one "
                         "value")
    lib = _kernels.library("sketch")
    if topk_ids.numel() + candidates > lib.detpu_topk_merge_max():
        raise ValueError(f"topk + candidates = "
                         f"{topk_ids.numel() + candidates}: the kernel takes "
                         f"at most {lib.detpu_topk_merge_max()}")
    count = torch.empty((1,), dtype=torch.float32, device=dev)
    err = lib.detpu_topk_merge(
        cms.data_ptr(), cms.shape[0], cms.shape[1], pool.data_ptr(),
        pool.numel(), candidates, topk_ids.data_ptr(), topk_est.data_ptr(),
        topk_ids.numel(), ids_acc.data_ptr(), counts.data_ptr(),
        counts.numel(), count.data_ptr(), _stream(cms))
    _kernels.check(lib, err, "topk_merge")
    topk_merge.launches += 1
    return count


cms_update.launches = 0
cms_query.launches = 0
topk_pool.launches = 0
topk_merge.launches = 0
