"""The streaming vocabulary's remap and commit on the hand-written kernels
K16 (slot-map remap with admission and eviction) and K17 (the
guard-gated commit), both in ``csrc/streaming.cu``, with their plain
PyTorch versions.

Counterpart of the math of ``distributed_embeddings_tpu/parallel/
streaming.py`` (``_mix``, ``_fingerprint``, ``remap_width``, and the
scatters of ``commit``), split at the kernels' seams:

* :func:`remap_stage` (K16) serves one width slab's external-id stream
  out of the slot map: each position's table-local row (its slot on a
  map hit, else its shared hash bucket) and, in update mode, this step's
  staged transitions (:class:`Remap`): it folds the stream's
  fingerprints into the STAGED sketch it is given (K13's integer adds:
  the words ``ops/sketch.py:cms_update`` gives), estimates each position
  from it, and resolves the claims to one winner per row by the
  lexicographic max of (estimate, fingerprint, position);
* :func:`commit_rows` (K17) applies them under the device verdict
  ``enable``: the claimed slab rows become ``x + (-x)``, every
  slab-shaped optimizer leaf on them ``(c + (-c)) + fill``, the slot map
  takes the winners' fingerprints and estimates and then the hits'
  estimates (a max), the staged sketch replaces the carried one, and the
  step counts join the cumulative counters.

Everything is integer arithmetic or single IEEE adds, so each kernel
equals its plain version bit for bit (a NaN is a NaN), and both equal
JAX's ``remap_width``/``commit`` for live counts below 2^24 (JAX sums
its masks in float32: beyond that its sum is not the count in any
order; the port counts exactly in int64 and rounds once). The plain
versions do the uint32 hashes in int64 masked to 32 bits, as
``ops/sketch.py`` does (PyTorch's CPU uint32 lacks the shifts).

K16 launches through the shared launch path (``_kernels.LaunchRecord``),
one record a mode: the update is ONE cooperative launch of persistent
CTAs (hash and fold, claims, the position max, outputs and counts,
behind grid-wide barriers) that writes every output into one allocation the call makes
and carves into the :class:`Remap`'s views (:func:`update_outputs`);
the read-only remap is one launch into one ``[n]`` allocation. K17 is
ONE cooperative launch too (the claims' slot map and row resets, the
sketch copy and the counts, then, behind a grid-wide barrier, the hits'
max), on a record keyed on layouts to which each call passes its
addresses.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises. Each wrapper counts its launches (one per call).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _kernels
from .sketch import _M32, _mul32, cms_query_plain, cms_update_plain

#: free-slot marker in the slot map (fingerprints are >= 0)
SLOT_FREE = -1
#: odd multipliers of the slot, bucket and fingerprint hashes and the
#: table-id salt (``streaming.py:83-86``)
H_SLOT = 0x7FEB352D
H_BUCKET = 0x846CA68B
H_FP = 0x9E3779B1
H_SALT = 0x85EBCA77
AVALANCHE = 0x2C1B3C6D
#: the four per-step counts, in the order of :attr:`Remap.counts`
COUNT_NAMES = ("admitted", "evicted", "bucket_ids", "hit_ids")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class Remap(NamedTuple):
    """One width stream's remap (``[n]`` int32 each unless noted).
    Read-only remaps fill only ``local_rows``."""

    local_rows: torch.Tensor   #: table-local row a live position reads
    fp: Optional[torch.Tensor] = None  #: fingerprint (the sketch key)
    est: Optional[torch.Tensor] = None  #: estimate in the staged sketch
    scrub_rows: Optional[torch.Tensor] = None  #: claimed row or rows_cap
    hit_rows: Optional[torch.Tensor] = None    #: hit row or rows_cap
    counts: Optional[torch.Tensor] = None  #: [4] int64, COUNT_NAMES


# ----------------------------------------------------------- the hashes


def _low32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as int32 (two's complement)."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def fold_ids(ext: torch.Tensor) -> torch.Tensor:
    """``uint32(ext)`` as int64 in ``[0, 2^32)``; 64-bit ids fold their
    high word in first (``ext ^ (ext >> 32)``)."""
    x = ext.long()
    if ext.dtype == torch.int64:
        x = x ^ (x >> 32)
    return x & _M32


def mix_plain(ext: torch.Tensor, salt: torch.Tensor, mult: int
              ) -> torch.Tensor:
    """``_mix``: the salted xxhash-style avalanche of ``ext`` (uint32 as
    int64)."""
    h = fold_ids(ext) ^ _mul32(salt.long() & _M32, H_SALT)
    h = _mul32(h, mult)
    h = h ^ (h >> 15)
    h = _mul32(h, AVALANCHE)
    return h ^ (h >> 13)


def fingerprint_plain(ext: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
    """``_fingerprint``: the 31-bit id fingerprint (int32), also the
    admission sketch's key."""
    return (mix_plain(ext, tid, H_FP) >> 1).to(torch.int32)


def slot_bucket_plain(ext, tid, cap, nbuckets):
    """Each position's direct-mapped slot and shared bucket (int32)."""
    slot = mix_plain(ext, tid, H_SLOT) % cap.long().clamp(min=1)
    bucket = mix_plain(ext, tid, H_BUCKET) % nbuckets.long().clamp(min=1)
    return slot.to(torch.int32), bucket.to(torch.int32)


# ----------------------------------------------------- plain versions


def remap_stage_plain(ext, live, cap, nbuckets, tid, roff, slot_fp,
                      slot_freq, cms, admit_min_count: int,
                      evict_margin: int, update: bool = True) -> Remap:
    """Plain PyTorch version of :func:`remap_stage`: ``remap_width`` op
    for op (the winner through three ``rows_cap``-long max-scatters)."""
    live = live & (ext >= 0)
    fp = fingerprint_plain(ext, tid)
    slot, bucket = slot_bucket_plain(ext, tid, cap, nbuckets)
    row = roff + slot
    rowc = torch.where(live, row, 0).long()
    occ = slot_fp[rowc]
    hit = live & (occ == fp)
    local = torch.where(hit, slot, cap + bucket)
    local_rows = torch.where(live, local, _low32(ext.long()))
    if not update:
        return Remap(local_rows)
    cms_update_plain(cms, fp, live)
    est = cms_query_plain(cms, fp)
    free = occ == SLOT_FREE
    admit = live & ~hit & (est >= admit_min_count)
    claim = admit & (free | (est >= slot_freq[rowc] + evict_margin))
    rows_cap = slot_fp.numel()
    neg = torch.full((rows_cap,), -1, dtype=torch.int32, device=ext.device)

    def best(vals):
        return neg.scatter_reduce(0, rowc, vals, "amax")[rowc]

    cand = claim & (est == best(torch.where(claim, est, -1)))
    cand = cand & (fp == best(torch.where(cand, fp, -1)))
    pos = torch.arange(ext.numel(), dtype=torch.int32, device=ext.device)
    scrub = cand & (best(torch.where(cand, pos, -1)) == pos)
    counts = torch.stack([scrub.sum(), (scrub & ~free).sum(),
                          (live & ~hit).sum(), hit.sum()])
    return Remap(local_rows, fp, est, torch.where(scrub, row, rows_cap),
                 torch.where(hit, row, rows_cap), counts)


def _reset(t: torch.Tensor, rows: torch.Tensor, fill: float) -> None:
    c = t[rows]
    z = c + (-c)
    if fill:
        z = z + torch.tensor(fill, dtype=t.dtype, device=t.device)
    t[rows] = z


def commit_rows_plain(slab, leaves, pend: Remap, slot_fp, slot_freq, cms,
                      staged, totals, counters, steps, enable=None,
                      finalize: bool = True) -> None:
    """Plain PyTorch version of :func:`commit_rows`."""
    rows_cap = slot_fp.numel()
    en = (torch.ones((), dtype=torch.bool, device=slab.device)
          if enable is None else enable)
    sel = (pend.scrub_rows >= 0) & (pend.scrub_rows < rows_cap) & en
    rows = pend.scrub_rows[sel].long()
    _reset(slab, rows, 0.0)
    for leaf, fill in leaves:
        _reset(leaf, rows, fill)
    slot_fp[rows] = pend.fp[sel]
    slot_freq[rows] = pend.est[sel]
    hsel = (pend.hit_rows >= 0) & (pend.hit_rows < rows_cap) & en
    slot_freq.scatter_reduce_(0, pend.hit_rows[hsel].long(),
                              pend.est[hsel], "amax")
    cms.copy_(torch.where(en, staged, cms))
    totals.add_(torch.where(en, pend.counts.to(torch.float32), 0.0))
    if finalize:
        for k, c in enumerate(counters):
            c.add_(totals[k:k + 1])
        steps.add_(en.to(torch.int32))


# ----------------------------------------------------------- the kernels


def _check(t, dtypes, shape, device, what):
    dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what}: expected a contiguous {dtypes} tensor of "
                         f"shape {tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _claim_scratch(device: torch.device, rows_cap: int):
    """K16's per-row claim scratch (``best_key`` zeros, ``best_pos``
    -1s), kept between launches per card and slot-map size: each launch
    resets the entries it touches, so a step costs O(n), not the
    O(rows_cap) fill a fresh buffer would (12 B a row: 127 MB for the
    capped Criteo-Kaggle slab)."""
    key = (device.index, rows_cap)
    s = _scratch.get(key)
    if s is None:
        s = (torch.zeros(rows_cap, dtype=torch.int64, device=device),
             torch.full((rows_cap,), -1, dtype=torch.int32, device=device))
        _scratch[key] = s
    return s


#: K16's launch records (both modes), by layout and policy
_CACHE = _kernels.LaunchCache()
#: int32 words before the update allocation's first [n] view: the four
#: int64 counts
_COUNT_WORDS = 8


def out_stride(n: int) -> int:
    """The int32 words between two ``[n]`` views of an update call's
    allocation: ``n`` rounded up to 4 (each view starts 16-byte
    aligned)."""
    return (n + 3) // 4 * 4


def _carve(buf: torch.Tensor, n: int) -> Remap:
    """The :class:`Remap` of an update call's allocation ``buf``: one
    ``split_with_sizes`` (the counts, then each ``[n]`` view and, where
    ``n`` is not a multiple of 4, its pad) and the counts' int64 view
    (each view object costs ~1 us of host)."""
    pad = out_stride(n) - n
    parts = buf.split_with_sizes([_COUNT_WORDS]
                                 + ([n, pad] * 5 if pad else [n] * 5))
    return Remap(*(parts[1::2] if pad else parts[1:]),
                 parts[0].view(torch.int64))


def update_outputs(n: int, device) -> Tuple[torch.Tensor, Remap]:
    """An update call's one allocation (int32) and the :class:`Remap` of
    its views: ``counts [4]`` int64 at its start, then ``local_rows``,
    ``fp``, ``est``, ``scrub_rows`` and ``hit_rows`` ``[n]`` int32, each
    at ``8 + k * out_stride(n)`` words (the kernel's layout,
    ``csrc/streaming.cu:detpu_stream_remap_launch``)."""
    buf = torch.empty(_COUNT_WORDS + 5 * out_stride(n), dtype=torch.int32,
                      device=device)
    return buf, _carve(buf, n)


def _inputs(ext, live, cap, nbuckets, tid, roff, slot_fp, slot_freq, cms,
            update):
    """The tensors a K16 call reads, in the launch's order."""
    return ((ext, live, cap, nbuckets, tid, roff, slot_fp)
            + ((slot_freq, cms) if update else ()))


def remap_key(ext, live, cap, nbuckets, tid, roff, slot_fp, slot_freq,
              cms, admit_min_count: int, evict_margin: int,
              update: bool = True) -> tuple:
    """Every fact K16's launch record rests on: the mode, the layouts
    (shape, strides, dtype, device index) of the tensors the call reads
    (so ``n``, the id dtype, ``rows_cap`` and, in update mode, the
    sketch's shape) and, in update mode, ``admit_min_count`` and
    ``evict_margin``. No address: each call passes its own."""
    if update and (cms is None or slot_freq is None):
        raise ValueError("remap_stage: an update needs slot_freq and cms "
                         "[depth, buckets]")
    ts = _inputs(ext, live, cap, nbuckets, tid, roff, slot_fp, slot_freq,
                 cms, update)
    return (bool(update),
            (int(admit_min_count), int(evict_margin)) if update else None,
            *map(_kernels._SHAPE, ts), *map(_kernels._STRIDE, ts),
            *map(_kernels._DTYPE, ts), *map(_kernels._DEVICE, ts))


def build_remap_record(ext, live, cap, nbuckets, tid, roff, slot_fp,
                       slot_freq, cms, admit_min_count: int,
                       evict_margin: int, update: bool = True,
                       sms: Optional[int] = None) -> _kernels.LaunchRecord:
    """Validate a call as :func:`remap_stage` does (raising as it does)
    and build its launch record: for CUDA tensors the prepared launch
    bound to the library, with (update mode) the per-card claim scratch
    (:func:`_claim_scratch`) and, where the stream passes the positions
    the grid holds in registers, the record's own scratch for the rest's
    rows and flags (``record.payload``: ``(prepared, scratch)``). CPU
    tensors (the tests) get a record without launches."""
    dev = ext.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    n = ext.numel()
    if n >= 2 ** 31:
        raise ValueError(f"{n} positions: at most 2^31 - 1")
    _check(ext, (torch.int32, torch.int64), (n,), dev, "ext")
    _check(live, torch.bool, (n,), dev, "live")
    for t, what in ((cap, "cap"), (nbuckets, "nbuckets"), (tid, "tid"),
                    (roff, "roff")):
        _check(t, torch.int32, (n,), dev, what)
    rows_cap = slot_fp.numel()
    _check(slot_fp, torch.int32, (rows_cap,), dev, "slot_fp")
    if update:
        _check(slot_freq, torch.int32, (rows_cap,), dev, "slot_freq")
        if cms is None or cms.dim() != 2:
            raise ValueError(f"cms: expected [depth, buckets], got "
                             f"{None if cms is None else tuple(cms.shape)}")
        _check(cms, torch.int32, tuple(cms.shape), dev, "cms")
    if rows_cap >= 2 ** 31:
        raise ValueError(f"{rows_cap} slot rows: at most 2^31 - 1")
    lib, calls, prepared, scratch = None, [], None, None
    if dev.type == "cuda":
        lib = _kernels.library("streaming")
        sms = sms or _kernels.sm_count(dev.index or 0)
        prepared = np.zeros(lib.detpu_stream_remap_prepared_bytes(),
                            np.uint8)
        keys = (None, None)
        depth = buckets = 0
        ids64 = int(ext.dtype == torch.int64)
        if update:
            nbytes = lib.detpu_stream_remap_scratch_bytes(ids64, n, sms)
            if nbytes < 0:
                raise RuntimeError("remap_stage: no launch configuration "
                                   "for the update kernel")
            if nbytes:
                scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            keys = tuple(t.data_ptr() for t in _claim_scratch(dev,
                                                              rows_cap))
            depth, buckets = cms.shape
        _kernels.check(lib, lib.detpu_stream_remap_prepare(
            int(update), ids64, n, out_stride(n), rows_cap, depth, buckets,
            int(admit_min_count), int(evict_margin), sms, *keys,
            None if scratch is None else scratch.data_ptr(),
            prepared.ctypes.data), "remap_stage")
        calls.append((lib.detpu_stream_remap_launch,
                      (prepared.ctypes.data,)))
    return _kernels.LaunchRecord(lib, "remap_stage", calls,
                                 _kernels.device_index(dev),
                                 payload=(prepared, scratch))


def find_remap_record(ext, live, cap, nbuckets, tid, roff, slot_fp,
                      slot_freq, cms, admit_min_count: int,
                      evict_margin: int, update: bool = True,
                      build_on_cpu: bool = False
                      ) -> Optional[_kernels.LaunchRecord]:
    """The record of a call, found in :data:`_CACHE` by
    :func:`remap_key` or built (:func:`build_remap_record`) and kept. A
    miss on CPU tensors is validated and gives None (the wrapper runs
    the plain version) unless ``build_on_cpu``."""
    args = (ext, live, cap, nbuckets, tid, roff, slot_fp, slot_freq, cms,
            admit_min_count, evict_margin, update)
    return _kernels.find_or_build(_CACHE, remap_key(*args),
                                  build_remap_record,
                                  ext.device.type == "cpu", build_on_cpu,
                                  *args)


def remap_stage(ext: torch.Tensor, live: torch.Tensor, cap: torch.Tensor,
                nbuckets: torch.Tensor, tid: torch.Tensor,
                roff: torch.Tensor, slot_fp: torch.Tensor,
                slot_freq: torch.Tensor, cms: Optional[torch.Tensor],
                admit_min_count: int, evict_margin: int,
                update: bool = True) -> Remap:
    """K16: remap ``ext [n]`` (int32 or int64 external ids; ``live [n]``
    bool; per position ``cap``, ``nbuckets``, ``tid`` (the hash salt) and
    ``roff`` (the table's slab row offset), int32 ``[n]``) through the
    slot map ``slot_fp``/``slot_freq [rows_cap]`` (int32). With
    ``update``, fold the fingerprints of the live positions into ``cms``
    ``[depth, buckets]`` (int32, the STAGED copy of the carried sketch,
    in place) and stage the admissions (:class:`Remap`, views of one
    allocation); the slot map is only read. On the card: one launch
    through the launch record of the call's layouts (the first call
    validates and prepares, later ones pass the pointers)."""
    if ext.device.type == "cpu":
        return remap_stage_plain(ext, live, cap, nbuckets, tid, roff,
                                 slot_fp, slot_freq, cms, admit_min_count,
                                 evict_margin, update)
    args = (ext, live, cap, nbuckets, tid, roff, slot_fp, slot_freq, cms,
            admit_min_count, evict_margin, update)
    rec = _kernels.find_or_build(_CACHE, remap_key(*args),
                                 build_remap_record, False, False, *args)
    n = ext.shape[0]
    if not update:
        local_rows = torch.empty(n, dtype=torch.int32, device=ext.device)
        remap_stage.launches += rec.replay(
            ext.data_ptr(), live.data_ptr(), cap.data_ptr(),
            nbuckets.data_ptr(), tid.data_ptr(), roff.data_ptr(),
            slot_fp.data_ptr(), None, None, local_rows.data_ptr())
        return Remap(local_rows)
    buf = torch.empty(_COUNT_WORDS + 5 * out_stride(n), dtype=torch.int32,
                      device=ext.device)
    remap_stage.launches += rec.replay(
        ext.data_ptr(), live.data_ptr(), cap.data_ptr(),
        nbuckets.data_ptr(), tid.data_ptr(), roff.data_ptr(),
        slot_fp.data_ptr(), slot_freq.data_ptr(), cms.data_ptr(),
        buf.data_ptr())
    # the views are carved while the launch runs
    return _carve(buf, n)


#: K17's launch records, by layout, leaves and policy
_COMMIT = _kernels.LaunchCache()


def _commit_tensors(slab, leaves, pend, slot_fp, slot_freq, cms, staged,
                    totals, counters, steps, enable) -> tuple:
    """The tensors a K17 call passes, in the launch's order
    (``csrc/streaming.cu:detpu_stream_commit_launch``; the record's
    ``payload[1]`` pads the leaves and ``enable`` to its five slots)."""
    return ((pend.scrub_rows, pend.fp, pend.est, pend.hit_rows, pend.counts,
             slot_fp, slot_freq, cms, staged, totals, *counters, steps, slab,
             *[t for t, _ in leaves])
            + (() if enable is None else (enable,)))


_CONTIGUOUS = torch.Tensor.is_contiguous


def _commit_key(ts, leaves, has_enable: bool, finalize: bool) -> tuple:
    # contiguity, not the strides: every check rests on it, and it costs
    # half as much a tensor (18 of them on the streaming step)
    return (len(leaves), tuple(f for _, f in leaves), bool(finalize),
            has_enable, *map(_kernels._SHAPE, ts),
            *map(_CONTIGUOUS, ts), *map(_kernels._DTYPE, ts),
            *map(_kernels._DEVICE, ts))


def commit_key(slab, leaves, pend, slot_fp, slot_freq, cms, staged, totals,
               counters, steps, enable=None, finalize: bool = True) -> tuple:
    """Every fact K17's launch record rests on: the leaves' count and
    fills, ``finalize``, whether ``enable`` is given, and the layouts
    (shape, contiguity, dtype, device index) of every tensor the call
    passes (the slab, the leaves, the ``pend`` views, the slot map, the
    sketch and its staged copy, the totals, counters and ``steps``, and
    ``enable``): so the width, ``rows_cap``, ``n``, the sketch's size and
    the leaves' dtypes. No address: each call passes its own."""
    ts = _commit_tensors(slab, leaves, pend, slot_fp, slot_freq, cms,
                         staged, totals, counters, steps, enable)
    return _commit_key(ts, leaves, enable is not None, finalize)


def build_commit_record(slab, leaves, pend, slot_fp, slot_freq, cms, staged,
                        totals, counters, steps, enable=None,
                        finalize: bool = True, sms: Optional[int] = None
                        ) -> _kernels.LaunchRecord:
    """Validate a call as :func:`commit_rows` does (raising as it does)
    and build its launch record: for CUDA tensors the prepared launch
    bound to the library; ``record.payload`` is ``(prepared, pad)``, a
    call replaying ``(*addresses, *pad)`` in :func:`_commit_tensors`'
    order. CPU tensors (the tests) get a record without launches."""
    dev = slab.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if slab.dim() != 2 or slab.dtype not in _DTYPE_CODE:
        raise ValueError(f"slab: expected a [rows, w] float32/bfloat16 "
                         f"tensor, got {slab.dtype} {tuple(slab.shape)}")
    rows_cap, w = slab.shape
    _check(slab, tuple(_DTYPE_CODE), (rows_cap, w), dev, "slab")
    for leaf, _ in leaves:
        _check(leaf, tuple(_DTYPE_CODE), (rows_cap, w), dev, "leaf")
    if len(leaves) > 4:
        raise ValueError(f"{len(leaves)} leaves: the kernel takes at most 4")
    n = pend.scrub_rows.numel()
    for t, what in ((pend.scrub_rows, "scrub_rows"), (pend.fp, "fp"),
                    (pend.est, "est"), (pend.hit_rows, "hit_rows")):
        _check(t, torch.int32, (n,), dev, what)
    _check(pend.counts, torch.int64, (4,), dev, "counts")
    _check(slot_fp, torch.int32, (rows_cap,), dev, "slot_fp")
    _check(slot_freq, torch.int32, (rows_cap,), dev, "slot_freq")
    _check(cms, torch.int32, tuple(cms.shape), dev, "cms")
    _check(staged, torch.int32, tuple(cms.shape), dev, "staged")
    _check(totals, torch.float32, (4,), dev, "totals")
    if len(counters) != 4:
        raise ValueError(f"{len(counters)} counters: expected the four of "
                         f"{COUNT_NAMES}")
    for c in counters:
        _check(c, torch.float32, (1,), dev, "counter")
    _check(steps, torch.int32, (1,), dev, "steps")
    if enable is not None:
        _check(enable, torch.bool, (), dev, "enable")
    if n >= 2 ** 31 or rows_cap >= 2 ** 31:
        raise ValueError(f"{n} positions into {rows_cap} slot rows: at most "
                         "2^31 - 1 each")
    pad = (None,) * (5 - len(leaves) - (enable is not None))
    lib, calls, prepared = None, [], None
    if dev.type == "cuda":
        lib = _kernels.library("streaming")
        prepared = np.zeros(lib.detpu_stream_commit_prepared_bytes(),
                            np.uint8)
        codes = np.array([_DTYPE_CODE[t.dtype] for t, _ in leaves] + [0],
                         np.int32)
        fills = np.array([float(f) for _, f in leaves] + [0.0], np.float32)
        _kernels.check(lib, lib.detpu_stream_commit_prepare(
            _DTYPE_CODE[slab.dtype], w, rows_cap, len(leaves),
            codes.ctypes.data, fills.ctypes.data, n, cms.numel(),
            int(bool(finalize)), int(enable is not None),
            sms or _kernels.sm_count(dev.index or 0),
            prepared.ctypes.data), "commit_rows")
        calls.append((lib.detpu_stream_commit_launch,
                      (prepared.ctypes.data,)))
    return _kernels.LaunchRecord(lib, "commit_rows", calls,
                                 _kernels.device_index(dev),
                                 payload=(prepared, pad))


def _commit_record(args, build_on_cpu: bool):
    """The record of a call (``args``: :func:`commit_rows`' arguments),
    found in :data:`_COMMIT` or built, and the tensors the call passes."""
    slab, leaves, *_, enable, finalize = args
    ts = _commit_tensors(*args[:-1])
    rec = _kernels.find_or_build(
        _COMMIT, _commit_key(ts, leaves, enable is not None, finalize),
        build_commit_record, slab.device.type == "cpu", build_on_cpu, *args)
    return rec, ts


def find_commit_record(slab, leaves, pend, slot_fp, slot_freq, cms, staged,
                       totals, counters, steps, enable=None,
                       finalize: bool = True, build_on_cpu: bool = False
                       ) -> Optional[_kernels.LaunchRecord]:
    """The record of a call, found in :data:`_COMMIT` by
    :func:`commit_key` or built (:func:`build_commit_record`) and kept. A
    miss on CPU tensors is validated and gives None (the wrapper runs the
    plain version) unless ``build_on_cpu``."""
    return _commit_record((slab, leaves, pend, slot_fp, slot_freq, cms,
                           staged, totals, counters, steps, enable,
                           finalize), build_on_cpu)[0]


def commit_rows(slab: torch.Tensor,
                leaves: Sequence[Tuple[torch.Tensor, float]], pend: Remap,
                slot_fp: torch.Tensor, slot_freq: torch.Tensor,
                cms: torch.Tensor, staged: torch.Tensor,
                totals: torch.Tensor, counters: Sequence[torch.Tensor],
                steps: torch.Tensor, enable: Optional[torch.Tensor] = None,
                finalize: bool = True) -> None:
    """K17: commit one width's staged transitions (``pend``, from
    :func:`remap_stage`) in place, unless the 0-d bool ``enable`` (on
    the card; ``None`` commits) is False: reset the claimed rows of
    ``slab [rows_cap, w]`` (float32/bfloat16) and of each ``(leaf,
    fill)`` of its shape, write the slot map, copy ``staged`` into
    ``cms``, and add the counts (0 when not enabled) to ``totals [4]``
    (float32). With ``finalize`` (the step's last width), add ``totals``
    to the four ``counters`` ([1] float32 each, :data:`COUNT_NAMES`
    order) and ``enable`` to ``steps`` ([1] int32). On the card: one
    launch through the launch record of the call's layouts (the first
    call validates and prepares, later ones pass the pointers)."""
    if slab.device.type == "cpu":
        return commit_rows_plain(slab, leaves, pend, slot_fp, slot_freq,
                                 cms, staged, totals, counters, steps,
                                 enable, finalize)
    rec, ts = _commit_record((slab, leaves, pend, slot_fp, slot_freq, cms,
                              staged, totals, counters, steps, enable,
                              finalize), False)
    commit_rows.launches += rec.replay(*map(_kernels._PTR, ts),
                                       *rec.payload[1])


remap_stage.launches = 0
commit_rows.launches = 0
