"""Datasets: synthetic id generation, synthetic benchmark feeds and the
Criteo raw-binary reader (counterpart of
``distributed_embeddings_tpu/utils/data.py``, copied where it is
JAX-free, so one numpy generator or one dataset directory gives both
packages the same batches).

* :func:`power_law_ids`: the power-law id generator of the synthetic
  models and the DLRM example.
* :func:`fast_forward`: position a data source at batch ``start`` for a
  resumed run.
* :class:`DummyDataset`: constant synthetic batches.
* :class:`RawBinaryDataset`: the split Criteo binary format
  (``label.bin``, ``numerical.bin`` float16, per-feature ``cat_<i>.bin``
  in the smallest int type that fits the vocab), read through
  ``np.memmap`` and a background prefetch thread. The JAX package's
  optional C reader (``utils/native.py``) is not ported (ROADMAP A8).

Batches are numpy; the caller moves them to its device.
"""

from __future__ import annotations

import itertools
import math
import os
import queue
import threading
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np


def power_law_ids(rng: np.random.Generator, vocab: int, shape,
                  alpha: float = 1.05) -> np.ndarray:
    """Power-law distributed ids in ``[0, vocab)``: hot ids dominate, as
    in real recommender traffic. Same inverse-CDF draw as the JAX
    package, so one numpy generator gives both packages the same ids."""
    u = rng.random(size=shape)
    # inverse-CDF of p(x) ~ x^(-alpha) on [1, vocab+1)
    exp = 1.0 - alpha
    ids = ((vocab + 1) ** exp * u + (1 - u)) ** (1.0 / exp) - 1.0
    return np.clip(ids.astype(np.int64), 0, vocab - 1)


def fast_forward(data: Any, start: int) -> Iterator:
    """Deterministically position a data source at batch ``start`` for a
    resumed run — the resume contract: no batch replayed, none skipped.

    Dispatch, cheapest first:

    * a **callable** ``data(start) -> iterable`` positions itself (the
      factory form; ``RawBinaryDataset(start_batch=...)`` or a seeded
      generator that folds the step into its key);
    * an object with ``iter_from(start)`` (e.g. :class:`RawBinaryDataset`)
      seeks directly — random access via the memmaps, no replay cost;
    * any other iterable is advanced with ``itertools.islice`` — the
      skipped batches are *generated* and discarded (deterministic for a
      seeded generator, but O(start) work; prefer the first two forms for
      long runs).
    """
    if start < 0:
        raise ValueError(f"fast_forward start must be >= 0, got {start}")
    if callable(data):
        return iter(data(start))
    if hasattr(data, "iter_from"):
        return data.iter_from(start)
    it = iter(data)
    if start:
        next(itertools.islice(it, start - 1, start), None)
    return it


def get_categorical_feature_type(size: int):
    """Smallest signed int dtype that can hold ids below ``size``
    (reference ``utils.py:116-123``)."""
    for t in (np.int8, np.int16, np.int32):
        if size < np.iinfo(t).max:
            return t
    raise RuntimeError(f"Categorical feature of size {size} is too big")


class DummyDataset:
    """Fixed synthetic batches (all-zero ids, like the reference's
    ``DummyDataset`` — measuring the compute path, not input randomness).

    ``num_workers`` ranks split the ``batch_size`` global batch: the
    numerical features and labels are one rank's rows. The categorical
    ids are one rank's rows too (``dp_input=True``), or, with
    ``dp_input=False``, the whole global batch a model-parallel input
    needs (``DistributedEmbedding.pack_mp_inputs`` packs it), as the
    Criteo reader's ``dp_input`` gives them."""

    def __init__(self, batch_size: int, num_numerical_features: int,
                 table_sizes: Sequence[int], num_batches: int,
                 hotness=1, num_workers: int = 1, dp_input: bool = True):
        local_bs = batch_size // num_workers
        cat_bs = local_bs if dp_input else local_bs * num_workers
        self.numerical = np.zeros((local_bs, num_numerical_features),
                                  np.float32)
        # hotness: one int for all tables, or a per-table sequence (the
        # reference's DummyDataset takes per-feature hotness, utils.py:126-154)
        if isinstance(hotness, (int, np.integer)):
            hotness = [int(hotness)] * len(table_sizes)
        if len(hotness) != len(table_sizes):
            raise ValueError("hotness list must match table_sizes")
        self.categorical = [np.zeros((cat_bs, h), np.int32)
                            for h in hotness]
        self.labels = np.ones((local_bs, 1), np.float32)
        self.num_batches = num_batches

    def __len__(self):
        return self.num_batches

    def __getitem__(self, idx):
        if idx >= self.num_batches:
            raise IndexError
        return self.numerical, self.categorical, self.labels

    def __iter__(self):
        for i in range(self.num_batches):
            yield self[i]


class RawBinaryDataset:
    """Split-binary Criteo reader.

    Layout (identical to the reference's, ``examples/dlrm/utils.py:157-237``):
    ``<root>/<train|test>/label.bin`` (bool), ``numerical.bin`` (float16,
    ``[N, num_numerical]`` row-major), ``cat_<i>.bin`` (per-feature smallest
    int type). Yields ``(numerical [B, F] float32, categorical list of
    [B] int32, labels [B, 1] float32)``.

    Args:
      data_path: dataset root.
      batch_size: global batch size.
      numerical_features: how many numerical columns to read (0 = none).
      categorical_features: feature ids this worker needs (model-parallel
        input reads only the local tables' files, reference ``main.py:166-176``).
      categorical_feature_sizes: vocab sizes for ALL features (determines the
        stored dtype of each file).
      offset/lbs: slice ``[offset, offset+lbs)`` of each batch for
        data-parallel shards (labels/numerical always sliced; categorical
        sliced only when ``dp_input``).
      drop_last_batch: drop the trailing partial batch.
      valid: read the ``test`` split.
      prefetch_depth: background-thread read-ahead.
      start_batch: iteration begins at this batch index (random access via
        the memmaps, no replay cost) — lets a resumed run continue the data
        stream where the checkpointed step left off instead of re-training
        the early batches with a late-step LR.
    """

    def __init__(self, data_path: str, batch_size: int = 1,
                 numerical_features: int = 0,
                 categorical_features: Optional[Sequence[int]] = None,
                 categorical_feature_sizes: Optional[Sequence[int]] = None,
                 prefetch_depth: int = 10, drop_last_batch: bool = False,
                 valid: bool = False, offset: int = -1, lbs: int = -1,
                 dp_input: bool = False, start_batch: int = 0):
        split_dir = os.path.join(data_path, "test" if valid else "train")
        self._batch_size = batch_size
        self._num_numerical = numerical_features
        self.offset, self.lbs, self.valid = offset, lbs, valid
        self.dp_input = dp_input

        self._labels = np.memmap(os.path.join(split_dir, "label.bin"),
                                 dtype=np.bool_, mode="r")
        n = len(self._labels)
        self._num_entries = (n // batch_size if drop_last_batch
                             else math.ceil(n / batch_size))

        if numerical_features > 0:
            num = np.memmap(os.path.join(split_dir, "numerical.bin"),
                            dtype=np.float16, mode="r")
            self._numerical = num.reshape(-1, numerical_features)
            if len(self._numerical) != n:
                raise ValueError("numerical.bin row count mismatch")
        else:
            self._numerical = None

        self._cat_maps: List[np.memmap] = []
        self._cat_ids = list(categorical_features or [])
        sizes = list(categorical_feature_sizes or [])
        for cid in self._cat_ids:
            dt = get_categorical_feature_type(sizes[cid])
            m = np.memmap(os.path.join(split_dir, f"cat_{cid}.bin"),
                          dtype=dt, mode="r")
            if len(m) != n:
                raise ValueError(f"cat_{cid}.bin row count mismatch")
            self._cat_maps.append(m)

        # NOT wrapped modulo the epoch: resuming a checkpoint saved at run
        # completion (step == num batches) must yield an EMPTY stream, not
        # silently retrain an extra epoch; multi-epoch drivers pass
        # ``step % len(ds)`` themselves
        self._start_batch = int(start_batch)
        self._prefetch_depth = min(prefetch_depth, self._num_entries)

    def __len__(self):
        # full-epoch batch count; iteration with start_batch > 0 yields
        # len(self) - start_batch items (absolute __getitem__ indexing is
        # unaffected)
        return self._num_entries

    def _read(self, idx: int):
        lo, hi = idx * self._batch_size, (idx + 1) * self._batch_size
        labels = np.asarray(self._labels[lo:hi], np.float32)[:, None]
        numerical = (np.asarray(self._numerical[lo:hi], np.float32)
                     if self._numerical is not None else
                     np.zeros((labels.shape[0], 0), np.float32))
        cats = [np.asarray(m[lo:hi], np.int32) for m in self._cat_maps]
        if self.offset >= 0:
            sl = slice(self.offset, self.offset + self.lbs)
            if not self.valid:
                labels = labels[sl]
            numerical = numerical[sl]
            if self.dp_input:
                cats = [c[sl] for c in cats]
        return numerical, cats, labels

    def __getitem__(self, idx: int):
        if idx >= self._num_entries:
            raise IndexError
        return self._read(idx)

    def iter_from(self, start: int):
        """Iterate from absolute batch ``start`` regardless of the
        constructor's ``start_batch`` — the :func:`fast_forward` resume
        hook (random access via the memmaps, no replay cost). Like
        ``start_batch``, NOT wrapped modulo the epoch: resuming at or past
        the end yields an empty stream."""
        return self._iter_range(int(start))

    def __iter__(self):
        return self._iter_range(self._start_batch)

    def _iter_range(self, start_batch: int):
        if self._prefetch_depth <= 1:
            for i in range(start_batch, self._num_entries):
                yield self._read(i)
            return

        # Fresh bounded queue + thread per iteration: maxsize caps read-ahead
        # memory at prefetch_depth batches, and an abandoned iteration can't
        # leak stale batches into the next epoch. The stop event makes the
        # producer exit promptly when the consumer abandons the generator —
        # a thread blocked forever on put() would keep the queue and memmaps
        # alive for the process lifetime.
        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch_depth)
        stop = threading.Event()

        def put_until_stopped(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # An exception (truncated file, transient IO error) must reach
            # the consumer — a silently dead producer would leave the
            # consumer blocked on q.get() forever.
            try:
                for i in range(start_batch, self._num_entries):
                    if not put_until_stopped(self._read(i)):
                        return
                put_until_stopped(None)
            except BaseException as e:  # noqa: BLE001 - relayed, not dropped
                put_until_stopped(e)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
