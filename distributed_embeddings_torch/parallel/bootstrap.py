"""The process-group layer: joining ``torch.distributed`` and moving
tensors over it (counterpart of
``distributed_embeddings_tpu/parallel/bootstrap.py``).

The JAX package joins one process per host into one runtime and lets
SPMD programs span its devices. Here every rank is a process (one per
GPU, or several on one card), joined by :func:`initialize` with an
explicit backend, address, world size and rank: nothing is detected
from the environment, and a backend that fails to start raises. After
it, :class:`~.dist_embedding.DistributedEmbedding` takes the group
(``process_group=``, ``None`` for the default one) the way the JAX layer
takes its mesh axis.

The collectives the hybrid step runs (:func:`all_to_all`,
:func:`all_reduce_sum_`, :func:`broadcast_`, :func:`all_gather`) hand
their tensors to the group's own backend as they are, on the host or on
the card (gloo copies a CUDA tensor through host memory itself); the
all-to-all can also be left in flight (:func:`all_to_all_start`, an
:class:`InFlight` to wait on), which is how the pipelined step keeps its
exchanges under other microbatches' compute;
bfloat16 travels as its bytes in the copying collectives (copies, not
sums). :func:`to_host` and :func:`gather_leaves` gather onto the host.

The checkpoint layer adds :func:`barrier`, :func:`send_to_chief` (one
tensor from its owner rank to group rank 0 only, point to point: a
chief-written save moves each table through host memory once) and
:func:`broadcast_object` (rank 0's small picklable object, the restore's
decision) and :func:`all_gather_object`. Every collective names the group
it runs on. :func:`spawn_ranks` starts a job's ranks as processes of one
host and collects their results (the example's launcher, the dryrun).
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import runtime

logger = logging.getLogger(__name__)


def initialize(backend: str, init_method: str, world_size: int, rank: int,
               timeout_s: Optional[float] = None, retries: int = 2) -> bool:
    """Join the process group (``torch.distributed.init_process_group``
    with these arguments); safe to call more than once.

    Args:
      backend: ``"nccl"`` or ``"gloo"``, explicit: there is no switch from
        one to the other. A backend this build lacks raises
        ``ValueError`` at once.
      init_method: the rendezvous, ``"tcp://host:port"`` or
        ``"file:///path"``.
      world_size, rank: this job's ranks and this process's rank.
      timeout_s: the group's timeout (each collective and the join);
        ``None`` keeps PyTorch's default.
      retries: further attempts after a failed join, with backoff.

    Returns True if this call joined, False if the process was already
    in a group. After ``retries + 1`` failed attempts it raises
    :class:`~..utils.runtime.CoordinatorUnreachable`.
    """
    if dist.is_initialized():
        return False
    avail = {"nccl": dist.is_nccl_available(),
             "gloo": dist.is_gloo_available()}
    if backend not in avail:
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if not avail[backend]:
        raise ValueError(f"this PyTorch build has no {backend} backend")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    last: Optional[BaseException] = None
    t0 = time.monotonic()
    for attempt in range(int(retries) + 1):
        try:
            dist.init_process_group(backend=backend, init_method=init_method,
                                    world_size=int(world_size),
                                    rank=int(rank), **kw)
            logger.info("bootstrap: joined %s group as rank %d/%d in %.2fs",
                        backend, rank, world_size, time.monotonic() - t0)
            return True
        except (RuntimeError, ValueError, OSError) as e:
            last = e
            if dist.is_initialized():
                dist.destroy_process_group()
            if attempt < retries:
                time.sleep(min(2.0 ** attempt, 10.0) * (0.5 + np.random.
                                                        random()))
    raise runtime.CoordinatorUnreachable(
        f"joining the {backend} group at {init_method!r} as rank {rank} of "
        f"{world_size} failed {int(retries) + 1} time(s): {last!r}"
    ) from last


def process_count() -> int:
    """Ranks in the default group (1 outside any group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group (0 outside any group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The ``world_size`` to build a
    :class:`~.dist_embedding.DistributedEmbedding` with: one rank a
    process."""
    return process_count()


def group_rank(group, world_size: int) -> int:
    """This process's rank in ``group`` (``None``: the default group),
    checking that the group has ``world_size`` ranks."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"world_size={world_size} needs a torch.distributed process "
            "group: join one first (parallel/bootstrap.py:initialize)")
    n = dist.get_world_size(group)
    if n != world_size:
        raise ValueError(f"the process group has {n} ranks, the layer "
                         f"world_size={world_size}")
    return dist.get_rank(group)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 as its bytes (a view) for the copying collectives: gloo
    moves no bfloat16 or 16-bit integer tensors."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


class InFlight:
    """A collective left in flight (:func:`all_to_all_start`):
    :meth:`wait` blocks until it is done and returns its output. It holds
    the send and receive buffers until then, so neither is freed or
    reused while the backend still reads or writes them. One without a
    ``work`` (world 1, or an exchange already completed) waits for
    nothing."""

    __slots__ = ("out", "_work", "_keep")

    def __init__(self, out: torch.Tensor, work=None, keep=()):
        self.out = out
        self._work = work
        self._keep = keep

    def wait(self) -> torch.Tensor:
        """The output, once the collective is done (on the card, the
        current stream is made to wait for it)."""
        if self._work is not None:
            self._work.wait()
            self._work, self._keep = None, ()
        return self.out


def all_to_all_start(x: torch.Tensor, group, world_size: int) -> InFlight:
    """Start ``out[r] = x_on_rank_r[my rank]`` over the leading ``[world,
    ...]`` axis (the tiled all-to-all of the JAX package) and return it
    in flight: ``.wait()`` gives ``out``. World 1 returns ``x`` itself,
    done. Every rank must start its collectives in the same order."""
    if world_size == 1:
        return InFlight(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    work = dist.all_to_all_single(_wire(out), _wire(x), group=group,
                                  async_op=True)
    return InFlight(out, work, keep=(x,))


def all_to_all(x: torch.Tensor, group, world_size: int) -> torch.Tensor:
    """``out[r] = x_on_rank_r[my rank]`` over the leading ``[world, ...]``
    axis: :func:`all_to_all_start`, then its wait. World 1 returns ``x``
    itself."""
    return all_to_all_start(x, group, world_size).wait()


def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the group, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Overwrite ``x`` on every rank with group rank ``src``'s, in place;
    returns ``x``."""
    gsrc = dist.get_global_rank(group, src) if group is not None else src
    dist.broadcast(_wire(x), gsrc, group=group)
    return x


def all_gather(x: torch.Tensor, group, world_size: int) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``[world, *x.shape]``, on
    ``x``'s device (a new tensor; world 1: ``x[None]``)."""
    if world_size == 1:
        return x[None]
    x = x.contiguous()
    out = torch.empty((world_size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(_wire(out).unbind(0)), _wire(x), group=group)
    return out


def gather_leaves(leaves, group) -> list:
    """Every rank's tensors ``leaves`` (each ``[1, ...]``, the same
    shapes and dtypes on every rank) as host numpy ``[world, ...]``
    arrays in rank order, through ONE gather of their bytes (so int32
    and float32 leaves travel bit for bit); every rank must call."""
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in leaves]) if leaves else torch.zeros(0)
    rows = to_host(flat[None], group)
    out, pos = [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(np.ascontiguousarray(rows[:, pos:pos + n]).view(dtype)
                   .reshape((rows.shape[0],) + tuple(t.shape[1:])))
        pos += n
    return out


def barrier(group) -> None:
    """Wait until every rank of ``group`` (``None``: the default group)
    reaches this call; nothing outside a process group."""
    if dist.is_initialized():
        dist.barrier(group=group)


def _global(group, r: int) -> int:
    return dist.get_global_rank(group, r) if group is not None else r


def send_to_chief(x: Optional[torch.Tensor], owner: int, group,
                  shape, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """Group rank ``owner``'s tensor on group rank 0 as a CPU tensor of
    ``shape`` and ``dtype``; ``None`` on every other rank. ``owner``
    passes ``x`` (on any device), the others ``None``. Point to point:
    no rank but the chief receives the bytes, and ranks other than
    ``owner`` and 0 return at once. gloo's point-to-point takes host
    tensors, so the owner copies its tensor to the host first (NCCL's
    takes the card's); bfloat16 travels as its bytes. Every rank of a
    transfer must make its calls in the same order."""
    me = dist.get_rank(group)
    if owner == 0:
        return x.detach().cpu() if me == 0 else None
    nccl = dist.get_backend(group) == dist.Backend.NCCL
    if me == owner:
        src = x.detach().contiguous()
        if not nccl:
            src = src.cpu()
        dist.send(_wire(src), _global(group, 0), group=group)
        return None
    if me != 0:
        return None
    buf = torch.empty(tuple(shape), dtype=dtype,
                      device="cuda" if nccl else "cpu")
    dist.recv(_wire(buf), _global(group, owner), group=group)
    return buf.cpu()


def broadcast_object(obj, group):
    """Group rank 0's ``obj`` (small, picklable) on every rank; the
    others pass anything (``None``)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=_global(group, 0), group=group)
    return box[0]


def all_gather_object(obj, group) -> list:
    """Every rank's ``obj`` (small, picklable) in rank order, on every
    rank; ``[obj]`` outside a group."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def shard_batch(tree, rank: Optional[int] = None,
                world_size: Optional[int] = None):
    """This rank's rows of a GLOBAL batch (the reference's per-rank
    dataset slicing): every tensor or array leaf ``[world * b, ...]``
    gives rows ``[rank * b, (rank + 1) * b)``. A global
    :class:`~..ops.embedding_lookup.Ragged` gives its rows' values and
    weights, padded to the largest rank's count (every rank's capacity,
    and so its exchange plan, must be the same), with rebased splits.
    ``rank``/``world_size`` default to this process's."""
    from ..ops.embedding_lookup import Ragged

    rank = process_index() if rank is None else int(rank)
    world_size = process_count() if world_size is None else int(world_size)

    def padded(x, lo, n, cap):
        x = torch.as_tensor(x)
        out = torch.zeros(cap, dtype=x.dtype)
        out[:n] = x[lo:lo + n]
        return out

    def rows(x):
        if isinstance(x, Ragged):
            splits = torch.as_tensor(x.row_splits)
            b = (splits.numel() - 1) // world_size
            ends = splits[::b].long()
            cap = max(int((ends[1:] - ends[:-1]).max()), 1)
            lo = int(ends[rank])
            n = int(ends[rank + 1]) - lo
            return Ragged(
                values=padded(x.values, lo, n, cap),
                row_splits=splits[rank * b:(rank + 1) * b + 1] - lo,
                weights=(None if x.weights is None
                         else padded(x.weights, lo, n, cap)))
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rows(v) for v in x)
        b = x.shape[0] // world_size
        return x[rank * b:(rank + 1) * b]

    return rows(tree)


def to_host(x: torch.Tensor, group=None) -> np.ndarray:
    """Every rank's ``x`` (each ``[b, ...]``) gathered in rank order on
    every rank, as one host array ``[world * b, ...]`` (the reference's
    ``hvd.allgather`` of eval predictions; bfloat16 comes back as
    float32, which holds it exactly)."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x.cpu().numpy()
    nccl = dist.get_backend(group) == dist.Backend.NCCL
    src = (x if nccl else x.cpu()).contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).cpu().numpy()


def broadcast_seed(seed: int, group=None) -> int:
    """Rank 0's ``seed`` on every rank (the reference's
    ``hvd.broadcast_object(seed)``)."""
    if not dist.is_initialized():
        return int(seed)
    t = torch.tensor([int(seed)], dtype=torch.int64)
    if dist.get_backend(group) == dist.Backend.NCCL:
        t = t.cuda()
    broadcast_(t, 0, group)
    return int(t.cpu()[0])


def _spawned_rank(target, rank, args, results) -> None:
    """A process of :func:`spawn_ranks`: run ``target(*args)``, send its
    result (or its traceback, then exit non-zero)."""
    import sys
    import traceback

    try:
        results.put((rank, True, target(*args)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)


def spawn_ranks(target, args_for_rank, world_size: int,
                timeout_s: Optional[float] = None, what: str = "ranks"
                ) -> list:
    """Run ``target(*args_for_rank(rank, init_method))`` in
    ``world_size`` spawned processes, one a rank, and return what each
    returned, in rank order. ``init_method`` is a ``file://`` store in a
    temporary directory, removed on the way out, for the ranks to join
    (:func:`initialize`). ``target`` and the arguments must pickle.
    When a rank raises (its traceback travels in the error), exits
    without a result, or the ranks give no result in ``timeout_s``
    (``None``: no limit), every process is stopped and ``RuntimeError``
    (prefixed ``what``) is raised."""
    import queue
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="detpu_ranks_")
    store = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_spawned_rank, args=(
        target, r, tuple(args_for_rank(r, store)), results))
             for r in range(world_size)]
    got = {}
    t0 = time.monotonic()
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            try:
                rank, ok, res = results.get(timeout=1)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"{what}: rank(s) exited without a "
                                       f"result (rank, exit code) {dead}"
                                       ) from None
                if timeout_s is not None and \
                        time.monotonic() - t0 > timeout_s:
                    left = sorted(set(range(world_size)) - set(got))
                    raise RuntimeError(f"{what}: ranks {left} gave no "
                                       f"result in {timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"{what}: rank {rank} failed:\n{res}")
            got[rank] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world_size)]


__all__ = ["InFlight", "all_gather", "all_gather_object", "all_reduce_sum_",
           "all_to_all", "all_to_all_start", "barrier", "broadcast_", "broadcast_object",
           "broadcast_seed", "gather_leaves", "group_rank", "initialize",
           "process_count", "process_index", "send_to_chief", "shard_batch",
           "spawn_ranks", "to_host", "world"]
