"""Full train-state checkpoint/resume at world 1 (counterpart of
``distributed_embeddings_tpu/utils/checkpoint.py``), in the JAX
package's on-disk format, so a checkpoint written by either package
restores in the other.

Layout under ``path/`` (the JAX package's)::

    tables/table_000.npy ...                # full logical tables
    emb_opt/<component>/table_000.npy ...   # slab-shaped optimizer state
    emb_opt/<component>.npz                 # small leaves (Adam counts)
    aux/<name>.npz                          # aux_states (streaming, ...)
    dense.msgpack                           # dense params + opt + step
    meta.json                               # manifest, written LAST

* Tables and slab-shaped optimizer components (``SparseAdagrad``'s
  accumulators, ``SparseMomentum``'s traces, ``SparseAdam``'s moments)
  go out one table at a time through
  :meth:`~..parallel.DistributedEmbedding._table_tensor`. A bfloat16
  table is written as its uint16 bits under the ``'<V2'`` descriptor,
  byte-identical to the JAX package's ``np.save`` of an ``ml_dtypes``
  bfloat16 array; ``meta.json`` records each component's dtype so
  restore re-views the bits (``set_weights(src_dtype=)``).
* ``dense.msgpack`` is flax's ``to_bytes`` of ``{"dense_params",
  "dense_opt_state", "step"}``, written and read by the port's own codec
  (:mod:`.msgpack_state`) without flax or msgpack.
* Every file goes through tmp + fsync + rename, the whole checkpoint is
  staged in ``<path>.staging`` and swapped into ``path`` in one
  directory rename; ``meta.json`` carries a CRC32 per file; the
  displaced checkpoint survives at ``<path>.prev`` (restore falls back
  to it), and with ``keep_last_n`` the one before it rotates into
  ``<path>.ring/step_<step>``.
* ``meta.json`` records the plan fingerprint (``strategy.plan_spec``):
  restore compares it with the restoring model's and, under
  ``on_mismatch="reshard"``, re-slices the full logical tables under
  the current plan (at world 1, a checkpoint of the JAX package's
  8-device mesh loads as the one rank's tables) and rebuilds Adam's
  per-slab counts from their consensus.

``DETPU_FAULT=die:checkpoint_write`` kills the process inside the write
path, ``DETPU_FAULT=corrupt@ckpt`` flips a byte in a just-committed
table file (``utils/runtime.py``). The offline ``reshard_checkpoint``
(and ``tools/reshard.py``) are not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import runtime
from .msgpack_state import dense_state_dict, load_dense_state_dict, packb, \
    unpackb

logger = logging.getLogger(__name__)

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return _DTYPE_NAMES[dtype]
    name = getattr(dtype, "name", None) or str(dtype)
    if name not in _DTYPES:
        raise ValueError(f"unsupported checkpoint dtype {dtype!r}")
    return name


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) \
        else _DTYPES[_dtype_name(dtype)]


# ------------------------------------------------------- atomic file layer


def _crc32_file(path: str, chunk_bytes: int = 1 << 20) -> int:
    """Streaming CRC32 of a file (constant memory; tables can be GBs)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync so renames inside it are durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _CRCWriter:
    """File proxy accumulating a CRC32 over sequential writes; a writer
    that seeks back (``np.savez``'s zipfile) sets ``dirty`` and the
    caller re-reads the file instead."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.dirty = False

    def write(self, data):
        self.crc = zlib.crc32(data, self.crc)
        return self._f.write(data)

    def seek(self, *args, **kwargs):
        self.dirty = True
        return self._f.seek(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._f, name)


def _atomic_file(path: str, writer: Callable[[Any], None]) -> int:
    """Write ``path`` via tmp + flush + fsync + rename; returns the
    file's CRC32. ``fault_point('checkpoint_write')`` fires first, so an
    injected death leaves at most a ``.tmp`` orphan."""
    runtime.fault_point("checkpoint_write")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        proxy = _CRCWriter(f)
        writer(proxy)
        f.flush()
        os.fsync(f.fileno())
    crc = _crc32_file(tmp) if proxy.dirty else proxy.crc
    os.replace(tmp, path)
    return crc


def save_npy(f, table: torch.Tensor) -> None:
    """``np.save`` of a CPU tensor into the open file ``f``; a bfloat16
    tensor as its uint16 bits under the ``'<V2'`` descriptor that
    ``np.save`` writes for an ``ml_dtypes`` bfloat16 array (the same
    bytes)."""
    if table.dtype != torch.bfloat16:
        np.save(f, table.numpy())
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": "<V2", "fortran_order": False,
            "shape": tuple(table.shape)})
    f.write(table.contiguous().view(torch.int16).numpy().tobytes())


def save_npz(f, arrays: Dict[str, torch.Tensor]) -> None:
    """``np.savez`` of named CPU tensors (bfloat16 ones as
    :func:`save_npy` writes them), one ``<name>.npy`` member each."""
    import zipfile

    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, t in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as member:
                save_npy(member, t)


def previous_checkpoint_path(path: str) -> str:
    """Where the swap parks the displaced checkpoint (restore fallback)."""
    return path.rstrip(os.sep) + ".prev"


def ring_dir(path: str) -> str:
    """Directory holding the checkpoint ring (checkpoints older than
    ``<path>.prev``), one subdirectory per retained save."""
    return path.rstrip(os.sep) + ".ring"


def _meta_step(path: str) -> Optional[int]:
    """The step a checkpoint's manifest records (``None`` when the
    manifest is unreadable or has none)."""
    try:
        with open(os.path.join(path, "meta.json"), encoding="utf-8") as f:
            step = json.load(f).get("step")
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    return int(step) if step is not None else None


def ring_entries(path: str) -> list:
    """The checkpoint ring of ``path``, newest first: ``[(step, dir),
    ...]``, listed, not validated."""
    d = ring_dir(path)
    if not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        if not name.startswith("step_"):
            continue
        try:
            step = int(name[len("step_"):])
        except ValueError:
            continue
        out.append((step, os.path.join(d, name)))
    out.sort(key=lambda e: e[0], reverse=True)
    return out


def prune_ring(path: str, keep_last_n: int) -> None:
    """Drop the oldest ring entries beyond ``keep_last_n``."""
    for _, entry in ring_entries(path)[max(0, keep_last_n):]:
        shutil.rmtree(entry, ignore_errors=True)


def rollback_candidates(path: str) -> list:
    """Every restorable generation of ``path``, newest first: ``[(step,
    dir), ...]`` across ``path``, ``<path>.prev`` and the ring (step
    ``None`` for a manifest without one; those sort last)."""
    out = []
    for p in (path, previous_checkpoint_path(path)):
        if os.path.isfile(os.path.join(p, "meta.json")):
            out.append((_meta_step(p), p))
    out.extend(ring_entries(path))
    out.sort(key=lambda e: (e[0] is not None, e[0] or 0), reverse=True)
    return out


def _archive_to_ring(path: str, prev: str, keep_last_n: int) -> None:
    """Move the former ``.prev`` into the ring instead of dropping it,
    then prune; a manifest without a step cannot be placed and is
    dropped."""
    step = _meta_step(prev)
    if step is None:
        shutil.rmtree(prev)
        return
    entry = os.path.join(ring_dir(path), f"step_{step:012d}")
    os.makedirs(ring_dir(path), exist_ok=True)
    if os.path.isdir(entry):  # same-step re-save: newest wins
        shutil.rmtree(entry)
    os.replace(prev, entry)
    prune_ring(path, keep_last_n)


def _commit_staging(staging: str, path: str, ring_n: int = 0) -> None:
    """Swap a fully written staging directory into ``path`` (the old
    checkpoint to ``<path>.prev``, the former ``.prev`` into the ring
    under ``ring_n > 0``), then honour a ``DETPU_FAULT=corrupt@ckpt``
    drill by flipping a byte mid-file in the committed first table."""
    runtime.fault_point("checkpoint_commit")
    prev = previous_checkpoint_path(path)
    if os.path.isdir(path):
        if os.path.isfile(os.path.join(path, "meta.json")):
            if os.path.isdir(prev):
                if ring_n > 0 and os.path.isfile(
                        os.path.join(prev, "meta.json")):
                    _archive_to_ring(path, prev, ring_n)
                else:
                    shutil.rmtree(prev)
            os.replace(path, prev)
        else:  # invalid leftovers: drop them
            shutil.rmtree(path)
    os.replace(staging, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    if runtime.corrupt_ckpt_requested():
        target = os.path.join(path, "tables", "table_000.npy")
        if os.path.isfile(target):
            with open(target, "r+b") as f:
                f.seek(max(0, os.path.getsize(target) // 2))
                byte = f.read(1) or b"\x00"
                f.seek(-len(byte), os.SEEK_CUR)
                f.write(bytes([byte[0] ^ 0xFF]))
            logger.error("DETPU_FAULT=corrupt@ckpt: flipped a byte in %s",
                         target)
            from . import obs

            obs.record_fault("ckpt_corrupt")


def _staging_path(path: str) -> str:
    return path.rstrip(os.sep) + ".staging"


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Validate a checkpoint directory; returns its parsed ``meta.json``.
    Raises :class:`~.runtime.CheckpointCorrupt` when the manifest is
    missing or torn, a listed file is absent, or a CRC32 mismatches."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.isfile(meta_path):
        raise runtime.CheckpointCorrupt(
            f"no checkpoint at {path!r} (missing meta.json)")
    try:
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise runtime.CheckpointCorrupt(
            f"torn manifest at {meta_path!r}: {e}") from e
    files = meta.get("files")
    if files is None:
        logger.debug("checkpoint %s predates CRC manifests; skipping "
                     "content validation", path)
        return meta
    for rel, crc in files.items():
        fp = os.path.join(path, rel)
        if not os.path.isfile(fp):
            raise runtime.CheckpointCorrupt(
                f"checkpoint {path!r} is missing {rel!r}")
        actual = _crc32_file(fp)
        if actual != crc:
            raise runtime.CheckpointCorrupt(
                f"CRC mismatch for {rel!r} in {path!r}: manifest "
                f"{crc:#010x}, on disk {actual:#010x} (torn write?)")
    return meta


def validate_checkpoint_model(path: str, meta: Dict[str, Any], de) -> None:
    """Check that a (whole) checkpoint matches the model it is restored
    into: the table count and every table's (vocab, dim). Raises
    :class:`~.runtime.CheckpointMismatch` naming the first offender."""
    want = de.strategy.global_configs
    n = int(meta.get("num_tables", -1))
    if n != len(want):
        raise runtime.CheckpointMismatch(
            f"checkpoint at {path!r} holds {n} table(s) but the model "
            f"declares {len(want)} — wrong checkpoint or changed model "
            "config")
    saved = meta.get("tables")
    for t, cfg in enumerate(want):
        exp = (int(cfg["input_dim"]), int(cfg["output_dim"]))
        if saved is not None:
            got = tuple(int(x) for x in saved[t])
        else:
            fp = os.path.join(path, "tables", f"table_{t:03d}.npy")
            try:
                got = tuple(np.load(fp, mmap_mode="r").shape)
            except (OSError, ValueError) as e:
                raise runtime.CheckpointCorrupt(
                    f"cannot read table header {fp!r}: {e}") from e
        if got != exp:
            raise runtime.CheckpointMismatch(
                f"table {t}: checkpoint at {path!r} was saved with "
                f"vocab x dim {got}, the model expects {exp} — fix the "
                "embedding configs or point at the matching checkpoint")


def _check_plan(path: str, meta: Dict[str, Any], de,
                on_mismatch: str) -> bool:
    """True when the checkpoint's plan fingerprint differs from ``de``'s
    and ``on_mismatch='reshard'`` authorizes re-slicing (recorded through
    ``obs.record_event("checkpoint_reshard")``); raises
    :class:`~.runtime.CheckpointMismatch` under ``'error'``."""
    from ..parallel.strategy import plan_diff, plans_equal

    saved = meta.get("plan")
    if saved is None:
        return False
    current = de.strategy.plan_spec()
    if plans_equal(saved, current):
        return False
    param_bytes = 2 if meta.get("dtypes", {}).get(
        "tables", "float32") == "bfloat16" else 4
    diff = plan_diff(saved, current, param_bytes=param_bytes)
    desc = (f"world {diff['world_size'][0]} -> {diff['world_size'][1]}, "
            f"strategy {diff['strategy'][0]!r} -> {diff['strategy'][1]!r}, "
            f"{len(diff['moved_tables'])} table(s) change ranks")
    if on_mismatch != "reshard":
        raise runtime.CheckpointMismatch(
            f"checkpoint at {path!r} was written under a different "
            f"sharding plan ({desc}). Pass on_mismatch='reshard' to "
            "re-slice it under the current plan on the fly")
    from . import obs

    obs.record_event("checkpoint_reshard", path=path,
                     old_plan=saved, new_plan=current, diff=diff)
    logger.warning(
        "restore_train_state: re-sharding checkpoint %s onto a different "
        "topology (%s; per-rank byte deltas on common ranks: %s)",
        path, desc, diff["per_rank_byte_deltas"])
    return True


def _is_slab_dict(tree, params) -> bool:
    """True when ``tree`` is a width-keyed dict of tensors shaped like
    the param slabs (Adagrad accumulators, momentum traces)."""
    if not isinstance(tree, dict) or set(tree) != set(params):
        return False
    return all(
        hasattr(v, "shape") and tuple(v.shape) == tuple(params[k].shape)
        for k, v in tree.items())


def _components(opt_state, params):
    """``(slab_components, aux_components)`` of an embedding-optimizer
    state: ``{wkey: slab}`` dicts (table-reassemblable) and small leaves
    saved verbatim (the JAX package's naming: ``state``, ``state<i>``)."""
    if _is_slab_dict(opt_state, params):
        return {"state": opt_state}, {}
    if isinstance(opt_state, dict) and set(opt_state) == set(params):
        vals = list(opt_state.values())
        if all(isinstance(v, tuple) for v in vals):
            ln = {len(v) for v in vals}
            if len(ln) == 1:
                n = ln.pop()
                if n == 0:  # SparseSGD
                    return {}, {}
                slabs, aux = {}, {}
                for i in range(n):
                    comp = {k: opt_state[k][i] for k in opt_state}
                    if _is_slab_dict(comp, params):
                        slabs[f"state{i}"] = comp
                    else:
                        aux[f"state{i}"] = comp
                return slabs, aux
    raise ValueError(
        "Unrecognized embedding-optimizer state structure; expected the "
        "slab-dict layouts of the parallel.optimizers classes")


def save_train_state(path: str, de, state,
                     keep_last_n: int = 0,
                     run_id: Optional[str] = None,
                     aux_states: Optional[Dict[str, Dict[str, Any]]]
                     = None) -> None:
    """Write the full train state (a ``HybridTrainState``) under ``path``
    (a directory), atomically, in the JAX package's format.

    The displaced checkpoint is kept at ``<path>.prev``; ``keep_last_n``
    > 0 rotates the former ``.prev`` into ``<path>.ring/`` and prunes it
    to that many entries. ``run_id`` stamps the manifest with a run lineage.
    ``aux_states``: named flat ``{key: array}`` dicts (numpy or tensors)
    saved as ``aux/<name>.npz`` (the streaming state through
    ``parallel.streaming.encode_state``; read back with
    :func:`load_aux_state`). (World 1: the JAX package's ``is_chief``
    and multi-host fetches have nothing to do here.)"""
    staging = _staging_path(path)
    manifest: Dict[str, int] = {}

    def put(rel, writer):
        manifest[rel] = _atomic_file(os.path.join(staging, rel), writer)

    if os.path.isdir(staging):  # leftover of an earlier killed save
        shutil.rmtree(staging)
    os.makedirs(os.path.join(staging, "tables"))
    n_tables = len(de.strategy.global_configs)

    def dump_tables(sub, comp):
        # table-at-a-time: host memory caps at ONE table
        os.makedirs(os.path.join(staging, sub), exist_ok=True)
        for t in range(n_tables):
            table = de._table_tensor(comp, t)
            put(f"{sub}/table_{t:03d}.npy",
                lambda f, a=table: save_npy(f, a))

    def host(v):
        return v.detach().cpu() if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.asarray(v))

    dump_tables("tables", state.emb_params)
    slabs, aux = _components(state.emb_opt_state, state.emb_params)
    for name, comp in slabs.items():
        dump_tables(f"emb_opt/{name}", comp)
    os.makedirs(os.path.join(staging, "emb_opt"), exist_ok=True)
    for name, comp in aux.items():
        put(f"emb_opt/{name}.npz",
            lambda f, c=comp: save_npz(f, {k: host(v)
                                           for k, v in c.items()}))
    if aux_states:
        os.makedirs(os.path.join(staging, "aux"), exist_ok=True)
        for name, enc in sorted(aux_states.items()):
            put(f"aux/{name}.npz",
                lambda f, c=enc: save_npz(f, {k: host(v)
                                              for k, v in c.items()}))
    dense = dense_state_dict(state.dense_params, state.dense_opt_state,
                             state.step.detach().cpu().to(torch.int32)
                             .reshape(()))
    put("dense.msgpack", lambda f: f.write(packb(dense)))

    def dt(tree):
        return _dtype_name(next(iter(tree.values())).dtype)

    meta = {"num_tables": n_tables,
            "step": int(state.step),
            "tables": [[int(c["input_dim"]), int(c["output_dim"])]
                       for c in de.strategy.global_configs],
            "plan": de.strategy.plan_spec(),
            "slab_components": sorted(slabs),
            "aux_components": sorted(aux),
            "aux_states": sorted(aux_states or {}),
            "dtypes": {"tables": dt(state.emb_params),
                       **{name: dt(comp) for name, comp in slabs.items()}},
            "files": dict(manifest)}
    if run_id is not None:
        meta["run_id"] = str(run_id)
    _atomic_file(os.path.join(staging, "meta.json"),
                 lambda f: f.write(json.dumps(meta).encode()))
    _fsync_dir(staging)
    _commit_staging(staging, path, ring_n=int(keep_last_n))


def _aux_consensus(comp: Dict[str, Any]) -> float:
    """A saved aux component's single representative value (Adam's
    per-slab counts advance in lockstep; the max, with a warning if they
    disagree)."""
    flat = [np.asarray(v).reshape(-1) for v in comp.values()]
    allv = np.concatenate(flat) if flat else np.zeros((1,))
    top = float(allv.max()) if allv.size else 0.0
    if allv.size and not np.all(allv == top):
        logger.warning(
            "aux optimizer component: per-slab values disagree (min %s, "
            "max %s) across the re-shard; using the max", allv.min(), top)
    return top


def _adapt_aux(name: str, comp: Dict[str, Any], wkey: str,
               like: torch.Tensor, resharding: bool,
               device) -> torch.Tensor:
    """Restore one aux optimizer leaf (``emb_opt/<name>.npz`` entry
    ``wkey``) in the shape and dtype of ``like`` (the init's leaf), on
    ``device``: exactly as saved under the same plan, rebuilt from the
    saved consensus under a re-shard."""
    arr = comp.get(wkey)
    if arr is not None:
        arr = np.asarray(arr)
        if arr.size == like.numel():
            return torch.from_numpy(arr.copy()).reshape(like.shape).to(
                device=device, dtype=like.dtype)
        if not resharding:
            raise runtime.CheckpointMismatch(
                f"aux optimizer component {name}/{wkey}: saved shape "
                f"{arr.shape} cannot fill {tuple(like.shape)} and the "
                "checkpoint plan matches the model — corrupt aux "
                "component?")
    elif not resharding:
        raise runtime.CheckpointMismatch(
            f"aux optimizer component {name} is missing width key "
            f"{wkey!r} though the checkpoint plan matches the model")
    return torch.full(tuple(like.shape), _aux_consensus(comp),
                      dtype=like.dtype, device=device)


def restore_train_state(path: str, de, emb_optimizer, dense_template,
                        dense_tx, mesh=None, dtype=None,
                        fallback: bool = True,
                        on_mismatch: str = "error", device="cuda"):
    """Rebuild a ``HybridTrainState`` from :func:`save_train_state`
    output (the port's or the JAX package's) on ``device``.

    ``dense_template``: the dense module (a ``DLRMDense``); its
    parameters are loaded IN PLACE and it becomes the state's
    ``dense_params``. ``dense_tx`` reads the dense optimizer state.
    ``dtype``: by default every component restores in the dtype it was
    SAVED in (``meta.json``: a bf16-tables + fp32-accumulator run
    resumes with the same mixed dtypes); a single dtype forces it
    everywhere, a dict keyed by component (``"tables"``, ``"state"``,
    ``"state0"``, ...) overrides per component.

    ``on_mismatch``: ``"error"`` raises
    :class:`~.runtime.CheckpointMismatch` when the checkpoint's plan
    fingerprint differs from ``de``'s; ``"reshard"`` re-slices the full
    logical tables under ``de``'s plan, rebuilds Adam's per-slab counts
    from their consensus and records ``checkpoint_reshard``.

    The checkpoint is CRC-verified first; a torn one falls back to
    ``<path>.prev`` with ``fallback`` (recording
    ``checkpoint_prev_fallback``), else
    :class:`~.runtime.CheckpointCorrupt` propagates. ``mesh`` belongs to
    world > 1 (ROADMAP A7)."""
    from ..parallel.trainer import HybridTrainState

    if mesh is not None:
        raise NotImplementedError(
            "restoring onto a mesh is not ported yet: ROADMAP A7")
    if on_mismatch not in ("error", "reshard"):
        raise ValueError(
            f"on_mismatch must be 'error' | 'reshard', got {on_mismatch!r}")
    runtime.fault_point("checkpoint_read")
    try:
        meta = verify_checkpoint(path)
    except runtime.CheckpointCorrupt as e:
        prev = previous_checkpoint_path(path)
        if not (fallback and os.path.isdir(prev)):
            raise
        logger.warning(
            "checkpoint at %s failed validation (%s); falling back to the "
            "previous valid checkpoint at %s", path, e, prev)
        meta = verify_checkpoint(prev)
        from . import obs

        obs.record_event("checkpoint_prev_fallback", path=path, prev=prev)
        path = prev
    validate_checkpoint_model(path, meta, de)
    resharding = _check_plan(path, meta, de, on_mismatch)
    n = meta["num_tables"]
    saved_dtypes = meta.get("dtypes", {})

    def saved(component):
        return saved_dtypes.get(component, "float32")

    def dtype_of(component):
        if isinstance(dtype, dict):
            if component in dtype:
                return _torch_dtype(dtype[component])
        elif dtype is not None:
            return _torch_dtype(dtype)
        return _torch_dtype(saved(component))

    def table_paths(sub):
        return [os.path.join(path, sub, f"table_{t:03d}.npy")
                for t in range(n)]

    emb_params = de.set_weights(table_paths("tables"),
                                dtype=dtype_of("tables"), device=device,
                                src_dtype=saved("tables"))
    slab_comps = {
        name: de.set_weights(table_paths(os.path.join("emb_opt", name)),
                             dtype=dtype_of(name), device=device,
                             src_dtype=saved(name))
        for name in meta["slab_components"]}
    aux_comps = {}
    for name in meta["aux_components"]:
        with np.load(os.path.join(path, "emb_opt", f"{name}.npz")) as z:
            aux_comps[name] = {k: z[k] for k in z.files}
    # the optimizer's own init, on shapes only, gives the state's
    # structure (a real init would allocate slab-sized state)
    dev = next(iter(emb_params.values())).device
    fresh = emb_optimizer.init({k: torch.empty(v.shape, dtype=v.dtype,
                                               device="meta")
                                for k, v in emb_params.items()})
    if _is_slab_dict(fresh, emb_params):
        if set(meta["slab_components"]) != {"state"}:
            raise runtime.CheckpointMismatch(
                f"checkpoint at {path!r} holds optimizer components "
                f"{meta['slab_components']}, the optimizer one slab state")
        opt_state = slab_comps["state"]
    elif meta["slab_components"] or meta["aux_components"]:
        opt_state = {}
        for k, parts in fresh.items():
            new = []
            for i, like in enumerate(parts):
                name = f"state{i}"
                if name in slab_comps:
                    new.append(slab_comps[name][k])
                else:
                    new.append(_adapt_aux(name, aux_comps[name], k, like,
                                          resharding, dev))
            opt_state[k] = tuple(new)
    else:
        opt_state = emb_optimizer.init(emb_params)  # SparseSGD: stateless
    with open(os.path.join(path, "dense.msgpack"), "rb") as f:
        tree = unpackb(f.read())
    dense_opt_state, step = load_dense_state_dict(tree, dense_template,
                                                  dense_tx)
    return HybridTrainState(
        emb_params=emb_params, emb_opt_state=opt_state,
        dense_params=dense_template, dense_opt_state=dense_opt_state,
        step=step.to(dev))


def load_aux_state(path: str, name: str) -> Optional[Dict[str, Any]]:
    """One ``aux_states`` entry of :func:`save_train_state` as a ``{key:
    numpy array}`` dict; ``None`` when the checkpoint never carried
    ``name`` or its file is unreadable (aux state never blocks a
    restore)."""
    fp = os.path.join(path, "aux", f"{name}.npz")
    if not os.path.isfile(fp):
        return None
    try:
        with np.load(fp) as loaded:
            return {k: loaded[k] for k in loaded.files}
    except (OSError, ValueError, zlib.error) as e:
        logger.warning("aux state %s at %s unreadable (%s); treating as "
                       "absent", name, path, e)
        return None
