"""Carry weights from the JAX package into the port.

* Tables: the JAX ``DistributedEmbedding.get_weights`` list (host numpy,
  bfloat16 tables as ``ml_dtypes`` arrays) goes into the port's
  ``DistributedEmbedding.set_weights`` through :func:`host_tensor`.
* Dense half: the flax ``DLRMDense`` or ``SyntheticDense`` parameter
  tree, as numpy (``params/Dense_0..Dense_k/{kernel [in, out], bias
  [out]}``), goes into the torch module (its ``linears()`` in flax
  order) through :func:`load_flax_dense`; a flax kernel becomes
  ``Linear.weight`` of shape ``[out, in]``. :func:`flax_dense_tree`
  maps the other way (the checkpoint codec's ``dense.msgpack``).
* Train state: :func:`hybrid_state_from_jax` builds the port's
  ``HybridTrainState`` from those two plus the JAX state's optimizer
  states and step, so both packages train from one state. It carries
  ``SparseAdagrad``'s accumulators (the JAX package's lane-packed
  ``[world, phys_rows, 128]`` slabs, unpacked to the port's logical
  ``[world, rows_cap, w]``) and ``optax.adagrad``'s sum of squares;
  ``SparseMomentum``'s trace and ``SparseAdam``'s moments (unpacked
  alike) and step count; ``optax.adam``'s ``ScaleByAdamState``,
  ``optax.sgd``'s ``TraceState`` and a schedule's count.
* Access telemetry: :func:`telemetry_state_from_jax` and
  :func:`telemetry_state_to_numpy` carry the telemetry state (the same
  keys, shapes and dtypes in both packages) either way;
  :func:`streaming_state_from_jax` and :func:`streaming_state_to_numpy`
  do the same for the streaming-vocabulary state.

Nothing here imports JAX: the arrays arrive as numpy.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device


def host_tensor(a: Any) -> torch.Tensor:
    """CPU tensor from a numpy array (``ml_dtypes`` bfloat16 included:
    numpy has no bfloat16 of its own, so such arrays cross as float32,
    which holds every bfloat16 value exactly) or from a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def load_flax_dense(module, params: Mapping[str, Any]) -> None:
    """Copy a flax ``DLRMDense`` or ``SyntheticDense`` tree
    (``{"params": {...}}`` or its inner dict) into ``module`` (the torch
    module of the same name) in place."""
    tree = params.get("params", params)
    linears = list(module.linears())
    names = sorted(tree, key=lambda k: int(k.split("_")[-1]))
    if len(names) != len(linears):
        raise ValueError(f"flax tree has {len(names)} Dense layers, the "
                         f"module {len(linears)}")
    with torch.no_grad():
        for name, lin in zip(names, linears):
            kernel = host_tensor(tree[name]["kernel"])
            bias = host_tensor(tree[name]["bias"])
            if tuple(kernel.shape) != (lin.in_features, lin.out_features):
                raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does "
                                 f"not fit Linear({lin.in_features}, "
                                 f"{lin.out_features})")
            lin.weight.copy_(kernel.t())
            lin.bias.copy_(bias)


def flax_dense_tree(module, tensors=None) -> dict:
    """The inverse of :func:`load_flax_dense`: ``{"params": {"Dense_i":
    {"bias": [out], "kernel": [in, out]}}}`` of ``module``'s linears in
    flax order, as CPU tensors (a ``Linear.weight`` ``[out, in]`` as a
    kernel ``[in, out]``). ``tensors``, one per parameter in the
    module's order (each linear's weight, then its bias; an optimizer
    state's per-parameter tuple), replaces the parameters' values. Keys
    come in the order a JAX step's ``tree_map`` leaves them in."""
    linears = list(module.linears())
    params = list(module.parameters())
    if tensors is None:
        tensors = params
    tensors = list(tensors)
    if len(tensors) != 2 * len(linears) or any(
            p is not q for p, q in zip(params, [t for lin in linears
                                                for t in (lin.weight,
                                                          lin.bias)])):
        raise ValueError("the dense module's parameters are not its "
                         "linears' (weight, bias) pairs in flax order")
    out = {}
    for i in range(len(linears)):
        w, b = tensors[2 * i], tensors[2 * i + 1]
        out[f"Dense_{i}"] = {"bias": b.detach().cpu().clone(),
                             "kernel": w.detach().cpu().t().contiguous()}
    return {"params": out}


def _leaf_count(tree) -> int:
    """Array leaves of a nested tuple/list/dict (namedtuples included)."""
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_leaf_count(v) for v in tree)
    return 0 if tree is None else 1


def _emb_state(de, params, emb_opt_state, emb_optimizer, device):
    """The port's slab optimizer state from the JAX one (numpy): each
    lane-packed slab-shaped leaf (Adagrad's accumulator, momentum's
    trace, Adam's ``mu``/``nu``) unpacked to logical rows, Adam's
    ``[world, 1, 1]`` count as it is."""
    from ..ops.packed_slab import unpack_rows_np
    from ..parallel.optimizers import (SparseAdagrad, SparseAdam,
                                       SparseMomentum)

    if not _leaf_count(emb_opt_state):
        return emb_optimizer.init(params) if emb_optimizer is not None \
            else {k: () for k in params}
    if not isinstance(emb_optimizer, (SparseAdagrad, SparseMomentum,
                                      SparseAdam)):
        raise NotImplementedError(
            "emb_opt_state holds arrays: pass the port's optimizer it "
            "belongs to (emb_optimizer=SparseAdagrad(...), "
            "SparseMomentum(...) or SparseAdam(...))")

    # at world > 1 this process holds its rank's row of JAX's [world, ...]
    ranks = (range(de.world_size) if de.world_size == 1 else [de.rank])

    def unpack(k, packed, slab):
        w = slab.shape[-1]
        out = np.stack([unpack_rows_np(np.asarray(packed[r]), w)
                        for r in ranks])
        if out.shape != tuple(slab.shape):
            raise ValueError(f"{k}: optimizer state unpacks to "
                             f"{out.shape}, the slab is "
                             f"{tuple(slab.shape)}")
        return host_tensor(out).to(device)

    out = {}
    for k, slab in params.items():
        st = emb_opt_state[k]
        if isinstance(emb_optimizer, SparseAdam):
            mu, nu, count = st
            count = np.asarray(count)[list(ranks)]
            if count.shape != (slab.shape[0], 1, 1):
                raise ValueError(f"{k}: Adam count of shape {count.shape}, "
                                 f"expected {(slab.shape[0], 1, 1)}")
            out[k] = (unpack(k, mu, slab), unpack(k, nu, slab),
                      host_tensor(count.astype(np.float32)).to(device))
        else:
            out[k] = unpack(k, st, slab)
    return out


def _param_tensors(dense, tree):
    """A flax ``Dense_i/{kernel, bias}`` tree (or ``{"params": ...}``) as
    one host tensor per parameter of ``dense``, in its order (a kernel
    ``[in, out]`` as ``[out, in]``)."""
    tree = tree.get("params", tree)
    names = sorted(tree, key=lambda k: int(k.split("_")[-1]))
    pairs = []
    for name, lin in zip(names, dense.linears()):
        pairs += [(lin.weight, host_tensor(tree[name]["kernel"]).t()),
                  (lin.bias, host_tensor(tree[name]["bias"]))]
    params = list(dense.parameters())
    if len(pairs) != len(params) or any(
            p is not q for p, (q, _) in zip(params, pairs)):
        raise ValueError("the dense module's parameters are not its "
                         "linears' (weight, bias) pairs in flax order")
    return tuple(t.to(p.device).contiguous() for p, t in pairs)


def _dense_state(dense, dense_opt_state, dense_tx):
    """The port's dense optimizer state from the optax one (numpy):
    ``optax.adagrad``'s sum of squares, ``optax.adam``'s
    ``ScaleByAdamState``, ``optax.sgd``'s ``TraceState`` (momentum), and
    the ``ScaleByScheduleState`` count a schedule keeps."""
    from ..parallel.optimizers import (SGD, Adagrad, Adam, AdamState,
                                       ScheduleState, TraceState)

    if not _leaf_count(dense_opt_state):
        return dense_tx.init(list(dense.parameters())) \
            if dense_tx is not None else ()
    if not isinstance(dense_tx, (SGD, Adagrad, Adam)):
        raise NotImplementedError(
            "dense_opt_state holds arrays: pass the port's optimizer it "
            "belongs to (dense_tx=SGD(...), Adagrad(...) or Adam(...))")
    parts = [s for s in dense_opt_state if _leaf_count(s)]
    dev = next(dense.parameters()).device

    def take(what, pred):
        found = [s for s in parts if pred(s)]
        if len(found) != 1:
            names = [type(s).__name__ for s in parts]
            raise ValueError(f"dense_opt_state: expected one {what}, found "
                             f"{len(found)} in {names}")
        parts.remove(found[0])
        return found[0]

    def count(s):
        return torch.tensor(int(np.asarray(s.count)), dtype=torch.int32,
                            device=dev)

    if isinstance(dense_tx, Adagrad):
        rss = take("sum of squares", lambda s: hasattr(s, "sum_of_squares"))
        out = _param_tensors(dense, rss.sum_of_squares)
    else:
        out = ()
        if isinstance(dense_tx, Adam):
            st = take("ScaleByAdamState", lambda s: hasattr(s, "nu"))
            out = (AdamState(count(st), _param_tensors(dense, st.mu),
                             _param_tensors(dense, st.nu)),)
        elif dense_tx.momentum is not None:
            st = take("TraceState", lambda s: hasattr(s, "trace"))
            out = (TraceState(_param_tensors(dense, st.trace)),)
        if callable(dense_tx.learning_rate):
            st = take("ScaleByScheduleState", lambda s: hasattr(s, "count"))
            out += (ScheduleState(count(st)),)
    if parts:
        names = [type(s).__name__ for s in parts]
        raise ValueError(f"dense_opt_state: {names} has no counterpart in "
                         f"{type(dense_tx).__name__}")
    return out


def hybrid_state_from_jax(de, dense, tables: Sequence[Any],
                          dense_tree: Mapping[str, Any], step,
                          emb_opt_state=None, dense_opt_state=None,
                          dtype: torch.dtype = torch.float32,
                          device="cuda", emb_optimizer=None, dense_tx=None):
    """The port's ``HybridTrainState`` from a JAX one, given as numpy:

    * ``tables``: the JAX ``DistributedEmbedding.get_weights`` list;
    * ``dense_tree``: the flax parameters of the dense half (``DLRMDense``
      or ``SyntheticDense``), loaded into ``dense`` (the torch module on
      ``device``) in place;
    * ``step``: the step counter;
    * ``emb_opt_state`` / ``dense_opt_state``: the optimizer states, read
      for ``emb_optimizer`` / ``dense_tx`` (the port's optimizers). State
      with no arrays (``SparseSGD``, ``optax.sgd``) needs neither. The
      JAX ``SparseAdagrad`` accumulators, ``SparseMomentum`` traces and
      ``SparseAdam`` moments are unpacked to logical rows, keeping their
      dtype (Adam's count stays ``[world, 1, 1]`` float32);
      ``optax.adagrad``'s ``ScaleByRssState`` becomes
      :class:`~..parallel.optimizers.Adagrad`'s tuple, ``optax.adam``'s
      and ``optax.sgd``'s states the port's ``AdamState`` /
      ``TraceState`` / ``ScheduleState`` tuples (a flax kernel ``[in,
      out]`` as ``[out, in]``).

    At world > 1 each rank builds its own slab from the full tables and
    takes its row of JAX's global ``[world, ...]`` optimizer state.
    """
    from ..parallel.trainer import HybridTrainState

    load_flax_dense(dense, dense_tree)
    params = de.set_weights(tables, dtype=dtype, device=device)
    dev = next(iter(params.values())).device
    return HybridTrainState(
        emb_params=params,
        emb_opt_state=_emb_state(de, params, emb_opt_state, emb_optimizer,
                                 dev),
        dense_params=dense,
        dense_opt_state=_dense_state(dense, dense_opt_state, dense_tx),
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev))


def _nested_from_numpy(tree: Mapping[str, Any], device) -> dict:
    from .device import resolve_device

    dev = resolve_device(device)

    def one(v):
        if isinstance(v, Mapping):
            return {k: one(x) for k, x in v.items()}
        return host_tensor(np.array(v)).to(dev)

    return one(tree)


def _nested_to_numpy(state: Mapping[str, Any]) -> dict:
    return {k: _nested_to_numpy(v) if isinstance(v, Mapping)
            else v.detach().cpu().numpy().copy() for k, v in state.items()}


def _rank_rows(tree: Mapping[str, Any], rank: Optional[int]) -> Mapping:
    """``rank``'s ``[1, ...]`` row of every leaf of a ``[world, ...]``
    tree (``None``: the tree as it is)."""
    if rank is None:
        return tree
    return {k: _rank_rows(v, rank) if isinstance(v, Mapping)
            else np.asarray(v)[int(rank):int(rank) + 1]
            for k, v in tree.items()}


def telemetry_state_from_jax(tree: Mapping[str, Any], device="cuda",
                             rank: Optional[int] = None) -> dict:
    """The port's telemetry state (``analysis/telemetry.py``) from a JAX
    one given as numpy (the same nested dict), copied to ``device``; at
    world > 1 ``rank`` picks that rank's ``[1, ...]`` row of JAX's
    ``[world, ...]`` leaves (the state the rank carries)."""
    return _nested_from_numpy(_rank_rows(tree, rank), device)


def telemetry_state_to_numpy(state: Mapping[str, Any]) -> dict:
    """A telemetry state as a nested dict of numpy arrays (host copies),
    the form the JAX package's state takes through ``np.asarray``; a
    rank's state gives its ``[1, ...]`` row (the inverse of
    :func:`telemetry_state_from_jax` with ``rank=``;
    ``analysis.telemetry.gather_state`` gives every rank's)."""
    return _nested_to_numpy(state)


def streaming_state_from_jax(tree: Mapping[str, Any], device="cuda",
                             rank: Optional[int] = None) -> dict:
    """The port's streaming state (``parallel/streaming.py``) from a JAX
    one given as numpy (the same nested dict: ``steps`` int32, the four
    counters float32, per width ``slot_fp``/``slot_freq``/``cms``
    int32), copied to ``device``; at world > 1 ``rank`` picks that
    rank's ``[1, ...]`` row."""
    return _nested_from_numpy(_rank_rows(tree, rank), device)


def streaming_state_to_numpy(state: Mapping[str, Any]) -> dict:
    """A streaming state as a nested dict of numpy arrays (host copies),
    the form the JAX package's state takes through ``np.asarray``; a
    rank's state gives its ``[1, ...]`` row (the inverse of
    :func:`streaming_state_from_jax` with ``rank=``;
    ``analysis.telemetry.gather_state`` gives every rank's)."""
    return _nested_to_numpy(state)
