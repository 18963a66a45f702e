"""Carry weights from the JAX package into the port.

* Tables: the JAX ``DistributedEmbedding.get_weights`` list (host numpy,
  bfloat16 tables as ``ml_dtypes`` arrays) goes into the port's
  ``DistributedEmbedding.set_weights`` through :func:`host_tensor`.
* Dense half: the flax ``DLRMDense`` or ``SyntheticDense`` parameter
  tree, as numpy (``params/Dense_0..Dense_k/{kernel [in, out], bias
  [out]}``), goes into the torch module (its ``linears()`` in flax
  order) through :func:`load_flax_dense`; a flax kernel becomes
  ``Linear.weight`` of shape ``[out, in]``.
* Train state: :func:`hybrid_state_from_jax` builds the port's
  ``HybridTrainState`` from those two plus the JAX state's optimizer
  states and step, so both packages train from one state. It carries
  ``SparseAdagrad``'s accumulators (the JAX package's lane-packed
  ``[world, phys_rows, 128]`` slabs, unpacked to the port's logical
  ``[world, rows_cap, w]``) and ``optax.adagrad``'s sum of squares.

Nothing here imports JAX: the arrays arrive as numpy.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch


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


def _leaf_count(tree) -> int:
    """Array leaves of a nested tuple/list/dict (namedtuples included)."""
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_leaf_count(v) for v in tree)
    return 0 if tree is None else 1


def _emb_state(de, params, emb_opt_state, emb_optimizer, device):
    """The port's slab optimizer state from the JAX one (numpy)."""
    from ..ops.packed_slab import unpack_rows_np
    from ..parallel.optimizers import SparseAdagrad

    if not _leaf_count(emb_opt_state):
        return emb_optimizer.init(params) if emb_optimizer is not None \
            else {k: () for k in params}
    if not isinstance(emb_optimizer, SparseAdagrad):
        raise NotImplementedError(
            "emb_opt_state holds arrays: only SparseAdagrad's accumulators "
            "are carried (pass emb_optimizer=SparseAdagrad(...)); momentum "
            "and Adam state are not ported yet (ROADMAP B8)")
    out = {}
    for k, slab in params.items():
        w = slab.shape[-1]
        packed = emb_opt_state[k]
        acc = np.stack([unpack_rows_np(np.asarray(packed[r]), w)
                        for r in range(packed.shape[0])])
        if acc.shape != tuple(slab.shape):
            raise ValueError(f"{k}: accumulator unpacks to {acc.shape}, "
                             f"the slab is {tuple(slab.shape)}")
        out[k] = host_tensor(acc).to(device)
    return out


def _dense_state(dense, dense_opt_state, dense_tx):
    """The port's dense optimizer state from the optax one (numpy)."""
    from ..parallel.optimizers import Adagrad

    if not _leaf_count(dense_opt_state):
        return dense_tx.init(list(dense.parameters())) \
            if dense_tx is not None else ()
    rss = [s for s in dense_opt_state if hasattr(s, "sum_of_squares")]
    if not isinstance(dense_tx, Adagrad) or len(rss) != 1:
        raise NotImplementedError(
            "dense_opt_state holds arrays: only optax.adagrad's sum of "
            "squares is carried (pass dense_tx=Adagrad(...))")
    tree = rss[0].sum_of_squares
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
      JAX ``SparseAdagrad`` accumulators are unpacked to logical rows,
      keeping their dtype; ``optax.adagrad``'s ``ScaleByRssState`` becomes
      :class:`~..parallel.optimizers.Adagrad`'s tuple (a flax kernel
      ``[in, out]`` as ``[out, in]``). Momentum and Adam state raise
      (ROADMAP B8).
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
