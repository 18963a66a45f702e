"""Hybrid-parallel gradient glue (counterpart of
``distributed_embeddings_tpu/parallel/grads.py``).

One backward gives two gradient families:

* **dp** (dense, replicated) gradients are averaged over the ranks: a
  SUM all-reduce, then a divide by the world size (what ``lax.pmean``
  computes; gloo has no average op);
* **mp** (model-parallel embedding) gradients stay local, scaled by
  ``1/world`` so the loss-mean-over-the-local-batch semantics match the
  averaged dp gradients.

A mask says which part of a tree is model-parallel: ``True``/``False``
for a whole subtree, or a dict/list/tuple prefix of the tree (optax
style). :func:`mean_flat` is what the train step uses: every dp tensor
of a step in ONE float32 buffer and one all-reduce, elementwise the same
sums as one ``pmean`` each.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from . import bootstrap


def _map_by_mask(fn_mp: Callable, fn_dp: Callable, mask: Any,
                 tree: Any) -> Any:
    """``fn_mp``/``fn_dp`` over the tensor leaves of ``tree`` as the mask
    (a bool, or a dict/list/tuple prefix of the tree) says."""
    if isinstance(mask, bool):
        fn = fn_mp if mask else fn_dp
        return _map_leaves(fn, tree)
    if isinstance(mask, dict):
        return {k: _map_by_mask(fn_mp, fn_dp, mask[k], v)
                for k, v in tree.items()}
    if isinstance(mask, (list, tuple)):
        return type(tree)(_map_by_mask(fn_mp, fn_dp, m, v)
                          for m, v in zip(mask, tree))
    raise TypeError(f"a mask is a bool or a dict/list/tuple of them, got "
                    f"{type(mask).__name__}")


def _map_leaves(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def split_mp_dp(tree: Any, mp_mask: Any):
    """``(mp_part, dp_part)``: the tree twice, with ``None`` at the other
    family's leaves."""
    return (_map_by_mask(lambda g: g, lambda g: None, mp_mask, tree),
            _map_by_mask(lambda g: None, lambda g: g, mp_mask, tree))


def resolve_dp_gradient(g: torch.Tensor, group, world_size: int
                        ) -> torch.Tensor:
    """The mean of ``g`` over the group (a new tensor): SUM all-reduce,
    then a divide by ``world_size``. World 1 returns ``g``."""
    if world_size == 1:
        return g
    return bootstrap.all_reduce_sum_(g.clone(), group) / world_size


def hybrid_gradients(grads: Any, mp_mask: Any, group, world_size: int
                     ) -> Any:
    """dp leaves averaged over the group, mp leaves divided by the world
    size (``None`` leaves stay ``None``)."""
    return _map_by_mask(
        lambda g: None if g is None else g / world_size,
        lambda g: None if g is None else resolve_dp_gradient(
            g, group, world_size),
        mp_mask, grads)


def broadcast_variables(params: Any, mp_mask: Any, group,
                        root_rank: int = 0) -> Any:
    """Overwrite the dp leaves (in place) with ``root_rank``'s; mp leaves
    pass through. A module's parameters: ``broadcast_variables(list(
    m.parameters()), False, group)``."""

    def bcast(p):
        if p is None:
            return p
        with torch.no_grad():
            bootstrap.broadcast_(p.data, root_rank, group)
        return p

    return _map_by_mask(lambda p: p, bcast, mp_mask, params)


def mean_flat(tensors: Sequence[torch.Tensor], group, world_size: int
              ) -> List[torch.Tensor]:
    """The mean over the group of each tensor, through ONE float32 buffer
    and one SUM all-reduce (each element's sum, then ``/ world_size``, as
    ``lax.pmean`` takes it). Returns new tensors in the inputs' dtypes
    and shapes. World 1 returns the tensors as they are."""
    if world_size == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    bootstrap.all_reduce_sum_(flat, group)
    flat = flat / world_size
    out, pos = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[pos:pos + n].view(t.shape).to(t.dtype))
        pos += n
    return out


__all__ = ["broadcast_variables", "hybrid_gradients", "mean_flat",
           "resolve_dp_gradient", "split_mp_dp"]
