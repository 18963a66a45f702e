"""K22's plain version (``ops/dense_update.py``), run by each dense
optimizer's in-place ``update_``, against the optimizer's functional
``update`` followed by ``p + u`` (the unfused chain), and against
``optax`` over a 10-step trajectory.

Tolerances, with their reasons:
  - in-place against the unfused chain: bit for bit (the same float32
    operations in the same order; the square roots taken in float64 and
    rounded once in both);
  - against ``optax`` after 10 steps: rtol 1e-5, atol 1e-7 on the
    parameters and every state leaf. XLA may fuse and reassociate, and
    its CPU ``rsqrt`` is an approximation, so the two differ by a few
    float32 ulps a step. A control one step behind must fail the bound;
  - a skipped step (``ok`` false): bitwise unchanged, counts included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.models.schedules import (
    warmup_poly_decay_schedule as jax_schedule)

from distributed_embeddings_torch.models.schedules import (
    warmup_poly_decay_schedule)
from distributed_embeddings_torch.ops import dense_update
from distributed_embeddings_torch.parallel import SGD, Adagrad, Adam

torch.set_num_threads(1)

SHAPES = ((7, 5), (5,), (1,), (33,))
SCHED = (0.05, 3, 6, 4)  # base lr, warmup, decay start, decay steps


def _opt(name, sched):
    lr = warmup_poly_decay_schedule(*SCHED) if sched else 0.05
    jlr = jax_schedule(*SCHED) if sched else 0.05
    if name == "sgd":
        return SGD(lr), optax.sgd(jlr)
    if name == "momentum":
        return SGD(lr, momentum=0.9), optax.sgd(jlr, momentum=0.9)
    if name == "nesterov":
        return (SGD(lr, momentum=0.9, nesterov=True),
                optax.sgd(jlr, momentum=0.9, nesterov=True))
    if name == "adagrad":
        return Adagrad(0.05), optax.adagrad(0.05)
    return Adam(lr), optax.adam(jlr)


CASES = [(n, s) for n in ("sgd", "momentum", "nesterov", "adam")
         for s in (False, True)] + [("adagrad", False)]
IDS = [f"{n}-{'sched' if s else 'const'}" for n, s in CASES]


def _params(rng):
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def _grads(rng, k):
    g = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    if k % 3 == 2:
        g[0][0, 0] = 0.0  # an exact zero gradient
    return g


def _leaves(state):
    return [t for t in torch.utils._pytree.tree_leaves(state)
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("name,sched", CASES, ids=IDS)
def test_in_place_update_equals_the_unfused_chain(name, sched):
    """Five steps of ``update`` then ``p + u`` (new state each step)
    against five of ``update_`` (in place): parameters and every state
    leaf bit for bit after each step."""
    rng = np.random.default_rng(0)
    tx, _ = _opt(name, sched)
    p0 = _params(rng)
    ref = [torch.from_numpy(p.copy()) for p in p0]
    mine = [torch.from_numpy(p.copy()) for p in p0]
    ref_state, my_state = tx.init(ref), tx.init(mine)
    for k in range(5):
        grads = [torch.from_numpy(g) for g in _grads(rng, k)]
        updates, ref_state = tx.update(grads, ref_state, ref)
        ref = [p + u for p, u in zip(ref, updates)]
        before = dense_update.launches
        out = tx.update_(grads, my_state, mine)
        assert out is my_state and dense_update.launches == before
        for a, b in zip(mine + _leaves(my_state),
                        ref + _leaves(ref_state)):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, k)


@pytest.mark.parametrize("name,sched", CASES, ids=IDS)
def test_ten_step_trajectory_matches_optax(name, sched):
    rng = np.random.default_rng(1)
    tx, jtx = _opt(name, sched)
    p0 = _params(rng)
    mine = [torch.from_numpy(p.copy()) for p in p0]
    state = tx.init(mine)
    jp = [jnp.asarray(p) for p in p0]
    js = jtx.init(jp)
    hist = []
    for k in range(10):
        g = _grads(rng, k)
        hist.append([p.clone() for p in mine])
        tx.update_([torch.from_numpy(x) for x in g], state, mine)
        u, js = jtx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(js)
               if np.asarray(x).dtype == np.float32 and np.asarray(x).ndim]
    tleaves = [t.numpy() for t in _leaves(state) if t.dim()]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(mine, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    jcounts = [int(x) for x in jax.tree.leaves(js)
               if np.asarray(x).dtype == np.int32]
    assert [int(t) for t in _leaves(state) if t.dim() == 0] == jcounts
    # the control: the parameters one step behind fail the bound
    behind = hist[-1]
    assert any(not np.allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                               atol=1e-7) for a, b in zip(behind, jp))


@pytest.mark.parametrize("name,sched", CASES, ids=IDS)
def test_skipped_step_leaves_everything_bitwise(name, sched):
    """``ok`` false (a NaN batch under the guard): the parameters and
    every state leaf, the counts included, bitwise unchanged; ``ok``
    true: the same as no ``ok`` at all."""
    tx, _ = _opt(name, sched)
    runs = []
    for ok in (False, True, None):
        rng = np.random.default_rng(2)
        params = [torch.from_numpy(p.copy()) for p in _params(rng)]
        state = tx.init(params)
        tx.update_([torch.from_numpy(g) for g in _grads(rng, 0)], state,
                   params)  # one real step first: nonzero state
        before = [t.clone() for t in params + _leaves(state)]
        g = [torch.from_numpy(x) for x in _grads(rng, 1)]
        g[1][2] = float("nan") if ok is False else 0.25
        tx.update_(g, state, params,
                   ok=None if ok is None else torch.tensor(ok))
        after = params + _leaves(state)
        if ok is False:
            for a, b in zip(after, before):
                assert torch.equal(a, b), name
        else:
            runs.append(after)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_wrapper_refuses_bad_arguments():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="unknown"):
        dense_update("lamb", p, p, None, None, -0.1, {})
    with pytest.raises(ValueError, match="must match"):
        dense_update("momentum", p, p, [], None, -0.1, {"momentum": 0.9})
    meta = [torch.zeros(3, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        dense_update("sgd", meta, meta, None, None, -0.1, {})
