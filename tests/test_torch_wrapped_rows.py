"""A negative id and its wrapped row in one ``apply_rows`` stream, in the
port's row optimizers (their plain versions on the CPU) against the JAX
package's ``SparseAdagrad`` (sparse regime), ``SparseMomentum`` (plain
and Nesterov) and ``SparseAdam``, on the same numpy inputs.

JAX's rules: the dedup sorts the ids, so ``-k`` comes before ``R - k``;
``take(mode="clip")`` reads row 0 for ``-k`` (as it was before the
update); ``slab.at[uids].add(mode="drop")`` wraps ``-k`` to ``R - k``
and adds both deltas there in index order; ``.at[uids].set`` keeps the
later (``R - k``) transition of the state row. Every id of these streams
is distinct, so the dedup sums nothing and the whole update is held bit
for bit, slab and state, in float32 and bfloat16 tables and state, with
one exception: XLA's CPU ``rsqrt`` is an approximation (an ulp off the
correctly rounded value for about one float32 input in seven), so
``SparseAdagrad``'s slab rows are held to JAX within 1e-6 of ``|slab| +
|update|`` (float32) or 2 bf16 ulps (bfloat16; two ulps on a wrapped
row, which takes two deltas), its accumulators bit for bit, and each
wrapped slab row bit for bit to the port's own two deltas added in JAX's
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.parallel.optimizers import (
    SparseAdagrad as JaxSparseAdagrad, SparseAdam as JaxSparseAdam,
    SparseMomentum as JaxSparseMomentum)

from distributed_embeddings_torch.ops.adagrad import _transition
from distributed_embeddings_torch.parallel import (
    SparseAdagrad, SparseAdam, SparseMomentum)

from torch_parity import assert_within_ulps, to_np

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ROWS, W, LR = 64, 8, 0.1

#: streams of distinct ids: a negative id beside its wrapped row, a lone
#: negative id, -R (wraps to row 0) without id 0, ids past the slab and a
#: negative id past -R (dropped); then with id 0 beside -R
STREAMS = {
    "wrapped": [-3, ROWS - 3, 7, -5, -ROWS, ROWS, ROWS + 4, -ROWS - 2, 12],
    "with_id0": [-3, ROWS - 3, 0, -ROWS, 11, -9, ROWS - 9, 40],
}


def _opts(name):
    return {
        "adagrad": (JaxSparseAdagrad(dense_apply_ratio=None),
                    SparseAdagrad(dense_apply_ratio=None)),
        "momentum": (JaxSparseMomentum(0.9), SparseMomentum(0.9)),
        "nesterov": (JaxSparseMomentum(0.9, nesterov=True),
                     SparseMomentum(0.9, nesterov=True)),
        "adam": (JaxSparseAdam(), SparseAdam()),
    }[name]


def _random_state(rng, jopt, jslab):
    """Nonzero state of the optimizer's own structure (so each row's
    transition depends on the row it reads); Adam's count at 999."""
    def one(a):
        if a.shape[-1] != W:
            return jnp.full(a.shape, 999.0, a.dtype)
        return jnp.asarray(rng.random(a.shape).astype(np.float32) * 0.2
                           + 0.05, a.dtype)
    return jax.tree.map(one, jopt.init(jslab))


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adagrad", "momentum", "nesterov", "adam"])
def test_wrapped_row_matches_jax_bitwise(name, dtype, stream):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    slab = rng.normal(size=(ROWS, W)).astype(np.float32)
    jopt, topt = _opts(name)
    jslab = jnp.asarray(slab, jdt)
    jst = _random_state(rng, jopt, jslab)
    host = jax.tree.map(lambda a: np.asarray(a).copy(), jst)
    tslab = torch.from_numpy(slab.copy()).to(tdt)
    tst = jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
            tdt if a.shape[-1] == W else torch.float32), host)
    ids = np.asarray(STREAMS[stream], np.int32)
    pairs = [(k, ROWS + k) for k in ids if k < 0 and ROWS + k in ids]
    for step in range(2):
        vals = rng.normal(size=(ids.size, W)).astype(np.float32)
        perm = rng.permutation(ids.size)  # the dedup sorts them
        old = tslab.clone(), jax.tree.map(torch.clone, tst)
        jslab, jst = jopt.apply_rows(jslab, jst, jnp.asarray(ids[perm]),
                                     jnp.asarray(vals[perm], jdt), LR)
        tslab, tst = topt.apply_rows(tslab, tst,
                                     torch.from_numpy(ids[perm].copy()),
                                     torch.from_numpy(vals[perm]).to(tdt), LR)
        if name != "adagrad":
            np.testing.assert_array_equal(to_np(tslab), to_np(jslab),
                                          err_msg=f"slab, step {step}")
        else:
            _adagrad_slab(old, tslab, jslab, ids, vals, pairs, tdt, topt)
        for i, (g, w) in enumerate(zip(jax.tree.leaves(tst),
                                       jax.tree.leaves(jst))):
            np.testing.assert_array_equal(to_np(g), to_np(w),
                                          err_msg=f"state {i}, step {step}")
    wr = (ROWS - 3, ROWS - 9 if stream == "with_id0" else ROWS - 5)
    assert (to_np(tslab)[list(wr)] != slab[list(wr)]).all()


def _adagrad_slab(old, tslab, jslab, ids, vals, pairs, tdt, topt):
    """The Adagrad slab: within ``rsqrt``'s ulp of JAX, and each wrapped
    row bitwise ``rnd(rnd(slab - u_neg) - u_pos)`` of the port's own
    transitions from the pre-step rows (row 0 for the negative id)."""
    slab0, acc0 = old
    got, want = to_np(tslab), to_np(jslab)
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * (np.abs(want).max() + LR))
    else:
        assert_within_ulps(got, want, np.abs(want) + LR / 8, 2.0,
                           "bf16 slab")
    for neg, pos in pairs:
        row = slab0[pos]
        for k, rd in ((neg, 0), (pos, pos)):
            g = torch.from_numpy(vals[list(ids).index(k)]).to(tdt)
            _, upd = _transition(acc0[rd], g.to(acc0.dtype), LR, topt.eps,
                                 tdt)
            row = row - upd
        assert torch.equal(tslab[pos], row), f"wrapped row {pos}"
