"""The port's interaction and gather kernels against the JAX package, on
the CPU, and against their plain versions on the card.

* K1 (``ops.embedding_lookup.gather_combine``): the plain version the
  CPU runs is held to the JAX ``parallel/lookup.py:lookup_group`` (kind
  ``"d"``, through the JAX lane-packed slab for widths 8/16, compared on
  logical rows) and to the dense branch of ``embedding_lookup``.
* K2 (``ops.interaction.dot_interact_fwd``): held to the JAX
  ``models/dlrm.py:dot_interact``.
* K4 (``ops.interaction.dot_interact_bwd``): held to ``jax.vjp`` of the
  same JAX function, and ``DotInteract`` (K2 forward, K4 backward) to
  ``torch.autograd.gradcheck`` in float64.

Tolerances, with their reasons:
  - gathers (hotness 1, sums of bf16 rows accumulated in fp32 by both)
    are bit-exact;
  - ``mean``: the JAX lookup rounds the bf16 sum, then divides; the port
    divides the fp32 sum and rounds once: <= 1 bf16 ulp of the result;
  - weighted bf16: the JAX lookup rounds each weight x row product to
    bf16 before summing, the port does not: <= 2 bf16 ulp of the
    largest product;
  - fp32 reductions: summation order only, rtol 1e-6;
  - K2 bf16: both accumulate in fp32 and round once; the fp32 order
    differs: <= 1 bf16 ulp of the result; K2 fp32: 1e-5 of the sum of
    |products|;
  - K4 fp32: summation order only, 1e-5 of the sum of |terms|
    (``sum_g |dG[f, g]| |feats[g]|``, plus the appended row's cotangent
    on feature 0); K4 bf16: the port rounds the fp32 sum once, JAX
    rounds the two einsum cotangents, their sum and the appended row's
    add: <= 2 bf16 ulp of the sum of |terms|.
``tests/test_torch_cuda.py`` holds each kernel to its plain version on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.models import dot_interact as jax_dot_interact
from distributed_embeddings_tpu.ops import embedding_lookup as jax_lookup
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE)
from distributed_embeddings_tpu.parallel import exchange as jax_exchange
from distributed_embeddings_tpu.parallel import lookup as jax_lookup_mod

from distributed_embeddings_torch.ops import (
    DotInteract, dot_interact_bwd, dot_interact_fwd, embedding_lookup,
    gather_combine)
from distributed_embeddings_torch.parallel import DistributedEmbedding
from distributed_embeddings_torch.parallel import exchange as t_exchange
from distributed_embeddings_torch.parallel import lookup as t_lookup

from torch_parity import assert_within_ulps, to_np

torch.set_num_threads(1)

CPU = torch.device("cpu")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _ids(rng, vocab, shape):
    """Ids mostly in range, with negatives and ids past the table."""
    return rng.integers(-3, vocab + 3, size=shape).astype(np.int32)


# ------------------------------------------------------------ K1 vs JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_group_matches_jax(dtype):
    """Every (width, hotness) group of a world-1 plan: the port's group
    lookup (K1's plain version) against the JAX group lookup over its
    lane-packed slab."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    configs = [
        {"input_dim": 37, "output_dim": 8, "combiner": "sum"},
        {"input_dim": 50, "output_dim": 8, "combiner": "mean"},
        {"input_dim": 29, "output_dim": 16, "combiner": "sum"},
        {"input_dim": 64, "output_dim": 16, "combiner": "mean"},
        {"input_dim": 23, "output_dim": 128, "combiner": "mean"},
        {"input_dim": 41, "output_dim": 128, "combiner": None},
        {"input_dim": 19, "output_dim": 128, "combiner": "sum"},
    ]
    hots = [3, 3, 1, 3, 3, 1, 3]
    b = 6
    tables = [rng.normal(size=(c["input_dim"], c["output_dim"]))
              .astype(np.float32) for c in configs]
    ids = [_ids(rng, c["input_dim"], (b, h))
           for c, h in zip(configs, hots)]

    de_j = JaxDE(configs, world_size=1)
    pj = de_j.local_view(de_j.set_weights(tables, dtype=jdt))
    ent, encs, _ = de_j._normalize_inputs([jnp.asarray(i) for i in ids])
    plan_j = de_j._get_plan(encs, b)
    recv_j = jax_exchange.build_send_blocks(de_j, plan_j, ent, jnp.int32)

    de_t = DistributedEmbedding(configs, world_size=1)
    pt = de_t.set_weights(tables, dtype=tdt, device="cpu")
    ent_t, encs_t, _, cdt = de_t._normalize_inputs(
        [torch.from_numpy(i) for i in ids], CPU)
    plan_t = de_t._get_plan(encs_t, b)
    recv_t = t_exchange.build_send_blocks(de_t, plan_t, ent_t, cdt, CPU)
    np.testing.assert_array_equal(to_np(recv_t), np.asarray(recv_j))

    # one jitted program for every group (one compile, not one per op)
    wants = jax.jit(lambda p, r: [
        jax_lookup_mod.lookup_group(de_j, plan_j, gi, g, p[f"w{g.width}"],
                                    r, 0, b)
        for gi, g in enumerate(plan_j.groups)])(pj, recv_j)
    for gi, g in enumerate(plan_t.groups):
        want = to_np(wants[gi])
        got = to_np(t_lookup.lookup_group(
            de_t, plan_t, gi, g, pt[f"w{g.width}"][0], recv_t, b))
        assert got.shape == want.shape == (1, g.n, b, g.width)
        mean_group = bool(plan_t.mean[gi].any()) and g.hot > 1
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        elif mean_group:
            assert_within_ulps(got, want, want, 1, f"group {g}")
        else:
            np.testing.assert_array_equal(got, want)


VARIANTS = [  # (combiner, hotness, weighted)
    (None, 1, False), ("sum", 1, False), ("sum", 3, False),
    ("mean", 3, False), ("sum", 3, True), ("mean", 3, True)]


@pytest.mark.parametrize("width", [8, 16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", VARIANTS,
                         ids=["gather", "sum1", "sum3", "mean3", "wsum3",
                              "wmean3"])
def test_embedding_lookup_dense_matches_jax(width, dtype, variant):
    combiner, hot, weighted = variant
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(width * 7 + hot)
    vocab, b = 45, 9
    table = rng.normal(size=(vocab, width)).astype(np.float32)
    ids = _ids(rng, vocab, (b, hot))
    wts = (rng.uniform(0.25, 2.0, size=(b, hot)).astype(np.float32)
           if weighted else None)
    jt = jnp.asarray(table, jdt)
    want = to_np(jax_lookup(jt, jnp.asarray(ids), combiner,
                            None if wts is None else jnp.asarray(wts)))
    tt = torch.from_numpy(table).to(tdt)
    got = to_np(embedding_lookup(
        tt, torch.from_numpy(ids), combiner,
        None if wts is None else torch.from_numpy(wts)))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    elif weighted:
        rows = to_np(tt)[np.clip(ids, 0, vocab - 1)]
        wq = to_np(torch.from_numpy(wts).to(tdt))
        biggest = np.abs(rows * wq[..., None]).max(axis=1)
        assert_within_ulps(got, want, biggest, 2, "weighted")
    elif combiner == "mean" and hot > 1:
        assert_within_ulps(got, want, want, 1, "mean")
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [8, 16, 128])
def test_packed_gather_matches_jax_logically(width):
    """The JAX gather reads a lane-packed slab, the port a logical one;
    the rows they return agree exactly. Ids are in range: every JAX
    caller clips them to the table first (``lookup.py:172``), and the
    packed layout clips out-of-range ids at physical-row granularity
    (``-3 // 8`` is row 0 but ``-3 % 8`` lane 5), a layout artifact the
    logical slab does not have."""
    from distributed_embeddings_tpu.ops import packed_slab as jax_ps
    from distributed_embeddings_torch.ops import packed_slab as t_ps

    rng = np.random.default_rng(width)
    rows = t_ps.align_rows(37, width)
    assert rows == jax_ps.align_rows(37, width)
    assert t_ps.pack_factor(width) == jax_ps.pack_factor(width)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    ids = rng.integers(0, rows, size=(4, 5)).astype(np.int32)
    want = jax_ps.packed_gather(
        jnp.asarray(jax_ps.pack_rows_np(table, width)), jnp.asarray(ids),
        width)
    got = t_ps.packed_gather(torch.from_numpy(table), torch.from_numpy(ids),
                             width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_clips_out_of_range_ids():
    """Negative ids read row 0, ids past the table its last row (the JAX
    ``mode="clip"``), where ``index_select`` would raise."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = embedding_lookup(table, torch.tensor([-5, 0, 3, 4, 99]))
    np.testing.assert_array_equal(
        out.numpy(), table.numpy()[[0, 0, 3, 3, 3]])


def test_cpu_tensors_run_plain_and_count_no_launch():
    kernels = (gather_combine, dot_interact_fwd, dot_interact_bwd)
    before = [k.launches for k in kernels]
    table = torch.ones(5, 8)
    embedding_lookup(table, torch.tensor([[1, 2]]), "sum")
    feats = torch.ones(2, 3, 8, requires_grad=True)
    DotInteract.apply(feats).sum().backward()
    assert feats.grad.shape == feats.shape
    assert [k.launches for k in kernels] == before


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card never reaches a
    silent fallback."""
    meta = torch.empty(5, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        embedding_lookup(meta, torch.tensor([1], device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        dot_interact_fwd(torch.empty(2, 3, 8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        dot_interact_bwd(torch.empty(2, 3, 8, device="meta"),
                         torch.empty(2, 11, device="meta"))


# ------------------------------------------------------------ K2 vs JAX


@pytest.mark.parametrize("dim", [16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_interact_matches_jax(dim, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(dim)
    B, F = 64, 27
    feats = rng.normal(size=(B, F, dim)).astype(np.float32)
    want = to_np(jax_dot_interact(
        [jnp.asarray(feats[:, f], jdt) for f in range(1, F)],
        jnp.asarray(feats[:, 0], jdt)))
    got = to_np(dot_interact_fwd(torch.from_numpy(feats).to(tdt)))
    assert got.shape == want.shape == (B, F * (F - 1) // 2 + dim)
    q = to_np(torch.from_numpy(feats).to(tdt))
    li, lj = np.tril_indices(F, k=-1)
    scale = np.concatenate(
        [np.einsum("bpd,bpd->bp", np.abs(q[:, li]), np.abs(q[:, lj])),
         np.abs(q[:, 0])], axis=1)
    if dtype == "float32":
        np.testing.assert_array_less(np.abs(got - want), 1e-5 * scale + 1e-30)
    else:
        np.testing.assert_array_equal(got[:, -dim:], want[:, -dim:])
        assert_within_ulps(got, want, np.maximum(np.abs(want), 1e-30), 1,
                           "dot_interact")


# ------------------------------------------------------------ K4 vs JAX


@pytest.mark.parametrize("dim", [16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_interact_bwd_matches_jax_vjp(dim, dtype):
    """K4's plain version against the cotangent JAX's autodiff gives the
    stacked features (bottom-MLP input and every embedding output)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(100 + dim)
    B, F = 48, 27
    P = F * (F - 1) // 2
    feats = rng.normal(size=(B, F, dim)).astype(np.float32)
    dy = rng.normal(size=(B, P + dim)).astype(np.float32)

    def fn(bottom, embs):
        return jax_dot_interact(embs, bottom)

    jf = jnp.asarray(feats, jdt)
    _, vjp = jax.vjp(fn, jf[:, 0], [jf[:, f] for f in range(1, F)])
    d_bottom, d_embs = vjp(jnp.asarray(dy, jdt))
    want = np.stack([to_np(d_bottom)] + [to_np(e) for e in d_embs], axis=1)
    got = to_np(dot_interact_bwd(torch.from_numpy(feats).to(tdt),
                                 torch.from_numpy(dy).to(tdt)))
    assert got.shape == want.shape == (B, F, dim)
    # the sum of |terms| each output element adds up
    qf = to_np(torch.from_numpy(feats).to(tdt))
    qd = to_np(torch.from_numpy(dy).to(tdt))
    li, lj = np.tril_indices(F, k=-1)
    adg = np.zeros((B, F, F))
    adg[:, li, lj] = np.abs(qd[:, :P])
    adg[:, lj, li] = np.abs(qd[:, :P])
    scale = np.einsum("bfg,bgd->bfd", adg, np.abs(qf))
    scale[:, 0] += np.abs(qd[:, P:])
    if dtype == "float32":
        np.testing.assert_array_less(np.abs(got - want), 1e-5 * scale + 1e-30)
    else:
        assert_within_ulps(got, want, np.maximum(scale, 1e-30), 2,
                           "dot_interact_bwd")


def test_dot_interact_function_gradcheck():
    """``DotInteract`` (K2 forward, K4 backward; their plain versions on
    the CPU) against finite differences, in float64."""
    feats = torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, 5, 4))).requires_grad_()
    assert torch.autograd.gradcheck(DotInteract.apply, (feats,))
