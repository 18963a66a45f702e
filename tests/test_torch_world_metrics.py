"""Step metrics (``with_metrics``) of the hybrid train step and loop at
world 8 in the port against the JAX package on its 8-device CPU mesh.

Eight gloo ranks (``torch_dist_worker.py``, one group for the file) run
the port's instrumented step; each rank tallies its own metrics and the
step gathers every rank's into JAX's ``[world]`` and ``[world,
n_tables]`` vectors (one all-gather).

* The JAX package's world-8 cases of ``tests/test_obs_metrics.py``: a
  ragged batch overflowing its capacity on one shard reports its 4
  dropped ids on the rank that owns the table only, the exchange byte
  metrics are equal and nonzero on every rank; a healthy batch reports
  zero overflow.
* The whole metrics dict of every step equal to JAX's (counts, bytes
  and fractions exact; the loss, the norms and the update bound within
  float32 summation order, rtol 1e-5, atol 1e-7) on a model with a
  row-sliced table (the invalid-id count skips its slots), ragged and
  multi-hot tables and ids outside their tables, with data-parallel
  input and with ``MpInputs``; and over the train loop (``[K, world]``,
  the sentinels ``[K, world, n_tables]``). Control: the metrics
  gathered in reversed rank order must fail the bound.
* ``obs.summarize`` equal to JAX's (``tests/test_obs_metrics.py``'s
  two cases, and the world-8 metrics above).
"""

import functools

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.utils import obs as jobs

from distributed_embeddings_torch.parallel import DistributedEmbedding
from distributed_embeddings_torch.utils import obs

from torch_dist_worker import RankGroup
from torch_world_ref import WORLD, jax_hybrid, metrics_mismatch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_world_metrics"))
    yield g
    g.close()


# ------------------------------------------ the JAX package's world-8 cases

OBS_CONFIGS = ([{"input_dim": 50, "output_dim": 16, "combiner": "sum"}]
               + [{"input_dim": 30 + i, "output_dim": 16}
                  for i in range(WORLD + 1)])


def _overflow_spec(lens_per_shard):
    """``tests/test_obs_metrics.py``'s ``_dist_setup`` batch: a ragged
    table whose shard ``s`` claims ``lens_per_shard[s]`` ids a row
    against a capacity of 8, and nine one-hot tables."""
    rng = np.random.default_rng(0)
    b, cap = 4, 8
    vals, splits = [], []
    for s in range(WORLD):
        vals.append(rng.integers(0, 50, cap).astype(np.int32))
        ln = lens_per_shard[s]
        splits.append(np.arange(0, ln * (b + 1), ln, dtype=np.int32))
    cats = [("ragged", vals, splits, None)] + [
        rng.integers(0, 30, WORLD * b).astype(np.int32)
        for _ in range(WORLD + 1)]
    tables = [rng.uniform(-0.05, 0.05, size=(c["input_dim"], 16))
              .astype(np.float32) for c in OBS_CONFIGS]
    return dict(configs=OBS_CONFIGS, strategy="memory_balanced",
                tables=tables, w=np.float32(0.5), lr=0.01, loss="sq",
                local_batch=b, with_metrics=True, nan_guard=True,
                steps=[cats])


def test_world8_overflow_is_per_rank(group):
    ranks = group.run("hybrid", _overflow_spec([3] + [2] * (WORLD - 1)))
    for got in ranks:
        m = got["metrics"][0]
        overflow = m["id_overflow"]
        assert overflow.shape == (WORLD,) and overflow.sum() == 4
        assert (overflow > 0).sum() == 1  # on the rank owning the table
        ida2a = m["id_a2a_bytes"]
        assert (ida2a > 0).all() and len(set(ida2a.tolist())) == 1
        assert (m["out_a2a_bytes"] > 0).all()
        assert m["ids_routed"].sum() > 0
        np.testing.assert_array_equal(m["id_overflow"],
                                      ranks[0]["metrics"][0]["id_overflow"])
    de = DistributedEmbedding(OBS_CONFIGS, WORLD, strategy="memory_balanced")
    owner = [r for r, t in enumerate(de.strategy.table_ids_list) if 0 in t]
    assert np.flatnonzero(ranks[0]["metrics"][0]["id_overflow"]).tolist() \
        == owner


def test_world8_healthy_batch_zero_overflow(group):
    ranks = group.run("hybrid", _overflow_spec([2] * WORLD))
    for got in ranks:
        assert got["metrics"][0]["id_overflow"].sum() == 0


# ---------------------------------------------------- the whole dict vs JAX

LOCAL_B = 4
ROW_THR = 900  # table 0 (120 x 8) splits in 2
#: (input_dim, width, combiner, input: a dense hotness or "r")
TABLES = [(120, 8, None, 1), (40, 8, "sum", 2), (30, 8, None, 1),
          (50, 16, "sum", "r"), (25, 16, None, 1), (35, 16, "mean", 3),
          (20, 8, None, 1), (22, 8, None, 1), (60, 8, None, 1)]
CONFIGS = [{"input_dim": d, "output_dim": w, "combiner": c}
           for d, w, c, _ in TABLES]


def _inputs(rng, ragged=True):
    """A global batch with ids outside their tables (negative and past
    the end) on every input."""
    B, cap = WORLD * LOCAL_B, LOCAL_B * 3
    out = []
    for dim, _, _, kind in TABLES:
        if kind == "r" and ragged:
            vals, splits = [], []
            for _ in range(WORLD):
                lens = rng.integers(0, 4, size=LOCAL_B)
                n = int(lens.sum())
                v = np.zeros(cap, np.int32)
                v[:n] = rng.integers(-2, dim + 2, size=n)
                vals.append(v)
                splits.append(np.concatenate([[0], np.cumsum(lens)])
                              .astype(np.int32))
            out.append(("ragged", vals, splits, None))
            continue
        hot = 2 if kind == "r" else kind
        out.append(rng.integers(-2, dim + 2, size=(B, hot)).astype(np.int32))
    return out


def metrics_spec(seed, ragged=True, steps=2, **kw):
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(d, w)).astype(np.float32)
              for d, w, _, _ in TABLES]
    cols = sum(w for _, w, _, _ in TABLES)
    return dict(configs=CONFIGS, row_slice=ROW_THR, tables=tables,
                w=np.full((cols, 1), 0.1, np.float32), lr=0.05, loss="proj",
                local_batch=LOCAL_B, with_metrics=True, nan_guard=True,
                steps=[_inputs(rng, ragged) for _ in range(steps)], **kw)


@functools.lru_cache(maxsize=None)
def _jax_metrics():
    return jax_hybrid(metrics_spec(31))


def _mismatch(ranks, want):
    return {(r, k): metrics_mismatch(m, wm) for r, got in enumerate(ranks)
            for k, (m, wm) in enumerate(zip(got["metrics"], want["metrics"]))
            if metrics_mismatch(m, wm)}


@pytest.mark.parametrize("dp_input", [True, False])
def test_world8_metrics_match_jax(group, dp_input):
    group.submit("hybrid", metrics_spec(31, dp_input=dp_input))
    want = _jax_metrics()
    ranks = group.collect()
    assert _mismatch(ranks, want) == {}
    for got in ranks:
        assert got["losses"] == pytest.approx(want["losses"], rel=1e-5,
                                              abs=1e-7)
    m = want["metrics"][0]
    assert m["invalid_id_count"].sum() > 0 and m["ids_routed"].shape == (
        WORLD,) and m["table_grad_norm"].shape == (WORLD, len(TABLES))
    de = DistributedEmbedding(CONFIGS, WORLD, row_slice=ROW_THR)
    assert de.strategy.row_sliced_tables == {0}
    if dp_input:  # control: every rank's metrics in reversed order
        bad = group.run("hybrid", metrics_spec(31, control="metrics_reversed"))
        assert _mismatch(bad, want)


def test_world8_loop_metrics_match_jax(group):
    spec = metrics_spec(32, ragged=False, steps=3, loop=True)
    group.submit("hybrid", spec)
    want = jax_hybrid(spec)
    ranks = group.collect()
    K = 3
    for got in ranks:
        m = got["metrics"]
        assert metrics_mismatch(m, want["metrics"]) == []
        assert m["ids_routed"].shape == (K, WORLD)
        assert m["table_nonfinite"].shape == (K, WORLD, len(TABLES))
        np.testing.assert_array_equal(m["step"], np.repeat(
            np.arange(K, dtype=np.int32)[:, None], WORLD, 1))


# --------------------------------------------------------- obs.summarize


def test_summarize_reduces_per_rank_vectors():
    m = {"ids_routed": np.asarray([4, 6]),
         "id_overflow": np.asarray([0, 3]),
         "id_a2a_bytes": np.asarray([10.0, 10.0]),
         "out_pad_frac": np.asarray([0.25, 0.5]),
         "loss": np.asarray([1.5, 1.5])}
    s = obs.summarize({k: torch.as_tensor(v) for k, v in m.items()})
    assert s == jobs.summarize(m)
    assert s["ids_routed"] == 10.0 and s["id_overflow"] == 3.0
    assert s["id_a2a_bytes"] == 20.0 and s["out_pad_frac"] == 0.5
    assert s["loss"] == 1.5


def test_summarize_percentiles_of_per_rank_vectors():
    ids = np.asarray([10.0, 10, 10, 10, 10, 10, 10, 94])
    m = {"ids_routed": ids, "loss": np.asarray([1.0])}
    s = obs.summarize(m)
    assert s == jobs.summarize(m)
    assert s["ids_routed"] == float(ids.sum())
    assert s["ids_routed_p50"] == pytest.approx(np.percentile(ids, 50))
    assert s["ids_routed_p95"] == pytest.approx(np.percentile(ids, 95))
    assert "loss_p50" not in s and "loss_p95" not in s


def test_summarize_world8_metrics_matches_jax(group):
    ranks = group.run("hybrid", metrics_spec(31))
    want = _jax_metrics()
    for k in range(len(want["metrics"])):
        got, ref = (obs.summarize(ranks[0]["metrics"][k]),
                    jobs.summarize(want["metrics"][k]))
        assert sorted(got) == sorted(ref)
        for key, v in ref.items():
            assert got[key] == pytest.approx(v, rel=1e-5, abs=1e-7), key
