"""Streaming vocabularies (``dynamic=``) in the hybrid train step at
world 8 in the port against the JAX package on its 8-device CPU mesh.

Eight gloo ranks (``torch_dist_worker.py``, one group for the file) run
the port's step from the same numpy tables, dense weight and ids as
JAX's; each rank carries its own ``[1, ...]`` row of the streaming (and
telemetry) state, remaps the external ids every sender sent it for its
own streaming tables, and commits under the global guard verdict.

* The port of ``test_streaming_on_mesh_with_telemetry_combined``
  (``tests/test_streaming_vocab.py``): 3 guarded, instrumented steps
  with telemetry. Every rank's slot map, admission sketch, counters and
  telemetry equal JAX's row bit for bit; the whole metrics dict equals
  JAX's ``[world]`` vectors (counts exact, the loss and norms within
  float32 summation order, rtol 1e-5), the ``stream_*`` metrics are
  ``(8,)``; ``occupancy`` (a collective) equals JAX's. Control: the
  streaming plan taken from rank 0's row on every rank (the world-1
  code) must fail the state bound.
* A ragged streaming table beside a dense one, and a row-sliced static
  table in the same width, with data-parallel input and with
  ``MpInputs`` (both against the same JAX run).
* A NaN batch under the guard: every rank's streaming state, slabs and
  dense parameters keep their bits, telemetry still counts, the
  metrics report the skip; the read-only eval step leaves the streaming
  state alone; each rank started from its rows of JAX's states after
  two steps (the converters with ``rank=``) ends the third on JAX's.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_embeddings_torch.parallel import DistributedEmbedding

from torch_dist_worker import RankGroup
from torch_world_ref import (WORLD, assert_tree_rows_equal, jax_hybrid,
                             metrics_mismatch, rows_differ)

torch.set_num_threads(1)

SCFG = (2, 1, 2, 64)  # admit_min_count, evict_margin, depth, buckets
TCFG = (2, 128, 8, 16)  # depth, buckets, topk, candidates


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_world_streaming"))
    yield g
    g.close()


def _tables(rng, configs):
    return [rng.uniform(-0.05, 0.05, size=(c["input_dim"], c["output_dim"]))
            .astype(np.float32) for c in configs]


def combined_spec(**kw):
    """``test_streaming_on_mesh_with_telemetry_combined``'s model, batch
    and steps."""
    configs = [{"input_dim": 24 + 3 * i, "output_dim": 8} for i in range(7)]
    configs.append({"input_dim": 64 + 8, "output_dim": 8,
                    "streaming": {"capacity": 64, "buckets": 8}})
    rng = np.random.default_rng(5)
    b = 16
    steps = []
    for _ in range(3):
        cats = [rng.integers(0, c["input_dim"], b).astype(np.int32)
                for c in configs[:7]]
        cats.append((rng.integers(0, 40, b) + 10 ** 7).astype(np.int32))
        steps.append(cats)
    return dict(configs=configs, tables=_tables(rng, configs),
                w=np.ones((8, 1), np.float32), lr=0.1, loss="mean",
                local_batch=b // WORLD, with_metrics=True, nan_guard=True,
                telemetry=TCFG, dynamic=SCFG, steps=steps, **kw)


RAGGED_B = 4
RAGGED_ROW_THR = 1000  # table 0 (200 x 8) splits; the others do not


def ragged_spec(**kw):
    """A dense and a ragged streaming table, a row-sliced static table
    and five small static ones, all of width 8."""
    configs = [{"input_dim": 200, "output_dim": 8},
               {"input_dim": 30, "output_dim": 8, "combiner": "sum"},
               {"input_dim": 31, "output_dim": 8},
               {"input_dim": 32, "output_dim": 8},
               {"input_dim": 33, "output_dim": 8, "combiner": "mean"},
               {"input_dim": 34, "output_dim": 8},
               {"input_dim": 32 + 4, "output_dim": 8,
                "streaming": {"capacity": 32, "buckets": 4}},
               {"input_dim": 48 + 6, "output_dim": 8, "combiner": "sum",
                "streaming": {"capacity": 48, "buckets": 6}}]
    rng = np.random.default_rng(7)
    B, cap = WORLD * RAGGED_B, RAGGED_B * 4
    steps = []
    for _ in range(4):
        cats = []
        for t, c in enumerate(configs[:6]):
            shape = (B, 2) if c.get("combiner") else (B,)
            cats.append(rng.integers(0, c["input_dim"], shape)
                        .astype(np.int32))
        cats.append((rng.integers(0, 30, B) + 10 ** 6).astype(np.int32))
        vals, splits = [], []
        for _ in range(WORLD):
            lens = rng.integers(0, 5, size=RAGGED_B)
            n = int(lens.sum())
            v = np.zeros(cap, np.int32)
            v[:n] = rng.integers(0, 20, size=n) + 2 * 10 ** 6
            vals.append(v)
            splits.append(np.concatenate([[0], np.cumsum(lens)])
                          .astype(np.int32))
        cats.append(("ragged", vals, splits, None))
        steps.append(cats)
    return dict(configs=configs, row_slice=RAGGED_ROW_THR,
                tables=_tables(rng, configs), w=np.ones((8, 1), np.float32),
                lr=0.1, loss="mean", local_batch=RAGGED_B, with_metrics=True,
                nan_guard=True, telemetry=TCFG, dynamic=SCFG, steps=steps,
                **kw)


def _check_against_jax(ranks, want):
    for r, got in enumerate(ranks):
        assert_tree_rows_equal(got["stream"], want["stream"], r, "stream")
        assert_tree_rows_equal(got["telem"], want["telem"], r, "telem")
        for k, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
            bad = metrics_mismatch(gm, wm)
            assert bad == [], (r, k, {m: (gm[m], wm[m]) for m in bad})
        assert got["occupancy"] == want["occupancy"]
        assert got["losses"] == pytest.approx(want["losses"], rel=1e-5,
                                              abs=1e-7)


@functools.lru_cache(maxsize=None)
def _combined(group):
    spec = combined_spec()
    group.submit("hybrid", spec)
    want = jax_hybrid(spec)
    return spec, group.collect(), want


def test_world8_streaming_with_telemetry_combined_matches_jax(group):
    _, ranks, want = _combined(group)
    _check_against_jax(ranks, want)
    last = want["metrics"][-1]
    assert float(last["stream_admitted"].sum()) > 0
    for k in ("stream_admitted", "stream_evicted", "stream_bucket_ids",
              "stream_hit_ids"):
        assert ranks[0]["metrics"][-1][k].shape == (WORLD,)
    occ = ranks[0]["occupancy"]
    assert occ["admitted"] > 0 and occ["tables"][0]["table_id"] == 7


def test_world8_streaming_carried_from_jax(group):
    """Each rank starts from its rows of JAX's streaming and telemetry
    states after two steps (``*_state_from_jax(rank=)``) and takes the
    third: both equal JAX's rows after three."""
    spec, _, want = _combined(group)
    telem2, stream2 = want["aux_steps"][1]
    ranks = group.run("hybrid", dict(spec, steps=spec["steps"][2:],
                                     telem_init=telem2, stream_init=stream2))
    for r, got in enumerate(ranks):
        assert_tree_rows_equal(got["stream"], want["stream"], r, "stream")
        assert_tree_rows_equal(got["telem"], want["telem"], r, "telem")


def test_world8_streaming_plan_of_rank0_fails(group):
    spec, _, want = _combined(group)
    bad = group.run("hybrid", dict(spec, control="stream_rank0"))
    assert rows_differ(bad, want, "stream")


@functools.lru_cache(maxsize=None)
def _jax_ragged():
    return jax_hybrid(ragged_spec())


@pytest.mark.parametrize("dp_input", [True, False])
def test_world8_ragged_streaming_matches_jax(group, dp_input):
    spec = ragged_spec(dp_input=dp_input)
    group.submit("hybrid", spec)
    want = _jax_ragged()
    ranks = group.collect()
    _check_against_jax(ranks, want)
    hits = sum(float(m["stream_hit_ids"].sum()) for m in want["metrics"])
    assert hits > 0
    de = DistributedEmbedding(spec["configs"], WORLD,
                              row_slice=RAGGED_ROW_THR)
    assert de.strategy.row_sliced_tables == {0}


def test_world8_nan_batch_leaves_streaming_state_bitwise(group):
    ranks = group.run("hybrid", ragged_spec(nan_after=True))
    for got in ranks:
        assert np.isnan(got["nan_loss"])
        assert got["nan_unchanged"]
        assert got["nan_step"] == len(got["losses"]) + 1
        assert got["nan_telem_steps"] == 1  # telemetry still counts
        m = got["nan_metrics"]
        assert (m["skipped_steps"] == 1).all()
        for k in ("stream_admitted", "stream_evicted", "stream_bucket_ids",
                  "stream_hit_ids"):
            assert not m[k].any()


def test_world8_eval_step_is_read_only(group):
    ranks = group.run("hybrid", ragged_spec(eval=True))
    for got in ranks:
        assert got["eval_unchanged"]
        assert got["pred"].shape == (RAGGED_B, 8)
        assert np.isfinite(got["pred"]).all()
