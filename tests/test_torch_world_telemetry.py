"""Access telemetry of the hybrid train step at world 8 in the port
against the JAX package on its 8-device CPU mesh.

Eight gloo ranks (``torch_dist_worker.py``, one group for the file) run
the port's step with ``telemetry=`` from the same numpy tables, dense
weight and ids as JAX's step; each rank carries its own ``[1, ...]`` row
of the state.

* After 3 steps every rank's state equals JAX's row for that rank, bit
  for bit: the sketches, the top-k ids and estimates, ``steps`` and
  ``ids_total`` (float32, exact: far below 2^24 live ids). One model
  gives each case its own width slab: dense hot-1 tables (w4), dense
  multi-hot tables with a combiner (w8), ragged tables (w16) and
  row-sliced tables (w32: 4 slices a table, ids at ``rbase - 1``,
  ``rbase``, ``rbase + rows - 1`` and ``rbase + rows`` of every slice).
  Control: rank 5's row bases (its slice of table 8 starts at row
  150) dropped must fail the bound on rank 5. Each rank started from its
  row of JAX's state after two steps (``telemetry_state_from_jax(rank=)``)
  ends the third on JAX's row.
* ``gather_state``, ``hot_rows``, ``load_balance`` and
  ``summarize_telemetry`` (collectives at world > 1) equal JAX's on
  every rank; ``_slab_row_to_table`` equals JAX's on the row-sliced
  plan, row by row.
* The JAX package's world-8 cases of ``tests/test_telemetry.py`` on the
  port: planted hot rows recovered, the imbalanced per-rank histogram,
  training bitwise identical with telemetry on and off, and the loop
  carrying one state.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.analysis import telemetry as jtel
from distributed_embeddings_tpu.utils import power_law_ids

from distributed_embeddings_torch.analysis import telemetry as tel
from distributed_embeddings_torch.parallel import DistributedEmbedding

from torch_dist_worker import RankGroup
from torch_world_ref import (WORLD, assert_tree_rows_equal, jax_hybrid,
                             layer, rows_differ)

torch.set_num_threads(1)

LOCAL_B = 4
B = WORLD * LOCAL_B
ROW_THR = 4000  # the two w32 tables split 4 ways
#: (input_dim, width, combiner, input kind: a dense hotness or "r")
TABLES = [(60, 4, None, 1), (70, 4, None, 1), (80, 4, None, 1),
          (50, 8, "sum", 3), (90, 8, "mean", 3),
          (40, 16, "sum", "r"), (120, 16, "mean", "r"),
          (400, 32, None, 1), (300, 32, "sum", 2)]
CONFIGS = [{"input_dim": d, "output_dim": w, "combiner": c}
           for d, w, c, _ in TABLES]
TCFG = (4, 64, 8, 16)  # depth, buckets, topk, candidates
CASES = {"dense_hot1": "w4", "dense_multihot": "w8", "ragged": "w16",
         "row_sliced": "w32"}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_world_telemetry"))
    yield g
    g.close()


def _edges():
    """Per table: the slice edges of its row slices (none unsliced) and
    two ids outside the table."""
    de = DistributedEmbedding(CONFIGS, WORLD, row_slice=ROW_THR)
    out = []
    for tid, (dim, _, _, _) in enumerate(TABLES):
        e = [-1, dim]
        for tids, cfgs in zip(de.strategy.table_ids_list,
                              de.strategy.local_configs_list):
            for t, cfg in zip(tids, cfgs):
                if t == tid and "_row_base" in cfg:
                    rb, rows = cfg["_row_base"], cfg["input_dim"]
                    e += [rb - 1, rb, rb + rows - 1, rb + rows]
        out.append(sorted(set(e)))
    return out


def make_inputs(rng, edges):
    """A global batch: dense ``[B, hot]`` int32 with the edge ids in its
    first positions; ragged as per-rank CSRs of 0-4 ids a row."""
    cap = LOCAL_B * 4
    out = []
    for (dim, _, _, kind), e in zip(TABLES, edges):
        if kind != "r":
            ids = rng.integers(0, dim, size=(B, kind)).astype(np.int32)
            ids.reshape(-1)[:len(e)] = e
            out.append(ids)
            continue
        vals, splits = [], []
        for r in range(WORLD):
            lens = rng.integers(0, 5, size=LOCAL_B)
            n = int(lens.sum())
            v = np.zeros(cap, np.int32)
            v[:n] = rng.integers(0, dim, size=n)
            if r == 0:
                v[:min(n, len(e))] = e[:n]
            vals.append(v)
            splits.append(np.concatenate([[0], np.cumsum(lens)])
                          .astype(np.int32))
        out.append(("ragged", vals, splits, None))
    return out


def spec_of(seed, **kw):
    rng = np.random.default_rng(seed)
    edges = _edges()
    tables = [rng.normal(size=(d, w)).astype(np.float32)
              for d, w, _, _ in TABLES]
    cols = sum(w for _, w, _, _ in TABLES)
    return dict(configs=CONFIGS, row_slice=ROW_THR, tables=tables,
                w=np.full((cols, 1), 0.1, np.float32), lr=0.01,
                loss="proj", local_batch=LOCAL_B, telemetry=TCFG,
                steps=[make_inputs(rng, edges) for _ in range(3)], **kw)


@functools.lru_cache(maxsize=None)
def _main_run(group):
    spec = spec_of(11)
    group.submit("hybrid", spec)
    want = jax_hybrid(spec)
    return spec, group.collect(), want


@pytest.mark.parametrize("case", sorted(CASES))
def test_world8_telemetry_state_matches_jax(group, case):
    _, ranks, want = _main_run(group)
    w = CASES[case]
    for r, got in enumerate(ranks):
        assert_tree_rows_equal(got["telem"][w], want["telem"][w], r, w)
        for k in ("steps", "ids_total"):
            np.testing.assert_array_equal(got["telem"][k],
                                          want["telem"][k][r:r + 1])
    # every width saw live ids on some rank, and the sketches are not
    # empty where the rank holds tables of that width
    assert (want["telem"][w]["ids"] > 0).any()
    assert int(want["telem"]["steps"][0, 0]) == 3
    assert float(np.max(want["telem"]["ids_total"])) < 2 ** 24
    if case == "row_sliced":
        de = DistributedEmbedding(CONFIGS, WORLD, row_slice=ROW_THR)
        assert de.strategy.row_sliced_tables == {7, 8}
        spec, _, _ = _main_run(group)
        bad = group.run("hybrid", dict(spec, drop_rbase=5))
        assert 5 in rows_differ([{"telem": g["telem"][w]} for g in bad],
                                {"telem": want["telem"][w]}, "telem")


def test_world8_telemetry_carried_from_jax(group):
    """Each rank starts from its row of JAX's state after two steps
    (``telemetry_state_from_jax(rank=)``) and takes the third: its state
    equals JAX's row after three; the converters round-trip a row."""
    from distributed_embeddings_torch.utils.convert import (
        telemetry_state_from_jax, telemetry_state_to_numpy)

    spec, _, want = _main_run(group)
    after2 = want["aux_steps"][1][0]
    for r in (0, 5):
        back = telemetry_state_to_numpy(telemetry_state_from_jax(
            after2, device="cpu", rank=r))
        assert_tree_rows_equal(back, after2, r)
    ranks = group.run("hybrid", dict(spec, steps=spec["steps"][2:],
                                     telem_init=after2))
    for r, got in enumerate(ranks):
        assert_tree_rows_equal(got["telem"], want["telem"], r)


def test_world8_host_summaries_match_jax(group):
    _, ranks, want = _main_run(group)
    for got in ranks:
        assert got["hot_rows"] == want["hot_rows"]
        assert got["load_balance"] == want["load_balance"]
        assert got["summary"] == want["summary"]
    gathered = ranks[0]["gathered"]
    for r in range(WORLD):
        assert_tree_rows_equal(
            {k: (v[r:r + 1] if not isinstance(v, dict) else
                 {kk: vv[r:r + 1] for kk, vv in v.items()})
             for k, v in gathered.items()}, want["telem"], r)
    assert len(want["load_balance"]["per_rank_ids"]) == WORLD


def test_slab_row_to_table_matches_jax_on_row_slices():
    jde = layer({"configs": CONFIGS, "row_slice": ROW_THR})
    de = DistributedEmbedding(CONFIGS, WORLD, row_slice=ROW_THR)
    based = 0
    for r in range(WORLD):
        for w in de.widths:
            for row in range(de.rows_cap[w] + 2):
                got = tel._slab_row_to_table(de, r, w, row)
                assert got == jtel._slab_row_to_table(jde, r, w, row)
                based += got is not None and got[1] >= 100
    assert based > 0  # rows of slices past the first map past row 100


# ------------------------------ the JAX package's world-8 telemetry cases

SMALL = tel.TelemetryConfig(depth=4, buckets=512, topk=8, candidates=32)


def _small_spec(configs, steps, **kw):
    cols = sum(int(c["output_dim"]) for c in configs)
    rng = np.random.default_rng(0)
    return dict(configs=configs,
                tables=[rng.uniform(-0.05, 0.05, size=(
                    c["input_dim"], c["output_dim"])).astype(np.float32)
                    for c in configs],
                w=np.full((cols, 1), 0.1, np.float32), lr=0.01,
                loss="proj", local_batch=steps[0][0].shape[0] // WORLD,
                telemetry=tuple(SMALL), steps=steps, **kw)


def test_world8_planted_hot_rows_recovered(group):
    configs = [{"input_dim": 500, "output_dim": 8} for _ in range(8)]
    rng = np.random.default_rng(0)
    planted = {0: 7, 3: 123, 6: 499}
    steps = []
    for _ in range(6):
        cats = []
        for t in range(8):
            ids = power_law_ids(rng, 500, (64,)).astype(np.int32)
            if t in planted:
                ids[rng.permutation(64)[:16]] = planted[t]
            cats.append(ids)
        steps.append(cats)
    ranks = group.run("hybrid", _small_spec(configs, steps))
    for got in ranks:
        hot = got["hot_rows"]
        for tid, row in planted.items():
            assert row in [r for r, _ in hot[tid]], (tid, row, hot[tid])
        assert hot[0][0][0] == 7
        lb = got["load_balance"]
        assert lb["steps"] == 6
        np.testing.assert_allclose(sum(lb["per_rank_ids"]), 6 * 8 * 64)
        assert lb["imbalance_ratio"] == pytest.approx(1.0)


def test_world8_imbalanced_sharding_in_per_rank_histogram(group):
    configs = [{"input_dim": 300, "output_dim": 8,
                "combiner": "sum" if i == 7 else None} for i in range(8)]
    rng = np.random.default_rng(0)
    local_b, hot = 8, 10
    steps = []
    for _ in range(3):
        cats = []
        for t in range(8):
            if t == 7:
                vals = [power_law_ids(rng, 300, (local_b * hot,))
                        .astype(np.int32) for _ in range(WORLD)]
                splits = [np.arange(local_b + 1, dtype=np.int32) * hot
                          for _ in range(WORLD)]
                cats.append(("ragged", vals, splits, None))
            else:
                cats.append(power_law_ids(rng, 300, (64,)).astype(np.int32))
        steps.append(cats)
    ranks = group.run("hybrid", _small_spec(configs, steps))
    for got in ranks:
        loads = got["load_balance"]["per_rank_ids"]
        assert max(loads) == pytest.approx(3 * 64 * hot)
        assert sorted(loads)[-2] == pytest.approx(3 * 64)
        assert got["load_balance"]["imbalance_ratio"] > 4.0


def test_world8_training_bitwise_identical_with_telemetry_on_and_off(group):
    configs = [{"input_dim": 200, "output_dim": 8} for _ in range(8)]
    rng = np.random.default_rng(3)
    steps = [[rng.integers(0, 200, 32).astype(np.int32) for _ in range(8)]
             for _ in range(3)]
    ranks = group.run("hybrid", _small_spec(configs, steps,
                                            telemetry_off_twin=True))
    for got in ranks:
        assert got["same_state"] and got["same_loss_bits"]


def test_world8_loop_carries_one_telemetry_state(group):
    configs = [{"input_dim": 100, "output_dim": 8} for _ in range(8)]
    rng = np.random.default_rng(0)
    K = 4
    steps = [[rng.integers(0, 100, 32).astype(np.int32) for _ in range(8)]
             for _ in range(K)]
    ranks = group.run("hybrid", _small_spec(configs, steps, loop=True))
    for got in ranks:
        assert len(got["losses"]) == K
        lb = got["load_balance"]
        assert lb["steps"] == K
        np.testing.assert_allclose(sum(lb["per_rank_ids"]), K * 8 * 32)
