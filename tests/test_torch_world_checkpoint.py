"""Full train-state checkpoints at world 8: the port's eight gloo ranks
(``torch_dist_worker.py:case_ckpt``, one group for the file) against
the JAX package on its 8-device CPU mesh, in the one on-disk format.

* Bytes and both directions: JAX saves a state on its mesh (random
  tables and optimizer state, Adam counts 3 + rank, step 7); the ranks
  restore it (every rank's tables, dense parameters and step bitwise
  JAX's) and save it again: every file, ``meta.json`` with its CRCs
  included, byte-identical to JAX's, for ``SparseSGD`` with bf16 tables,
  ``SparseAdagrad``, ``SparseAdam`` (its ``[8, 1, 1]`` counts), a
  column-sliced and a row-sliced plan. JAX restores the port's files on
  its mesh bitwise. On the column-sliced plan both then take two steps:
  losses within ``tests/test_torch_dist_train.py``'s float32
  ``DLRM_BOUNDS`` (atol 1e-5) and every table's and dense parameter's
  update within 1e-4 of JAX's, relative to JAX's; the control (the
  ranks' state before the steps) must fail the update bound.
* Re-shard: a world-8 checkpoint restores at world 1 and a world-1
  checkpoint at world 8 under ``on_mismatch="reshard"`` (tables bitwise,
  Adam's counts from their consensus, the largest, with the warning);
  ``"error"`` raises ``CheckpointMismatch`` naming both worlds.
* A torn head: every rank restores ``<path>.prev``, the same
  generation (its step, not the torn one's); with ``fallback=False``
  every rank raises ``CheckpointCorrupt``.
* ``is_chief``: any value but ``None`` or ``rank == 0`` raises on every
  rank and writes nothing.
* ``set_weights(use_lock=True)``: the same slabs as without the lock;
  the ranks build in rank order (a log appended inside each build).

Exact checks have no tolerance; the two-step bound states its own.
"""

import json
import os

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.utils import checkpoint as jax_ckpt

from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
from distributed_embeddings_torch.parallel import DistributedEmbedding
from distributed_embeddings_torch.utils import checkpoint as ckpt
from distributed_embeddings_torch.utils import obs

from torch_dist_worker import RankGroup, ckpt_optimizers
from torch_world_ref import (CKPT_MODEL, CKPT_SIZES, WORLD, ckpt_spec,
                             jax_ckpt_parts, jax_ckpt_state, jax_ckpt_steps,
                             mesh, tree_bits_equal)

torch.set_num_threads(1)

LOSS_ATOL, UPDATE_GAP = 1e-5, 1e-4  # DLRM_BOUNDS["float32"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_world_ckpt"))
    yield g
    g.close()


def _files(path):
    out = {}
    for root, _, names in os.walk(path):
        for n in names:
            fp = os.path.join(root, n)
            with open(fp, "rb") as f:
                out[os.path.relpath(fp, path)] = f.read()
    return out


def _bf16_as_f32(a):
    a = np.asarray(a)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        return (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
                << 16).view(np.float32)
    return a.astype(np.float32)


def _dense_list(tree):
    """Flax DLRMDense parameters in the port's ``parameters()`` order."""
    tree = tree["params"]
    names = sorted(tree, key=lambda k: int(k.split("_")[-1]))
    return [np.asarray(a) for n in names
            for a in (np.asarray(tree[n]["kernel"]).T, tree[n]["bias"])]


def _gap(got, before, after):
    """``max|got - after| / max|after - before|`` (JAX's update)."""
    err = np.abs(np.asarray(got, np.float64) - after).max()
    step = np.abs(np.asarray(after, np.float64) - before).max()
    return float(err / step) if step else (0.0 if err == 0 else np.inf)


@pytest.mark.parametrize("case", ["sgd_bf16", "adagrad", "adam", "colslice",
                                  "rowslice"])
def test_world8_save_bytes_equal_jax_and_both_restore(group, tmp_path,
                                                      case):
    jde, dense, emb_opt, tx, _ = jax_ckpt_parts(case)
    jst = jax_ckpt_state(case)
    jtables = [np.asarray(t) for t in jde.get_weights(jst.emb_params)]
    J, P = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_train_state(J, jde, jst)
    two = case == "colslice"
    ops = [("restore", J, "error", {}), ("snap", "restored"),
           ("save", P, {})]
    if two:
        ops += [("steps", 2, "losses"), ("snap", "after")]
    ranks = group.run("ckpt", ckpt_spec(case, ops=ops))
    for r, got in enumerate(ranks):
        assert "error" not in got, got.get("error")
        snap = got["restored"]
        assert snap["step"] == 7
        for a, b in zip(snap["dense"], _dense_list(jst.dense_params)):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")
    for t, (a, b) in enumerate(zip(ranks[0]["restored"]["tables"],
                                   jtables)):
        np.testing.assert_array_equal(a, _bf16_as_f32(b),
                                      err_msg=f"table {t}")
    jfiles, tfiles = _files(J), _files(P)
    assert sorted(jfiles) == sorted(tfiles)
    for rel in jfiles:
        assert jfiles[rel] == tfiles[rel], rel
    meta = json.loads(tfiles["meta.json"])
    assert meta["plan"]["world_size"] == WORLD
    if case == "adam":
        with np.load(os.path.join(P, "emb_opt", "state2.npz")) as z:
            for k in z.files:
                assert z[k].shape == (WORLD, 1, 1)
                np.testing.assert_array_equal(z[k].reshape(-1),
                                              3 + np.arange(WORLD))
    # JAX restores the port's checkpoint on its mesh, bitwise
    back = jax_ckpt.restore_train_state(P, jde, emb_opt, jst.dense_params,
                                        tx, mesh=mesh())
    assert tree_bits_equal(back, jst)
    if not two:
        return
    jl, jafter = jax_ckpt_steps(case, back, ranks[0]["restored"] and
                                ckpt_spec(case)["batches"][:2])
    after_tables = [np.asarray(t) for t in jde.get_weights(
        jafter.emb_params)]
    before_dense = _dense_list(jst.dense_params)
    after_dense = _dense_list(jafter.dense_params)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], jl, atol=LOSS_ATOL,
                                   rtol=0, err_msg=f"rank {r}")
        assert got["losses"] == ranks[0]["losses"]
        gaps = [_gap(a, b, c) for a, b, c in zip(
            got["after"]["dense"], before_dense, after_dense)]
        assert max(gaps) <= UPDATE_GAP, (r, gaps)
    gaps = [_gap(a, b, c) for a, b, c in zip(
        ranks[0]["after"]["tables"], jtables, after_tables)]
    assert max(gaps) <= UPDATE_GAP, gaps
    # control: the state before the steps fails the update bound
    ctrl = [_gap(a, b, c) for a, b, c in zip(
        ranks[0]["restored"]["tables"], jtables, after_tables)]
    assert max(ctrl) > UPDATE_GAP, ctrl


def _port_world1(case):
    """The port's layer, fresh dense module and optimizers at world 1."""
    de = DistributedEmbedding(
        DLRMConfig(**CKPT_MODEL).embedding_configs(), world_size=1)
    emb_opt, tx, _ = ckpt_optimizers("adam" if case == "adam" else "sgd",
                                     None)
    dense = DLRMDense(DLRMConfig(**CKPT_MODEL), device="cpu",
                      generator=torch.Generator().manual_seed(9))
    return de, emb_opt, tx, dense


def test_world8_reshards_to_world1_and_back(group, tmp_path, caplog):
    jde, _, _, _, _ = jax_ckpt_parts("adam")
    jst = jax_ckpt_state("adam", seed=1)
    jtables = [np.asarray(t) for t in jde.get_weights(jst.emb_params)]
    J8, P1 = str(tmp_path / "jax8"), str(tmp_path / "port1")
    jax_ckpt.save_train_state(J8, jde, jst)
    # world 8 -> 1 at world 1: refused under "error", re-sliced under
    # "reshard" (tables bitwise, the counts' consensus with a warning)
    de, emb_opt, tx, dense = _port_world1("adam")
    with pytest.raises(ckpt.runtime.CheckpointMismatch,
                       match="world 8 -> 1"):
        ckpt.restore_train_state(J8, de, emb_opt, dense, tx, device="cpu")
    obs.drain_events()
    st1 = ckpt.restore_train_state(J8, de, emb_opt, dense, tx, device="cpu",
                                   on_mismatch="reshard")
    assert "per-slab values disagree" in caplog.text
    for t, (a, b) in enumerate(zip(de.get_weights(st1.emb_params),
                                   jtables)):
        np.testing.assert_array_equal(a, b, err_msg=f"table {t}")
    for k, (_, _, count) in st1.emb_opt_state.items():
        assert count.shape == (1, 1, 1) and float(count) == 3 + WORLD - 1
    assert obs.drain_events("checkpoint_reshard")[0]["diff"][
        "world_size"] == [WORLD, 1]
    ckpt.save_train_state(P1, de, st1)
    # world 1 -> 8 at world 8
    ranks = group.run("ckpt", ckpt_spec("adam", ops=[
        ("restore", P1, "refused", {}),
        ("restore", P1, "error", {"on_mismatch": "reshard"}),
        ("snap", "back"), ("events", "events")]))
    for r, got in enumerate(ranks):
        kind, msg = got["refused"]
        assert kind == "CheckpointMismatch" and "world 1 -> 8" in msg, msg
        assert "error" not in got, got.get("error")
        assert "checkpoint_reshard" in got["events"]
        counts = got["back"]["opt"][2::3]
        assert all(c.shape == (1, 1, 1) and c.item() == 3 + WORLD - 1
                   for c in counts), counts
        assert got["back"]["step"] == 7
    for t, (a, b) in enumerate(zip(ranks[0]["back"]["tables"], jtables)):
        np.testing.assert_array_equal(a, b, err_msg=f"table {t}")


def test_torn_head_restores_prev_on_every_rank(group, tmp_path):
    J, P = str(tmp_path / "jax"), str(tmp_path / "port")
    jde = jax_ckpt_parts("colslice")[0]
    jax_ckpt.save_train_state(J, jde, jax_ckpt_state("colslice", seed=2))
    ranks = group.run("ckpt", ckpt_spec("colslice", ops=[
        ("restore", J, "error", {}), ("save", P, {}),
        ("steps", 1, "losses"), ("save", P, {}), ("corrupt", P),
        ("events", "before"),
        ("restore", P, "error", {}), ("snap", "back"), ("events", "events"),
        ("restore", P, "strict", {"fallback": False})]))
    for r, got in enumerate(ranks):
        assert "error" not in got, got.get("error")
        # the generation of step 7, not the torn one of step 8
        assert got["back"]["step"] == 7, (r, got["back"]["step"])
        assert "checkpoint_prev_fallback" in got["events"]
        kind, msg = got["strict"]
        assert kind == "CheckpointCorrupt" and "CRC mismatch" in msg, msg
    assert all(g["strict"] == ranks[0]["strict"] for g in ranks)


def test_is_chief_other_than_rank0_raises_on_every_rank(group, tmp_path):
    """``save_train_state``'s ``is_chief`` is None or ``rank == 0``: one
    rank that claims the chief (rank 3), or rank 0 that declines, makes
    every rank raise ``ValueError`` before any transfer and nothing is
    written; the ranks' own values save. Control: the same ops with
    every rank passing ``None`` save."""
    J = str(tmp_path / "jax")
    jde = jax_ckpt_parts("colslice")[0]
    jax_ckpt.save_train_state(J, jde, jax_ckpt_state("colslice", seed=2))
    bad3 = [None] * WORLD
    bad3[3] = True
    bad0 = [False] + [None] * (WORLD - 1)
    own = [r == 0 for r in range(WORLD)]
    paths = {k: str(tmp_path / k) for k in ("bad3", "bad0", "own", "none")}
    ranks = group.run("ckpt", ckpt_spec("colslice", ops=[
        ("restore", J, "error", {}),
        ("save_chief", paths["bad3"], bad3, "bad3"),
        ("save_chief", paths["bad0"], bad0, "bad0"),
        ("save_chief", paths["own"], own, "own"),
        ("save_chief", paths["none"], [None] * WORLD, "none")]))
    for got in ranks:
        assert "error" not in got, got.get("error")
        for name, who in (("bad3", "[3]"), ("bad0", "[0]")):
            kind, msg = got[name]
            assert kind == "ValueError" and who in msg, (name, msg)
        assert got["own"] == got["none"] == "saved"
    assert not os.path.exists(paths["bad3"])
    assert not os.path.exists(paths["bad0"])
    assert _files(paths["own"]) == _files(paths["none"])


def test_set_weights_lock_takes_turns_in_rank_order(group, tmp_path):
    rng = np.random.default_rng(4)
    configs = [{"input_dim": s, "output_dim": 8} for s in CKPT_SIZES]
    log = str(tmp_path / "turns.log")
    ranks = group.run("lock_turns", dict(
        configs=configs, strategy="memory_balanced", log=log,
        tables=[rng.normal(size=(s, 8)).astype(np.float32)
                for s in CKPT_SIZES]))
    assert all(g["equal"] for g in ranks)
    with open(log) as f:
        assert [int(x) for x in f.read().split()] == list(range(WORLD))
